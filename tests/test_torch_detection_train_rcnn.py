"""The RCNN-lite training script of mxnet_tpu_torch held against the
reference's own script on the CPU.

- ``tools/train_rcnn_lite.py`` against ``examples/rcnn/train_rcnn_lite.py``,
  2 steps at batch 4: the initial parameters bitwise after
  ``mx.random.seed`` (deferred Xavier from numpy's global RNG, drawn at
  the first forward), the losses within 2e-5 and the parameters after two
  Adam steps within 5e-6 (each over the larger of 1 and the reference's
  largest magnitude).  Both scripts stop where they draw their evaluation
  batch; the reference runs ``Proposal``, ``ROIAlign`` and
  ``bipartite_matching`` (held in ``test_torch_contrib_box.py``) and its
  Adam update under ``jax.jit``, which compiles one program where its
  eager dispatch compiles every primitive.

``python tests/test_torch_detection_train_rcnn.py --rcnn-seeds 0,1,2``
runs both packages' scripts at their defaults after ``mx.random.seed(s)``
for each seed and prints their head accuracy and recall: the reference's
bars do not hold at every seed, and the port gives the same figures
(ROADMAP.md C9).
"""
import contextlib
import io as pyio
import os
import sys

import numpy as np
import pytest

from test_torch_detection_train import (LOSS_TOL, PARAM_TOL, ROOT, _Stop,
                                        _argv, _jitted, _jitted_lr, _load,
                                        _within)


# -- RCNN ----------------------------------------------------------------
def _rcnn_capture(mx, monkeypatch, losses, init, box):
    backward = mx.ndarray.NDArray.backward
    trainer_init = mx.gluon.Trainer.__init__

    def record(self, *a, **k):
        if not init:
            init.update({n: p.data().asnumpy().copy()
                         for n, p in box[0].items()})
        losses.append(float(self.asnumpy()))
        return backward(self, *a, **k)

    def capture(self, params, *a, **k):
        box.append(params)
        return trainer_init(self, params, *a, **k)
    monkeypatch.setattr(mx.ndarray.NDArray, "backward", record)
    monkeypatch.setattr(mx.gluon.Trainer, "__init__", capture)


def _suffixes(params):
    """{name past the block prefix: array}."""
    out = {}
    for n, p in params.items():
        out[n.split("_", 1)[1]] = p.data().asnumpy()
    return out


def _stop_at_evaluation(module, monkeypatch):
    """Stop the script where it draws its evaluation batch (32 images)."""
    make = module.make_batch

    def make_batch(rng, n):
        if n == 32:
            raise _Stop
        return make(rng, n)
    monkeypatch.setattr(module, "make_batch", make_batch)


def test_train_rcnn_lite_matches_reference_script(monkeypatch):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.tools import train_rcnn_lite
    mod = _load("examples/rcnn/train_rcnn_lite.py", "rcnn_example")
    want, got = {}, {}
    for mx, module, run, out in (
            (jmx, mod, lambda: mod.main(), want),
            (tmx, train_rcnn_lite, lambda: train_rcnn_lite.main(
                ["--steps", "2", "--batch", "4", "--ctx", "cpu"]), got)):
        losses, init, box = [], {}, []
        _rcnn_capture(mx, monkeypatch, losses, init, box)
        _stop_at_evaluation(module, monkeypatch)
        if mx is jmx:
            for name in ("_contrib_Proposal", "_contrib_ROIAlign",
                         "_contrib_bipartite_matching"):
                op = jreg.get(name)
                monkeypatch.setattr(op, "fn", _jitted(op.fn))
            op = jreg.get("adam_update")
            monkeypatch.setattr(op, "fn", _jitted_lr(op.fn))
        mx.random.seed(0)
        with _argv(["--steps", "2", "--batch", "4"]), \
                contextlib.redirect_stdout(pyio.StringIO()) as text:
            with pytest.raises(_Stop):
                run()
        monkeypatch.undo()
        out.update(losses=losses, init=init, final=_suffixes(box[0]),
                   text=text.getvalue())
    assert len(got["losses"]) == len(want["losses"]) == 2
    _within(np.array(got["losses"]), np.array(want["losses"]), LOSS_TOL)
    assert sorted(got["final"]) == sorted(want["final"])
    want_init = {n.split("_", 1)[1]: v for n, v in want["init"].items()}
    got_init = {n.split("_", 1)[1]: v for n, v in got["init"].items()}
    for n, w in want_init.items():
        np.testing.assert_array_equal(got_init[n], w, err_msg=n)
    for n, w in want["final"].items():
        _within(got["final"][n], w, PARAM_TOL)
    for text in (want["text"], got["text"]):
        assert text.startswith("step 0 loss ")


def _rcnn_seeds(seeds):
    """Both packages' RCNN scripts at their defaults, one run a seed:
    (seed, package, head accuracy, recall, passed)."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.tools import train_rcnn_lite
    mod = _load("examples/rcnn/train_rcnn_lite.py", "rcnn_example_seeds")
    rows = []
    for seed in seeds:
        for name, mx, run in (("mxnet_tpu", jmx, mod.main),
                              ("mxnet_tpu_torch", tmx,
                               lambda: train_rcnn_lite.main(["--ctx",
                                                             "cpu"]))):
            mx.random.seed(seed)
            buf = pyio.StringIO()
            try:
                with _argv([]), contextlib.redirect_stdout(buf):
                    run()
                ok = True
            except AssertionError:
                ok = False
            line = [ln for ln in buf.getvalue().splitlines()
                    if "head accuracy" in ln][0]
            acc, rec = [float(w.rstrip(";")) for w in line.split()
                        if w[0].isdigit()]
            rows.append((seed, name, acc, rec, ok))
            print("seed %d %-16s head accuracy %.3f recall %.3f %s"
                  % (seed, name, acc, rec, "passes" if ok else "fails"),
                  flush=True)
    return rows


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    if "--rcnn-seeds" in sys.argv:
        _rcnn_seeds([int(s) for s in
                     sys.argv[sys.argv.index("--rcnn-seeds") + 1].split(",")])
