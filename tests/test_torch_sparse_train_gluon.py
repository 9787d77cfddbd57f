"""The two Gluon examples of the sparse workloads held against the
reference's own scripts on the CPU (the linear classifier is
``test_torch_sparse_train.py``).

- ``tools/train_wide_deep.py`` against ``examples/wide_deep/train.py``, 4
  batches of 16 over 4 fields of 10 ids (CSR batches densified for the
  wide part, their columns read back as ids for the deep part), and
- ``tools/matrix_fact.py`` against ``examples/recommenders/matrix_fact.py``
  at 30 users, 20 items and rank 4, stopped after 4 batches of 256:
  the initial parameters bitwise after ``mx.random.seed`` (Xavier, or
  Normal(0.05), from numpy's global RNG; the deferred ones drawn at the
  first forward), each batch's loss within 2e-5 and the parameters after
  the four Adam steps within 5e-6 (each over the larger of 1 and the
  reference's largest magnitude).  The wide & deep example's assert
  (running accuracy above 0.75) does not hold after 4 batches: both
  scripts run to it and it decides alike in both.
- Both tools at their defaults pass their examples' asserts.
"""
import numpy as np
import pytest

from test_torch_detection_train import (LOSS_TOL, PARAM_TOL, _Stop, _argv,
                                        _load, _within)
from test_torch_sparse_train import _quiet, _run_to_assert

WD_ARGS = ["--vocab", "10", "--batch-size", "16", "--num-batches", "4"]
MF_ARGS = ["--num-users", "30", "--num-items", "20", "--rank", "4"]
MF_STEPS = 4


def _suffixes(params):
    """{name past the block prefix: array}."""
    return {n.split("_", 1)[1]: p.data().asnumpy()
            for n, p in params.items()}


def _capture(mx, monkeypatch, losses, init, box, stop_after=None):
    """Record each loss at its backward (and the parameters before the
    first), the trainer's parameters, and stop after ``stop_after``
    trainer steps."""
    backward = mx.ndarray.NDArray.backward
    trainer_init = mx.gluon.Trainer.__init__
    step = mx.gluon.Trainer.step

    def record(self, *a, **k):
        if not init:
            init.update(_suffixes(box[0]))
        losses.append(self.asnumpy().copy())
        return backward(self, *a, **k)

    def capture(self, params, *a, **k):
        box.append(params)
        return trainer_init(self, params, *a, **k)

    def counted(self, *a, **k):
        out = step(self, *a, **k)
        if stop_after is not None and len(losses) == stop_after:
            raise _Stop
        return out
    monkeypatch.setattr(mx.ndarray.NDArray, "backward", record)
    monkeypatch.setattr(mx.gluon.Trainer, "__init__", capture)
    monkeypatch.setattr(mx.gluon.Trainer, "step", counted)


def _both(monkeypatch, example, tool, args, stop_after=None):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    mod = _load(example, example.replace("/", "_")[:-3])
    out = {}
    for pkg, mx, run in (("ref", jmx, mod.main),
                         ("port", tmx, lambda: tool.main(
                             args + ["--ctx", "cpu"]))):
        losses, init, box = [], {}, []
        _capture(mx, monkeypatch, losses, init, box, stop_after)
        mx.random.seed(0)
        with _argv(args):
            if stop_after is None:
                passed = _run_to_assert(run)
            else:
                with _quiet(), pytest.raises(_Stop):
                    run()
                passed = None
        monkeypatch.undo()
        out[pkg] = dict(losses=losses, init=init, final=_suffixes(box[0]),
                        passed=passed)
    return out["ref"], out["port"]


def _held(want, got, steps):
    assert got["passed"] == want["passed"]
    assert len(got["losses"]) == len(want["losses"]) == steps
    for g, w in zip(got["losses"], want["losses"]):
        _within(g, w, LOSS_TOL)
    assert sorted(got["init"]) == sorted(want["init"]) \
        == sorted(want["final"]) == sorted(got["final"])
    for n, w in want["init"].items():
        np.testing.assert_array_equal(got["init"][n], w, err_msg=n)
    for n, w in want["final"].items():
        _within(got["final"][n], w, PARAM_TOL)
        assert not np.array_equal(w, want["init"][n]), n


def test_train_wide_deep_matches_reference_example(monkeypatch):
    from mxnet_tpu_torch.tools import train_wide_deep
    want, got = _both(monkeypatch, "examples/wide_deep/train.py",
                      train_wide_deep, WD_ARGS)
    _held(want, got, 4)
    assert got["passed"] is False


def test_matrix_fact_matches_reference_example(monkeypatch):
    from mxnet_tpu_torch.tools import matrix_fact
    want, got = _both(monkeypatch, "examples/recommenders/matrix_fact.py",
                      matrix_fact, MF_ARGS, stop_after=MF_STEPS)
    _held(want, got, MF_STEPS)


@pytest.mark.parametrize("tool", ["train_wide_deep", "matrix_fact"])
def test_tool_defaults_pass_the_examples_assert(tool):
    import importlib
    mod = importlib.import_module("mxnet_tpu_torch.tools." + tool)
    with _quiet():
        out = mod.main(["--ctx", "cpu"])
    if tool == "train_wide_deep":
        acc, losses = out
        assert acc > 0.75 and len(losses) == 120
    else:
        assert len(out) == 12 and out[-1] < 0.3 * out[0]
