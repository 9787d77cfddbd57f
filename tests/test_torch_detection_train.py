"""The SSD training script of mxnet_tpu_torch held against the reference's
own script on the CPU (the RCNN script's run is
``test_torch_detection_train_rcnn.py``, which imports the helpers here).

- ``tools/train_ssd.py`` against ``examples/ssd/train_ssd.py``, 3 steps at
  batch 4: the packed ``.rec`` and ``.idx`` byte for byte (PIL JPEG at
  quality 95 in both), the initial parameters bitwise after
  ``mx.random.seed`` (Xavier from numpy's global RNG), the losses within
  2e-5 and the parameters after the three SGD steps within 5e-6 (each
  over the larger of 1 and the reference's largest magnitude), and the
  port's detections of its last batch in the reference's row format.  The
  reference's loop runs as it is; the test reads its losses through
  ``jax.value_and_grad`` and its executor through ``simple_bind``.
- Python's ``random`` (the iterator's shuffle and mirror) is seeded before
  each package's run, and each iterator's prefetch thread is let settle
  before the script resets it, so both consume one stream.
- To keep the reference's run short, it decodes with the same OpenCV call
  without its round trip through a jax array, runs ``MultiBoxTarget``
  and its SGD update under ``jax.jit`` (one program where its eager
  dispatch compiles every primitive) and stops at its inference batch
  (that op is held in ``test_torch_contrib_box.py``).
- ``tools/train_rcnn_lite.py``'s anchors and batches are the reference
  script's.
"""
import contextlib
import importlib.util
import io as pyio
import os
import random
import sys
import tempfile
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _settle(make):
    """An iterator factory whose prefetch thread has filled its queue and
    started the next batch before the caller goes on (a script resets the
    iterator right after binding; the draws of the batches prefetched
    before that reset must be the same in both packages)."""
    def wrapped(*args, **kwargs):
        it = make(*args, **kwargs)
        deadline = time.monotonic() + 30
        while not it._queue.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        return it
    return wrapped


@contextlib.contextmanager
def _argv(args):
    saved = sys.argv
    sys.argv = ["x"] + list(args)
    try:
        yield
    finally:
        sys.argv = saved


# -- SSD -----------------------------------------------------------------
def _jitted(fn):
    """``fn(*arrays, **params)`` compiled once per parameter set."""
    import jax
    progs = {}

    def run(*arrays, **params):
        key = repr(sorted(params.items()))
        if key not in progs:
            progs[key] = jax.jit(lambda *a: fn(*a, **params))
        return progs[key](*arrays)
    return run


def _jitted_lr(fn):
    """An optimizer update ``fn(*arrays, lr=, **params)`` compiled once per
    parameter set and shapes, with ``lr`` (the bias-corrected rate that
    changes every step) a float32 argument of the program."""
    import jax
    import jax.numpy as jnp
    progs = {}

    def run(*arrays, lr=None, **params):
        key = repr(sorted(params.items()))
        if key not in progs:
            progs[key] = jax.jit(lambda lr_, *a: fn(*a, lr=lr_, **params))
        return progs[key](jnp.float32(lr), *arrays)
    return run


class _Stop(Exception):
    """Raised where a test stops a script after its training steps."""


def _stop(*args, **kwargs):
    raise _Stop


def _ssd_reference(tmp, monkeypatch):
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu.image import detection as jdet
    from mxnet_tpu_torch.image import image as timage
    ex_box, init, losses = [], {}, []
    mod = _load("examples/ssd/train_ssd.py", "ssd_example")
    bind = jmx.sym.Symbol.simple_bind

    def simple_bind(self, *a, **k):
        ex = bind(self, *a, **k)
        ex_box.append(ex)
        fwd = ex.forward

        def forward(*fa, **fk):
            if not init:
                init.update({n: v.asnumpy().copy()
                             for n, v in ex.arg_dict.items()})
            return fwd(*fa, **fk)
        ex.forward = forward
        return ex
    vg = jax.value_and_grad

    def value_and_grad(fn, **kw):
        inner = vg(fn, **kw)

        def run(*a):
            loss, grads = inner(*a)
            losses.append(float(loss))
            return loss, grads
        return run
    monkeypatch.setattr(jmx.sym.Symbol, "simple_bind", simple_bind)
    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **k: tmp)
    monkeypatch.setattr(jmx.io, "ImageDetRecordIter",
                        _settle(jmx.io.ImageDetRecordIter))
    # the reference's decode is cv2 through a jax array and back; the
    # same cv2 decode without the round trip spares its compiles
    monkeypatch.setattr(jdet.ImageDetIter, "_decode_raw",
                        lambda self, s: timage.imdecode(s).asnumpy())
    # stop after the training steps: the inference batch's op is held in
    # test_torch_contrib_box.py
    monkeypatch.setattr(jmx.nd.contrib, "MultiBoxDetection", _stop)
    # MultiBoxTarget under jax.jit: one program where the eager vmap
    # compiles each of its primitives
    op = jreg.get("_contrib_MultiBoxTarget")
    monkeypatch.setattr(op, "fn", _jitted(op.fn))
    op = jreg.get("sgd_mom_update")
    monkeypatch.setattr(op, "fn", _jitted_lr(op.fn))
    random.seed(0)
    jmx.random.seed(0)
    with _argv(["--num-batches", "3", "--batch-size", "4"]), \
            pytest.raises(_Stop):
        mod.main()
    monkeypatch.undo()
    ex = ex_box[0]
    return dict(init=init, losses=losses,
                final={n: v.asnumpy() for n, v in ex.arg_dict.items()})


def _ssd_port(tmp, monkeypatch):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.tools import train_ssd
    init, box = {}, []
    bind = train_ssd.bind

    def bind_and_snapshot(args, device):
        ex, updater = bind(args, device)
        init.update({n: v.asnumpy().copy() for n, v in ex.arg_dict.items()})
        box.append(ex)
        return ex, updater
    monkeypatch.setattr(train_ssd, "bind", bind_and_snapshot)
    monkeypatch.setattr(train_ssd, "make_iter",
                        _settle(train_ssd.make_iter))
    random.seed(0)
    tmx.random.seed(0)
    losses, kept = train_ssd.main(["--num-batches", "3", "--batch-size", "4",
                                   "--ctx", "cpu"], workdir=tmp)
    monkeypatch.undo()
    return dict(init=init, losses=losses, kept=kept,
                final={n: v.asnumpy() for n, v in box[0].arg_dict.items()})


def test_train_ssd_matches_reference_script(tmp_path, monkeypatch):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    want = _ssd_reference(str(ref_dir), monkeypatch)
    got = _ssd_port(str(port_dir), monkeypatch)
    for ext in (".rec", ".idx"):
        assert (ref_dir / ("det" + ext)).read_bytes() == \
            (port_dir / ("det" + ext)).read_bytes()
    assert list(got["init"]) == list(want["init"])
    for n, w in want["init"].items():
        np.testing.assert_array_equal(got["init"][n], w, err_msg=n)
    assert len(got["losses"]) == len(want["losses"]) == 3
    _within(np.array(got["losses"]), np.array(want["losses"]), LOSS_TOL)
    for n, w in want["final"].items():
        if n != "data":
            _within(got["final"][n], w, PARAM_TOL)
    assert got["kept"].ndim == 2 and got["kept"].shape[1] == 6


def test_train_ssd_records_are_the_references_with_pil(tmp_path):
    """``pack_det_records`` writes the reference's bytes with PIL; with
    OpenCV the same pixels and labels, other JPEG bytes."""
    import mxnet_tpu_torch.recordio as trec
    from mxnet_tpu_torch.tools import train_ssd
    mod = _load("examples/ssd/train_ssd.py", "ssd_example_pack")
    want = mod.pack_det_records(str(tmp_path / "a"), 6, 3,
                                np.random.RandomState(1))
    got = train_ssd.pack_det_records(str(tmp_path / "b"), 6, 3,
                                     np.random.RandomState(1), "pil")
    cv = train_ssd.pack_det_records(str(tmp_path / "c"), 6, 3,
                                    np.random.RandomState(1), "opencv")
    for w, g in zip(want, got):
        assert open(w, "rb").read() == open(g, "rb").read()
    a = trec.MXIndexedRecordIO(want[1], want[0], "r")
    c = trec.MXIndexedRecordIO(cv[1], cv[0], "r")
    for i in range(6):
        ha, ia = trec.unpack_img(a.read_idx(i))
        hc, ic = trec.unpack_img(c.read_idx(i))
        np.testing.assert_array_equal(ha.label, hc.label)
        assert np.abs(ia.astype(int) - ic.astype(int)).mean() < 2.0
    assert train_ssd.jpeg_encoder() == "pil"


# -- RCNN's data -------------------------------------------------------
def test_rcnn_anchor_grid_matches_reference():
    from mxnet_tpu_torch.tools import train_rcnn_lite
    mod = _load("examples/rcnn/train_rcnn_lite.py", "rcnn_example_grid")
    np.testing.assert_array_equal(train_rcnn_lite.anchor_grid(3, 16, 16),
                                  mod.anchor_grid(3, 16, 16))
    rng_a, rng_b = np.random.RandomState(4), np.random.RandomState(4)
    for a, b in zip(train_rcnn_lite.make_batch(rng_a, 3),
                    mod.make_batch(rng_b, 3)):
        np.testing.assert_array_equal(a, b)


