"""``mx.Context`` (ROADMAP C17, repaired) held to ``mxnet_tpu/context.py``,
and device lists / ``group2ctx`` with ``Context`` values against
``tests/test_group2ctx.py:62-100``'s cases without a model axis.

Arrays made under ``with cpu():`` live on the host in both packages;
scopes nest and each thread has its own; ``str`` / ``repr`` / equality /
hashing / ``Context(Context)`` are the reference's, with ``gpu`` mapped
to CUDA where the reference maps it to the TPU.  A device list of host
contexts binds on the host, and a two-group net bound with ``Context``
group values trains through ``Module.fit`` to the reference's numbers
(1e-5).  Cases that need a card carry the ``cuda`` marker.

Wall at ``-n 6``: ~10 s.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as ref
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError, as_torch_device

TOL = 1e-5


def test_arrays_made_under_cpu_live_on_the_host():
    with mx.cpu():
        a = mx.nd.zeros((2,))
        b = mx.nd.array(np.arange(3, dtype=np.float32))
        assert mx.current_context() == mx.cpu()
    with ref.cpu():
        r = ref.nd.zeros((2,))
    assert a.context == mx.cpu() and b.context == mx.cpu(0)
    assert str(mx.cpu()) == str(r.context) == "cpu(0)"
    np.testing.assert_array_equal(a.asnumpy(), r.asnumpy())
    with mx.cpu_pinned():
        assert mx.nd.ones((1,)).context == mx.cpu()


def test_default_stays_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is it")
    with pytest.raises(MXNetError):
        mx.current_context()
    with pytest.raises(MXNetError):
        mx.gpu()
    with pytest.raises(MXNetError):
        mx.nd.zeros((2,))
    with pytest.raises(MXNetError):
        mx.gpu_memory_info(0)


def test_nested_scopes_and_threads():
    outer, inner = mx.cpu(0), mx.cpu(1)
    seen = {}
    with outer:
        assert mx.current_context() is outer
        with inner:
            assert mx.current_context() is inner
            with inner:                     # the same context re-entered
                assert mx.current_context() is inner
            assert mx.current_context() is inner

            def other():
                seen["thread"] = getattr(mx.Context._default_ctx, "value",
                                         None)
                with mx.cpu(2):
                    seen["inside"] = mx.current_context()
            t = threading.Thread(target=other)
            t.start()
            t.join()
        assert mx.current_context() is outer
    assert seen["thread"] is None          # a new thread starts unset
    assert seen["inside"] == mx.cpu(2)
    assert getattr(mx.Context._default_ctx, "value", None) is None
    # the same nesting in the reference
    with ref.cpu(0):
        with ref.cpu(1):
            assert ref.current_context() == ref.cpu(1)
        assert ref.current_context() == ref.cpu(0)


def test_str_repr_equality_and_hash_match_the_reference():
    for dev_id in (0, 3):
        c, r = mx.cpu(dev_id), ref.cpu(dev_id)
        assert str(c) == str(r) and repr(c) == repr(r)
        assert c.device_type == r.device_type == "cpu"
        assert c.device_typeid == r.device_typeid
    assert mx.cpu(0) == mx.Context("cpu", 0) != mx.cpu(1)
    assert mx.cpu(0) != mx.Context("gpu", 0)
    assert hash(mx.cpu(0)) == hash(mx.Context("cpu")) == hash(ref.cpu(0))
    assert {mx.cpu(0): 1}[mx.Context("cpu", 0)] == 1
    assert mx.Context(mx.cpu(3)) == mx.cpu(3)
    assert mx.Context(ref.Context(ref.cpu(2)).device_type,
                      ref.Context(ref.cpu(2)).device_id) == mx.cpu(2)
    g = mx.Context("gpu", 1)
    assert g.device_type == "gpu" and str(g) == "gpu(1)"
    assert ref.Context("gpu", 1).device_type == "tpu"   # the TPU mapping
    assert g.device_typeid == ref.Context("gpu", 1).device_typeid == 2
    assert mx.cpu_pinned().device_type == ref.cpu_pinned().device_type
    # a Context equals only a Context (as the reference's), and converts
    # to the torch.device it stands for explicitly
    assert mx.cpu() != torch.device("cpu") and torch.device("cpu") != mx.cpu()
    assert mx.Context("gpu", 1) != torch.device("cuda", 1)
    assert len({mx.cpu(0), mx.cpu(0).torch_device(), mx.cpu(3)}) == 3
    assert mx.Context(torch.device("cuda", 1)) == g
    assert mx.Context("cpu").torch_device() == torch.device("cpu")
    assert as_torch_device(g) == torch.device("cuda", 1)
    assert isinstance(mx.nd.zeros((1,), ctx=mx.cpu(3)).context, mx.Context)
    assert mx.nd.zeros((1,), ctx=mx.cpu(3)).context == mx.cpu(0)


def test_context_goes_wherever_a_device_does():
    c = mx.cpu()
    a = mx.nd.array(np.ones((2, 2), np.float32), ctx=c)
    assert a.as_in_context(c) is a
    assert a.copyto(c).context == c
    net = mx.gluon.nn.Dense(3, in_units=2)
    net.initialize(ctx=c)
    assert net(a).context == c
    with mx.context.use(c) as dev:
        assert dev == torch.device("cpu")
        assert mx.current_context() == c


def _two_group_net(pkg):
    data = pkg.sym.Variable("data")
    with pkg.AttrScope(ctx_group="g0"):
        fc1 = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
        act = pkg.sym.Activation(fc1, act_type="relu")
    with pkg.AttrScope(ctx_group="g1"):
        fc2 = pkg.sym.FullyConnected(act, num_hidden=16, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def test_ctx_group_attr_not_leaked_to_kernels():
    with mx.AttrScope(ctx_group="anything"):
        out = mx.sym.Activation(mx.sym.Variable("x"), act_type="relu")
    exe = out.bind(mx.cpu(), args={"x": np.ones((2, 2), np.float32)})
    np.testing.assert_array_equal(exe.forward()[0].asnumpy(),
                                  np.ones((2, 2), np.float32))


def _fit(pkg, ctx, group2ctxs):
    rng = np.random.RandomState(0)
    x = rng.rand(32, 8).astype(np.float32)
    y = (np.arange(32) % 4).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, 8)
    mod = pkg.mod.Module(_two_group_net(pkg), context=ctx,
                         group2ctxs=group2ctxs)
    np.random.seed(5)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            initializer=pkg.init.Xavier())
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def test_device_list_and_context_groups_train_as_the_reference():
    got = _fit(mx, [mx.cpu(0), mx.cpu(1)],
               {"g0": mx.cpu(0), "g1": mx.cpu(1)})
    # (the reference cannot build its data mesh over one host device
    # twice; its list of one is the same program)
    want = _fit(ref, [ref.cpu(0)], {"g0": ref.cpu(0), "g1": ref.cpu(0)})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_group2ctx_specs_and_distinct_devices_name_their_items(tmp_path):
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel.mesh import PartitionSpec, make_mesh
    net = _two_group_net(mx)
    # ported by item A7(a): a sharding spec is recorded, and over an
    # in-process mesh each argument of the group reads it (held against
    # the reference in tests/test_torch_tensor_parallel.py)
    mx.mod.Module(net, group2ctxs={"g0": PartitionSpec("model")})
    rng = np.random.RandomState(0)
    args = {n: rng.rand(*shape).astype(np.float32) for n, shape in zip(
        net.list_arguments(), net.infer_shape(data=(4, 8))[0])}
    exe = net.bind(make_mesh((2,), ("model",), ["cpu"] * 2), args=args,
                   group2ctx={"g1": (None, "model")})
    assert tuple(exe._sharding("fc2_weight").spec) == (None, "model")
    # over a mesh of one rank per process it is item A7(b)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method="file://" + str(tmp_path / "pg"))
    try:
        pg = make_mesh((1,), ("model",), process_group=True)
        with pytest.raises(NotImplementedError, match="A7\\(b\\)"):
            mx.mod.Module(net, context=pg,
                          group2ctxs={"g0": PartitionSpec("model")})
        with pytest.raises(NotImplementedError, match="A7\\(b\\)"):
            net.bind(pg, args=args, group2ctx={"g1": (None, "model")})
    finally:
        dist.destroy_process_group()
    # a replicated spec is a placement the port keeps
    mx.mod.Module(net, group2ctxs=[{"g0": PartitionSpec()}])
    from mxnet_tpu_torch.executor import _device_of
    assert _device_of([mx.cpu(0), mx.cpu(1)]) == torch.device("cpu")
    if torch.cuda.is_available():
        with pytest.raises(NotImplementedError, match="A6\\(c\\)"):
            _device_of([mx.cpu(), mx.gpu(0)])


@pytest.mark.cuda
def test_gpu_context_scopes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with mx.gpu(0):
        a = mx.nd.zeros((2,))
    with mx.cpu():
        b = mx.nd.zeros((2,))
    assert a.context == mx.gpu(0) and b.context == mx.cpu()
    free, total = mx.gpu_memory_info(0)
    tfree, ttotal = torch.cuda.mem_get_info(0)
    assert total == ttotal and 0 < free <= total
