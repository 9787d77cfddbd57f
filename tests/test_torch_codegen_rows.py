"""The row and flat plans of the mxgen emitter (B10's redesign for
Hopper), held on the CPU: which plan each chain gets, the row plan's
levels, phases, exchanges and shared memory, the emitted text
(deterministic, the mislowering seam, the ablation cuts), a CPU emulation
of the row plan's schedule against the twin and the reference's outputs,
and the flat plan's indexing (every element exactly once, whole 16-byte
runs, the tail masked) emulated the same way.

The emulation (:func:`emulate`) runs the plan phase by phase: row-local
eqns over all rows at once (elementwise, so the grouping of rows does not
change a bit), reductions along a row as the kernel's shuffle tree (each
lane's columns in order, then ``__shfl_xor_sync`` over 16, 8, 4, 2, 1),
and each reduction across rows as the kernel's exchange — per warp over
its rows in order, per CTA over its warps in order, over the cluster in
rank order.  A value summed across rows can be read only after the
exchange at the end of its phase: reading it earlier raises.  The group
plan's chains (``_gen_zero1_top2``) are emulated group by group, each
reduction a serial loop in the emitted order.  The emitted CUDA itself
runs only on the card (``chip_smoke.py`` phase 15).
"""
import itertools

import numpy as np
import pytest
import torch

import test_torch_codegen as tc
from test_torch_codegen import export_dir, ref  # noqa: F401 (fixtures)
from mxnet_tpu_torch.analysis import codegen as cg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import codegen_ablate

ROWS = {"_gen_tp_transformer_top1": ((4, 32), 32),
        "_gen_tp_transformer_top2": ((4, 32), 32),
        "_gen_tp_transformer_top3": ((4, 32), 32),
        "_gen_zero1_top1": ((64,), 512), "_gen_zero1_top3": ((64,), 128)}
FLAT = ["_gen_zero1_top2"]
SMEM_48K = 48 * 1024


def _chain(name):
    return {c.name: c for c in cg.load_ir()}[name]


def _inputs(lk):
    return [torch.from_numpy(x) for x in
            cg.seeded_inputs(lk.in_avals, cg.EQUIV_SEED)]


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------
def _stepper(prim):
    return {"reduce_sum": torch.add, "reduce_prod": torch.mul,
            "reduce_max": torch.maximum, "reduce_min": torch.minimum,
            "reduce_and": torch.logical_and,
            "reduce_or": torch.logical_or}[prim]


def _init(prim, dtype, shape):
    if prim in ("reduce_and", "reduce_or"):
        return torch.full(shape, prim == "reduce_and", dtype=torch.bool)
    if prim in ("reduce_sum", "reduce_prod"):
        return torch.full(shape, int(prim == "reduce_prod"), dtype=dtype)
    big = float("inf") if dtype.is_floating_point else \
        torch.iinfo(dtype).max
    return torch.full(shape, -big if prim == "reduce_max" else big,
                      dtype=dtype)


def _tree(x, prim, cols):
    """The kernel's reduction along a row: ``x`` (rows, cols); lane l
    sums columns l, l + 32, ... in order, then the xor tree."""
    step = _stepper(prim)
    lanes = []
    for lane in range(32):
        acc = _init(prim, x.dtype, x.shape[:1])
        for col in range(lane, cols, 32):
            acc = step(acc, x[:, col])
        lanes.append(acc)
    for m in (16, 8, 4, 2, 1):
        lanes = [step(lanes[lane], lanes[lane ^ m]) for lane in range(32)]
    for lane in range(1, 32):     # every lane ends with the same value
        assert torch.equal(lanes[lane], lanes[0]) or prim in (
            "reduce_max", "reduce_min")
    return lanes[0]


def _exchange(pl, v, y):
    """The reduction across rows of per-row parts ``y`` (rows, C'): per
    warp over its rows, per CTA over its warps, over the ranks."""
    op, kept, cp = pl.reduced[v]
    step = _stepper(op.prim)
    partials = []
    for rank in range(pl.cluster):
        lo = rank * pl.rows_per_cta
        hi = min(lo + pl.rows_per_cta, pl.n_rows)
        warps = []
        for w in range(pl.warps):
            acc = _init(op.prim, y.dtype, (cp,))
            for k in range(pl.rows_per_warp):
                r = lo + w + k * pl.warps
                if r < hi:
                    acc = step(acc, y[r])
            warps.append(acc)
        pc = _init(op.prim, y.dtype, (kept, cp))
        for kr in range(kept):
            acc = _init(op.prim, y.dtype, (cp,))
            for w in range(pl.warps):
                if kept == 1 or (lo + w) % kept == kr:
                    acc = step(acc, warps[w])
            pc[kr] = acc
        partials.append(pc)
    out = partials[0]
    for pc in partials[1:]:
        out = step(out, pc)
    return out


class _Env(dict):
    """Values by id; a reduction across rows is readable only once its
    exchange has run (``ready``)."""

    def __init__(self, lk, inputs):
        super().__init__(zip(lk.chain.ext_in, inputs))
        self.lk, self.ready = lk, set()

    def read(self, i):
        c, pl = self.lk.chain, self.lk.layout
        if i in c.literals:
            return torch.as_tensor(c.literals[i])
        if i in getattr(pl, "reduced", {}) and i not in self.ready:
            raise AssertionError("value %d read before its exchange" % i)
        if i not in self and pl.name == "rows" and pl.cls.get(i) == "cross":
            op = pl.made[i]            # cross values: computed where read
            self[i] = cg._prim_eval(op.prim, self.operands(op), op.params)
        return self[i]

    def operands(self, op):
        return cg._coerce_literals(self.lk.chain, op,
                                   [self.read(i) for i in op.ins])


def emulate_rows(lk, inputs):
    """The row plan's schedule on the CPU; returns the external outputs."""
    c, pl = lk.chain, lk.layout
    env = _Env(lk, inputs)
    rows, cols = pl.n_rows, pl.cols
    nr = len(pl.row_shape)
    for p in range(pl.n_phases):
        parts = {}
        for op in c.ops:
            out = op.outs[0]
            if pl.phase.get(out) != p:
                continue
            x = op.ins[0]
            if out in pl.reduced:
                xv = env.read(x)
                if pl.cls[x] == "full" and pl.reduced[out][2] == 1:
                    y = _tree(xv.reshape(rows, cols), op.prim, cols)
                else:
                    y = xv.reshape(rows, -1)
                parts[out] = y.reshape(rows, -1)
            elif op.prim in cg._REDUCES and op.params.get("axes"):
                assert tuple(op.params["axes"]) == (nr,)
                xv = env.read(x)
                y = _tree(xv.reshape(rows, cols), op.prim, cols) \
                    if pl.cls[x] == "full" else xv.reshape(rows)
                env[out] = y.reshape(c.avals[out].shape)
            else:
                env[out] = cg._prim_eval(op.prim, env.operands(op),
                                         op.params)
        for v, y in parts.items():
            env[v] = _exchange(pl, v, y).reshape(c.avals[v].shape)
            env.ready.add(v)
    return [env.read(i) for i in c.ext_out]


def emulate_groups(lk, inputs):
    """The group plan's schedule: groups in order, each reduction a
    serial loop over its axes in the emitted order."""
    c, pl = lk.chain, lk.layout
    env = _Env(lk, inputs)
    done = set(c.ext_in)
    for g, (_, ops) in enumerate(pl.groups):
        for op in ops:
            assert all(i in done or i in c.literals for i in op.ins)
            if op.prim in cg._REDUCES and op.params.get("axes"):
                x = env.read(op.ins[0])
                axes = sorted(op.params["axes"])
                kept = [d for d in range(x.dim()) if d not in axes]
                xt = x.permute(kept + axes)
                acc = _init(op.prim, x.dtype, xt.shape[:len(kept)])
                for idx in itertools.product(*[range(x.shape[a])
                                               for a in axes]):
                    acc = _stepper(op.prim)(acc, xt[(Ellipsis,) + idx])
                env[op.outs[0]] = acc.reshape(c.avals[op.outs[0]].shape)
            else:
                env[op.outs[0]] = cg._prim_eval(op.prim, env.operands(op),
                                                op.params)
            done.add(op.outs[0])
    return [env.read(i) for i in c.ext_out]


def emulate(lk, inputs):
    return (emulate_rows if lk.plan == "rows" else emulate_groups)(
        lk, inputs)


# ---------------------------------------------------------------------------
# the plan each chain gets, and the row plan's shape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", tc.SHIPPED_NAMES)
def test_each_shipped_chain_gets_its_plan(name):
    lk = tc._lowered(name)
    want = "flat" if name in FLAT else "rows"
    assert lk.plan == want and lk.as_plan()["plan"] == want
    assert ("// Plan: %s" % want) in lk.src
    if want == "rows":
        assert (lk.layout.row_shape, lk.layout.cols) == ROWS[name]
        assert lk.cluster == cg.ROW_CLUSTER[name]
        assert lk.as_plan()["cluster"] == lk.cluster
        assert "cudaLaunchAttributeClusterDimension" in lk.src
        assert lk.ws_bytes == 0 and "ws_g" in lk.src
    else:
        assert lk.cluster == 1 and "a 1-D chain has no row axes" in lk.src


def test_top1_has_three_levels_one_exchange_and_fits_48k():
    """B10.1: the dataflow crosses rows twice (3 levels: 35 eqns, then
    195, then the 8 sums across rows); only the sums across rows need a
    barrier, and nothing reads them inside the chain, so one exchange at
    the end (a CTA barrier and a cluster barrier, then the final one
    before exit); shared memory under the 48 KB that needs no opt-in at
    every cluster size."""
    lk = tc._lowered("_gen_tp_transformer_top1")
    pl = lk.layout
    assert pl.levels == 3
    assert pl.exchanges == 1 <= 2 and pl.n_phases == 1
    assert len(pl.reduced) == 8 and not pl.read_later
    for c in cg._ROW_CLUSTERS:
        other = cg.lower_chain(lk.chain, cluster=c).layout
        assert other.smem_bytes <= SMEM_48K, (c, other.smem_bytes)
        assert other.levels == 3 and other.exchanges == 1
    assert lk.src.count("cluster.sync()") == 2
    assert "cudaFuncSetAttribute" not in lk.src
    assert "unsigned char* const ws" not in lk.src


def test_level_counts_of_top1():
    """The rule: an edge costs a level where it crosses rows — a
    reduction across rows, or a row-local eqn reading a cross-row value
    an eqn made."""
    pl = tc._lowered("_gen_tp_transformer_top1").layout
    lvl, lits = {}, pl.chain.literals
    for op in pl.chain.ops:
        o = op.outs[0]
        lvl[o] = max([lvl.get(i, 0) + ((pl.cls[i] != "cross"
                                         and pl.cls[o] == "cross")
                                        or (pl.cls[i] == "cross"
                                            and i in pl.made
                                            and pl.cls[o] != "cross"))
                      for i in op.ins if i not in lits] or [0])
    counts = np.bincount(list(lvl.values()))
    assert counts.tolist() == [35, 195, 8]


@pytest.mark.parametrize("name", sorted(ROWS))
def test_every_cluster_size_fits_the_shipped_rows(name):
    lk = tc._lowered(name)
    for c in cg._ROW_CLUSTERS:
        assert lk.layout.fits(c) is None
        pl = cg.lower_chain(lk.chain, cluster=c).layout
        assert pl.cluster == c and pl.threads == 32 * pl.warps <= 1024
        assert pl.rows_per_cta * c >= pl.n_rows
        assert pl.warps * pl.rows_per_warp >= pl.rows_per_cta
        assert pl.cpl == -(-pl.cols // 32)


def test_plans_fall_back_by_shape_not_at_run_time():
    """The prim sweep's (33, 1, 7) value and a 1-D chain keep the group
    plan, with the reason in the text; forcing the row plan on them
    raises; a cluster size outside the portable ones is refused."""
    import chip_smoke
    sweep = cg.lower_chain(chip_smoke._sweep_ir())
    assert sweep.plan == "groups"
    assert "neither a row value nor a cross-row one" in sweep.src
    with pytest.raises(ValueError, match="does not fit the row plan"):
        cg.lower_chain(chip_smoke._sweep_ir(), plan="rows")
    with pytest.raises(ValueError, match="does not fit the row plan"):
        cg.lower_chain(_chain("_gen_zero1_top2"), plan="rows")
    with pytest.raises(ValueError, match="does not fit the row plan"):
        cg.lower_chain(_chain("_gen_zero1_top1"), cluster=16)
    with pytest.raises(ValueError, match="plan"):
        cg.lower_chain(_chain("_gen_zero1_top1"), plan="tiles")


# ---------------------------------------------------------------------------
# the emitted text
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cluster", cg._ROW_CLUSTERS)
def test_row_text_is_deterministic_at_every_cluster(cluster):
    for name in ROWS:
        a = cg.lower_chain(_chain(name), cluster=cluster).src
        b = cg.lower_chain(cg.Chain.from_json(_chain(name)),
                           cluster=cluster).src
        assert a == b
        assert "cluster of %d CTA(s)" % cluster in a
        assert "attr[0].val.clusterDim.x = %d;" % cluster in a
        assert ("map_shared_rank" in a) == (cluster > 1)


@pytest.mark.parametrize("cluster", cg._ROW_CLUSTERS)
def test_seam_changes_exactly_the_chains_with_a_sub(cluster, monkeypatch):
    for name in ROWS:
        chain = _chain(name)
        exact = cg.lower_chain(chain, cluster=cluster).src
        monkeypatch.setattr(cg, "MXGEN_LOWER_EXACT", False)
        mutated = cg.lower_chain(chain, cluster=cluster).src
        monkeypatch.setattr(cg, "MXGEN_LOWER_EXACT", True)
        assert (mutated != exact) == ("sub" in chain.prims), name
        assert "__fsub_rn" not in mutated
        assert mutated.count("__fadd_rn") == exact.count("__fadd_rn") \
            + exact.count("__fsub_rn")


def test_division_by_a_power_of_two_is_a_multiply():
    """``x / 32`` and ``x * 2^-5`` round the same real number: the
    emitter writes the multiply (20 of B10.1's 25 divisions)."""
    src = tc._lowered("_gen_tp_transformer_top1").src
    assert src.count("__uint_as_float(0x3d000000u)") == 20   # 1 / 32
    assert "__uint_as_float(0x42000000u)" not in src          # 32
    chain = cg.Chain.from_json(_chain("_gen_zero1_top2"))
    div = next(op for op in chain.ops if op.prim == "div")
    assert cg._pow2_reciprocal(chain, div.ins[1]) == np.float32(0.125)
    x = torch.from_numpy(np.concatenate([
        np.random.RandomState(1).standard_normal(4096).astype(np.float32)
        * s for s in (1.0, 1e-37, 1e37)]))
    for d in (32.0, 0.125, -2.0):
        q = torch.div(x, d)
        m = torch.mul(x, torch.tensor(1.0, dtype=torch.float32) / d)
        assert torch.equal(q.view(torch.int32), m.view(torch.int32))


@pytest.mark.parametrize("variant", sorted(codegen_ablate.CUTS))
def test_ablation_cuts_take_their_part_out(variant):
    chain = _chain("_gen_tp_transformer_top1")
    full = cg.lower_chain(chain).src
    cut = codegen_ablate.variants(chain)[variant].src
    assert cut != full and "Ablation" in cut
    parts = codegen_ablate.CUTS[variant]
    assert ("map_shared_rank" in cut) == ("exchange" not in parts)
    assert ("__shfl_xor_sync" in cut) == ("shuffles" not in parts)
    assert ("in14[row * 32 + col]" in cut) == ("loads" not in parts)


def test_ablation_variants_and_the_card():
    vs = codegen_ablate.variants(_chain("_gen_tp_transformer_top1"))
    assert sorted(vs) == sorted(["groups", "rows_c1", "rows_c2", "rows_c4",
                                 "rows_c8"] + list(codegen_ablate.CUTS))
    assert len({v.symbol for v in vs.values()}) == len(vs)
    assert vs["groups"].plan == "groups"
    flat = codegen_ablate.variants(_chain("_gen_zero1_top2"))
    assert sorted(flat) == sorted(["groups"] + [
        "flat_t%d_e%d" % te for te in cg._FLAT_SIZES])
    assert {v.plan for k, v in flat.items() if k != "groups"} == {"flat"}
    import chip_smoke
    with pytest.raises(MXNetError, match="group plan|groups"):
        codegen_ablate.variants(cg.Chain.from_json(chip_smoke._sweep_ir()))
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            codegen_ablate.main([])


# ---------------------------------------------------------------------------
# the schedule, emulated
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", tc.SHIPPED_NAMES)
def test_emulated_schedule_matches_twin_and_reference(ref, name):  # noqa: F811
    lk = tc._lowered(name)
    xs = _inputs(lk)
    got = emulate(lk, xs)
    ok, err = cg.compare_outputs(got, cg.reference_outputs(lk, xs))
    assert ok, (name, err)
    tc._assert_matches(got, tc._outputs(ref, name, "ref"), (name, "ref"))
    tc._assert_matches(got, tc._outputs(ref, name, "whole"),
                       (name, "pallas"))


@pytest.mark.parametrize("cluster", cg._ROW_CLUSTERS)
@pytest.mark.parametrize("name", sorted(ROWS))
def test_emulated_schedule_at_every_cluster_size(name, cluster):
    lk = cg.lower_chain(_chain(name), cluster=cluster)
    xs = _inputs(lk)
    ok, err = cg.compare_outputs(emulate(lk, xs),
                                 cg.reference_outputs(lk, xs))
    assert ok, (name, cluster, err)


@pytest.mark.parametrize("cluster", cg._ROW_CLUSTERS)
def test_the_row_sweep_takes_two_phases_and_matches(cluster):
    """chip_smoke.py's row sweep: a column mean read back by every row
    (so a second phase), sums across rows in both phases (two
    exchanges), every reduction across rows, 40 columns (a ragged second
    lane group), and at cluster 8 CTAs that own no row."""
    import chip_smoke
    lk = cg.lower_chain(chip_smoke._rows_sweep_ir(), cluster=cluster)
    pl = lk.layout
    assert lk.plan == "rows" and (pl.row_shape, pl.cols) == ((3, 4), 40)
    assert pl.cpl == 2 and "if (col < 40)" in lk.src
    assert pl.n_phases == 2 and pl.exchanges == 2 and pl.levels == 4
    assert len(pl.read_later) == 2 and "rf" in lk.src
    # every lane reaches every shuffle: none sits behind a bool's || / &&
    shuffles = [ln.strip() for ln in lk.src.splitlines()
                if "__shfl_xor_sync" in ln]
    assert len(shuffles) == 5 * 3
    assert all(ln.startswith("{ const ") and "o = " in ln.split(";")[0]
               for ln in shuffles), shuffles
    xs = _inputs(lk)
    ok, err = cg.compare_outputs(emulate(lk, xs),
                                 cg.reference_outputs(lk, xs))
    assert ok, err
    # the schedule is what makes the read legal: move the row eqn that
    # reads the column mean into phase 0 and the emulation refuses
    reader = next(op.outs[0] for op in lk.chain.ops if op.prim == "sub")
    pl.phase[reader] = 0
    with pytest.raises(AssertionError, match="before its exchange"):
        emulate(lk, xs)


# ---------------------------------------------------------------------------
# the flat plan
# ---------------------------------------------------------------------------
def _flat_ir(n, dtype="float32"):
    """A 1-D pointwise chain over ``n`` elements: ``a = x * 2``, ``b = a +
    y`` (bool: ``b = x > y``), both outputs, and a single-element input."""
    avals = {"0": [[n], dtype], "1": [[n], dtype], "2": [[], "float32"],
             "3": [[n], dtype], "4": [[1], dtype], "5": [[n], dtype]}
    ops = [{"prim": "mul", "in": [0, 2], "out": [3]},
           {"prim": "add", "in": [3, 4], "out": [5]}]
    if dtype == "bool":
        avals.update({"3": [[n], "float32"], "0": [[n], "float32"],
                      "4": [[1], "float32"], "5": [[n], "bool"],
                      "1": [[n], "float32"]})
        ops[1] = {"prim": "gt", "in": [3, 4], "out": [5]}
    return tc._ir(ops, avals, [0, 1, 4], [3, 5],
                  {"2": {"dtype": "float32", "shape": [],
                         "values": ["0x40000000"]}})


def flat_runs(lk, vec):
    """The flat kernel's indexing, thread by thread: ``(elements, whole
    16-byte run)`` of every thread that computes anything (``vec``: what
    the launcher passes when every operand is 16-byte aligned)."""
    pl = lk.layout
    for b in range(pl.grid):
        for t in range(pl.threads):
            first = (b * pl.threads + t) * pl.per_thread
            if first >= pl.n:
                continue
            if vec and pl.vector and first + pl.per_thread <= pl.n:
                yield list(range(first, first + pl.per_thread)), True
            else:
                yield [o for o in range(first, first + pl.per_thread)
                       if o < pl.n], False


def emulate_flat(lk, inputs, vec=True):
    """The flat kernel on the CPU: the twin's per-element arithmetic on
    each thread's elements, in thread order; every element exactly once."""
    c, pl = lk.chain, lk.layout
    order = [o for run, _ in flat_runs(lk, vec) for o in run]
    assert sorted(order) == list(range(pl.n)), "not every element once"
    idx = torch.tensor(order, dtype=torch.long)
    gathered = [x.reshape(-1)[idx] if c.avals[i].shape ==
                c.avals[c.ext_out[0]].shape else x
                for i, x in zip(c.ext_in, inputs)]
    outs = []
    for o in cg.reference_outputs(lk, gathered):
        y = torch.empty_like(o.reshape(-1))
        y[idx] = o.reshape(-1)
        outs.append(y.reshape(o.shape))
    return outs


def test_b10_5_takes_the_flat_plan_at_the_pinned_size():
    lk = tc._lowered("_gen_zero1_top2")
    pl = lk.layout
    assert (lk.plan, lk.cluster, lk.ws_bytes) == ("flat", 1, 0)
    assert (pl.threads, pl.per_thread) == (cg.FLAT_THREADS,
                                           cg.FLAT_PER_THREAD)
    assert (cg.FLAT_THREADS, cg.FLAT_PER_THREAD) in cg._FLAT_SIZES
    assert pl.n == 9458 and pl.vector and len(pl.groups) == 1
    span = pl.threads * pl.per_thread
    assert pl.grid == -(-9458 // span)
    assert "// Plan: flat (no row plan: a 1-D chain has no row axes)" \
        in lk.src
    assert "<<<%d, %d, 0, (cudaStream_t)stream>>>" % (pl.grid, pl.threads) \
        in lk.src
    assert "__syncthreads" not in lk.src and "ws_g)" not in lk.src
    assert lk.tileable and "%s_tiled(" % lk.symbol in lk.src


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 4097, 9458])
def test_flat_indexing_covers_each_element_once(n):
    lk = cg.lower_chain(_flat_ir(n))
    pl = lk.layout
    assert lk.plan == "flat" and pl.n == n
    e = pl.per_thread
    # the emulation reads the launch and the index from the text
    assert "<<<%d, %d, 0," % (pl.grid, pl.threads) in lk.src
    assert "const int first = (blockIdx.x * %d + threadIdx.x) * %d;" \
        % (pl.threads, e) in lk.src
    assert "if (vec && first + %d <= %d) {" % (e, n) in lk.src
    assert "o < first + %d && o < %d; ++o" % (e, n) in lk.src
    for vec in (True, False):
        runs = list(flat_runs(lk, vec))
        order = [o for run, _ in runs for o in run]
        assert sorted(order) == list(range(n)), (n, vec)
        whole = [run for run, w in runs if w]
        assert all(len(r) == e and r[0] % e == 0 for r in whole)
        assert len(whole) == (n // e if vec else 0)
        # only the last thread holds a tail
        assert all(len(r) == e for r, w in runs[:-1]) or not vec
    xs = _inputs(lk)
    for vec in (True, False):
        got = emulate_flat(lk, xs, vec)
        want = cg.reference_outputs(lk, xs)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("size", cg._FLAT_SIZES)
def test_flat_text_is_deterministic_at_every_size(size):
    chain = _chain("_gen_zero1_top2")
    a = cg.lower_chain(chain, flat=size)
    b = cg.lower_chain(cg.Chain.from_json(chain), flat=size)
    assert a.src == b.src and a.plan == "flat"
    assert (a.layout.threads, a.layout.per_thread) == size
    assert "__launch_bounds__(%d)" % size[0] in a.src
    if size == (cg.FLAT_THREADS, cg.FLAT_PER_THREAD):
        assert a.src == tc._lowered("_gen_zero1_top2").src


def test_groups_forced_keeps_the_group_plan():
    chain = _chain("_gen_zero1_top2")
    lk = cg.lower_chain(chain, plan="groups")
    assert lk.plan == "groups" and lk.threads == 1024
    assert "// Plan: groups.  One block, 1024 threads" in lk.src
    assert "<<<1, 1024, 0, (cudaStream_t)stream>>>" in lk.src
    flat = tc._lowered("_gen_zero1_top2")
    # one per-element body: the group plan's loop body appears verbatim
    # in the flat kernel's element-by-element path
    body = lk.src.split("o += 1024) {\n")[1].split("  }\n}")[0]
    assert body in flat.src
    with pytest.raises(ValueError, match="flat"):
        cg.lower_chain(chain, plan="groups", flat=(256, 4))
    with pytest.raises(ValueError, match="multiple of"):
        cg.lower_chain(chain, flat=(100, 4))


def test_flat_outputs_match_twin_and_reference(ref):  # noqa: F811
    lk = tc._lowered("_gen_zero1_top2")
    xs = _inputs(lk)
    got = emulate_flat(lk, xs)
    ok, err = cg.compare_outputs(got, cg.reference_outputs(lk, xs))
    assert ok and err == 0.0, err
    tc._assert_matches(got, tc._outputs(ref, lk.name, "ref"),
                       (lk.name, "ref"))
    tc._assert_matches(got, tc._outputs(ref, lk.name, "whole"),
                       (lk.name, "pallas"))


def test_multi_group_or_reducing_chains_never_take_the_flat_plan():
    import chip_smoke
    sweep = cg.lower_chain(chip_smoke._sweep_ir())
    assert sweep.plan == "groups" and len(sweep.layout.groups) > 1
    n = 64
    reducing = tc._ir(
        [{"prim": "mul", "in": [0, 0], "out": [1]},
         {"prim": "reduce_sum", "in": [1], "out": [2],
          "params": {"axes": [0]}}],
        {"0": [[n], "float32"], "1": [[n], "float32"],
         "2": [[], "float32"]}, [0], [1, 2])
    one_group_reduce = tc._ir(
        [{"prim": "reduce_sum", "in": [0], "out": [1],
          "params": {"axes": [0]}}],
        {"0": [[n], "float32"], "1": [[], "float32"]}, [0], [1])
    broadcast = tc._ir(
        [{"prim": "broadcast_in_dim", "in": [0], "out": [1],
          "params": {"shape": [n], "broadcast_dimensions": []}},
         {"prim": "add", "in": [1, 2], "out": [3]}],
        {"0": [[], "float32"], "1": [[n], "float32"],
         "2": [[n], "float32"], "3": [[n], "float32"]}, [0, 2], [3])
    for ir in (chip_smoke._sweep_ir(), reducing, one_group_reduce,
               broadcast):
        lk = cg.lower_chain(ir)
        assert lk.src is not None and lk.plan == "groups", lk.findings
        assert "// Plan: groups" in lk.src
        with pytest.raises(ValueError, match="does not fit the flat plan"):
            cg.lower_chain(ir, flat=(cg.FLAT_THREADS, cg.FLAT_PER_THREAD))


def test_a_bool_chain_runs_the_flat_plan_element_by_element():
    lk = cg.lower_chain(_flat_ir(1000, "bool"))
    assert lk.plan == "flat" and not lk.layout.vector
    assert "element by element" in lk.src and "vec &&" not in lk.src
    assert "const int vec = 0;" in lk.src
    xs = _inputs(lk)
    got = emulate_flat(lk, xs, vec=True)
    assert all(torch.equal(g, w) for g, w in
               zip(got, cg.reference_outputs(lk, xs)))
