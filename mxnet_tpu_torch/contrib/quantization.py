"""Model quantization driver: the port of
``mxnet_tpu/contrib/quantization.py`` (reference: python/mxnet/contrib/
quantization.py — the quantize_model calibration flow over the int8 ops).

Everything here is numpy and the graph walker, as in the reference:
``fold_batch_norms``, the three rewrites (``_rewrite_int8``,
``_elide_dq_q``, ``_fuse_conv_requant``), ``calib_graph``, the naive
(min/max) and entropy (KL) calibrations and ``optimal_threshold``.  The
calibration forward runs where the parameters live (``ctx`` overrides);
arrays the passes create stay on their source's device.
``MXTPU_FUSE_QCONV=1`` turns the conv-requant fusion on, as in the
reference (default off).
"""
from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from .. import symbol as sym

__all__ = ["quantize_model", "calib_graph", "optimal_threshold"]


# -- entropy (KL) calibration --------------------------------------------
# Reference: python/mxnet/contrib/quantization.py:253 _get_optimal_threshold
# — the TensorRT-style histogram/KL-divergence threshold search.  Naive
# min/max calibration lets one outlier blow up the scale; the entropy mode
# picks the clip threshold whose 255-level quantized distribution is
# closest (in KL divergence) to the clipped fp32 distribution.

_NUM_HIST_BINS = 8001
_NUM_QUANT_BINS = 255


def _smoothed_kl(p, q):
    """KL(p || q) with the zero-bin smoothing the calibration literature
    uses: mass from q's empty bins that are non-empty in p is redistributed
    so the divergence stays finite."""
    p = p.astype(np.float64)
    q = q.astype(np.float64)
    eps = 1e-4
    p_nz = p > 0
    q_z = (q == 0) & p_nz
    # move eps into q's problem bins, taking it from its non-empty ones
    if q_z.any():
        take = eps * q_z.sum() / max(1, (q > 0).sum())
        q = np.where(q_z, eps, np.where(q > 0, q - take, 0.0))
    ps = p[p_nz] / p.sum()
    qs = q[p_nz] / q.sum()
    return float(np.sum(ps * np.log(ps / np.maximum(qs, 1e-12))))


def optimal_threshold(hist, hist_edges,
                      num_quantized_bins=_NUM_QUANT_BINS):
    """Pick the |threshold| minimizing KL(clipped fp32 dist || int8 dist).

    ``hist`` is a symmetric histogram over ``[-amax, amax]``.  For every
    candidate half-width ``i`` the central ``2i+1`` bins are kept (outlier
    mass folded into the edge bins), down-quantized to
    ``num_quantized_bins`` levels, expanded back, and scored by KL
    divergence (reference: _get_optimal_threshold:253)."""
    hist = np.asarray(hist, np.float64).copy()
    num_bins = hist.size
    zero = num_bins // 2
    # exclude the zero bin: zero is exactly representable at any threshold,
    # and after relu its spike would dominate the distributions, washing
    # out the clipping cost of every candidate (TensorRT's calibration
    # skips bin 0 for the same reason)
    hist[zero] = 0.0
    # start at num_quantized_bins//2 like the reference
    # (_get_optimal_threshold:253) so the tightest candidate is considered
    half_start = num_quantized_bins // 2
    best = (np.inf, float(hist_edges[-1]))
    for i in range(half_start, zero + 1):
        lo, hi = zero - i, zero + i + 1
        sliced = hist[lo:hi]
        # p: the clipped reference distribution — outlier mass folded into
        # the boundary bins
        p = sliced.copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        if p.sum() == 0:
            continue
        # q: the int8 rendition, built from the *unfolded* slice — the
        # folded outlier mass present in p but absent from q is exactly
        # the clipping cost KL charges this candidate with
        n = p.size
        idx = (np.arange(n) * num_quantized_bins // n)
        q_groups = np.bincount(idx, weights=sliced,
                               minlength=num_quantized_bins)
        # each group's mass spread uniformly over its non-empty source bins
        nonzero = np.bincount(idx, weights=(p > 0).astype(np.float64),
                              minlength=num_quantized_bins)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_bin = np.where(nonzero > 0, q_groups / nonzero, 0.0)
        q = np.where(p > 0, per_bin[idx], 0.0)
        kl = _smoothed_kl(p, q)
        if kl < best[0]:
            th = float(max(abs(hist_edges[lo]), abs(hist_edges[hi])))
            best = (kl, th)
    return best[1]


def _calib_module(symbol, outputs, arg_params, aux_params, calib_data,
                  data_names, ctx):
    """An inference Module over the internal outputs ``outputs`` of
    ``symbol``, bound on ``ctx`` with the given parameters."""
    from ..module.module import Module
    internals = symbol.get_internals()
    index = {o: i for i, o in enumerate(internals.list_outputs())}
    group = sym.Group([internals[index[o]] for o in outputs])
    mod = Module(group, data_names=data_names, label_names=None,
                 context=ctx)
    mod.bind(calib_data.provide_data, for_training=False)
    mod.set_params(arg_params, aux_params, allow_missing=True,
                   allow_extra=True)
    return mod


def _collect_layer_histograms(symbol, arg_params, aux_params, calib_data,
                              num_calib_examples, data_names, stats, ctx):
    """Second calibration pass: per-layer histograms over the naive
    [-amax, amax] range (reference: _LayerHistogramCollector)."""
    outputs = list(stats.keys())
    mod = _calib_module(symbol, outputs, arg_params, aux_params, calib_data,
                        data_names, ctx)
    hists = {}
    edges = {}
    for name in outputs:
        lo, hi = stats[name]
        amax = max(abs(lo), abs(hi)) or 1.0
        hists[name] = np.zeros(_NUM_HIST_BINS, np.float64)
        edges[name] = np.linspace(-amax, amax, _NUM_HIST_BINS + 1)
    seen = 0
    calib_data.reset()
    for batch in calib_data:
        mod.forward(batch, is_train=False)
        for name, out in zip(outputs, mod.get_outputs()):
            a = out.asnumpy().ravel()
            h, _ = np.histogram(a, bins=edges[name])
            hists[name] += h
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    return hists, edges


def _collect_layer_stats(symbol, arg_params, aux_params, calib_data,
                         num_calib_examples, data_names, label_names, ctx):
    """Run calibration batches through the fp32 graph collecting per-output
    min/max (reference: _collect_layer_output_min_max); the extremes are
    taken on the device and read back together, once per batch."""
    import torch
    outputs = [o for o in symbol.get_internals().list_outputs()
               if o.endswith("_output") or o in data_names]
    mod = _calib_module(symbol, outputs, arg_params, aux_params, calib_data,
                        data_names, ctx)
    stats = {o: (np.inf, -np.inf) for o in outputs}
    seen = 0
    calib_data.reset()
    for batch in calib_data:
        mod.forward(batch, is_train=False)
        outs = [o._data for o in mod.get_outputs()]
        los = torch.stack([o.min().float() for o in outs]).tolist()
        his = torch.stack([o.max().float() for o in outs]).tolist()
        for name, a_lo, a_hi in zip(outputs, los, his):
            lo, hi = stats[name]
            stats[name] = (min(lo, a_lo), max(hi, a_hi))
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    return stats


def _entry_range_key(entry):
    node, _ = entry
    return node.name if node.op is None else node.name + "_output"


def _graph_rewrite(symbol, hook):
    """Memoized clone of a symbol graph with a per-node rewrite hook — the
    single walker behind every quantization pass (each used to hand-roll
    its own memo/clone recursion).

    ``hook(node, new, clone)`` runs after ``new`` (a fresh ``_Node`` with
    cloned inputs) is built; ``clone`` maps original nodes to their copies
    (memoized).  A non-None return replaces ``new`` in the memo so every
    downstream consumer rewires to it."""
    from ..symbol.symbol import Symbol, _Node

    memo = {}

    def clone(node):
        if id(node) in memo:
            return memo[id(node)]
        new = _Node(node.op, node.name, dict(node.attrs), [], node._is_aux)
        memo[id(node)] = new  # register before recursing into inputs
        new.inputs = [(clone(c), i) for c, i in node.inputs]
        repl = hook(node, new, clone)
        if repl is not None and repl is not new:
            memo[id(node)] = repl
            return repl
        return new

    return Symbol([(clone(n), i) for n, i in symbol._outputs])


def _consumer_sets(symbol, with_indices=False):
    """{id(node): set of distinct consumers} with ``"head"`` marking graph
    outputs.  A multi-output producer feeding one consumer through several
    edges still counts as a single consumer.  With ``with_indices`` also
    returns {id(node): set of output indices read by any consumer} so
    rewrites can tell a data-output edge from a stats-output edge."""
    consumers = {}
    out_idx = {}
    seen = set()

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for child, i in node.inputs:
            consumers.setdefault(id(child), set()).add(id(node))
            out_idx.setdefault(id(child), set()).add(i)
            walk(child)

    for n, i in symbol._outputs:
        consumers.setdefault(id(n), set()).add("head")
        out_idx.setdefault(id(n), set()).add(i)
        walk(n)
    return (consumers, out_idx) if with_indices else consumers


def fold_batch_norms(symbol, arg_params, aux_params):
    """Fold Convolution→BatchNorm chains into the conv weights/bias — the
    standard inference-graph transform (the reference's MKLDNN subgraph
    fuse pass does the same ahead of int8 rewriting).  Inference only:
    uses the moving statistics.

    Returns (new_symbol, new_arg_params, new_aux_params)."""
    from ..symbol.symbol import _Node

    arg_params = dict(arg_params)
    aux_params = dict(aux_params)
    consumers, out_idx = _consumer_sets(symbol, with_indices=True)

    def hook(node, new, clone):
        if node.op != "BatchNorm" or not node.inputs:
            return None
        src, _src_out = node.inputs[0]
        if src.op != "Convolution" or \
                len(consumers.get(id(src), ())) != 1:
            return None
        # a consumer wired to BN output 1/2 (mean/var) would be silently
        # rewired to a nonexistent conv output — only fold data-only BNs
        if out_idx.get(id(node), {0}) != {0}:
            return None
        # the BN must normalize the conv's channel axis: channels-last
        # convs carry channels on the minor axis, channels-first on axis 1
        bn_axis = int(_reg_canon(node.attrs.get("axis", 1)))
        kernel = src.attrs.get("kernel")
        nsp = len(_attr_tuple(kernel)) if kernel else 2
        ch_axis = nsp + 1 if src.attrs.get("layout") in (
            "NWC", "NHWC", "NDHWC") else 1
        if bn_axis != ch_axis:
            return None
        wname = src.name + "_weight"
        gname, bname = node.name + "_gamma", node.name + "_beta"
        mname, vname = node.name + "_moving_mean", node.name + "_moving_var"
        if wname not in arg_params or mname not in aux_params:
            return None
        eps = float(_reg_canon(node.attrs.get("eps", 1e-3)))
        fix_gamma = _reg_canon(node.attrs.get("fix_gamma", True))
        mean = aux_params[mname].asnumpy()
        var = aux_params[vname].asnumpy()
        gamma = np.ones_like(mean) if fix_gamma else \
            arg_params[gname].asnumpy()
        beta = arg_params[bname].asnumpy() if bname in arg_params \
            else np.zeros_like(mean)
        scale = gamma / np.sqrt(var + eps)
        shift = beta - mean * scale
        w = arg_params[wname].asnumpy()
        dev = arg_params[wname].context
        # output channels are axis 0 in both OIHW and O*kernel*I layouts
        arg_params[wname] = nd.array(
            w * scale.reshape((-1,) + (1,) * (w.ndim - 1)), ctx=dev)
        cbias = src.name + "_bias"
        had_bias = not _reg_canon(src.attrs.get("no_bias", False))
        if had_bias and cbias in arg_params:
            shift = arg_params[cbias].asnumpy() * scale + shift
        arg_params[cbias] = nd.array(shift, ctx=dev)
        folded = clone(src)
        conv = _Node(src.op, src.name, dict(src.attrs), list(folded.inputs))
        conv.attrs["no_bias"] = False
        if not had_bias:
            bvar = _Node(None, cbias, {"__shape__": str(shift.shape),
                                       "__dtype__": "float32"})
            conv.inputs = conv.inputs[:2] + [(bvar, 0)]
        return conv

    out = _graph_rewrite(symbol, hook)
    # drop the folded BN params so set_params doesn't complain
    live = {n.name for n in out._nodes() if n.op is None}
    arg_params = {k: v for k, v in arg_params.items()
                  if k in live or not k.endswith(("_gamma", "_beta"))}
    aux_params = {k: v for k, v in aux_params.items() if k in live}
    return out, arg_params, aux_params


def _reg_canon(v):
    from ..ops.registry import canonicalize
    return canonicalize(v)


# attrs each quantized op inherits from its fp32 node
_QCONV_ATTRS = ("kernel", "stride", "dilate", "pad", "num_filter",
                "num_group", "layout")
_QPOOL_ATTRS = ("kernel", "pool_type", "global_pool", "pooling_convention",
                "stride", "pad", "count_include_pad", "layout")
_QUANTIZABLE = {"FullyConnected", "Convolution", "Pooling"}


def _rewrite_int8(symbol, arg_params, th_dict, excluded):
    """Replace calibrated FullyConnected/Convolution/Pooling nodes with
    quantize_v2 → quantized op → dequantize (+ fp32 bias) subgraphs — the
    quantize_graph_pass.cc analogue (reference also covers conv and
    pooling: quantized_conv.cu, quantized_pooling.cc).  Layers without a
    calibrated input range, or in `excluded`, stay fp32."""
    from ..symbol.symbol import _Node

    def hook(node, new, clone):
        if node.op not in _QUANTIZABLE or node.name in excluded:
            return None
        rng = th_dict.get(_entry_range_key(node.inputs[0]))
        if rng is None:
            return None
        lo, hi = rng
        data_entry = new.inputs[0]
        qdata = _Node("_contrib_quantize_v2", node.name + "_qdata",
                      {"out_type": "int8", "min_calib_range": lo,
                       "max_calib_range": hi}, [data_entry])

        if node.op == "Pooling":
            qpool = _Node("_contrib_quantized_pooling", node.name + "_int8",
                          {k: node.attrs[k] for k in _QPOOL_ATTRS
                           if k in node.attrs},
                          [(qdata, 0), (qdata, 1), (qdata, 2)])
            return _Node("_contrib_dequantize", node.name + "_deq", {},
                         [(qpool, 0), (qpool, 1), (qpool, 2)])

        wname = node.name + "_weight"
        if wname + "_quantized" not in arg_params:
            return None

        def qvar(suffix):
            full = wname + suffix
            arr = arg_params[full]
            return _Node(None, full,
                         {"__shape__": str(tuple(arr.shape)),
                          "__dtype__": str(np.dtype(arr.dtype).name)})

        wq = qvar("_quantized")
        wmn = qvar("_min")
        wmx = qvar("_max")
        has_bias = len(node.inputs) > 2
        if node.op == "FullyConnected":
            attrs = {"num_hidden": node.attrs.get("num_hidden"),
                     "no_bias": True,
                     "flatten": node.attrs.get("flatten", True)}
            qop_name = "_contrib_quantized_fully_connected"
        else:
            attrs = {k: node.attrs[k] for k in _QCONV_ATTRS
                     if k in node.attrs}
            attrs["no_bias"] = True
            qop_name = "_contrib_quantized_conv"
        qop = _Node(qop_name, node.name + "_int8", attrs,
                    [(qdata, 0), (wq, 0), (qdata, 1), (qdata, 2),
                     (wmn, 0), (wmx, 0)])
        deq = _Node("_contrib_dequantize", node.name + "_deq",
                    {}, [(qop, 0), (qop, 1), (qop, 2)])
        if not has_bias:
            return deq
        bias_entry = new.inputs[2]
        bname = node.name + "_bias"
        if bias_entry[0].op is None and bname in arg_params:
            # no fp32 node derives its shape anymore — pin it on the var
            bias_entry[0].attrs.setdefault(
                "__shape__", str(tuple(arg_params[bname].shape)))
        if node.op == "Convolution" and \
                node.attrs.get("layout") not in ("NWC", "NHWC", "NDHWC"):
            # bias broadcasts over channels: (C,) -> (1, C, 1, ...);
            # channels-last layouts broadcast on the minor axis natively
            nsp = len(_attr_tuple(node.attrs.get("kernel", (1, 1))))
            bshape = (1, -1) + (1,) * nsp
            bias_entry = (_Node("Reshape", node.name + "_bias_rs",
                                {"shape": str(bshape)}, [bias_entry]), 0)
        return _Node("broadcast_add", node.name + "_addbias", {},
                     [(deq, 0), bias_entry])

    return _graph_rewrite(symbol, hook)


def _attr_tuple(v):
    if isinstance(v, str):
        import ast
        return ast.literal_eval(v)
    return tuple(v) if not isinstance(v, int) else (v,)


def _elide_dq_q(symbol):
    """Fuse dequantize→quantize_v2 chains into requantize so adjacent int8
    layers hand tensors over without a round-trip through fp32
    (reference: quantize_graph_pass.cc requantize fusion)."""
    from ..symbol.symbol import _Node

    def hook(node, new, clone):
        if node.op != "_contrib_quantize_v2" or not node.inputs:
            return None
        src, _ = node.inputs[0]
        # only when the dequantize reads an int32 accumulator (conv/fc);
        # int8 producers (pooling) use a different scale domain
        acc_ok = src.inputs and src.inputs[0][0].op in (
            "_contrib_quantized_conv",
            "_contrib_quantized_fully_connected")
        if src.op != "_contrib_dequantize" or not acc_ok or \
                "min_calib_range" not in node.attrs:
            return None
        acc_entry = new.inputs[0][0].inputs  # dequantize's inputs
        return _Node("_contrib_requantize", node.name + "_rq",
                     {"min_calib_range": node.attrs["min_calib_range"],
                      "max_calib_range": node.attrs["max_calib_range"],
                      "out_type": node.attrs.get("out_type", "int8")},
                     list(acc_entry))

    return _graph_rewrite(symbol, hook)


def _amax_of(attrs):
    lo = float(_reg_canon(attrs["min_calib_range"]))
    hi = float(_reg_canon(attrs["max_calib_range"]))
    return max(abs(lo), abs(hi))


_CALIB_PRODUCERS = ("_contrib_quantize_v2", "_contrib_requantize",
                    "_contrib_quantized_conv_requant")


def _fuse_conv_requant(symbol, arg_params):
    """Fuse qconv → dequantize → [bias add] → [relu] → quantize chains into
    one ``_contrib_quantized_conv_requant`` node (reference:
    quantize_graph_pass.cc fusion; kernel: ops/pallas_kernels.py
    qmm_requant).  Only NHWC chains whose intermediates have exactly one
    consumer fuse; residual branches (dequantize feeding an fp32 add)
    stay unfused.  Opt-in via MXTPU_FUSE_QCONV=1, as in the reference."""
    from ..symbol.symbol import _Node

    consumers = _consumer_sets(symbol)

    def single(node):
        return len(consumers.get(id(node), ())) == 1

    def hook(node, new, clone):
        if node.op != "_contrib_quantize_v2" or \
                "min_calib_range" not in node.attrs or not node.inputs:
            return None
        # walk up: [relu] <- [bias add] <- dequantize <- qconv
        cur = node.inputs[0][0]
        relu = False
        bias_node = None
        if cur.op == "Activation" and single(cur) and \
                _reg_canon(cur.attrs.get("act_type")) == "relu":
            relu = True
            cur = cur.inputs[0][0]
        if cur.op == "broadcast_add" and single(cur) and \
                cur.inputs[1][0].op is None:
            bias_node = cur.inputs[1][0]
            cur = cur.inputs[0][0]
        if cur.op != "_contrib_dequantize" or not single(cur):
            return None
        qconv = cur.inputs[0][0]
        if qconv.op != "_contrib_quantized_conv" or not single(qconv):
            return None
        if qconv.attrs.get("layout") not in ("NWC", "NHWC", "NDHWC"):
            return None
        qdata = qconv.inputs[0][0]
        if qdata.op not in _CALIB_PRODUCERS or \
                "min_calib_range" not in qdata.attrs:
            return None
        wq = qconv.inputs[1][0]
        if wq.op is not None or not wq.name.endswith("_quantized"):
            return None
        base = wq.name[:-len("_quantized")]
        if base + "_min" not in arg_params:
            return None
        w_amax = max(abs(float(arg_params[base + "_min"].asnumpy()[0])),
                     abs(float(arg_params[base + "_max"].asnumpy()[0])))
        attrs = {k: qconv.attrs[k] for k in _QCONV_ATTRS
                 if k in qconv.attrs}
        attrs.update({
            "in_scale": _amax_of(qdata.attrs) / 127.0,
            "w_scale": w_amax / 127.0,
            "out_scale": _amax_of(node.attrs) / 127.0,
            "relu": relu,
            "min_calib_range": node.attrs["min_calib_range"],
            "max_calib_range": node.attrs["max_calib_range"],
        })
        inputs = [(clone(qdata), 0), (clone(wq), 0)]
        if bias_node is not None:
            inputs.append((clone(bias_node), 0))
        return _Node("_contrib_quantized_conv_requant",
                     node.name + "_fused", attrs, inputs)

    return _graph_rewrite(symbol, hook)


_rewrite_int8_fc = _rewrite_int8  # back-compat name


def calib_graph(qsym, th_dict):
    """Attach calibrated thresholds as node attrs
    (reference: quantize_graph_pass.cc calibration)."""
    for node, _ in qsym.get_internals()._outputs:
        key = node.name + "_output"
        if key in th_dict:
            lo, hi = th_dict[key]
            node.attrs["__min_calib_range__"] = str(lo)
            node.attrs["__max_calib_range__"] = str(hi)
    return qsym


def quantize_model(sym_in, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=None, calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", fold_bn=True, logger=logging):
    """Quantize weights to int8 and (optionally) calibrate activations
    (reference: contrib/quantization.py quantize_model).
    ``calib_mode``: "naive" (min/max) or "entropy" (KL-optimal thresholds,
    reference :253); ``fold_bn`` folds Convolution→BatchNorm chains into
    the conv weights first.  ``excluded_sym_names``: ops to keep on the
    float rail (nothing is excluded implicitly, as in the reference).
    The calibration forward runs on ``ctx``, by default the device of the
    parameters.

    Returns (symbol, qarg_params, aux_params): weights stored quantized as
    (int8 data, min, max) triples under their original names + suffixes."""
    excluded = set(excluded_sym_names or [])
    if ctx is None and arg_params:
        ctx = next(iter(arg_params.values())).context
    if fold_bn:
        sym_in, arg_params, aux_params = fold_batch_norms(
            sym_in, arg_params, aux_params)
    qarg_params = {}
    for name, arr in arg_params.items():
        layer = name[:-len("_weight")] if name.endswith("_weight") else name
        if name.endswith("weight") and layer not in excluded:
            q, mn, mx = nd.contrib.quantize_v2(arr, out_type=quantized_dtype)
            qarg_params[name + "_quantized"] = q
            qarg_params[name + "_min"] = mn
            qarg_params[name + "_max"] = mx
            # keep the fp32 copy too: ops without int8 kernels fall back
            qarg_params[name] = arr
        else:
            qarg_params[name] = arr

    th_dict = {}
    if calib_mode != "none" and calib_data is not None:
        th_dict = _collect_layer_stats(sym_in, arg_params, aux_params,
                                       calib_data, num_calib_examples,
                                       list(data_names), list(label_names),
                                       ctx)
        if calib_mode == "entropy":
            # KL-optimal clip thresholds from a second histogram pass, only
            # over ranges a quantizable node will consume
            needed = set()
            for node in sym_in._nodes():
                if node.op in _QUANTIZABLE and node.name not in excluded \
                        and node.inputs:
                    needed.add(_entry_range_key(node.inputs[0]))
            needed &= set(th_dict)
            sub_stats = {k: th_dict[k] for k in needed}
            if sub_stats:
                hists, edges = _collect_layer_histograms(
                    sym_in, arg_params, aux_params, calib_data,
                    num_calib_examples, list(data_names), sub_stats, ctx)
                for name in needed:
                    th = optimal_threshold(hists[name], edges[name])
                    th_dict[name] = (-th, th)
        logger.info("calibrated %d layer output ranges (%s)",
                    len(th_dict), calib_mode)
        sym_in = calib_graph(sym_in, th_dict)
        # rewrite calibrated FC/conv/pooling layers to int8 subgraphs, fuse
        # dequantize->quantize handoffs into requantize, then (opt-in) fuse
        # whole qconv->bias->relu->quantize chains into int8-out nodes
        sym_in = _rewrite_int8(sym_in, qarg_params, th_dict, excluded)
        sym_in = _elide_dq_q(sym_in)
        import os as _os
        if _os.environ.get("MXTPU_FUSE_QCONV", "0") == "1":
            sym_in = _fuse_conv_requant(sym_in, qarg_params)
    return sym_in, qarg_params, aux_params
