"""contrib ops of the port, the whole of ``mxnet_tpu/ops/contrib.py``:
the CTC loss, the box family (``box_iou``, ``box_nms``,
``bipartite_matching``), the SSD family (``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection``), the two-stage detector's
``Proposal`` / ``MultiProposal`` and ``ROIAlign``, the sparse helpers
``getnnz`` and ``SparseEmbedding``, and the rest (adaptive pooling, the
bilinear resize, count sketch, the FFTs, Khatri-Rao, deformable
convolution, deformable and plain PS RoI pooling, ``div_sqrt_dim``,
``quadratic`` and ``IdentityAttachKLSparseReg``).  None of them reaches
a ``pallas_call`` in the reference; they map to torch calls.

**CTC.** The reference runs the log-space forward recursion under
``lax.scan`` and differentiates through it; the port calls
``F.ctc_loss`` (torch's native CTC on the CPU and on the card).  The
reference's semantics are kept:

- the softmax runs inside the op: ``data`` are activations, and the
  gradient is the one with respect to them (torch's CTC backward is the
  true gradient only through ``log_softmax``'s, so the op never hands out
  the log-probabilities);
- ``blank_label="first"``: blank 0, labels padded with 0; ``"last"``:
  blank ``A - 1``, labels padded with -1 (a negative label indexes from
  the end, as the reference's gather does);
- label lengths are counted from the padding unless
  ``use_label_lengths``; data lengths default to ``T``;
- a row whose labels need more frames than it has (its length plus one
  per repeated neighbour) has no alignment: the reference's ``-1e30``
  sentinel gives it a loss of ``1e30``, and so does the port, with a zero
  gradient (the reference's gradient there is an artifact of its
  sentinel, ROADMAP.md C7);
- the output is ``(batch,)`` losses.

**Boxes.** The reference writes every box op in ``jnp`` under ``vmap``
(no ``pallas_call``); the port batches the same arithmetic over the
leading axis.  The reference's results depend on order, and the port
keeps each rule on both devices:

- every sort is stable (``argsort(..., stable=True)``), as JAX's is;
  ``lax.top_k``'s lower index first on ties is a stable descending sort;
  ``argmax`` takes the first index in both frameworks;
- where several ground truths claim one anchor in ``MultiBoxTarget``
  (``.at[].set`` with duplicate indices), the last one wins, as XLA's
  scatter on the CPU lets it: the port takes the largest claiming index
  by comparison, with no scatter whose winner the card leaves open;
- masked values are selected (``torch.where``), never multiplied by a
  0/1 mask, where the reference selects.

The greedy NMS (:func:`_nms_keep`) gives the reference's keep mask bit
for bit.  The reference visits all N rows in score order under
``fori_loop``; a row that is not a candidate on entry (valid, and within
``topk``) never suppresses anything, so the port compacts the candidates
to the front in score order, builds their pairwise suppression bits on
the tensor's device (IoU above the threshold, later rows only, same
class where the op is class-aware), packs them eight to a byte, copies
them to the host in one transfer and sweeps them there in score order.
On the card that transfer is the op's one host synchronization;
:func:`host_sync_counts` counts them by op.

``MultiBoxPrior``'s output depends only on its input's shape: its
gradient is zero (the reference's op is differentiable and its gradient
vanishes).  ``MultiBoxTarget``, ``MultiBoxDetection``, ``Proposal`` and
``bipartite_matching`` are not differentiable in the reference and run
on detached inputs here.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as TF

from .registry import register

__all__ = ["ctc_loss", "ctc_infeasible", "box_iou", "box_nms",
           "bipartite_matching", "multibox_prior", "multibox_target",
           "multibox_detection", "roi_align", "proposal", "host_sync_counts",
           "reset_host_sync_counts", "getnnz", "sparse_embedding",
           "adaptive_avg_pooling2d", "bilinear_resize2d", "count_sketch",
           "fft", "ifft", "khatri_rao", "deformable_convolution",
           "deformable_psroi_pooling", "psroi_pooling", "div_sqrt_dim",
           "quadratic", "identity_attach_kl_sparse_reg"]

# the loss of a row with no alignment: the reference's -(-1e30)
NO_ALIGNMENT_LOSS = 1e30


def ctc_infeasible(labels, label_lengths, data_lengths):
    """Rows whose first ``label_lengths`` labels need more frames than
    ``data_lengths``: one per label, one more between equal neighbours."""
    L = labels.shape[1]
    steps = torch.arange(1, L, device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (steps[None, :] < label_lengths[:, None])).sum(-1)
    return label_lengths + repeats > data_lengths


def _ctc_optional(params):
    opt = []
    if not params.get("use_data_lengths", False):
        opt.append("data_lengths")
    if not params.get("use_label_lengths", False):
        opt.append("label_lengths")
    return opt


@register("_contrib_ctc_loss",
          arg_names=["data", "label", "data_lengths", "label_lengths"],
          aliases=("ctc_loss", "CTCLoss", "_contrib_CTCLoss"),
          optional_args=_ctc_optional)
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC loss (reference: src/operator/contrib/ctc_loss.cc).

    data: (seq_len, batch, alphabet) activations; label: (batch,
    label_len) padded.  Returns (batch,) losses."""
    T, B, A = data.shape
    if data.device.type == "meta":
        return data.new_empty((B,))
    blank = 0 if blank_label == "first" else A - 1
    labels = label.long()
    if use_label_lengths and label_lengths is not None:
        lab_lens = label_lengths.long()
    else:
        pad = 0 if blank_label == "first" else -1
        lab_lens = (labels != pad).sum(-1)
    if use_data_lengths and data_lengths is not None:
        dat_lens = data_lengths.long()
    else:
        dat_lens = torch.full((B,), T, dtype=torch.long, device=data.device)
    targets = torch.remainder(labels, A)
    log_probs = torch.log_softmax(data, dim=-1)
    loss = TF.ctc_loss(log_probs, targets, dat_lens, lab_lens, blank=blank,
                       reduction="none", zero_infinity=True)
    return torch.where(ctc_infeasible(targets, lab_lens, dat_lens),
                       torch.full((), NO_ALIGNMENT_LOSS, dtype=loss.dtype,
                                  device=loss.device), loss)


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------
_host_syncs = {}


def host_sync_counts():
    """{op: host synchronizations on the card} since the last reset: the
    greedy NMS's one transfer of its suppression bits a call, and
    ``control_flow``'s reads of a loop condition or a predicate."""
    return dict(_host_syncs)


def reset_host_sync_counts():
    _host_syncs.clear()


def _pos(x):
    """``max(x, 0)`` (``jnp.clip(x, 0, None)``; a tie splits its gradient
    as JAX's does)."""
    return torch.maximum(x, x.new_zeros(()))


def _box_iou_corner(a, b):
    """IoU between corner boxes a (..., N, 4) and b (..., M, 4) ->
    (..., N, M): the reference's arithmetic, elementwise."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = _pos(br - tl)
    inter = wh[..., 0] * wh[..., 1]
    area_a = _pos(a[..., 2] - a[..., 0]) * _pos(a[..., 3] - a[..., 1])
    area_b = _pos(b[..., 2] - b[..., 0]) * _pos(b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, inter.new_zeros(()))


def _center_to_corner(x):
    return torch.cat([x[..., :2] - x[..., 2:] / 2,
                      x[..., :2] + x[..., 2:] / 2], dim=-1)


@register("_contrib_box_iou", arg_names=["lhs", "rhs"])
def box_iou(lhs, rhs, format="corner"):
    """Reference: src/operator/contrib/bounding_box.cc box_iou."""
    a, b = lhs, rhs
    if format == "center":
        a, b = _center_to_corner(a), _center_to_corner(b)
    out = _box_iou_corner(a.reshape(-1, 4), b.reshape(-1, 4))
    return out.reshape(a.shape[:-1] + b.shape[:-1])


# pairs of the IoU matrix built at once (images are taken in chunks that
# keep it near 2^26 elements: ~256 MB of float32)
_NMS_CHUNK = 1 << 26


def _sweep(packed, counts):
    """The greedy pass on the host: ``packed`` (B, C, C / 8) uint8 rows of
    suppression bits (bit j of row i: candidate i suppresses candidate j),
    ``counts`` candidates an image.  Returns the keep mask (B, C)."""
    B, C = packed.shape[:2]
    keep = _np.zeros((B, C), bool)
    for b in range(B):
        removed = 0
        rows = packed[b]
        for i in range(int(counts[b])):
            if not (removed >> i) & 1:
                keep[b, i] = True
                removed |= int.from_bytes(rows[i].tobytes(), "little")
    return keep


def _nms_keep(boxes, scores, valid, overlap_thresh, topk, class_ids=None,
              op="box_nms"):
    """Greedy NMS over each image of (B, N, 4) corner boxes: the keep mask
    (B, N) of the reference's ``_nms_single`` (``contrib.py:151-175``),
    bit for bit.  With ``class_ids`` only same-class pairs suppress."""
    B, N = scores.shape
    dev = scores.device
    if N == 0 or B == 0:
        return torch.zeros((B, N), dtype=torch.bool, device=dev)
    order = torch.argsort(-scores, dim=1, stable=True)
    cand = valid.gather(1, order)
    if topk > 0:
        cand = cand & (torch.arange(N, device=dev) < topk)
    C = min(N, topk) if topk > 0 else N
    # the candidates first, still in score order
    front = torch.argsort((~cand).to(torch.uint8), dim=1, stable=True)[:, :C]
    idx = order.gather(1, front)                           # (B, C)
    counts = cand.sum(1)
    cb = boxes.gather(1, idx[..., None].expand(B, C, 4))
    later = torch.triu(torch.ones((C, C), dtype=torch.bool, device=dev), 1)
    W = (C + 7) // 8
    weights = (2 ** torch.arange(8, device=dev)).to(torch.uint8)
    packed = torch.empty((B, C, W), dtype=torch.uint8, device=dev)
    step = max(1, _NMS_CHUNK // (C * C))
    for s in range(0, B, step):
        iou = _box_iou_corner(cb[s:s + step], cb[s:s + step])
        if class_ids is not None:
            ci = class_ids.gather(1, idx[s:s + step])
            iou = iou * (ci[:, :, None] == ci[:, None, :]).to(iou.dtype)
        bits = TF.pad((iou > overlap_thresh) & later, (0, W * 8 - C))
        packed[s:s + step] = (bits.view(-1, C, W, 8).to(torch.uint8)
                              * weights).sum(-1, dtype=torch.uint8)
    host = torch.cat([packed.reshape(B, -1),
                      counts.to(torch.int64)[:, None].view(torch.uint8)],
                     dim=1)
    if dev.type == "cuda":
        _host_syncs[op] = _host_syncs.get(op, 0) + 1
    host = host.cpu().numpy()
    counts = host[:, C * W:].copy().view(_np.int64)[:, 0]
    keep_c = torch.from_numpy(_sweep(host[:, :C * W].reshape(B, C, W),
                                     counts)).to(dev, non_blocking=True)
    return torch.zeros((B, N), dtype=torch.bool, device=dev).scatter_(
        1, idx, keep_c)


@register("_contrib_box_nms", arg_names=["data"], aliases=("box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1, coord_start=2,
            score_index=1, id_index=-1, background_id=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """Greedy box NMS (reference: bounding_box.cc BoxNMS).  Suppressed
    rows are overwritten with -1; the kept rows are the input's, in their
    order, whatever ``out_format`` (the reference's choice)."""
    shape = data.shape
    if data.device.type == "meta":
        return data.new_empty(shape)
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    det = flat.detach()
    cs = int(coord_start)
    scores = det[..., score_index]
    boxes = det[..., cs:cs + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (det[..., id_index] != background_id)
    class_ids = det[..., id_index] \
        if (id_index >= 0 and not force_suppress) else None
    keep = _nms_keep(boxes, scores, valid, overlap_thresh, int(topk),
                     class_ids)
    out = torch.where(keep[..., None], flat, -torch.ones_like(flat))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# SSD MultiBox family
# ---------------------------------------------------------------------------
class _ZeroGrad(torch.autograd.Function):
    """``out`` as it is, joined to ``like`` with a zero gradient."""

    @staticmethod
    def forward(ctx, out, like):
        ctx.like = (like.shape, like.dtype, like.device)
        return out

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        return None, torch.zeros(shape, dtype=dtype, device=device)


def _seq(v):
    return (v,) if isinstance(v, (int, float)) else tuple(v)


@register("_contrib_MultiBoxPrior", arg_names=["data"],
          aliases=("MultiBoxPrior", "_contrib_multibox_prior"))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor generation (reference: multibox_prior.cc).  data: (N, C, H,
    W); returns (1, H*W*num_anchors, 4) corner boxes in [0, 1] coords,
    ``len(sizes) + len(ratios) - 1`` anchors a position."""
    sizes, ratios = _seq(sizes), _seq(ratios)
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    f32 = torch.float32
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + offsets[1]) * step_x
    whs = [(s * _np.sqrt(ratios[0]), s / _np.sqrt(ratios[0]))
           for s in sizes]
    whs += [(sizes[0] * _np.sqrt(r), sizes[0] / _np.sqrt(r))
            for r in ratios[1:]]
    # each anchor's float32 width and height, filled on the device (a
    # tensor made from host values would be a synchronizing copy)
    whs = _np.asarray(whs, _np.float32)
    half_w = torch.stack([cx.new_full((), float(v)) for v in whs[:, 0]]) / 2
    half_h = torch.stack([cx.new_full((), float(v)) for v in whs[:, 1]]) / 2
    cyy = cy[:, None, None].expand(h, w, len(whs))
    cxx = cx[None, :, None].expand(h, w, len(whs))
    out = torch.stack([cxx - half_w, cyy - half_h, cxx + half_w,
                       cyy + half_h], dim=-1).reshape(1, -1, 4)
    if clip:
        out = torch.minimum(_pos(out), out.new_ones(()))
    if data.requires_grad:
        out = _ZeroGrad.apply(out, data)
    return out


def _anchor_geometry(anchors):
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    return aw, ah, acx, acy


def _softmax(x, dim):
    """``jax.nn.softmax``'s arithmetic: exp of the shifted input over its
    sum."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


@register("_contrib_MultiBoxTarget", arg_names=["anchor", "label", "cls_pred"],
          aliases=("MultiBoxTarget", "_contrib_multibox_target"),
          num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor-to-ground-truth matching and the encoded loc targets
    (reference: multibox_target.cc).

    anchor: (1, N, 4) corner; label: (B, M, 5) [cls, xmin, ymin, xmax,
    ymax] padded with -1; cls_pred: (B, num_cls+1, N) (negative mining).
    Returns (loc_target (B, N*4), loc_mask (B, N*4), cls_target (B, N))."""
    anchors = anchor.detach().reshape(-1, 4)
    label, cls_pred = label.detach(), cls_pred.detach()
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    if anchors.device.type == "meta":
        return (anchors.new_empty((B, N * 4)), anchors.new_empty((B, N * 4)),
                anchors.new_empty((B, N)))
    dev = anchors.device
    valid = label[..., 0] >= 0                          # (B, M)
    gt = label[..., 1:5]
    iou = _box_iou_corner(anchors.expand(B, N, 4), gt)  # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, iou.new_full((), -1.0))
    best_gt = iou.argmax(dim=2)                         # (B, N)
    best_iou = iou.amax(dim=2)
    # each valid ground truth claims its best anchor; of several claiming
    # one anchor the last wins (the reference's duplicate-index scatter)
    best_anchor = iou.argmax(dim=1)                     # (B, M)
    claims = valid[:, :, None] & (
        best_anchor[:, :, None] == torch.arange(N, device=dev))  # (B, M, N)
    forced = claims.any(dim=1)
    last = (M - 1) - claims.flip(1).to(torch.uint8).argmax(dim=1)
    match = torch.where(forced, last, best_gt)
    pos = forced | (best_iou >= overlap_threshold)
    zero = label.new_zeros(())
    cls_t = torch.where(pos, label[..., 0].gather(1, match) + 1.0, zero)
    if negative_mining_ratio > 0:
        # hard-negative mining: keep the hardest negatives (lowest
        # background probability, IoU under the mining threshold); the
        # rest take ignore_label
        bg_prob = _softmax(cls_pred, 1)[:, 0]           # (B, N)
        neg_cand = (~pos) & (best_iou < negative_mining_thresh)
        hardness = torch.where(neg_cand, 1.0 - bg_prob,
                               bg_prob.new_full((), -1.0))
        num_pos = pos.sum(1, dtype=torch.int32)
        ratio = torch.full((), negative_mining_ratio, dtype=torch.float32,
                           device=dev)
        num_neg = torch.clamp((ratio * num_pos.to(torch.float32)).to(
            torch.int32), min=int(minimum_negative_samples))
        order = torch.argsort(-hardness, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(N, device=dev).expand(B, N))
        keep_neg = neg_cand & (rank < num_neg[:, None])
        cls_t = torch.where(pos, cls_t, torch.where(
            keep_neg, zero, label.new_full((), float(ignore_label))))
    g = gt.gather(1, match[..., None].expand(B, N, 4))
    aw, ah, acx, acy = _anchor_geometry(anchors)
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    eps = anchors.new_full((), 1e-8)
    aw_, ah_ = torch.maximum(aw, eps), torch.maximum(ah, eps)
    var = [anchors.new_full((), float(v)) for v in variances]
    tx = (gcx - acx) / aw_ / var[0]
    ty = (gcy - acy) / ah_ / var[1]
    tw = torch.log(torch.maximum(gw / aw_, eps)) / var[2]
    th = torch.log(torch.maximum(gh / ah_, eps)) / var[3]
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)
    loc_t = torch.where(pos[..., None], loc_t, zero).reshape(B, -1)
    loc_m = pos[..., None].expand(B, N, 4).to(label.dtype).reshape(B, -1)
    return loc_t, loc_m, cls_t


@register("_contrib_MultiBoxDetection",
          arg_names=["cls_prob", "loc_pred", "anchor"],
          aliases=("MultiBoxDetection", "_contrib_multibox_detection"))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and NMS (reference: multibox_detection.cc).

    cls_prob: (B, num_cls+1, N); loc_pred: (B, N*4); anchor: (1, N, 4).
    Returns (B, N, 6) rows [cls_id, score, xmin, ymin, xmax, ymax] in
    anchor order (not sorted by score, as the reference's), -1 where
    dropped."""
    cls_prob, loc_pred = cls_prob.detach(), loc_pred.detach()
    anchors = anchor.detach().reshape(-1, 4)
    B, N = cls_prob.shape[0], anchors.shape[0]
    if anchors.device.type == "meta":
        return anchors.new_empty((B, N, 6))
    aw, ah, acx, acy = _anchor_geometry(anchors)
    loc = loc_pred.reshape(B, -1, 4)
    var = [anchors.new_full((), float(v)) for v in variances]
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = torch.minimum(_pos(boxes), boxes.new_ones(()))
    # the best non-background class of each anchor
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    cls_id = fg.argmax(dim=1).to(boxes.dtype)
    score = fg.amax(dim=1)
    rows = torch.cat([cls_id[..., None], score[..., None], boxes], dim=-1)
    rows = torch.where((score > threshold)[..., None], rows,
                       rows.new_full((), -1.0))
    keep = _nms_keep(rows[..., 2:], rows[..., 1], rows[..., 1] > threshold,
                     nms_threshold, int(nms_topk),
                     None if force_suppress else rows[..., 0],
                     op="MultiBoxDetection")
    return torch.where(keep[..., None], rows, rows.new_full((), -1.0))


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------
def _bilinear_gather(flat, base, y, x, H, W):
    """Bilinear samples of ``flat`` ((N*H*W, C), channels last) at float
    coords ``y`` / ``x`` (R, P) of the images whose first row is ``base``
    (R, 1): (R, P, C), zero outside (the reference's ``_bilinear_gather``,
    tap by tap)."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = y - y0
    wx1 = x - x0

    def tap(yy, xx, wgt):
        iy = yy.to(torch.int64).clamp(0, H - 1)
        ix = xx.to(torch.int64).clamp(0, W - 1)
        inside = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        vals = flat[base + iy * W + ix]
        return vals * (wgt * inside)[..., None]

    return (tap(y0, x0, (1 - wy1) * (1 - wx1))
            + tap(y0, x0 + 1, (1 - wy1) * wx1)
            + tap(y0 + 1, x0, wy1 * (1 - wx1))
            + tap(y0 + 1, x0 + 1, wy1 * wx1))


@register("_contrib_ROIAlign", arg_names=["data", "rois"],
          aliases=("ROIAlign",))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """ROI Align (reference: src/operator/contrib/roi_align.cc).

    data: (N, C, H, W); rois: (R, 5) [batch_idx, x1, y1, x2, y2].
    Returns (R, C, ph, pw), the mean of ``sample_ratio``^2 bilinear
    samples a bin; the gradient is torch's autograd (a scatter-add)."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    R = rois.shape[0]
    if data.device.type == "meta":
        return data.new_empty((R, C, ph, pw))
    sr = max(int(sample_ratio), 1)
    offset = 0.5 if aligned else 0.0
    bidx = rois[:, 0].detach().to(torch.int64)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    floor = rois.new_full((), 1e-6 if aligned else 1.0)
    rw = torch.maximum(x2 - x1, floor)
    rh = torch.maximum(y2 - y1, floor)
    bin_h = (rh / ph)[:, None, None, None, None]
    bin_w = (rw / pw)[:, None, None, None, None]
    dev, dt = rois.device, rois.dtype
    py = torch.arange(ph, device=dev, dtype=dt)[:, None, None, None]
    px = torch.arange(pw, device=dev, dtype=dt)[None, :, None, None]
    sy = torch.arange(sr, device=dev, dtype=dt)[None, None, :, None]
    sx = torch.arange(sr, device=dev, dtype=dt)[None, None, None, :]
    iy = py * bin_h + (sy + 0.5) * bin_h / sr + y1[:, None, None, None, None]
    ix = px * bin_w + (sx + 0.5) * bin_w / sr + x1[:, None, None, None, None]
    shape = (R, ph, pw, sr, sr)
    yy = iy.expand(shape).reshape(R, -1)
    xx = ix.expand(shape).reshape(R, -1)
    flat = data.permute(0, 2, 3, 1).reshape(N * H * W, C)
    vals = _bilinear_gather(flat, (bidx * (H * W))[:, None], yy, xx, H, W)
    vals = vals.reshape(R, ph, pw, sr * sr, C).mean(dim=3)
    return vals.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Proposal / MultiProposal (reference: src/operator/contrib/proposal.cc,
# multi_proposal.cc: anchors plus deltas, clip, the min-size filter,
# top-K, NMS)
# ---------------------------------------------------------------------------
def _gen_anchors(scales, ratios, stride):
    """Base anchors (A, 4) centred on a stride x stride cell, float32 on
    the host (reference: proposal.cc GenerateAnchors semantics)."""
    f = torch.float32
    base = torch.tensor([0, 0, stride - 1, stride - 1], dtype=f)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = torch.round(torch.sqrt(size / r))
        hs = torch.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append(torch.stack([cx - 0.5 * (wss - 1),
                                        cy - 0.5 * (hss - 1),
                                        cx + 0.5 * (wss - 1),
                                        cy + 0.5 * (hss - 1)]))
    return torch.stack(anchors)


def _proposal_batch(score_fg, bbox_delta, im_info, anchors, stride, pre_n,
                    post_n, thresh, min_size):
    """(B, A, H, W) foreground scores and (B, 4A, H, W) deltas -> boxes
    (B, K, 4) and scores (B, K), K = min(post_n, pre-NMS count), zero
    where no box survives (the reference's ``_proposal_single`` over the
    batch)."""
    B, A, H, W = score_fg.shape
    dev, f = score_fg.device, score_fg.dtype
    shift_x = torch.arange(W, dtype=f, device=dev) * stride
    shift_y = torch.arange(H, dtype=f, device=dev) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")   # (H, W)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)
    all_anchors = (anchors[None, None] + shifts[:, :, None]).reshape(-1, 4)
    deltas = bbox_delta.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    scores = score_fg.permute(0, 2, 3, 1).reshape(B, -1)
    widths = all_anchors[:, 2] - all_anchors[:, 0] + 1.0
    heights = all_anchors[:, 3] - all_anchors[:, 1] + 1.0
    ctr_x = all_anchors[:, 0] + 0.5 * (widths - 1)
    ctr_y = all_anchors[:, 1] + 0.5 * (heights - 1)
    px = deltas[..., 0] * widths + ctr_x
    py = deltas[..., 1] * heights + ctr_y
    lim = score_fg.new_full((), 10.0)
    pw = torch.exp(torch.minimum(torch.maximum(deltas[..., 2], -lim),
                                 lim)) * widths
    ph = torch.exp(torch.minimum(torch.maximum(deltas[..., 3], -lim),
                                 lim)) * heights
    zero = score_fg.new_zeros(())

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi[:, None])

    xmax = im_info[:, 1] - 1
    ymax = im_info[:, 0] - 1
    boxes = torch.stack([clip(px - 0.5 * (pw - 1), xmax),
                         clip(py - 0.5 * (ph - 1), ymax),
                         clip(px + 0.5 * (pw - 1), xmax),
                         clip(py + 0.5 * (ph - 1), ymax)], dim=-1)
    # the min-size filter in the original image's scale
    ms = (min_size * im_info[:, 2])[:, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1) >= ms) & \
        ((boxes[..., 3] - boxes[..., 1] + 1) >= ms)
    scores = torch.where(keep, scores, scores.new_full((), -float("inf")))
    n = scores.shape[1]
    pre = min(pre_n, n) if pre_n > 0 else n
    # lax.top_k: descending, the lower index first on ties
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :pre], top_idx[:, :pre]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(B, pre, 4))
    finite = torch.isfinite(top_scores)
    keep_mask = _nms_keep(top_boxes, top_scores, finite, thresh, -1,
                          op="Proposal")
    ninf = top_scores.new_full((), -float("inf"))
    ranked = torch.argsort(-torch.where(keep_mask, top_scores, ninf), dim=1,
                           stable=True)
    sel = ranked[:, :post_n]
    sel_valid = keep_mask.gather(1, sel) & finite.gather(1, sel)
    out_boxes = torch.where(
        sel_valid[..., None],
        top_boxes.gather(1, sel[..., None].expand(B, sel.shape[1], 4)), zero)
    out_scores = torch.where(sel_valid, top_scores.gather(1, sel), zero)
    return out_boxes, out_scores


def _proposal_outputs(params):
    return 2 if params.get("output_score") else 1


@register("_contrib_Proposal",
          arg_names=["cls_prob", "bbox_pred", "im_info"],
          aliases=("Proposal", "_contrib_MultiProposal", "MultiProposal"),
          num_outputs=_proposal_outputs)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals (reference: contrib/proposal.cc; MultiProposal is the
    batched variant, multi_proposal.cc, and one batched function serves
    both).  Returns rois (B*K, 5) with the batch index in column 0 (and
    their scores (B*K, 1) with ``output_score``)."""
    cls_prob, bbox_pred = cls_prob.detach(), bbox_pred.detach()
    im_info = im_info.detach()
    B, A2, H, W = cls_prob.shape
    A = A2 // 2
    pre_n, post_n = int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n)
    if cls_prob.device.type == "meta":
        n = H * W * A
        K = min(post_n, min(pre_n, n) if pre_n > 0 else n)
        rois = cls_prob.new_empty((B * K, 5))
        return (rois, cls_prob.new_empty((B * K, 1))) if output_score \
            else rois
    anchors = _gen_anchors(list(scales), list(ratios),
                           float(feature_stride)).to(cls_prob.device,
                                                     non_blocking=True)
    boxes, scores = _proposal_batch(
        cls_prob[:, A:], bbox_pred, im_info.to(cls_prob.dtype), anchors,
        float(feature_stride), pre_n, post_n, float(threshold),
        float(rpn_min_size))
    K = boxes.shape[1]
    batch_ids = torch.arange(B, dtype=boxes.dtype,
                             device=boxes.device).repeat_interleave(K)
    rois = torch.cat([batch_ids[:, None], boxes.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


# ---------------------------------------------------------------------------
# bipartite matching (reference: contrib/bounding_box.cc
# _contrib_bipartite_matching: greedy best-pair assignment)
# ---------------------------------------------------------------------------
@register("_contrib_bipartite_matching", arg_names=["data"], num_outputs=2,
          aliases=("bipartite_matching",))
def bipartite_matching(data, is_ascend=False, threshold=1e-12, topk=-1):
    """Greedy bipartite matching over a score matrix (..., N, M): the best
    remaining pair (the first in row-major order on ties) while it passes
    ``threshold``, at most ``min(N, M)`` pairs (``topk`` if positive).
    Outputs: row match (column index or -1) and column match (row index
    or -1), float32."""
    scores = data.detach().to(torch.float32)
    lead = tuple(scores.shape[:-2])
    N, M = scores.shape[-2:]
    dev = scores.device
    if dev.type == "meta":
        return (scores.new_empty(lead + (N,)), scores.new_empty(lead + (M,)))
    s = scores.reshape(-1, N, M).clone()
    B = s.shape[0]
    bad = float("inf") if is_ascend else -float("inf")
    row_m = torch.full((B, N), -1.0, device=dev)
    col_m = torch.full((B, M), -1.0, device=dev)
    rows = torch.arange(B, device=dev)
    steps = min(N, M)
    if topk > 0:
        steps = min(steps, int(topk))
    thr = s.new_full((), threshold)
    for _ in range(steps):
        flat = s.reshape(B, N * M)
        idx = (flat if is_ascend else -flat).argmin(dim=1)
        r, c = idx // M, idx % M
        val = flat.gather(1, idx[:, None])[:, 0]
        ok = (val < thr) if is_ascend else (val > thr)
        row_m[rows, r] = torch.where(ok, c.to(row_m.dtype), row_m[rows, r])
        col_m[rows, c] = torch.where(ok, r.to(col_m.dtype), col_m[rows, c])
        s[rows, r, :] = torch.where(ok[:, None], s.new_full((), bad),
                                    s[rows, r, :])
        s[rows, :, c] = torch.where(ok[:, None], s.new_full((), bad),
                                    s[rows, :, c])
    return row_m.reshape(lead + (N,)), col_m.reshape(lead + (M,))


# ---------------------------------------------------------------------------
# the sparse helpers (reference: src/operator/contrib/nnz.cc and
# src/operator/tensor/indexing_op.cc SparseEmbedding)
# ---------------------------------------------------------------------------
@register("_contrib_getnnz", arg_names=["data"])
def getnnz(data, axis=None):
    """The count of nonzero entries (over ``axis``, or all), int64."""
    nz = (data != 0).to(torch.int64)
    return nz.sum() if axis is None else nz.sum(dim=axis)


@register("_contrib_SparseEmbedding", arg_names=["data", "weight"],
          aliases=("SparseEmbedding",))
def sparse_embedding(data, weight, input_dim=0, output_dim=0,
                     dtype="float32", deterministic=False):
    """Rows of a row-sparse weight table by integer index: ``Embedding``'s
    forward (its gradient is dense here, as in the reference)."""
    return weight[data.to(device=weight.device, dtype=torch.long)]


# ---------------------------------------------------------------------------
# the rest of the contrib ops (reference: mxnet_tpu/ops/contrib.py:375-449,
# 521-577, 736-877)
# ---------------------------------------------------------------------------
def _div(a, v):
    """``a / v`` with ``v`` a 0-d tensor of ``a``'s dtype on its device: a
    true division on the card too (a Python divisor becomes a
    multiplication by its reciprocal there)."""
    return a / a.new_full((), float(v))


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, float)) \
        else tuple(int(i) for i in v)


@register("_contrib_AdaptiveAvgPooling2D", arg_names=["data"],
          aliases=("AdaptiveAvgPooling2D",))
def adaptive_avg_pooling2d(data, output_size=(1, 1)):
    """Adaptive average pooling (reference:
    src/operator/contrib/adaptive_avg_pooling.cc): bin ``i`` of ``o``
    spans ``floor(i n / o)`` to ``ceil((i + 1) n / o)``, as
    ``F.adaptive_avg_pool2d``'s bins do."""
    return TF.adaptive_avg_pool2d(data, _pair(output_size))


@register("_contrib_BilinearResize2D", arg_names=["data"],
          aliases=("BilinearResize2D",))
def bilinear_resize2d(data, height=1, width=1, scale_height=None,
                      scale_width=None):
    """Bilinear resize as the reference computes it
    (``jax.image.resize(method="linear")``): half-pixel sampling,
    antialiased where a side shrinks.  Upstream MXNet's op aligns the
    corners (ROADMAP.md C12)."""
    n, c, h, w = data.shape
    if scale_height is not None:
        height = int(round(h * scale_height))
        width = int(round(w * scale_width))
    size = (int(height), int(width))
    if data.device.type == "meta":
        return data.new_empty((n, c) + size)
    return TF.interpolate(data, size=size, mode="bilinear",
                          align_corners=False, antialias=True)


@register("_contrib_count_sketch", arg_names=["data", "h", "s"],
          aliases=("count_sketch",))
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count sketch (reference: contrib/count_sketch.cu): column ``j`` of
    ``data``, times ``s[j]``, added into output column ``h[j]``."""
    n, in_dim = data.shape
    hh = h.detach().reshape(-1)[:in_dim].to(torch.int64)
    vals = data * s.reshape(-1)[:in_dim][None, :]
    return data.new_zeros((n, int(out_dim))).index_add(1, hh, vals)


@register("_contrib_fft", arg_names=["data"], aliases=("fft",))
def fft(data, compute_size=128):
    """FFT over the last axis, real and imaginary parts interleaved
    (reference: contrib/fft.cu; ``compute_size`` is ignored)."""
    out = torch.fft.fft(data, dim=-1)
    inter = torch.stack([out.real, out.imag], dim=-1)
    return inter.reshape(data.shape[:-1] + (data.shape[-1] * 2,)) \
        .to(data.dtype)


@register("_contrib_ifft", arg_names=["data"], aliases=("ifft",))
def ifft(data, compute_size=128):
    """The inverse FFT's real part from the interleaved layout
    (reference: contrib/ifft.cc)."""
    n = data.shape[-1] // 2
    comp = data.reshape(data.shape[:-1] + (n, 2))
    z = torch.complex(comp[..., 0], comp[..., 1])
    return torch.fft.ifft(z, dim=-1).real.to(data.dtype)


@register("khatri_rao", arg_names=["args"])
def khatri_rao(*args):
    """Column-wise Khatri-Rao product (reference: contrib/krprod.cc)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[1])
    return out


@register("_contrib_DeformableConvolution",
          arg_names=["data", "offset", "weight", "bias"],
          aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=0, num_group=1, num_deformable_group=1,
                           workspace=1024, no_bias=False, layout=None):
    """Deformable convolution v1 (reference:
    contrib/deformable_convolution.cc).

    ``offset`` (N, 2 dg kh kw, OH, OW) is laid out [dg, kh, kw, {y, x}].
    The deformed im2col is a bilinear gather (zero outside, the rule of
    ``_bilinear_gather``) of each deformable group's channels only, then
    one GEMM, grouped by ``num_group``."""
    N, C, H, W = data.shape
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilate)
    ph, pw = _pair(pad)
    OH = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    F = int(num_filter)
    if data.device.type == "meta":
        return data.new_empty((N, F, OH, OW))
    dg, G = int(num_deformable_group), int(num_group)
    cpg, K, L = C // dg, kh * kw, OH * OW
    dev = data.device
    off = offset.reshape(N, dg, kh, kw, 2, OH, OW)
    # integer sample positions (exact), then the offsets added in the
    # data's dtype: (kh, 1, OH, 1) and (1, kw, 1, OW)
    by = ((torch.arange(OH, device=dev) * sh - ph)[None, None, :, None]
          + (torch.arange(kh, device=dev) * dh)[:, None, None, None])
    bx = ((torch.arange(OW, device=dev) * sw - pw)[None, None, None, :]
          + (torch.arange(kw, device=dev) * dw)[None, :, None, None])
    gy = by.to(data.dtype) + off[:, :, :, :, 0]       # (N, dg, kh, kw, OH, OW)
    gx = bx.to(data.dtype) + off[:, :, :, :, 1]
    flat = data.reshape(N * dg, cpg, H * W).transpose(1, 2) \
        .reshape(N * dg * H * W, cpg)
    base = (torch.arange(N * dg, device=dev) * (H * W))[:, None]
    vals = _bilinear_gather(flat, base, gy.reshape(N * dg, K * L),
                            gx.reshape(N * dg, K * L), H, W)
    col = vals.reshape(N, dg, K, L, cpg).permute(0, 1, 4, 2, 3) \
        .reshape(N, G, C // G * K, L)
    out = torch.matmul(weight.reshape(G, F // G, C // G * K), col)
    out = out.reshape(N, F, OH, OW)
    if bias is not None and not no_bias:
        out = out + bias[None, :, None, None]
    return out


def _psroi_optional(params):
    return ("trans",) if params.get("no_trans") else ()


@register("_contrib_DeformablePSROIPooling",
          arg_names=["data", "rois", "trans"],
          aliases=("DeformablePSROIPooling",),
          optional_args=_psroi_optional)
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=0, group_size=1, pooled_size=1,
                             part_size=0, sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Deformable position-sensitive RoI pooling (reference:
    contrib/deformable_psroi_pooling.cc, R-FCN / Deformable ConvNets).

    data (N, C, H, W), C = output_dim group_size^2; rois (R, 5); trans
    (R, 2 classes, part, part), of which the reference reads the first
    two channels.  Bin (d, i, j) of RoI r is the mean of
    ``sample_per_part``^2 bilinear samples, each clipped into the map, of
    its position-sensitive channel, displaced by ``trans`` times
    ``trans_std`` and the RoI's size.  The reference samples all C
    channels and then picks one a bin; only the picked channel is
    gathered here (the same samples and mean, C / output_dim times less
    memory).  Returns (R, output_dim, pooled_size, pooled_size)."""
    N, C, H, W = data.shape
    R = rois.shape[0]
    P, G, D = int(pooled_size), int(group_size), int(output_dim)
    part = int(part_size) or P
    sp = int(sample_per_part)
    if data.device.type == "meta":
        return data.new_empty((R, D, P, P))
    dev = data.device
    bidx = rois[:, 0].detach().to(torch.int64)
    x1 = rois[:, 1] * spatial_scale - 0.5
    y1 = rois[:, 2] * spatial_scale - 0.5
    x2 = (rois[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = (rois[:, 4] + 1.0) * spatial_scale - 0.5
    floor = rois.new_full((), 0.1)
    rw = torch.maximum(x2 - x1, floor)
    rh = torch.maximum(y2 - y1, floor)
    bin_w = _div(rw, P)[:, None, None, None, None]
    bin_h = _div(rh, P)[:, None, None, None, None]
    i = torch.arange(P, device=dev)
    iy, ix = i[:, None].expand(P, P), i[None, :].expand(P, P)
    sub = torch.arange(sp, device=dev, dtype=rois.dtype) + 0.5
    ys = y1[:, None, None, None, None] + iy.to(rois.dtype)[
        None, :, :, None, None] * bin_h
    xs = x1[:, None, None, None, None] + ix.to(rois.dtype)[
        None, :, :, None, None] * bin_w
    if not no_trans and trans is not None:
        py, px = (iy * part) // P, (ix * part) // P
        off_x = trans[:, 0][:, py, px] * trans_std * rw[:, None, None]
        off_y = trans[:, 1][:, py, px] * trans_std * rh[:, None, None]
        ys = ys + off_y[..., None, None]
        xs = xs + off_x[..., None, None]
    ys = ys + sub[:, None] * _div(bin_h, sp)           # (R, P, P, sp, 1)
    xs = xs + sub[None, :] * _div(bin_w, sp)           # (R, P, P, 1, sp)
    ys, xs = torch.broadcast_tensors(ys, xs)
    ys = torch.minimum(torch.maximum(ys, ys.new_zeros(())),
                       ys.new_full((), H - 1))
    xs = torch.minimum(torch.maximum(xs, xs.new_zeros(())),
                       xs.new_full((), W - 1))
    # the position-sensitive channel of each (d, i, j)
    cidx = ((torch.arange(D, device=dev)[:, None, None] * G
             + ((iy * G) // P)[None]) * G + ((ix * G) // P)[None]) % C
    base = ((bidx[:, None, None, None] * C + cidx[None]) * (H * W))[..., None]
    S = sp * sp
    vals = _bilinear_gather(data.reshape(-1, 1), base,
                            ys.reshape(R, 1, P, P, S),
                            xs.reshape(R, 1, P, P, S), H, W)
    return vals[..., 0].mean(dim=-1)


@register("_contrib_PSROIPooling", arg_names=["data", "rois"],
          aliases=("PSROIPooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                  pooled_size=1, group_size=0):
    """Position-sensitive RoI pooling (reference:
    src/operator/contrib/psroi_pooling.cc, R-FCN): the deformable op
    without offsets, one sample a bin."""
    g = int(group_size) or int(pooled_size)
    return deformable_psroi_pooling(
        data, rois, None, spatial_scale=spatial_scale,
        output_dim=output_dim, group_size=g, pooled_size=pooled_size,
        no_trans=True)


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """``data / sqrt(last dim)`` (reference: contrib/transformer.cc)."""
    return _div(data, float(data.shape[-1]) ** 0.5)


@register("_contrib_quadratic", aliases=("quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a x^2 + b x + c`` (reference: contrib/quadratic_op.cc)."""
    return a * data * data + b * data + c


class _KLSparseReg(torch.autograd.Function):
    """The identity forward; the backward adds the KL sparseness
    penalty's gradient, from the batch's mean activation clipped to
    [1e-6, 1 - 1e-6]."""

    @staticmethod
    def forward(ctx, data, rho, penalty):
        ctx.save_for_backward(data)
        ctx.rho, ctx.penalty = rho, penalty
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        rho = ctx.rho
        rho_hat = data.mean(dim=0).clamp(1e-6, 1 - 1e-6)
        reg = ctx.penalty * (rho_hat.new_full((), -rho) / rho_hat
                             + rho_hat.new_full((), 1 - rho)
                             / (1 - rho_hat))
        return g + reg.to(g.dtype), None, None


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1, penalty=0.001,
                                  momentum=0.9):
    """The identity, whose gradient gains ``penalty (-rho / rho_hat +
    (1 - rho) / (1 - rho_hat))`` with ``rho_hat`` the batch's mean
    activation (reference: src/operator/
    identity_attach_KL_sparse_reg-inl.h, the sparse autoencoder).  As in
    the reference, ``momentum`` is ignored and no moving average is kept
    (upstream MXNet keeps one; ROADMAP.md C14)."""
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))
