"""A tiny SSD trained through the symbolic executor: the port of
``examples/ssd/train_ssd.py``.

    python -m mxnet_tpu_torch.tools.train_ssd [--batch-size 16]
        [--num-classes 2] [--num-batches 80] [--lr 0.05] [--ctx gpu|cpu]

Three conv / relu / max-pool stages (16, 32, 64 filters) under a
``MultiBoxPrior`` head (sizes 0.3 / 0.6, ratios 1 / 2 / 0.5: 4 anchors a
position) and class / loc convolution heads, bound by ``simple_bind``.
The data is the reference's synthetic detection set: ``batch_size * 8``
64 x 64 images with one coloured square each, packed into a JPEG
``.rec`` (PIL at quality 95, the reference's encoder; OpenCV's
``recordio.pack_img`` where PIL is missing, and the script says which)
and read back through ``io.ImageDetRecordIter`` with shuffle and mirror.
Each step runs the executor's training forward, ``MultiBoxTarget`` with
hard-negative mining (ratio 3), the loss on the executor's outputs with
torch's autograd (softmax cross-entropy over the targets that are not
ignored, over their count and at least 1, plus smooth-L1 over
``loc_mask``, over its sum and at least 1), ``Executor.backward`` with
those head gradients, and SGD (momentum 0.9, ``rescale_grad``
1 / batch) through ``optimizer.get_updater`` per argument.  A last batch
goes through ``softmax`` and ``MultiBoxDetection`` (NMS 0.45, threshold
0.3).  Runs on the card unless ``--ctx cpu``; :func:`main` returns the
losses and image 0's kept detections.
"""
from __future__ import annotations

import argparse
import io as _pyio
import logging
import os
import tempfile

import numpy as np
import torch

from .. import initializer, io, nd, optimizer, recordio, symbol as sym
from ..context import cpu, gpu, use

__all__ = ["build_net", "jpeg_encoder", "pack_det_records", "parse_args",
           "make_iter", "batches", "bind", "ssd_loss", "train_step",
           "detect", "main"]

NUM_ANCHORS = 4          # len(sizes) + len(ratios) - 1
SIDE = 64


def build_net(num_classes, num_anchors):
    """Backbone and class / loc heads: a group of (anchors, cls_preds
    (B, classes + 1, N), loc_preds (B, 4N))."""
    data = sym.Variable("data")
    body = data
    for i, nf in enumerate((16, 32, 64)):
        body = sym.Convolution(body, kernel=(3, 3), num_filter=nf,
                               pad=(1, 1), name="conv%d" % i)
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    anchors = sym.contrib.MultiBoxPrior(body, sizes=(0.3, 0.6),
                                        ratios=(1.0, 2.0, 0.5),
                                        name="anchors")
    cls_pred = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                               num_filter=num_anchors * (num_classes + 1),
                               name="cls_pred")
    cls_pred = sym.transpose(cls_pred, axes=(0, 2, 3, 1))
    cls_pred = sym.Reshape(cls_pred, shape=(0, -1, num_classes + 1))
    cls_pred = sym.transpose(cls_pred, axes=(0, 2, 1))
    loc_pred = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                               num_filter=num_anchors * 4, name="loc_pred")
    loc_pred = sym.transpose(loc_pred, axes=(0, 2, 3, 1))
    loc_pred = sym.Flatten(loc_pred)
    return sym.Group([anchors, cls_pred, loc_pred])


def jpeg_encoder():
    """``"pil"`` where PIL imports (the reference's encoder), else
    ``"opencv"``."""
    try:
        import PIL.Image  # noqa: F401
        return "pil"
    except ImportError:
        return "opencv"


def pack_det_records(path_prefix, num_images, num_classes, rng,
                     encoder="pil"):
    """Pack the synthetic detection ``.rec``: images with one coloured
    square, labels in the detection header format ``[header_w, obj_w,
    cls, x1, y1, x2, y2]``.  ``encoder="pil"`` writes the reference's
    bytes; ``"opencv"`` encodes the same pixels with ``pack_img``."""
    rec, idx = path_prefix + ".rec", path_prefix + ".idx"
    writer = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(num_images):
        cls = rng.randint(num_classes)
        cx, cy = rng.uniform(0.3, 0.7, 2)
        s = rng.uniform(0.15, 0.3)
        x1, y1, x2, y2 = cx - s, cy - s, cx + s, cy + s
        img = np.zeros((SIDE, SIDE, 3), np.uint8)
        xi = [int(v * SIDE) for v in (x1, y1, x2, y2)]
        img[xi[1]:xi[3], xi[0]:xi[2], cls] = 255
        label = np.asarray([2.0, 5.0, cls, x1, y1, x2, y2], np.float32)
        hdr = recordio.IRHeader(len(label), label, i, 0)
        if encoder == "pil":
            from PIL import Image
            buf = _pyio.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=95)
            payload = recordio.pack(hdr, buf.getvalue())
        else:
            payload = recordio.pack_img(hdr, img[:, :, ::-1], quality=95)
        writer.write_idx(i, payload)
    writer.close()
    return rec, idx


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-classes", type=int, default=2)
    parser.add_argument("--num-batches", type=int, default=80)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return parser.parse_args(argv)


def make_iter(rec, idx, batch_size):
    """The reference's detection record iterator over the packed file."""
    return io.ImageDetRecordIter(
        path_imgrec=rec, path_imgidx=idx, batch_size=batch_size,
        data_shape=(3, SIDE, SIDE), shuffle=True, rand_mirror=True)


def batches(it, batch_size):
    """Full batches forever, epoch after epoch: (data / 255, labels) as
    CPU NDArrays."""
    while True:
        it.reset()
        for b in it:
            if b.data[0].shape[0] == batch_size:
                yield b.data[0] / 255.0, b.label[0]


def bind(args, device):
    """The bound executor (Xavier on the weights, from numpy's global RNG
    as the reference's) and its SGD updater."""
    net = build_net(args.num_classes, NUM_ANCHORS)
    ex = net.simple_bind(device, data=(args.batch_size, 3, SIDE, SIDE),
                         grad_req="write")
    for name, arr in ex.arg_dict.items():
        if name != "data" and name.endswith(("weight",)):
            initializer.Xavier()(name, arr)
    updater = optimizer.get_updater(optimizer.create(
        "sgd", learning_rate=args.lr, momentum=0.9,
        rescale_grad=1.0 / args.batch_size))
    return ex, updater


def ssd_loss(cls_pred, loc_pred, loc_t, loc_mask, cls_t):
    """Softmax cross-entropy over the targets that are not ignored (over
    their count, at least 1) plus smooth-L1 over ``loc_mask`` (over its
    sum, at least 1): the reference's ``loss_fn``."""
    logp = torch.log_softmax(cls_pred, dim=1)
    # an ignored target (-1) picks the last class, as the reference's
    # take_along_axis does; the selection below drops it
    pick = torch.remainder(cls_t.to(torch.int64), cls_pred.shape[1])
    ce = -logp.gather(1, pick[:, None, :])[:, 0]
    valid = cls_t >= 0
    ce = torch.where(valid, ce, ce.new_zeros(())).sum() / torch.clamp(
        valid.sum(), min=1)
    diff = (loc_pred - loc_t) * loc_mask
    ad = diff.abs()
    l1 = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5).sum() \
        / torch.clamp(loc_mask.sum(), min=1.0)
    return ce + l1


def train_step(ex, updater, x, y, marks=None):
    """One step: forward, targets, loss and head gradients, backward,
    update.  ``marks(stage)`` runs after each of ``"forward"``,
    ``"target"``, ``"loss"``, ``"backward"`` and ``"update"`` (the chip
    smoke records CUDA events there).  Returns the loss, a 0-dim tensor
    on the executor's device."""
    def mark(stage):
        if marks is not None:
            marks(stage)
    anchors, cls_pred, loc_pred = ex.forward(is_train=True, data=x)
    mark("forward")
    loc_t, loc_mask, cls_t = nd.contrib.MultiBoxTarget(
        anchors, y.as_in_context(anchors.context), cls_pred,
        negative_mining_ratio=3.0)
    mark("target")
    cp = cls_pred._data.detach().requires_grad_()
    lp = loc_pred._data.detach().requires_grad_()
    loss = ssd_loss(cp, lp, loc_t._data, loc_mask._data, cls_t._data)
    g_cls, g_loc = torch.autograd.grad(loss, (cp, lp))
    mark("loss")
    ex.backward(out_grads=[nd.zeros(anchors.shape, ctx=anchors.context),
                           nd.NDArray(g_cls), nd.NDArray(g_loc)])
    mark("backward")
    for i, name in enumerate(n for n in ex.arg_dict if n != "data"):
        g = ex.grad_dict.get(name)
        if g is not None:
            updater(i, g, ex.arg_dict[name])
    mark("update")
    return loss.detach()


def detect(ex, x):
    """Inference on one batch: ``softmax`` over the classes and
    ``MultiBoxDetection`` (NMS 0.45, threshold 0.3); (B, N, 6) rows."""
    anchors, cls_pred, loc_pred = ex.forward(is_train=False, data=x)
    cls_prob = nd.softmax(cls_pred, axis=1)
    return nd.contrib.MultiBoxDetection(cls_prob, loc_pred, anchors,
                                        nms_threshold=0.45, threshold=0.3)


def main(argv=None, batch_end_callback=None, workdir=None):
    """Pack, train, detect.  ``batch_end_callback(step, ex, loss)`` runs
    after each update; ``workdir`` holds the ``.rec`` (a new temporary
    directory otherwise).  Returns (losses, image 0's kept detection
    rows)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = cpu() if args.ctx == "cpu" else gpu()
    rng = np.random.RandomState(0)
    encoder = jpeg_encoder()
    logging.info("packing %d records with %s%s", args.batch_size * 8,
                 encoder, "" if encoder == "pil" else
                 " (PIL is missing: not the reference's bytes)")
    workdir = workdir or tempfile.mkdtemp(prefix="mxtpu_torch_ssd_")
    rec, idx = pack_det_records(os.path.join(workdir, "det"),
                                args.batch_size * 8, args.num_classes, rng,
                                encoder)
    with use(device):
        it = make_iter(rec, idx, args.batch_size)
        ex, updater = bind(args, device)
        batch_gen = batches(it, args.batch_size)
        losses = []
        for step in range(args.num_batches):
            x, y = next(batch_gen)
            loss = train_step(ex, updater, x, y)
            losses.append(loss)
            if step % 10 == 0:
                logging.info("step %d  loss %.4f", step, float(loss))
            if batch_end_callback is not None:
                batch_end_callback(step, ex, loss)
        # inference: decode + NMS on a fresh batch from the record pipeline
        x, _ = next(batch_gen)
        kept = detect(ex, x).asnumpy()[0]
    kept = kept[kept[:, 0] >= 0]
    losses = [float(v) for v in losses]
    logging.info("image 0: %d detections after NMS", len(kept))
    return losses, kept


if __name__ == "__main__":
    main()
