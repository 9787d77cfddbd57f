"""Faster R-CNN lite, the two-stage detector end to end: the port of
``examples/rcnn/train_rcnn_lite.py``.

    python -m mxnet_tpu_torch.tools.train_rcnn_lite [--steps 60]
        [--batch 8] [--ctx gpu|cpu]

Reference: ``example/rcnn/``: RPN (anchor classification and box
regression) -> ``Proposal`` -> ``ROIAlign`` -> a classification head,
with anchors assigned through ``bipartite_matching``.  The task is the
reference's synthetic one: each 64 x 64 image holds one axis-aligned
coloured square, which the RPN must localize and the head classify by
colour.  Gluon and autograd, Adam at 2e-3.  The script asserts that the
model learns: head accuracy on the ground-truth rois of 32 held-out
images at least 0.8, proposal recall at IoU 0.3 at least 0.5.  Runs on
the card unless ``--ctx cpu``; :func:`main` returns the losses, the head
accuracy and the recall.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import autograd, gluon, init, nd
from ..context import cpu, gpu, use
from ..ops.contrib import _gen_anchors

__all__ = ["make_sample", "make_batch", "RCNNLite", "anchor_grid",
           "rpn_targets", "head_rois_and_targets", "parse_args", "main"]

IMG = 64
STRIDE = 4
SCALES = (3, 5, 8)
NCLASS = 3  # colors


def make_sample(rng):
    """One image with one colored square; returns (chw image, gt box, cls)."""
    cls = rng.randint(NCLASS)
    size = rng.randint(14, 28)
    x0 = rng.randint(2, IMG - size - 2)
    y0 = rng.randint(2, IMG - size - 2)
    img = rng.randn(3, IMG, IMG).astype(np.float32) * 0.1
    img[cls, y0:y0 + size, x0:x0 + size] += 1.5
    return img, np.array([x0, y0, x0 + size, y0 + size], np.float32), cls


def make_batch(rng, n):
    imgs, boxes, clss = zip(*[make_sample(rng) for _ in range(n)])
    return (np.stack(imgs), np.stack(boxes),
            np.array(clss, np.int64))


class RCNNLite(gluon.nn.HybridBlock):
    def __init__(self, num_anchors):
        super().__init__()
        self.backbone = gluon.nn.HybridSequential()
        self.backbone.add(
            gluon.nn.Conv2D(16, 3, strides=2, padding=1, activation="relu"),
            gluon.nn.Conv2D(32, 3, strides=2, padding=1, activation="relu"),
        )
        self.rpn_conv = gluon.nn.Conv2D(32, 3, padding=1, activation="relu")
        self.rpn_cls = gluon.nn.Conv2D(2 * num_anchors, 1)
        self.rpn_box = gluon.nn.Conv2D(4 * num_anchors, 1)
        self.head = gluon.nn.HybridSequential()
        self.head.add(gluon.nn.Dense(64, activation="relu"),
                      gluon.nn.Dense(NCLASS + 1))

    def features(self, x):
        f = self.backbone(x)
        r = self.rpn_conv(f)
        return f, self.rpn_cls(r), self.rpn_box(r)


def anchor_grid(num_anchors, fh, fw):
    """All anchors (A*fh*fw, 4) in corner format, matching the Proposal
    op's anchor enumeration (contrib/proposal.cc)."""
    base = np.asarray(_gen_anchors(list(SCALES), [1.0], float(STRIDE)))
    shifts_x = np.arange(fw) * STRIDE
    shifts_y = np.arange(fh) * STRIDE
    sx, sy = np.meshgrid(shifts_x, shifts_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


def _iou_np(boxes, gt):
    """IoU of (A,4) anchors vs (4,) gt, numpy corner format."""
    x0 = np.maximum(boxes[:, 0], gt[0])
    y0 = np.maximum(boxes[:, 1], gt[1])
    x1 = np.minimum(boxes[:, 2], gt[2])
    y1 = np.minimum(boxes[:, 3], gt[3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_g = (gt[2] - gt[0]) * (gt[3] - gt[1])
    return inter / (area_a + area_g - inter + 1e-9)


def rpn_targets(anchors, gt_boxes):
    """Anchor labels/regression targets: IoU>=0.5 positives plus the
    bipartite best-anchor-per-gt claim (reference: rcnn anchor assignment
    via the bipartite_matching op)."""
    B = gt_boxes.shape[0]
    A = anchors.shape[0]
    labels = np.zeros((B, A), np.float32)
    bbox_t = np.zeros((B, A, 4), np.float32)
    ious = np.stack([_iou_np(anchors, gt_boxes[b]) for b in range(B)])
    # one batched bipartite_matching call: each gt claims its best anchor
    match, _ = nd.contrib.bipartite_matching(
        nd.array(ious.reshape(B, 1, A)), threshold=1e-6)
    best = match.asnumpy().reshape(B).astype(int)
    for b in range(B):
        pos = ious[b] >= 0.5
        pos[best[b]] = True
        labels[b] = pos.astype(np.float32)
        gx0, gy0, gx1, gy1 = gt_boxes[b]
        gcx, gcy = (gx0 + gx1) / 2, (gy0 + gy1) / 2
        gw, gh = gx1 - gx0, gy1 - gy0
        acx = (anchors[:, 0] + anchors[:, 2]) / 2
        acy = (anchors[:, 1] + anchors[:, 3]) / 2
        aw = anchors[:, 2] - anchors[:, 0]
        ah = anchors[:, 3] - anchors[:, 1]
        bbox_t[b, :, 0] = (gcx - acx) / aw
        bbox_t[b, :, 1] = (gcy - acy) / ah
        bbox_t[b, :, 2] = np.log(gw / aw)
        bbox_t[b, :, 3] = np.log(gh / ah)
    return labels, bbox_t, ious


def head_rois_and_targets(net, x, gt_boxes, gt_cls, rng):
    """Proposals from the RPN (+gt box as one roi, standard rcnn practice)
    with class targets by IoU."""
    B = x.shape[0]
    with autograd.pause():
        f, cls, box = net.features(nd.array(x))
        A = len(SCALES)
        fh, fw = f.shape[2], f.shape[3]
        score = nd.reshape(cls, (B, 2 * A, fh, fw))
        sm = nd.softmax(nd.reshape(score, (B, 2, A * fh * fw)), axis=1)
        sm = nd.reshape(sm, (B, 2 * A, fh, fw))
        im_info = nd.array(np.tile([IMG, IMG, 1.0], (B, 1)))
        rois = nd.contrib.Proposal(
            sm, box, im_info, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=7,
            threshold=0.7, rpn_min_size=4, scales=SCALES, ratios=(1.0,),
            feature_stride=STRIDE).asnumpy()
    # append the gt box per image so the head always sees one positive
    gt_rois = np.concatenate(
        [np.arange(B, dtype=np.float32)[:, None], gt_boxes], axis=1)
    rois = np.concatenate([rois, gt_rois], axis=0)
    # class target: IoU with the image's gt >= 0.5 -> gt class, else bg 0
    tgt = np.zeros(len(rois), np.int64)
    for i, r in enumerate(rois):
        b = int(r[0])
        iou = float(_iou_np(r[None, 1:], gt_boxes[b])[0])
        if iou >= 0.5:
            tgt[i] = gt_cls[b] + 1
    return rois, tgt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return ap.parse_args(argv)


def main(argv=None, step_callback=None):
    """Train and evaluate; ``step_callback(step, net, loss)`` runs after
    each update.  Returns (losses, head accuracy, recall) after the two
    asserts."""
    args = parse_args(argv)
    with use(cpu() if args.ctx == "cpu" else gpu()):
        return _run(args, step_callback)


def _run(args, step_callback):
    rng = np.random.RandomState(0)
    A = len(SCALES)
    net = RCNNLite(A)
    net.initialize(init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 2e-3})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=False)

    fh = fw = IMG // STRIDE
    anchors = anchor_grid(A, fh, fw)

    losses = []
    for step in range(args.steps):
        x, gt_boxes, gt_cls = make_batch(rng, args.batch)
        labels, bbox_t, _ = rpn_targets(anchors, gt_boxes)
        rois, head_tgt = head_rois_and_targets(net, x, gt_boxes, gt_cls, rng)
        with autograd.record():
            f, cls, box = net.features(nd.array(x))
            B = x.shape[0]
            # RPN objectness: (B, A, fh, fw) fg logits vs assigned labels
            logits = nd.reshape(cls, (B, 2, A, fh, fw))
            # Proposal enumerates anchors position-major (H, W, A):
            # transpose so the labels (built the same way) line up
            fg = nd.reshape(nd.transpose(logits[:, 1] - logits[:, 0],
                                         (0, 2, 3, 1)), (B, -1))
            rpn_cls_loss = bce(fg, nd.array(labels)).mean()
            # RPN bbox smooth-l1 on positives
            pred_box = nd.reshape(
                nd.transpose(nd.reshape(box, (B, A, 4, fh, fw)),
                             (0, 3, 4, 1, 2)), (B, -1, 4))
            diff = pred_box - nd.array(bbox_t.reshape(B, -1, 4))
            sl1 = nd.smooth_l1(diff, scalar=3.0)
            mask = nd.array(labels).reshape((B, -1, 1))
            rpn_box_loss = (sl1 * mask).sum() / (mask.sum() + 1)
            # head classification over ROIAlign features
            pooled = nd.contrib.ROIAlign(
                f, nd.array(rois.astype(np.float32)), pooled_size=(4, 4),
                spatial_scale=1.0 / STRIDE, sample_ratio=2)
            head_logits = net.head(pooled)
            head_loss = ce(head_logits, nd.array(head_tgt)).mean()
            loss = rpn_cls_loss + rpn_box_loss + head_loss
        loss.backward()
        trainer.step(args.batch)
        losses.append(loss)
        if step_callback is not None:
            step_callback(step, net, loss)
        if step % 20 == 0:
            print("step %d loss %.4f (rpn_cls %.4f box %.4f head %.4f)"
                  % (step, float(loss.asscalar()),
                     float(rpn_cls_loss.asscalar()),
                     float(rpn_box_loss.asscalar()),
                     float(head_loss.asscalar())))

    # -- evaluation: classify the gt-box roi + proposal recall ------------
    x, gt_boxes, gt_cls = make_batch(np.random.RandomState(99), 32)
    with autograd.pause():
        f, cls, box = net.features(nd.array(x))
        gt_rois = np.concatenate(
            [np.arange(32, dtype=np.float32)[:, None], gt_boxes], axis=1)
        pooled = nd.contrib.ROIAlign(
            f, nd.array(gt_rois.astype(np.float32)), pooled_size=(4, 4),
            spatial_scale=1.0 / STRIDE, sample_ratio=2)
        pred = net.head(pooled).asnumpy().argmax(1)
        head_acc = float((pred == gt_cls + 1).mean())

        B = 32
        A_ = len(SCALES)
        fh, fw = f.shape[2], f.shape[3]
        sm = nd.reshape(nd.softmax(nd.reshape(cls, (B, 2, A_ * fh * fw)),
                                   axis=1), (B, 2 * A_, fh, fw))
        im_info = nd.array(np.tile([IMG, IMG, 1.0], (B, 1)))
        rois = nd.contrib.Proposal(
            sm, box, im_info, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=4,
            threshold=0.7, rpn_min_size=4, scales=SCALES, ratios=(1.0,),
            feature_stride=STRIDE).asnumpy()
        hits = 0
        for b in range(B):
            mine = rois[rois[:, 0] == b][:, 1:]
            if len(mine) == 0:
                continue
            hits += float(_iou_np(mine, gt_boxes[b]).max()) >= 0.3
        recall = hits / B
    print("head accuracy on gt rois: %.3f; proposal recall@0.3: %.3f"
          % (head_acc, recall))
    assert head_acc >= 0.8, head_acc
    assert recall >= 0.5, recall
    print("RCNN-lite OK")
    return [float(v.asscalar()) for v in losses], head_acc, recall


if __name__ == "__main__":
    main()
