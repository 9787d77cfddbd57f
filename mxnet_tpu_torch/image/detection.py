"""Detection image pipeline: ImageDetIter and the detection augmenters.

The port's copy of ``mxnet_tpu/image/detection.py`` (reference:
``python/mxnet/image/detection.py``, ImageDetIter and the DetAugmenter
family, and the C++ ``ImageDetRecordIter``, ``src/io/
iter_image_det_recordio.cc`` + ``image_det_aug_default.cc``).  As in
``image.py``, everything here is numpy and OpenCV on the host; batches
are CPU NDArrays.  The random crop, the flip and the select draw from
Python's global ``random``, as the reference's do (``mx.random.seed``
does not reach it; seed ``random`` to replay a stream).

Detection labels ride the record header as a flat vector:
``[header_width, object_width, (extra...), obj0..., obj1..., ...]`` with
each object ``[id, xmin, ymin, xmax, ymax, (extra...)]`` in normalized
coordinates.  Augmenters transform image and boxes together; batches pad
the per-image object list with -1 rows to a fixed label shape, exactly the
contract MultiBoxTarget consumes.
"""
from __future__ import annotations

import random

import numpy as np

from .. import io as _io
from .. import ndarray as nd
from ..base import MXNetError
from .image import (ImageIter, ResizeAug, ForceResizeAug, CastAug,
                    ColorNormalizeAug, Augmenter, fixed_crop)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomSelectAug", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter: __call__(src, label) -> (src, label)
    (reference: detection.py DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Borrow a plain image augmenter (labels pass through) — valid only
    for geometry-preserving augs (color jitter, cast, normalize)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Random horizontal flip mirroring the boxes (reference:
    detection.py DetHorizontalFlipAug / image_det_aug_default.cc)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            tmp = 1.0 - label[valid, 1]
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = tmp
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop with object-coverage constraints (reference:
    detection.py DetRandomCropAug; SSD-style sampling)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[:2]
        crop = self._propose(label)
        if crop is None:
            return src, label
        x0, y0, cw, ch = crop
        new_label = self._update_labels(label, (x0, y0, cw, ch))
        if new_label is None:
            return src, label
        out = fixed_crop(src, int(x0 * w), int(y0 * h),
                         max(1, int(cw * w)), max(1, int(ch * h)))
        return out, new_label

    def _propose(self, label):
        valid = label[label[:, 0] >= 0]
        for _ in range(self.max_attempts):
            area = random.uniform(*self.area_range)
            ratio = random.uniform(*self.aspect_ratio_range)
            cw = min(1.0, np.sqrt(area * ratio))
            ch = min(1.0, np.sqrt(area / ratio))
            x0 = random.uniform(0, 1 - cw)
            y0 = random.uniform(0, 1 - ch)
            if len(valid) == 0:
                return (x0, y0, cw, ch)
            # coverage of each object by the crop
            ix0 = np.maximum(valid[:, 1], x0)
            iy0 = np.maximum(valid[:, 2], y0)
            ix1 = np.minimum(valid[:, 3], x0 + cw)
            iy1 = np.minimum(valid[:, 4], y0 + ch)
            iw = np.clip(ix1 - ix0, 0, None)
            ih = np.clip(iy1 - iy0, 0, None)
            inter = iw * ih
            obj_area = (valid[:, 3] - valid[:, 1]) * \
                (valid[:, 4] - valid[:, 2])
            cover = inter / np.maximum(obj_area, 1e-12)
            if (cover >= self.min_object_covered).any():
                return (x0, y0, cw, ch)
        return None

    def _update_labels(self, label, crop):
        x0, y0, cw, ch = crop
        out = label.copy()
        kept = 0
        for i in range(out.shape[0]):
            if out[i, 0] < 0:
                continue
            bx0 = max(out[i, 1], x0)
            by0 = max(out[i, 2], y0)
            bx1 = min(out[i, 3], x0 + cw)
            by1 = min(out[i, 4], y0 + ch)
            inter = max(0.0, bx1 - bx0) * max(0.0, by1 - by0)
            area = (out[i, 3] - out[i, 1]) * (out[i, 4] - out[i, 2])
            if area <= 0 or inter / area < self.min_eject_coverage:
                out[i, 0] = -1.0   # ejected
                continue
            out[i, 1] = (bx0 - x0) / cw
            out[i, 2] = (by0 - y0) / ch
            out[i, 3] = (bx1 - x0) / cw
            out[i, 4] = (by1 - y0) / ch
            kept += 1
        return out if kept else None


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one augmenter from a list (or skip)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if random.random() < self.skip_prob or not self.aug_list:
            return src, label
        return random.choice(self.aug_list)(src, label)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_pad=0.0,
                       rand_gray=0.0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Build the standard detection augmenter chain (reference:
    detection.py CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                area_range, min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # force to the network input size after geometric augs
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        if mean is True:
            mean = np.array([123.68, 116.28, 103.53])
        if std is True:
            std = np.array([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator over .rec/.lst sources (reference:
    detection.py ImageDetIter ≈ C++ ImageDetRecordIter).

    Emits data (B, C, H, W) and label (B, max_objects, label_width) with
    -1-padded object rows."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 last_batch_handle="pad", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_mirror", "mean", "std",
                         "min_object_covered", "area_range",
                         "aspect_ratio_range", "min_eject_coverage",
                         "max_attempts")})
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         last_batch_handle=last_batch_handle,
                         native_decode=False)
        self.det_auglist = aug_list
        self._label_shape = self._estimate_label_shape()
        self.provide_label = [_io.DataDesc(
            label_name, (batch_size,) + self._label_shape)]

    # -- label plumbing ----------------------------------------------------
    def _parse_label(self, raw):
        """Flat header vector -> (num_obj, obj_width) array (reference:
        ImageDetIter._parse_label)."""
        raw = np.asarray(raw, np.float32).reshape(-1)
        if raw.size < 2:
            raise MXNetError("invalid detection label: too short")
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5:
            raise MXNetError("invalid detection label: object width < 5")
        body = raw[header_width:]
        if body.size % obj_width != 0:
            raise MXNetError("invalid detection label length")
        return body.reshape(-1, obj_width)

    def _estimate_label_shape(self):
        max_count, width = 0, 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                parsed = self._parse_label(label)
                max_count = max(max_count, parsed.shape[0])
                width = max(width, parsed.shape[1])
        except StopIteration:
            pass
        self.reset()
        return (max(1, max_count), width)

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [_io.DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + self.data_shape)]
        if label_shape is not None:
            self._label_shape = tuple(label_shape)
            self.provide_label = [_io.DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + self._label_shape)]

    def augmentation_transform(self, data, label):
        for aug in self.det_auglist:
            data, label = aug(data, label)
        return data, label

    def next(self):
        c, h, w = self.data_shape
        n_obj, lw = self._label_shape
        batch_data = np.zeros((self.batch_size, h, w, c), np.float32)
        batch_label = np.full((self.batch_size, n_obj, lw), -1.0, np.float32)
        i = 0
        try:
            while i < self.batch_size:
                raw_label, s = self.next_sample()
                img = self._decode_raw(s)
                label = self._parse_label(raw_label)
                img, label = self.augmentation_transform(img, label)
                batch_data[i] = np.asarray(img, np.float32)
                k = min(label.shape[0], n_obj)
                batch_label[i, :k, :label.shape[1]] = label[:k]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        if pad:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "keep":
                batch_data = batch_data[:i]
                batch_label = batch_label[:i]
                pad = 0
            else:
                batch_data[i:] = batch_data[i - 1]
                batch_label[i:] = batch_label[i - 1]
        data = nd.array(batch_data.transpose(0, 3, 1, 2), ctx="cpu")
        return _io.DataBatch([data], [nd.array(batch_label, ctx="cpu")],
                             pad=pad)

    def _decode_raw(self, s):
        from .image import imdecode
        return imdecode(s).asnumpy()
