"""Image loading + augmentation pipeline (host-side).

The port's copy of ``mxnet_tpu/image/image.py`` (reference:
``python/mxnet/image/image.py``, ImageIter and the augmenters, and the C++
``ImageRecordIter``, ``src/io/iter_image_recordio_2.cc``, whose default
augmenters are ``src/io/image_aug_default.cc``).

Everything here is numpy and OpenCV on the host, never the card: the
augmenters take and return numpy (an NDArray in gives an NDArray out, on
the input's device, as the reference's API does), ``imdecode`` gives a CPU
NDArray, and ``ImageIter`` yields CPU NDArrays; the batch moves to the
card once, in a ``DeviceFeedIter`` or the trainer.  ``ImageIter.next_numpy``
is the decode core the multi-process pipeline's workers run
(``io/pipeline.py``): it creates no tensor at all, so a worker never
touches CUDA.  When the spatial chain is resize-short plus center crop,
the native libjpeg runtime (``_native``, ``native/mxtpu_io.cc``) decodes
the whole batch in C++ threads.
"""
from __future__ import annotations

import os
import random

import numpy as np

from .. import _native
from .. import io as _io
from .. import ndarray as nd
from .. import recordio
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["imread", "imdecode", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
           "HorizontalFlipAug", "CastAug", "CreateAugmenter", "ImageIter"]


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:
        raise ImportError("image ops require OpenCV (cv2)") from e


def _as_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return np.asarray(img)


def _out(arr, ref, dtype=None):
    """numpy-in -> numpy-out (host pipeline stays on host: zero per-image
    device dispatch); NDArray-in -> NDArray-out on the input's device
    (reference API parity)."""
    if dtype is not None:
        arr = np.ascontiguousarray(arr, dtype=dtype)
    if isinstance(ref, NDArray):
        return nd.array(arr, ctx=ref.context, dtype=arr.dtype)
    return arr


def imdecode(buf, to_rgb=True, flag=1, **kwargs):
    """Decode an image byte buffer to an HWC (RGB by default) CPU NDArray
    (reference: image.py imdecode via cv2)."""
    cv2 = _cv2()
    img = cv2.imdecode(np.frombuffer(buf, dtype=np.uint8), flag)
    if img is None:
        raise MXNetError("cannot decode image")
    if to_rgb and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return nd.array(img, ctx="cpu", dtype=np.uint8)


def imread(filename, to_rgb=True, flag=1):
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


def imresize(src, w, h, interp=1):
    cv2 = _cv2()
    return _out(cv2.resize(_as_np(src), (w, h), interpolation=interp), src)


def scale_down(src_size, size):
    """Scale (w, h) down to fit src_size (reference: image.py scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge equals `size`."""
    cv2 = _cv2()
    img = _as_np(src)
    h, w = img.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return _out(cv2.resize(img, (new_w, new_h), interpolation=interp), src)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    img = _as_np(src)
    out = img[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        cv2 = _cv2()
        out = cv2.resize(out, size, interpolation=interp)
    return _out(out, src)


def random_crop(src, size, interp=2):
    img = _as_np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    img = _as_np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    img = _as_np(src).astype(np.float32)
    img = img - np.asarray(mean, dtype=np.float32)
    if std is not None:
        img = img / np.asarray(std, dtype=np.float32)
    return _out(img, src)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random crop with area/aspect jitter (Inception-style)."""
    img = _as_np(src)
    h, w = img.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = random.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


# ---------------------------------------------------------------------------
# augmenters
# ---------------------------------------------------------------------------
class Augmenter:
    """Image augmenter base (reference: image.py Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        cv2 = _cv2()
        return _out(cv2.resize(_as_np(src), tuple(self.size),
                               interpolation=self.interp), src)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            img = _as_np(src)
            return _out(np.ascontiguousarray(img[:, ::-1]), src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _out(_as_np(src).astype(self.typ), src)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return _out(_as_np(src).astype(np.float32) * alpha, src)


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        img = _as_np(src).astype(np.float32)
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        gray = (img * self._coef).sum(axis=2, keepdims=True).mean()
        return _out(img * alpha + gray * (1 - alpha), src)


class SaturationJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        img = _as_np(src).astype(np.float32)
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        gray = (img * self._coef).sum(axis=2, keepdims=True)
        return _out(img * alpha + gray * (1 - alpha), src)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype=np.float32)

    def __call__(self, src):
        img = _as_np(src).astype(np.float32)
        alpha = random.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      dtype=np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return _out(np.dot(img, t), src)


class ColorJitterAug(SequentialAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        random.shuffle(ts)
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA lighting noise (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd,
                                 size=(3,)).astype(np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _out(_as_np(src).astype(np.float32) + rgb, src)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, dtype=np.float32) \
            if mean is not None else None
        self.std = np.asarray(std, dtype=np.float32) \
            if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _mat = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], dtype=np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return _out(np.dot(_as_np(src).astype(np.float32), self._mat), src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference: image.py CreateAugmenter
    — mirrors the C++ default augmenter chain, image_aug_default.cc)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and (not isinstance(mean, np.ndarray)
                             or mean.shape[0] in (1, 3)):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(_io.DataIter):
    """Image iterator reading .rec files or image lists with augmentation
    (reference: image.py ImageIter ≈ the C++ ImageRecordIter).

    Supports distributed sharding via num_parts/part_index (the reference
    shards the RecordIO file by worker rank)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 last_batch_handle="pad", layout="NCHW",
                 preprocess_threads=0, **kwargs):
        super().__init__(batch_size)
        # decode-thread count for the native libjpeg pipeline (reference:
        # preprocess_threads on ImageRecordIter, iter_image_recordio_2.cc
        # OMP team); 0 = min(host cores, 16)
        self.preprocess_threads = int(preprocess_threads)
        assert len(data_shape) == 3 and data_shape[0] in (1, 3)
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.dtype = dtype
        # layout="NHWC" emits batches exactly as the decoder produces them
        # (HWC): no host-side transpose, and uint8 dtype keeps the
        # host->device transfer 4x narrower; normalization then runs on
        # the device (io/device_tail.py)
        assert layout in ("NCHW", "NHWC")
        self.layout = layout

        self.imgrec = None
        self.imglist = None
        self.seq = None
        self._offsets = None

        if path_imgrec:
            idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.isfile(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                         "r")
                self.seq = list(self.imgrec.keys)
            else:
                # no .idx sidecar: build an in-memory offset index with one
                # sequential scan so shuffle / num_parts sharding still work
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self._offsets = []
                while True:
                    pos = self.imgrec.tell()
                    if self.imgrec.read() is None:
                        break
                    self._offsets.append(pos)
                self.imgrec.reset()
                self.seq = list(range(len(self._offsets)))
        elif path_imglist or imglist is not None:
            if path_imglist:
                imglist_dict = {}
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = np.array(parts[1:-1], dtype=np.float32)
                        imglist_dict[int(parts[0])] = (label, parts[-1])
            else:
                imglist_dict = {}
                for i, item in enumerate(imglist):
                    imglist_dict[i] = (np.array(item[:-1], dtype=np.float32),
                                       item[-1])
            self.imglist = imglist_dict
            self.path_root = path_root
            self.seq = list(imglist_dict.keys())
        else:
            raise ValueError("need path_imgrec, path_imglist or imglist")

        # distributed sharding (reference: kv.num_workers/rank split)
        if num_parts > 1 and self.seq is not None:
            n_per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n_per:(part_index + 1) * n_per]

        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast", "saturation",
                         "hue", "pca_noise", "rand_gray", "inter_method")})
        self.auglist = aug_list

        # native fast path: when the spatial part of the chain is
        # deterministic resize+center-crop, the C++ runtime decodes the
        # whole batch in parallel (native/mxtpu_io.cc — the
        # ImageRecordIOParser2 analogue); remaining per-pixel augs
        # (cast/normalize) apply batched
        self._native_resize = 0
        self._native_tail = None
        if kwargs.get("native_decode", True):
            spatial, tail = [], []
            for aug in aug_list:
                if isinstance(aug, (ResizeAug, CenterCropAug)):
                    spatial.append(aug)
                else:
                    tail.append(aug)
            resize = next((a.size for a in spatial
                           if isinstance(a, ResizeAug)), 0)
            # the native pipeline is resize-short (optional) + center-crop
            # to data_shape — exactly ResizeAug/CenterCropAug semantics, so
            # engage whenever the spatial chain is those two (in any
            # combination, including none) and every crop targets data_shape
            target = (data_shape[2], data_shape[1])
            crops_ok = all(a.size == target for a in spatial
                           if isinstance(a, CenterCropAug))
            if crops_ok and \
                    all(isinstance(a, (CastAug, ColorNormalizeAug))
                        for a in tail):
                if _native.available():
                    self._native_resize = resize
                    self._native_tail = tail

        c, h, w = self.data_shape
        dshape = (batch_size, h, w, c) if layout == "NHWC" \
            else (batch_size,) + self.data_shape
        self.provide_data = [_io.DataDesc(data_name, dshape, np.dtype(dtype),
                                          layout=layout)]
        if label_width > 1:
            self.provide_label = [_io.DataDesc(label_name,
                                               (batch_size, label_width))]
        else:
            self.provide_label = [_io.DataDesc(label_name, (batch_size,))]
        self.cur = 0
        self._allow_read = True
        self.last_batch_handle = last_batch_handle
        self._cache_data = None
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """Read one (label, image-bytes) sample."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                if getattr(self, "_offsets", None) is not None:
                    s = self.imgrec.read_at(self._offsets[idx])
                else:
                    s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _decode_one(self, s):
        """cv2-decode one record payload through the full augmenter chain."""
        decode_flag = 1 if self.data_shape[0] == 3 else 0
        img = _cv2().imdecode(np.frombuffer(s, dtype=np.uint8), decode_flag)
        if img is None:
            raise MXNetError("cannot decode image record")
        if decode_flag == 1:
            img = _cv2().cvtColor(img, _cv2().COLOR_BGR2RGB)
        for aug in self.auglist:
            img = _as_np(aug(img))
        if img.ndim == 2:
            img = img[:, :, None]
        return img

    def next(self):
        data, label, pad = self.next_numpy()
        d = nd.array(data, ctx="cpu", dtype=self.dtype)
        lab = nd.array(label if self.label_width > 1 else label[:, 0],
                       ctx="cpu")
        return _io.DataBatch([d], [lab], pad=pad)

    def next_numpy(self):
        """One batch as ``(data, label, pad)`` *numpy* arrays — the host
        side of ``next()`` with no device arrays created.  The
        multi-process pipeline workers (io/pipeline.py) call this so a
        worker never creates a tensor, on the card or anywhere; ``label``
        always has shape (B, label_width)."""
        if self._native_tail is not None:
            return self._next_native_numpy()
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, h, w, c), dtype=np.float32)
        lw = self.label_width
        batch_label = np.zeros((self.batch_size, lw), dtype=np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                batch_data[i] = self._decode_one(s)
                batch_label[i] = np.asarray(label, np.float32).reshape(-1)[:lw]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = self.batch_size - i
        if pad:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "keep":
                # emit the partial tail as-is (C++ round_batch=0)
                batch_data = batch_data[:i]
                batch_label = batch_label[:i]
                pad = 0
            else:
                # pad by repeating the last valid sample (reference C++
                # iterator); DataBatch.pad tells consumers how many to drop
                batch_data[i:] = batch_data[i - 1]
                batch_label[i:] = batch_label[i - 1]
        if self.layout != "NHWC":
            batch_data = batch_data.transpose(0, 3, 1, 2)
        return (batch_data.astype(self.dtype, copy=False), batch_label, pad)

    def _next_native_numpy(self):
        """Batch decode through the C++ runtime (deterministic pipelines)."""
        c, h, w = self.data_shape
        lw = self.label_width
        bufs, labels = [], []
        try:
            while len(bufs) < self.batch_size:
                label, s = self.next_sample()
                bufs.append(bytes(s))
                labels.append(np.asarray(label, np.float32).reshape(-1)[:lw])
        except StopIteration:
            if not bufs:
                raise
        pad = self.batch_size - len(bufs)
        if pad:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle != "keep":
                bufs.extend([bufs[-1]] * pad)
                labels.extend([labels[-1]] * pad)
                # keep pad count; 'keep' emits partial
        if not all(b[:2] == b"\xff\xd8" for b in bufs):
            # non-JPEG records (e.g. PNG-packed .rec): libjpeg can't decode
            # them — permanently fall back to the cv2 python path
            self._native_tail = None
            return self._decode_python_bufs(bufs, labels, pad)
        decoded, fails = _native.decode_batch(
            bufs, h, w, c, resize_short=self._native_resize,
            num_threads=self.preprocess_threads)
        if fails:
            raise MXNetError("%d corrupt image records in batch" % fails)
        if np.dtype(self.dtype) == np.uint8 and not any(
                isinstance(a, ColorNormalizeAug) for a in self._native_tail):
            batch = decoded           # raw uint8 pass-through, no host copy
        else:
            batch = decoded.astype(np.float32)
            for aug in self._native_tail:
                if isinstance(aug, ColorNormalizeAug):
                    if aug.mean is not None:
                        batch = batch - aug.mean
                    if aug.std is not None:
                        batch = batch / aug.std
                elif isinstance(aug, CastAug):
                    batch = batch.astype(aug.typ)
        if self.layout != "NHWC":
            batch = batch.transpose(0, 3, 1, 2)
        lab = np.stack(labels).reshape(-1, lw)
        return (batch.astype(self.dtype, copy=False), lab,
                0 if self.last_batch_handle == "keep" else pad)

    def _decode_python_bufs(self, bufs, labels, pad):
        """cv2-decode pre-collected record buffers (fallback from the
        native path)."""
        lw = self.label_width
        batch = np.stack([self._decode_one(s) for s in bufs]) \
            .astype(np.float32)
        if self.layout != "NHWC":
            batch = batch.transpose(0, 3, 1, 2)
        lab = np.stack(labels).reshape(-1, lw)
        return (batch.astype(self.dtype, copy=False), lab,
                0 if self.last_batch_handle == "keep" else pad)
