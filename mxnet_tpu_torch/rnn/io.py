"""Bucketing data iterator for variable-length sequences: the port of
``mxnet_tpu/rnn/io.py`` (reference: python/mxnet/rnn/io.py).

``BucketSentenceIter`` puts each sentence in the smallest bucket that
fits it, pads it there with ``invalid_label`` and emits batches tagged
with ``bucket_key`` for ``BucketingModule``.  Its shuffles draw from
Python's ``random`` and numpy's global RNG, as the reference's do, so
one seed of both gives the reference's batches bitwise.  Batches are
host NDArrays (``ctx="cpu"``); the module moves them to its device.
"""
from __future__ import annotations

import bisect
import random

import numpy as _np

from .. import ndarray as nd
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lengths = [len(s) for s in sentences]
            max_len = max(lengths)
            counts = _np.bincount(lengths, minlength=max_len + 1)
            buckets = [i for i, j in enumerate(counts) if j >= batch_size]
            if not buckets:
                buckets = [max_len]
        buckets.sort()
        self.buckets = buckets
        self.data = [[] for _ in buckets]
        self.invalid_label = invalid_label

        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                continue
            buff = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # empty buckets become (0, bucket_len) so the label shift in reset()
        # stays 2-D
        self.data = [_np.asarray(i, dtype=dtype) if i else
                     _np.zeros((0, buckets[k]), dtype=dtype)
                     for k, i in enumerate(self.data)]

        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)

        shape = (batch_size, self.default_bucket_key) if self.major_axis == 0 \
            else (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            # language-model convention: label is data shifted left by one
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data = data.T
            label = label.T
        shape = data.shape
        return DataBatch([nd.array(data, ctx="cpu")],
                         [nd.array(label, ctx="cpu")], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name, shape,
                                                 layout=self.layout)])
