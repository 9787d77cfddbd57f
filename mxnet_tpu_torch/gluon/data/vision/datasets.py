"""Vision datasets: the port of ``mxnet_tpu/gluon/data/vision/datasets.py``
(reference: python/mxnet/gluon/data/vision/datasets.py).

MNIST, FashionMNIST, CIFAR10 and CIFAR100 read their files from a local
``root`` directory (downloads are not ported); images are CPU NDArrays
(HWC uint8), labels numpy.  ``ImageRecordDataset`` decodes with OpenCV
(``image.imdecode``).
"""
from __future__ import annotations

import gzip
import os
import struct
import tarfile

import numpy as np

from .... import ndarray as nd
from .... import recordio as _recordio
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx files (reference: datasets.py MNIST; format parity
    with src/io/iter_mnist.cc)."""

    _base_files = {
        True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _find(self, fname):
        for cand in (fname, fname[:-3]):  # allow unzipped
            p = os.path.join(self._root, cand)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(
            "%s not found under %s (no network egress; place the idx files "
            "there manually)" % (fname, self._root))

    def _get_data(self):
        img_file, lab_file = self._base_files[self._train]
        img_path = self._find(img_file)
        lab_path = self._find(lab_file)

        def _open(p):
            return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")

        with _open(lab_path) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
        with _open(img_path) as fin:
            _, n, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(n, rows, cols, 1)
        self._data = nd.array(data, ctx="cpu", dtype=np.uint8)
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the binary batches (reference: datasets.py CIFAR10)."""

    _archive = "cifar-10-binary.tar.gz"
    _train_names = ["data_batch_%d.bin" % i for i in range(1, 6)]
    _test_names = ["test_batch.bin"]
    _ncats = 1

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, path):
        with open(path, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        row = 3072 + self._ncats
        raw = raw.reshape(-1, row)
        data = raw[:, self._ncats:].reshape(-1, 3, 32, 32)
        return (data.transpose(0, 2, 3, 1),
                raw[:, self._ncats - 1].astype(np.int32))

    def _locate(self, name):
        for cand in (os.path.join(self._root, name),
                     os.path.join(self._root, "cifar-10-batches-bin", name),
                     os.path.join(self._root, "cifar-100-binary", name)):
            if os.path.isfile(cand):
                return cand
        # try extracting a local archive copy
        arc = os.path.join(self._root, self._archive)
        if os.path.isfile(arc):
            with tarfile.open(arc) as tf:
                tf.extractall(self._root)
            return self._locate(name)
        raise FileNotFoundError(
            "%s not found under %s (no network egress; place the CIFAR "
            "binaries there manually)" % (name, self._root))

    def _get_data(self):
        names = self._train_names if self._train else self._test_names
        data, label = zip(*[self._read_batch(self._locate(n)) for n in names])
        self._data = nd.array(np.concatenate(data), ctx="cpu",
                              dtype=np.uint8)
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    _archive = "cifar-100-binary.tar.gz"
    _train_names = ["train.bin"]
    _test_names = ["test.bin"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._ncats = 2
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, path):
        with open(path, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        row = 3072 + 2
        raw = raw.reshape(-1, row)
        data = raw[:, 2:].reshape(-1, 3, 32, 32)
        lab = raw[:, 1 if self._fine else 0].astype(np.int32)
        return data.transpose(0, 2, 3, 1), lab


class ImageRecordDataset(RecordFileDataset):
    """Dataset over an image RecordIO file
    (reference: datasets.py ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image as _img
        record = super().__getitem__(idx)
        header, img = _recordio.unpack(record)
        decoded = _img.imdecode(img, flag=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(decoded, label)
        return decoded, label


class ImageFolderDataset(Dataset):
    """folder/label/img.jpg layout (reference: datasets.py
    ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image as _img
        img = _img.imread(self.items[idx][0], flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
