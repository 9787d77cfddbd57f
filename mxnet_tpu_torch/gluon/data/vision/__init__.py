"""`gluon.data.vision`: the port of ``mxnet_tpu/gluon/data/vision/``
(reference: python/mxnet/gluon/data/vision/)."""
from . import transforms
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset)
