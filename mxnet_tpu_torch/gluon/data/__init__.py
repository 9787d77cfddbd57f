"""`gluon.data`: the port of ``mxnet_tpu/gluon/data/`` (reference:
python/mxnet/gluon/data/)."""
from . import vision
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .dataloader import DataLoader
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
