"""``gluon.data`` (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers, the DataLoader and the vision datasets and transforms."""
from . import vision
from .dataloader import DataLoader
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,
                      SimpleDataset)
from .sampler import (BatchSampler, IntervalSampler, RandomSampler, Sampler,
                      SequentialSampler)

__all__ = ["ArrayDataset", "BatchSampler", "DataLoader", "Dataset",
           "IntervalSampler", "RandomSampler", "RecordFileDataset", "Sampler",
           "SequentialSampler", "SimpleDataset", "vision"]
