"""``mx.io`` (counterpart of ``mxnet_tpu/io``): the legacy data
iterators and ``ImageRecordIter``."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, ImageRecordIter,
                 MNISTIter, NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "ImageRecordIter",
           "MNISTIter", "NDArrayIter", "PrefetchingIter", "ResizeIter"]
