"""Analysis passes (counterpart of ``mxnet_tpu.analysis``): the runtime
half of the numerics sentinel, :mod:`.numerics`."""
from . import numerics

__all__ = ["numerics"]
