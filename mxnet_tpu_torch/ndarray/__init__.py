"""``mx.nd``: the imperative NDArray API (counterpart of
``mxnet_tpu/ndarray``), with ``save``/``load`` of the ``.params``
container and the ``contrib`` ops of the layer slice.  ``linalg`` and
``sparse`` are not ported yet."""
import sys as _sys

from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      invoke, load, moveaxis, ones, onehot_encode, save,
                      waitall, zeros)
from . import register as _register
from . import contrib, random  # noqa: F401

_register.populate(_sys.modules[__name__].__dict__)

# the `mx.nd.op` mirror of the flat namespace
op = _sys.modules[__name__]
