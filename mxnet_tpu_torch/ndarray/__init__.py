"""``mx.nd``: the imperative NDArray API (counterpart of
``mxnet_tpu/ndarray``), with ``save``/``load`` of the ``.params``
container, ``sparse`` (CSR and row-sparse storage) and ``contrib`` (the
contrib ops under their nested names and the control-flow constructs).
The ``linalg_*`` ops are flat ``mx.nd`` names, as in the JAX package,
which has no ``mx.nd.linalg`` submodule."""
import sys as _sys

from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      invoke, load, moveaxis, ones, onehot_encode, save,
                      waitall, zeros)
from . import register as _register
from . import contrib, random, sparse  # noqa: F401

_register.populate(_sys.modules[__name__].__dict__)

# the `mx.nd.op` mirror of the flat namespace
op = _sys.modules[__name__]
