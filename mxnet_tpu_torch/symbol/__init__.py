"""``mx.sym`` (counterpart of ``mxnet_tpu/symbol``; reference
``python/mxnet/symbol/``): :class:`Symbol`, variables, groups,
``-symbol.json`` and one graph-building function per op of the table."""
import sys as _sys

from .symbol import (Group, Symbol, Variable, _eval_symbol, load, load_json,
                     var)
from . import register as _register

_register.populate(_sys.modules[__name__].__dict__)
