"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
the contrib ops of the layer slice under their nested names, the same
functions as the flat ``mx.nd`` ones.  The control-flow constructs
(``foreach``, ``while_loop``, ``cond``) and the box, ROI, quantization
and interleaved-matmul ops are not ported yet."""
import sys as _sys

from . import register as _register

_NAMES = ("CTCLoss", "ctc_loss", "im2col", "col2im", "flash_attention")


def _export():
    ns = _register.populate({})
    mod = _sys.modules[__name__]
    for name in _NAMES:
        setattr(mod, name, ns[name])


_export()
