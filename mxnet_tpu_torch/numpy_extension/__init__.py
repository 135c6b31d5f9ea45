"""``mx.npx``: NumPy-extension operators (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``; reference
``python/mxnet/numpy_extension/``): the neural-network ops that have no
NumPy equivalent, beside ``mx.np``, and the ``set_np()`` switch.

Each op runs one op of the port's op table and returns ``mx.np.ndarray``
views.  ``layer_norm`` over the last axis reaches the ``layernorm_fwd``
hand kernel through the ``LayerNorm`` op on the card; ``batch_norm`` is
the plain ``BatchNorm`` op, unfused, as in the JAX package.
"""
from __future__ import annotations

# NDArray and np_array are in the namespace as in the JAX package's npx
from ..ndarray import NDArray  # noqa: F401
from ..ndarray import ndarray as _nd_mod
from ..numpy import _view, _views
from ..numpy import array as np_array  # noqa: F401
from ..ops.registry import get_op

_np_active = False


def set_np(shape=True, array=True):
    """Turn NumPy semantics on (reference: ``npx.set_np``): a Gluon
    block called on NDArrays then returns ``mx.np.ndarray`` views
    (``gluon/block.py :: Block.__call__``)."""
    global _np_active
    _np_active = bool(array)


def reset_np():
    global _np_active
    _np_active = False


def is_np_array():
    return _np_active


def is_np_shape():
    return _np_active


def _call(opname, tensor_args, **params):
    return _views(_nd_mod.invoke(get_op(opname), tensor_args, params))


def relu(data):
    return _call("relu", [data])


def sigmoid(data):
    return _call("sigmoid", [data])


def softmax(data, axis=-1):
    return _call("softmax", [data], axis=axis)


def log_softmax(data, axis=-1):
    return _call("log_softmax", [data], axis=axis)


def activation(data, act_type="relu"):
    return _call("Activation", [data], act_type=act_type)


def fully_connected(x, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    return _call("FullyConnected", [x, weight, bias],
                 num_hidden=num_hidden,
                 no_bias=no_bias or bias is None, flatten=flatten)


def convolution(data, weight, bias=None, kernel=(1, 1), stride=(1, 1),
                pad=(0, 0), num_filter=0, no_bias=False, **kwargs):
    return _call("Convolution", [data, weight, bias], kernel=kernel,
                 stride=stride, pad=pad, num_filter=num_filter,
                 no_bias=no_bias or bias is None, **kwargs)


def pooling(data, kernel=(2, 2), stride=None, pad=(0, 0),
            pool_type="max", **kwargs):
    return _call("Pooling", [data], kernel=kernel,
                 stride=stride or kernel, pad=pad, pool_type=pool_type,
                 **kwargs)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, **kwargs):
    return _call("BatchNorm", [x, gamma, beta, running_mean, running_var],
                 eps=eps, momentum=momentum, **kwargs)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return _call("LayerNorm", [data, gamma, beta], axis=axis, eps=eps)


def embedding(data, weight, input_dim=0, output_dim=0):
    return _call("Embedding", [data, weight], input_dim=input_dim,
                 output_dim=output_dim)


def one_hot(data, depth, on_value=1.0, off_value=0.0):
    return _call("one_hot", [data], depth=depth, on_value=on_value,
                 off_value=off_value)


def pick(data, index, axis=-1, keepdims=False):
    return _call("pick", [data, index], axis=axis, keepdims=keepdims)


def topk(data, k=1, axis=-1, ret_typ="indices"):
    return _call("topk", [data], k=k, axis=axis, ret_typ=ret_typ)


def reshape_like(lhs, rhs):
    return _call("reshape_like", [lhs, rhs])


def save(file, arr_dict):
    """Reference: ``npx.save``; the ``.params`` container of
    ``mx.nd.save``."""
    _nd_mod.save(file, arr_dict)


def load(file):
    return {k: _view(v) for k, v in _nd_mod.load(file).items()}


def seed(s):
    from .. import random as rnd
    rnd.seed(s)


def waitall():
    _nd_mod.waitall()
