"""Basic Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential`` with its BatchNorm+ReLU fusion plan, ``Dense``,
``BatchNorm``, ``SyncBatchNorm``, ``Flatten``, ``Dropout``,
``Embedding``, ``LayerNorm``, ``InstanceNorm``, ``GroupNorm``,
``Lambda`` and ``HybridLambda``."""
from __future__ import annotations

import math

from ... import autograd
from ... import ops
from ...base import MXNetError
from ...symbol.symbol import Symbol
from ..block import Block, HybridBlock
from ..parameter import _dtype
from .activations import Activation

__all__ = ["BatchNorm", "Dense", "Dropout", "Embedding", "Flatten",
           "GroupNorm", "HybridLambda", "HybridSequential", "InstanceNorm",
           "Lambda", "LayerNorm", "Sequential", "SyncBatchNorm"]


class Sequential(Block):
    """Stack of blocks run in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._children)), b)

    def forward(self, x):
        for b in self._children.values():
            x = b(x)
        return x

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


def _bn_relu_fusion_plan(children, ndim):
    """Pair each channels-last ``BatchNorm`` or ``SyncBatchNorm``
    directly followed by a relu ``Activation`` for the fused op.

    Returns ``[(block, fused)]``; ``fused=True`` marks a BatchNorm whose
    trailing relu runs inside ``_forward_fused_relu`` (the Activation is
    consumed).  The port has no switch for the kernel tier, so the plan
    is always armed; a BatchNorm whose axis is not the input's last
    (``ndim`` axes) stays unpaired and runs BatchNorm then Activation,
    which is what the fused op computes for it in the JAX package.
    ``ndim`` None (a symbol, whose rank is unknown) raises where the
    pairing depends on it."""
    blocks = list(children)
    plan = []
    i = 0
    while i < len(blocks):
        b = blocks[i]
        nxt = blocks[i + 1] if i + 1 < len(blocks) else None
        pair = type(b) in (BatchNorm, SyncBatchNorm) \
            and type(nxt) is Activation and nxt._act == "relu"
        if pair and b._axis != -1 and ndim is None:
            raise MXNetError(
                "HybridSequential: the graph pairs BatchNorm(axis=%d) "
                "with its relu only when that axis is the input's last; "
                "run the block once at its input shape before export"
                % b._axis)
        if pair and b._axis in (-1, (ndim or 0) - 1):
            plan.append((b, True))
            i += 2
            continue
        plan.append((b, False))
        i += 1
    return plan


class HybridSequential(HybridBlock):
    """Stack of hybrid blocks run in order, BatchNorm+ReLU pairs fused.
    The rank of the last tensor it ran on decides the pairs of its
    symbol graph (``export``), so the graph fuses where the tensor
    forward does."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        object.__setattr__(self, "_ndim", None)

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._children)), b)

    def hybrid_forward(self, F, x):
        if not isinstance(x, Symbol):
            object.__setattr__(self, "_ndim", x.dim())
        for b, fused in _bn_relu_fusion_plan(self._children.values(),
                                             self._ndim):
            x = b._forward_fused_relu(x) if fused else b(x)
        return x

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class Dense(HybridBlock):
    """Fully-connected layer; weight ``(units, in_units)``, ``in_units``
    deferred when 0."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        if self.weight._sharding is not None:
            from ...parallel.tensor_parallel import dense_in_units
            in_units = dense_in_units(self, in_units)
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        sh = self.weight._sharding
        if sh is not None and not sh.is_replicated:
            # column- or row-parallel over a mesh axis
            from ...parallel.tensor_parallel import dense_forward
            return dense_forward(F, self, x, weight, bias)
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class BatchNorm(HybridBlock):
    """Batch normalization with MXNet's running statistics, which the
    layer updates in place after each training forward (a captured
    graph keeps its running statistics accumulating)."""

    # the batch axis a data-parallel TrainStep sets for its step's
    # forward (a collectives.BatchSync), else None
    _batch_sync = None

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, grad_req="null",
                allow_deferred_init=True)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, grad_req="null",
                allow_deferred_init=True)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (c,)

    def _op_kwargs(self, symbolic=False):
        kwargs = dict(eps=self._eps, momentum=self._momentum,
                      fix_gamma=not self._scale,
                      use_global_stats=self._use_global_stats,
                      axis=self._axis)
        if not symbolic:
            # a graph's node takes the mode of the walk that runs it
            kwargs["training"] = autograd.is_training()
            if self._batch_sync is not None:
                kwargs["sync"] = self._batch_sync
        return kwargs

    def _rebind_stats(self, new_mean, new_var):
        if autograd.is_training() and not self._use_global_stats \
                and not isinstance(new_mean, Symbol):
            self.running_mean._update_aux(new_mean)
            self.running_var._update_aux(new_var)

    def cast(self, dtype):
        if _dtype(dtype).itemsize < 4:
            dtype = "float32"   # statistics and scale stay fp32 (AMP-safe)
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, new_mean, new_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var,
            **self._op_kwargs(isinstance(x, Symbol)))
        self._rebind_stats(new_mean, new_var)
        return out

    def _forward_fused_relu(self, x):
        """BatchNorm followed by relu through the fused op: the
        ``HybridSequential`` fusion-site entry (in symbol mode, a
        ``fused_batch_norm_relu`` node).  Same running-statistic
        contract as ``hybrid_forward``."""
        if isinstance(x, Symbol):
            from ... import symbol as F
            p = {k: q.var() for k, q in self._reg_params.items()}
            out, _mean, _var = F.fused_batch_norm_relu(
                x, p["gamma"], p["beta"], p["running_mean"],
                p["running_var"], **self._op_kwargs(symbolic=True))
            return out
        p = self._param_values(x)
        out, new_mean, new_var = ops.fused_batch_norm_relu(
            x, p["gamma"], p["beta"], p["running_mean"], p["running_var"],
            **self._op_kwargs())
        self._rebind_stats(new_mean, new_var)
        return out


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BN (reference:
    ``contrib.nn.SyncBatchNorm``).  Inside a data-parallel
    ``TrainStep(mesh=)`` every BatchNorm's batch statistics reduce over
    the batch axis, as the JAX package's do over a sharded batch axis,
    so this is the same op; kept as a distinct class for API parity
    (``num_devices`` is accepted and unused)."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Dropout(HybridBlock):
    """Dropout in training mode (``autograd.record()``), identity
    otherwise; masks come from the port's per-device generator
    (:mod:`mxnet_tpu_torch.random`)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        if isinstance(x, Symbol):
            # the node takes the mode of the walk that runs it
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.Dropout(x, p=self._rate, axes=self._axes,
                         training=autograd.is_training())


class Embedding(HybridBlock):
    """Lookup table ``(input_dim, output_dim)``; ids may be float.  Its
    gradient is dense, ``sparse_grad=True`` included, as in the JAX
    package: the row-sparse win is the kvstore's and the optimizer's
    (``row_sparse_pull``, ``Optimizer.update_row_sparse``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        sh = self.weight._sharding
        if sh is not None and not sh.is_replicated:
            from ...parallel.tensor_parallel import embedding_forward
            return embedding_forward(F, self, x, weight)
        return F.Embedding(x, weight)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (the ``layernorm_fwd`` kernel
    over the last axis)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")

    def infer_shape(self, x):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class _ChannelNorm(HybridBlock):
    """A normalization with a ``gamma``/``beta`` pair over axis 1."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, **kwargs):
        super().__init__(**kwargs)
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")

    def infer_shape(self, x):
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)


class InstanceNorm(_ChannelNorm):
    """Each sample's channel normalized over its spatial axes; the
    channel axis is 1 whatever ``axis`` says, as in the JAX layer."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class GroupNorm(_ChannelNorm):
    """Each sample normalized over ``num_groups`` groups of its channels
    (NCHW)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)
        self._ngroups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._ngroups,
                           eps=self._eps)


def _op_function(name):
    """The op-table function named ``name`` (an ``mx.nd`` op name)."""
    return ops.table.lookup(name).fn


class Lambda(Block):
    """Wrap ``function``, a callable or the name of an ``mx.nd``
    function, as a block: ``forward(*args)`` is ``function(*args)``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = _op_function(function) if isinstance(function, str) \
            else function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """Wrap ``function``, a callable ``function(F, *args)`` or the name
    of an ``mx.nd`` function, as a hybrid block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            fn = _op_function(function)
            self._func = lambda F, *a: fn(*a)
        else:
            self._func = function

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)
