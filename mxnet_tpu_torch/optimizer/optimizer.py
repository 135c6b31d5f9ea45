"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``):
the base :class:`Optimizer`, :class:`SGD` with momentum, :class:`LARS`,
:class:`LAMB`, the :class:`Updater` that keeps per-parameter state,
``create`` and ``register``.

``Updater.get_states`` pickles the per-parameter state in the JAX
package's payload (``{index: ("nd", numpy) | ("tuple", [...]) |
("raw", value)}``), so a blob written by either package loads in the
other.

``update(index, weight, grad, state)`` counts the update and then
applies it in place through :mod:`mxnet_tpu_torch.ops.optimizer_ops`;
``_apply`` is the update without the count, which ``TrainStep`` calls
after its own bookkeeping.  Learning rate and weight decay are scaled
by each parameter's ``lr_mult``/``wd_mult`` through ``param_dict``.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..base import MXNetError
from ..kernels.optimizer_update import l2_norm
from ..ops import optimizer_ops

__all__ = ["LAMB", "LARS", "Optimizer", "SGD", "Updater", "create",
           "get_updater", "register"]

_OPT_REGISTRY = {}


def register(klass):
    key = klass.__name__.lower()
    if key in _OPT_REGISTRY and _OPT_REGISTRY[key] is not klass:
        raise MXNetError("duplicate optimizer registration %r (already %r)"
                         % (key, _OPT_REGISTRY[key]))
    _OPT_REGISTRY[key] = klass
    return klass


class Optimizer:
    """Base optimizer."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.param_dict = param_dict or {}

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key not in _OPT_REGISTRY:
            raise MXNetError("unknown optimizer %r; registered: %s"
                             % (name, ", ".join(sorted(_OPT_REGISTRY))))
        return _OPT_REGISTRY[key](**kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply(index, weight, grad, state)

    def _apply(self, index, weight, grad, state):
        raise NotImplementedError

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _get_lr(self, index):
        p = self.param_dict.get(index)
        return self.lr * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)

    def _common_kwargs(self, index):
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


def create(name, **kwargs):
    return Optimizer.create_optimizer(name, **kwargs)


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom' = momentum * mom - lr * g``, ``w' = w +
    mom'`` (plain ``w' = w - lr * g`` without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def _apply(self, index, weight, grad, state):
        kw = self._common_kwargs(index)
        if state is not None:
            optimizer_ops.sgd_mom_update(weight, grad, state,
                                         momentum=self.momentum, **kw)
        else:
            optimizer_ops.sgd_update(weight, grad, **kw)


@register
class LARS(Optimizer):
    """Layer-wise Adaptive Rate Scaling for large-batch SGD (You et al.
    2017): momentum SGD whose learning rate each tensor scales by its
    trust ratio.  Parameters whose name ends with one of ``skip_list``
    (biases and norm-layer scales) take plain momentum SGD instead, with
    SGD's momentum sign.  ``TrainStep`` runs the same update over one
    flat bucket (:mod:`mxnet_tpu_torch.kernels.optimizer_update`)."""

    def __init__(self, momentum=0.9, eta=0.001, epsilon=1e-9,
                 skip_list=("bias", "gamma", "beta"), **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon
        self.skip_list = tuple(skip_list)

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def _skip_lars(self, index):
        p = self.param_dict.get(index)
        return (p.name if p is not None else "").endswith(self.skip_list)

    def _apply(self, index, weight, grad, state):
        kw = self._common_kwargs(index)
        if self._skip_lars(index):
            optimizer_ops.sgd_mom_update(weight, grad, state,
                                         momentum=self.momentum, **kw)
        else:
            optimizer_ops.lars_update(weight, grad, state,
                                      momentum=self.momentum, eta=self.eta,
                                      epsilon=self.epsilon, **kw)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer (You et al. 2019):
    phase 1 moments and direction, phase 2 trust-ratio step, per
    parameter.  ``TrainStep`` runs the same update over one flat bucket
    (:mod:`mxnet_tpu_torch.kernels.optimizer_update`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _apply(self, index, weight, grad, state):
        mean, var = state
        kw = {"wd": self._get_wd(index), "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        g = optimizer_ops.lamb_update_phase1(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, t=self._index_update_count[index],
            bias_correction=self.bias_correction, **kw)
        optimizer_ops.lamb_update_phase2(
            weight, g, l2_norm(weight.detach()), l2_norm(g),
            lr=self._get_lr(index),
            lower_bound=self.lower_bound, upper_bound=self.upper_bound)


class Updater:
    """Per-parameter optimizer state, created at first use."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def ensure_state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad,
                              self.ensure_state(index, weight))

    def get_states(self, dump_optimizer=False):
        """The states as a pickled blob of host copies, with the
        optimizer when ``dump_optimizer``.  A bf16 state is stored as
        ml_dtypes' bfloat16, as the JAX package's ``asnumpy`` gives it,
        or as float32 where ml_dtypes is not installed."""
        def to_np(s):
            if isinstance(s, torch.Tensor):
                return ("nd", _state_to_numpy(s.detach()))
            if isinstance(s, (tuple, list)):
                return ("tuple", [to_np(x) for x in s])
            return ("raw", s)
        payload = {k: to_np(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((payload, self.optimizer))
        return pickle.dumps(payload)

    def set_states(self, states, placement=None):
        """Replace the states with those of a :meth:`get_states` blob
        (this program's or the JAX package's: unpickle only such
        blobs).  ``placement`` maps an index to its parameter's
        ``(device, dtype)``: each floating state of that index goes to
        the device at the parameter's dtype (every state is made like
        its weight), so a bf16 state stored as float32 comes back bf16.
        An index without placement lands on the CPU as stored."""
        data = pickle.loads(states)
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            payload, self.optimizer = data
        else:
            payload = data
        placement = placement or {}

        def from_np(s, where):
            kind, val = s
            if kind == "nd":
                t = _state_from_numpy(val)
                if where is None:
                    return t
                device, dtype = where
                if t.is_floating_point():
                    return t.to(device, dtype)
                return t.to(device)
            if kind == "tuple":
                return tuple(from_np(x, where) for x in val)
            return val
        self.states = {k: from_np(v, placement.get(k))
                       for k, v in payload.items()}


def _state_to_numpy(t):
    if t.dtype != torch.bfloat16:
        return t.cpu().numpy()
    try:
        import ml_dtypes
    except ImportError:
        return t.float().cpu().numpy()
    bits = t.contiguous().view(torch.int16).cpu().numpy()
    return bits.view(ml_dtypes.bfloat16).copy()


def _state_from_numpy(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes
        bits = np.array(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def get_updater(optimizer):
    return Updater(optimizer)
