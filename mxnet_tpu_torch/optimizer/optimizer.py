"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``): the
base :class:`Optimizer`, :class:`SGD`, :class:`NAG`, :class:`Adam`,
:class:`AdamW`, :class:`RMSProp`, :class:`AdaGrad`, :class:`Ftrl`,
:class:`Signum`, :class:`LARS` and :class:`LAMB`, the :class:`Updater`
that keeps per-parameter state, ``create`` and ``register``.

``update(index, weight, grad, state)`` counts the update and then
applies it in place through :mod:`mxnet_tpu_torch.ops.optimizer_ops`;
``_apply`` is the update without the count, which ``TrainStep`` calls
after its own bookkeeping.  Every update writes the weight and its
states in place: a captured step reads them at fixed addresses.

The learning rate is ``lr_scheduler(num_update)`` where a scheduler is
given, else ``learning_rate``, scaled by the parameter's multiplier:
its ``param_dict`` entry's ``lr_mult``, else ``lr_mult[index]``, else
``lr_mult[name]`` (``name`` from ``param_idx2name``); weight decay
alike.  With ``multi_precision``, an fp16 weight is updated through an
fp32 master copy: its state is ``(state, weight32)``
(:meth:`Optimizer.create_state_multi_precision`), the update runs on
the copy and the weight is written as its cast
(:meth:`Optimizer.update_multi_precision`).  As in the JAX package this
applies to float16 weights only; a bf16 weight takes the plain update.

``Updater.get_states`` pickles the per-parameter state in the JAX
package's payload (``{index: ("nd", numpy) | ("tuple", [...]) |
("raw", value)}``), so a blob written by either package loads in the
other.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..base import MXNetError
from ..kernels.optimizer_update import l2_norm
from ..ops import optimizer_ops

__all__ = ["AdaGrad", "Adam", "AdamW", "Ftrl", "LAMB", "LARS", "NAG",
           "Optimizer", "RMSProp", "SGD", "Signum", "Updater", "create",
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

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key not in _OPT_REGISTRY:
            raise MXNetError("unknown optimizer %r; registered: %s"
                             % (name, ", ".join(sorted(_OPT_REGISTRY))))
        return _OPT_REGISTRY[key](**kwargs)

    def create_state(self, index, weight):
        return None

    def _master_copy(self, weight):
        """Whether ``weight`` is updated through an fp32 master copy."""
        return self.multi_precision and _t(weight).dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        if self._master_copy(weight):
            w32 = _t(weight).detach().float()
            if w32 is not weight and not isinstance(weight, torch.Tensor):
                w32 = type(weight)(w32)
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._update_count(index)
        self._apply_multi_precision(index, weight, grad, state)

    def _apply(self, index, weight, grad, state):
        raise NotImplementedError

    @torch.no_grad()
    def _apply_multi_precision(self, index, weight, grad, state):
        """The update without the count, through the master copy where
        there is one."""
        if not self._master_copy(weight):
            self._apply(index, weight, grad, state)
            return
        inner, w32 = state
        self._apply(index, w32, grad.float(), inner)
        weight.copy_(w32)

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _mult(self, index, attr, table):
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        if index in table:
            return table[index]
        if name in table:
            return table[name]
        return 1.0

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def _common_kwargs(self, index):
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def _sparse_grad_prep(self, index, grad, weight_rows, fold_wd=True):
        """The live rows' gradient, rescaled and clipped; with
        ``fold_wd`` the rows' weight decay is added (AdaGrad keeps it out
        of its squared history and passes ``fold_wd=False``)."""
        g = grad._rs_data * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient > 0:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        if fold_wd:
            wd = self._get_wd(index)
            if wd:
                g = g + wd * weight_rows
        return g

    @torch.no_grad()
    def update_row_sparse(self, index, weight, grad, state):
        """The update from a ``RowSparseNDArray`` gradient.  By default
        the gradient is densified, which is right for every optimizer;
        SGD and AdaGrad move only the live rows."""
        self.update(index, _t(weight), grad.todense()._data, _t(state))

    def update_row_sparse_multi_precision(self, index, weight, grad,
                                          state):
        """The sparse update through the fp32 master copy where there is
        one: that route densifies, so the copy stays in step."""
        if self._master_copy(_t(weight)):
            self.update_multi_precision(index, _t(weight),
                                        grad.todense()._data, _t(state))
        else:
            self.update_row_sparse(index, weight, grad, state)


def _t(x):
    """The tensor of an NDArray (a state tuple's entries each), or ``x``
    as it is."""
    if isinstance(x, (tuple, list)):
        return type(x)(_t(v) for v in x)
    data = getattr(x, "_data", None)
    return data if isinstance(data, torch.Tensor) else x


def create(name, **kwargs):
    return Optimizer.create_optimizer(name, **kwargs)


def _zeros(weight, n=1):
    """``n`` zero states shaped as ``weight``; NDArrays for an NDArray
    weight."""
    data = _t(weight)
    zs = tuple(torch.zeros_like(data) for _ in range(n))
    if data is not weight:
        zs = tuple(type(weight)(z) for z in zs)
    return zs if n > 1 else zs[0]


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom' = momentum * mom - lr * g``, ``w' = w +
    mom'`` (plain ``w' = w - lr * g`` without momentum).  Its
    multi-precision update is the fused ``mp_sgd(_mom)_update``; its
    master state is ``(momentum or None, weight32)``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    def _apply(self, index, weight, grad, state):
        kw = self._common_kwargs(index)
        if state is not None:
            optimizer_ops.sgd_mom_update(weight, grad, state,
                                         momentum=self.momentum, **kw)
        else:
            optimizer_ops.sgd_update(weight, grad, **kw)

    def update_multi_precision(self, index, weight, grad, state):
        if not self._master_copy(weight):
            self.update(index, weight, grad, state)
            return
        # the JAX package reads lr and wd before it counts the update
        kw = self._common_kwargs(index)
        self._update_count(index)
        self._mp_sgd(weight, grad, state, kw)

    def _apply_multi_precision(self, index, weight, grad, state):
        if not self._master_copy(weight):
            self._apply(index, weight, grad, state)
            return
        self._mp_sgd(weight, grad, state, self._common_kwargs(index))

    @torch.no_grad()
    def update_row_sparse(self, index, weight, grad, state):
        """The lazy row update: only the rows the gradient names move.
        With momentum every row's momentum decays, so it densifies."""
        if self.momentum != 0.0:
            return super().update_row_sparse(index, weight, grad, state)
        weight = _t(weight)
        self._update_count(index)
        lr = self._get_lr(index)
        rows = grad._rs_indices.to(weight.device).long()
        g = self._sparse_grad_prep(index, grad, weight[rows])
        weight.index_add_(0, rows, (-lr * g).to(weight.dtype))
        return None

    def _mp_sgd(self, weight, grad, state, kw):
        mom, w32 = state
        if self.momentum != 0.0:
            optimizer_ops.mp_sgd_mom_update(weight, grad, mom, w32,
                                            momentum=self.momentum, **kw)
        else:
            optimizer_ops.mp_sgd_update(weight, grad, w32, **kw)


@register
class NAG(SGD):
    """Nesterov accelerated SGD: ``mom' = momentum * mom + g``, ``w' = w
    - lr * (g + momentum * mom')``."""

    def _apply(self, index, weight, grad, state):
        kw = self._common_kwargs(index)
        if state is not None:
            optimizer_ops.nag_mom_update(weight, grad, state,
                                         momentum=self.momentum, **kw)
        else:
            optimizer_ops.sgd_update(weight, grad, **kw)


@register
class Adam(Optimizer):
    """Adam (Kingma & Ba 2015), with the bias correction folded into the
    learning rate: ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _bias_corrected(self, index, kw):
        """``kw`` with the bias correction folded into its lr, at the
        update count ``t`` (a 0-d tensor under a captured step)."""
        t = self._index_update_count[index]
        kw["lr"] = kw["lr"] * ((1.0 - self.beta2 ** t) ** 0.5
                               / (1.0 - self.beta1 ** t))
        return kw

    def _apply(self, index, weight, grad, state):
        mean, var = state
        optimizer_ops.adam_update(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon,
            **self._bias_corrected(index, self._common_kwargs(index)))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (Loshchilov & Hutter 2019)."""

    def _apply(self, index, weight, grad, state):
        mean, var = state
        optimizer_ops.adamw_update(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon,
            **self._bias_corrected(index, self._common_kwargs(index)))


@register
class RMSProp(Optimizer):
    """RMSProp (Tieleman & Hinton 2012); ``centered`` is Graves's
    variant; ``clip_weights`` bounds the weights after each update."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros(weight, 3) if self.centered else _zeros(weight)

    def _apply(self, index, weight, grad, state):
        kw = self._common_kwargs(index)
        if self.clip_weights is not None:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            n, g, delta = state
            optimizer_ops.rmspropalex_update(
                weight, grad, n, g, delta, gamma1=self.gamma1,
                gamma2=self.gamma2, epsilon=self.epsilon, **kw)
        else:
            optimizer_ops.rmsprop_update(weight, grad, state,
                                         gamma1=self.gamma1,
                                         epsilon=self.epsilon, **kw)


@register
class AdaGrad(Optimizer):
    """AdaGrad (Duchi et al. 2011)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def _apply(self, index, weight, grad, state):
        optimizer_ops.adagrad_update(weight, grad, state,
                                     epsilon=self.float_stable_eps,
                                     **self._common_kwargs(index))

    @torch.no_grad()
    def update_row_sparse(self, index, weight, grad, state):
        """Only the live rows add to their history and move, by the dense
        update's math: weight decay out of the history, epsilon inside
        the square root."""
        weight, state = _t(weight), _t(state)
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        rows = grad._rs_indices.to(weight.device).long()
        w_rows = weight[rows]
        g = self._sparse_grad_prep(index, grad, w_rows, fold_wd=False)
        h_rows = state[rows] + g * g
        state.index_copy_(0, rows, h_rows)
        step = g / torch.sqrt(h_rows + self.float_stable_eps) + wd * w_rows
        weight.index_add_(0, rows, (-lr * step).to(weight.dtype))


@register
class Ftrl(Optimizer):
    """FTRL-Proximal (McMahan et al. 2013)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _apply(self, index, weight, grad, state):
        z, n = state
        optimizer_ops.ftrl_update(weight, grad, z, n, lamda1=self.lamda1,
                                  beta=self.beta,
                                  **self._common_kwargs(index))


@register
class Signum(Optimizer):
    """signSGD with momentum (Bernstein et al. 2018); ``wd_lh`` decays
    the weight apart from the gradient."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    def _apply(self, index, weight, grad, state):
        kw = self._common_kwargs(index)
        if state is not None:
            optimizer_ops.signum_update(weight, grad, state,
                                        momentum=self.momentum,
                                        wd_lh=self.wd_lh, **kw)
        else:
            optimizer_ops.signsgd_update(weight, grad, **kw)


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
        name = p.name if p is not None else str(self.idx2name.get(index, ""))
        return name.endswith(self.skip_list)

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
        return _zeros(weight, 2)

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
    """Per-parameter optimizer state, created at first use, and the
    update through the multi-precision entry points."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def ensure_state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        from ..ndarray.sparse import RowSparseNDArray
        state = self.ensure_state(index, _t(weight))
        if isinstance(grad, RowSparseNDArray):
            self.optimizer.update_row_sparse_multi_precision(
                index, weight, grad, state)
            return
        self.optimizer.update_multi_precision(index, weight, grad, state)

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
        blobs).  ``placement`` maps an index to ``(device, dtype)``: each
        floating state of that index goes to the device at that dtype,
        so a bf16 state stored as float32 comes back bf16.  An index
        without placement lands on the CPU as stored."""
        data = pickle.loads(states)
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[0], dict):
            # dumped with its optimizer: this program's is adopted, the
            # JAX package's (a Module's .states) leaves ours in place
            payload = data[0]
            if isinstance(data[1], Optimizer):
                self.optimizer = data[1]
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
