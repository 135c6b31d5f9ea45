"""Optimizer update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``, MXNet's ``optimizer_op.cc``).

MXNet's forms, exactly, with ``g = clip(grad * rescale_grad) + wd *
weight`` where an op folds weight decay into the gradient:

- ``sgd_update``: ``w' = w - lr * g``; ``sgd_mom_update``: ``mom' =
  momentum * mom - lr * g``, ``w' = w + mom'``; ``nag_mom_update``:
  ``mom' = momentum * mom + g``, ``w' = w - lr * (g + momentum *
  mom')``; ``mp_sgd_update``/``mp_sgd_mom_update`` the same on an fp32
  master copy ``weight32``, the weight its cast;
- ``adam_update``: the moments, ``w' = w - lr * m / (sqrt(v) + eps)``
  (the caller folds the bias correction into ``lr``);
  ``adamw_update``: weight decay applied apart, ``w' = w - eta * (lr *
  m / (sqrt(v) + eps) + wd * w)``;
- ``rmsprop_update``, ``rmspropalex_update`` (centered), ``ftrl_update``,
  ``adagrad_update``, ``signsgd_update``, ``signum_update``;
- ``lars_update``: momentum SGD at the per-tensor trust ratio;
  ``lamb_update_phase1`` the LAMB moments and update direction,
  ``lamb_update_phase2`` the trust-ratio step;
- ``multi_sum_sq``, ``multi_all_finite``, ``multi_lars`` and the
  ``multi_*sgd*`` group updates over interleaved ``[w0, g0, (m0 |
  w32_0), w1, ...]``.

Where the JAX ops return new arrays, the functions here update
``weight`` and its states in place under ``torch.no_grad()``, so a step
allocates no second copy of the model and a captured step keeps every
tensor it read.  The same ops are entered into the op table under the
JAX names and arguments, as functions that work on copies and return
them, so ``mx.nd.adam_update(...)`` returns new NDArrays as the JAX
package's ``mx.nd`` does.  These are elementwise PyTorch ops: the JAX
package computes them outside any Pallas kernel.

``lr``, ``wd`` and ``rescale_grad`` may be 0-d fp32 tensors (a captured
``TrainStep`` feeds them from the device); the update of a tensor below
fp32 is then computed in fp32, so a scalar is never rounded to the
weight's dtype.
"""
from __future__ import annotations

import functools

import torch

from ..kernels.optimizer_update import l2_norm
from . import table

__all__ = ["adagrad_update", "adam_update", "adamw_update", "ftrl_update",
           "lamb_update_phase1", "lamb_update_phase2", "lars_update",
           "mp_sgd_mom_update", "mp_sgd_update", "multi_all_finite",
           "multi_lars", "multi_mp_sgd_update", "multi_sgd_mom_update",
           "multi_sgd_update", "multi_sum_sq", "nag_mom_update",
           "rmsprop_update", "rmspropalex_update", "sgd_mom_update",
           "sgd_update", "signsgd_update", "signum_update"]


def _fp32_if_fed(scalar, *tensors):
    """``tensors`` upcast to fp32 where ``scalar`` is a tensor."""
    if isinstance(scalar, torch.Tensor):
        return tuple(t.float() for t in tensors)
    return tensors


def _rescaled(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    grad, weight = _fp32_if_fed(rescale_grad, grad, weight)
    return _rescaled(grad, rescale_grad, clip_gradient) + wd * weight


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    weight.sub_(lr * g)
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * g)
    weight.add_(mom)
    return weight, mom


@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom + g)
    weight.sub_(lr * (g + momentum * mom))
    return weight, mom


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """SGD on the fp32 master copy ``weight32``; ``weight`` becomes its
    cast."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    weight32.sub_(lr * g)
    weight.copy_(weight32)
    return weight, weight32


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * g)
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight, mom, weight32


def _moments(g, mean, var, beta1, beta2):
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g))


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    _moments(g, mean, var, beta1, beta2)
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
    return weight, mean, var


@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Adam with weight decay apart from the gradient's moments."""
    grad, w = _fp32_if_fed(rescale_grad, grad, weight)
    _moments(_rescaled(grad, rescale_grad, clip_gradient), mean, var,
             beta1, beta2)
    weight.sub_(eta * (lr * mean / (torch.sqrt(var) + epsilon) + wd * w))
    return weight, mean, var


@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n.copy_(gamma1 * n + (1 - gamma1) * torch.square(g))
    weight.copy_(_clip_weights(weight - lr * g / (torch.sqrt(n) + epsilon),
                               clip_weights))
    return weight, n


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013): ``n`` the mean square, ``g`` the
    mean, ``delta`` the step."""
    gr = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n.copy_(gamma1 * n + (1 - gamma1) * torch.square(gr))
    g.copy_(gamma1 * g + (1 - gamma1) * gr)
    delta.copy_(gamma2 * delta
                - lr * gr / torch.sqrt(n - torch.square(g) + epsilon))
    weight.copy_(_clip_weights(weight + delta, clip_weights))
    return weight, n, g, delta


@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    grad, w = _fp32_if_fed(rescale_grad, grad, weight)
    g = _rescaled(grad, rescale_grad, clip_gradient)
    n2 = n + torch.square(g)
    sigma = (torch.sqrt(n2) - torch.sqrt(n)) / lr
    z.copy_(z + g - sigma * w)
    n.copy_(n2)
    weight.copy_(torch.where(
        torch.abs(z) <= lamda1, torch.zeros_like(w),
        -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd)))
    return weight, z, n


@torch.no_grad()
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad; weight decay stays out of the squared history."""
    grad, w = _fp32_if_fed(rescale_grad, grad, weight)
    g = _rescaled(grad, rescale_grad, clip_gradient)
    history.copy_(history + torch.square(g))
    weight.sub_(lr * (g / torch.sqrt(history + epsilon) + wd * w))
    return weight, history


@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    grad, w = _fp32_if_fed(rescale_grad, grad, weight)
    g = _rescaled(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (torch.sign(g) + wd * w))
    return weight


@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum: the sign of the momentum; ``wd_lh`` decays the weight
    apart from the gradient."""
    grad, w = _fp32_if_fed(rescale_grad, grad, weight)
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - (1 - momentum) * g)
    weight.copy_((1 - lr * wd_lh) * w + lr * torch.sign(mom) - lr * wd * w)
    return weight, mom


@torch.no_grad()
def lars_update(weight, grad, mom, lr=0.01, momentum=0.9, eta=0.001,
                epsilon=1e-9, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """LARS: the learning rate scaled by the trust ratio ``eta * ||w|| /
    (||g|| + wd * ||w|| + eps)`` of this tensor (1 where either norm is
    0), ``g = clip(grad * rescale_grad)``; ``mom' = momentum * mom + lr *
    trust * (g + wd * w)``, ``w' = w - mom'``."""
    wf, grad = _fp32_if_fed(rescale_grad, weight, grad)
    g = _rescaled(grad, rescale_grad, clip_gradient)
    w_norm, g_norm = l2_norm(wf), l2_norm(g)
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wd * w_norm + epsilon), 1.0)
    mom.copy_(momentum * mom + (lr * trust) * (g + wd * wf))
    weight.sub_(mom)
    return weight, mom


@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB phase 1: updates ``mean`` and ``var`` in place and returns
    the update direction ``mean_hat / (sqrt(var_hat) + eps) + wd *
    weight``.  ``t`` may be a 0-d tensor (a captured step's count)."""
    _moments(_rescaled(grad, rescale_grad, clip_gradient), mean, var,
             beta1, beta2)
    if bias_correction:
        mh = mean / (1 - beta1 ** t)
        vh = var / (1 - beta2 ** t)
    else:
        mh, vh = mean, var
    return mh / (torch.sqrt(vh) + epsilon) + wd * weight


@torch.no_grad()
def lamb_update_phase2(weight, g, r1, r2, lr=0.001, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB phase 2: ``weight -= lr * ratio * g`` in place, ``ratio =
    r1 / r2`` (``r1 = ||weight||`` clipped to the bounds, ``r2 =
    ||g||``), 1 where either norm is 0."""
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp_max(r1, upper_bound)
    ratio = torch.where((r1 == 0) | (r2 == 0), 1.0, r1 / r2)
    weight.sub_(lr * ratio * g)
    return weight


def multi_sum_sq(*data, num_arrays=1):
    """The sum of squares of each array, each ``(1,)`` (one array: one
    tensor, several: a tuple)."""
    out = tuple(torch.sum(torch.square(a)).reshape(1) for a in data)
    return out if len(out) > 1 else out[0]


def multi_all_finite(*data, num_arrays=1, init_output=True):
    """``(1,)`` fp32: 1 where every element of every array is finite."""
    ok = torch.ones((), dtype=torch.bool, device=data[0].device)
    for a in data:
        ok = ok & torch.isfinite(a).all()
    return ok.float().reshape(1)


def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-9,
               rescale_grad=1.0):
    """Each tensor's lr scaled by its LARS trust ratio, from the stacked
    sums of squares of the weights and gradients."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wds * w_norm + eps), 1.0)
    return lrs * trust


def _groups(data, size, num_weights):
    n = num_weights if num_weights > 0 else len(data) // size
    return [data[i * size:(i + 1) * size] for i in range(n)]


@torch.no_grad()
def multi_sgd_update(*data, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=-1):
    """``sgd_update`` of every ``(w, g)`` of ``[w0, g0, w1, g1, ...]``;
    returns the weights."""
    return tuple(sgd_update(w, g, lr=lrs[i], wd=wds[i],
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
                 for i, (w, g) in enumerate(_groups(data, 2, num_weights)))


@torch.no_grad()
def multi_sgd_mom_update(*data, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=-1):
    """``sgd_mom_update`` of every ``(w, g, m)`` of ``[w0, g0, m0, ...]``;
    returns the weights, then the momenta."""
    groups = _groups(data, 3, num_weights)
    for i, (w, g, m) in enumerate(groups):
        sgd_mom_update(w, g, m, lr=lrs[i], momentum=momentum, wd=wds[i],
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient)
    return tuple(grp[0] for grp in groups) + tuple(grp[2] for grp in groups)


@torch.no_grad()
def multi_mp_sgd_update(*data, lrs=(), wds=(), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=-1):
    """``mp_sgd_update`` of every ``(w, g, w32)`` of ``[w0, g0, w32_0,
    ...]``; returns the weights, then the master copies."""
    groups = _groups(data, 3, num_weights)
    for i, (w, g, w32) in enumerate(groups):
        mp_sgd_update(w, g, w32, lr=lrs[i], wd=wds[i],
                      rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return tuple(grp[0] for grp in groups) + tuple(grp[2] for grp in groups)


# -- the op table: the JAX names, arguments and results ----------------

def _on_copies(fn, written, variadic_group=None):
    """``fn`` as an op of the table: the tensors it writes in place
    (``written``: their positions; for a variadic op, positions within
    each group of ``variadic_group``) are copied first, so the caller's
    arrays keep their values and the results are new tensors."""
    @functools.wraps(fn)
    def op(*tensors, **kwargs):
        tensors = list(tensors)
        for k in range(len(tensors)):
            pos = k if variadic_group is None else k % variadic_group
            if pos in written:
                tensors[k] = tensors[k].clone()
        return fn(*tensors, **kwargs)
    return op


for _fn, _args, _written, _aliases in (
        (sgd_update, ("weight", "grad"), (0,), ()),
        (sgd_mom_update, ("weight", "grad", "mom"), (0, 2), ()),
        (nag_mom_update, ("weight", "grad", "mom"), (0, 2), ()),
        (mp_sgd_update, ("weight", "grad", "weight32"), (0, 2), ()),
        (mp_sgd_mom_update, ("weight", "grad", "mom", "weight32"),
         (0, 2, 3), ()),
        (adam_update, ("weight", "grad", "mean", "var"), (0, 2, 3), ()),
        (adamw_update, ("weight", "grad", "mean", "var"), (0, 2, 3), ()),
        (rmsprop_update, ("weight", "grad", "n"), (0, 2), ()),
        (rmspropalex_update, ("weight", "grad", "n", "g", "delta"),
         (0, 2, 3, 4), ()),
        (ftrl_update, ("weight", "grad", "z", "n"), (0, 2, 3), ()),
        (adagrad_update, ("weight", "grad", "history"), (0, 2),
         ("_sparse_adagrad_update",)),
        (signsgd_update, ("weight", "grad"), (0,), ()),
        (signum_update, ("weight", "grad", "mom"), (0, 2), ()),
        (lars_update, ("weight", "grad", "mom"), (0, 2), ()),
        (lamb_update_phase2, ("weight", "g", "r1", "r2"), (0,), ()),
        (multi_lars, ("lrs", "weights_sum_sq", "grads_sum_sq", "wds"), (),
         ())):
    table.register(_fn.__name__, args=_args, aliases=_aliases)(
        _on_copies(_fn, _written))



@functools.wraps(lamb_update_phase1)
def _lamb_phase1_op(weight, grad, mean, var, **kwargs):
    mean, var = mean.clone(), var.clone()
    return lamb_update_phase1(weight, grad, mean, var, **kwargs), mean, var


table.register("lamb_update_phase1", args=("weight", "grad", "mean", "var"))(
    _lamb_phase1_op)
for _fn, _written, _group in ((multi_sgd_update, (0,), 2),
                              (multi_sgd_mom_update, (0, 2), 3),
                              (multi_mp_sgd_update, (0, 2), 3)):
    table.register(_fn.__name__, args=("data",), variadic=True)(
        _on_copies(_fn, _written, _group))
for _fn in (multi_sum_sq, multi_all_finite):
    table.register(_fn.__name__, args=("data",), variadic=True)(_fn)
