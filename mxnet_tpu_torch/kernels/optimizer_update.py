"""Bucket-flattened LARS and LAMB updates (counterpart of
``mxnet_tpu/kernels/optimizer_update.py``).

The parameter set is grouped by dtype (:mod:`mxnet_tpu_torch.bucketing`)
and each group's weights, gradients and optimizer state are flattened
into one contiguous buffer.

- LARS: the per-tensor trust ratios are norms of each tensor's weight
  and clipped, rescaled gradient; they are folded into a per-element
  ``lr`` vector beside per-element ``wd`` and ``sign`` vectors, and the
  momentum update runs as ONE pass over the flat buffer -- the
  ``lars_flat`` kernel.  Skip-list tensors (biases, norm scales) take
  the ratio 1 and ``sign = -1``: plain momentum SGD with SGD's momentum
  sign, so stored state is the per-parameter optimizer's.
- LAMB: phase 1 (moments and update direction) runs as ONE pass -- the
  ``lamb_phase1`` kernel -- the per-tensor trust-ratio norms are segment
  reductions over views of it, and phase 2 (the trust-scaled step) is
  written into each tensor from views of the flat results.

Per-tensor semantics are those of the per-parameter optimizers
(``lars_update`` / ``sgd_mom_update``, ``lamb_update_phase1/2``).  A
caller whose tensors are shards of larger parameters passes
``shard_norms``, a function that makes each tensor's weight and update
norms the whole parameter's (``TrainStep`` on a tensor-parallel mesh),
so each shard takes the trust ratio of its whole parameter.

The per-step scalars -- each tensor's lr and wd, ``rescale_grad`` and
LAMB's bias corrections -- may be given as device tensors (the
``TrainStep`` of a CUDA graph refreshes them before each replay); both
kernels read theirs through a pointer, and nothing here reads a value
on the host or copies from host memory.  With ``finite`` (a 0-d bool
tensor), the write-back keeps the old weights and states where it is
false, the JAX step's ``jnp.where(all_finite, new, old)``.
Where the JAX functions return new arrays, :func:`lars_bucket_update`,
:func:`lamb_bucket_update` and :func:`bucket_update` write the new
weights and states into the given tensors in place, so a step keeps no
second copy of the model beyond the flat buffers.

The two bucket updates are differentiable, as the JAX ones are: when
grad mode is on and an input requires a gradient, they write nothing in
place and return new tensors whose graph runs through the flat pass as
a ``torch.autograd.Function`` (:class:`FlatLars`, :class:`FlatLamb1`,
the JAX ``custom_vjp``s ``_flat_lars`` and ``_flat_lamb1``).  Its
forward dispatches as always -- the kernel on CUDA, the plain version
on the CPU -- and its backward replays autodiff of the plain math over
the saved inputs (the JAX ``_flat_lars_bwd``/``_flat_lamb1_bwd``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXNetError
from ..bucketing import dtype_groups, flatten_group, split_group
from .costs import lamb_phase1_cost, lars_flat_cost
from .registry import KernelSpec, count_launch, dispatch, register_kernel

__all__ = ["FlatLamb1", "FlatLars", "bucket_supported", "bucket_update",
           "l2_norm",
           "lamb1_reference", "lamb_bias_corrections", "lamb_bucket_update",
           "lamb_phase1_cuda", "lars_bucket_update", "lars_flat_cuda",
           "lars_flat_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scalar_vector(values, n, device):
    """``values`` (a tensor, or numbers) as an fp32 ``(n,)`` tensor on
    ``device``."""
    t = torch.as_tensor(values, dtype=torch.float32, device=device)
    return t.reshape(n)


def lamb1_reference(w, g, m, v, wd, scalars, beta1=0.9, beta2=0.999,
                    eps=1e-6, clip=0.0):
    """Plain version of the phase-1 kernel (the JAX package's
    ``_lamb1_math``): ``scalars`` is ``(rescale, bc1, bc2)``, the
    kernel's fp32 ``(3,)`` tensor (or three numbers); returns ``(gw
    fp32, m', v')`` with the moments at ``m``'s and ``v``'s dtype."""
    rescale, bc1, bc2 = _scalar_vector(scalars, 3, w.device)
    wf = w.float()
    gr = g.float() * rescale
    if clip is not None and clip > 0:
        gr = torch.clamp(gr, -clip, clip)
    nm = beta1 * m.float() + (1 - beta1) * gr
    nv = beta2 * v.float() + (1 - beta2) * gr * gr
    gw = (nm * bc1) / (torch.sqrt(nv * bc2) + eps) + wd * wf
    return gw, nm.to(m.dtype), nv.to(v.dtype)


@functools.cache
def _lib():
    from .. import _build
    lib = _build.load("optimizer_update")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lamb_phase1_launch.argtypes = [p, p, p, p, p, p, p, p,
                                       ctypes.c_int64, p, f, f, f, f, f, f,
                                       i, p]
    lib.lamb_phase1_launch.restype = i
    lib.lars_flat_launch.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_int64,
                                     p, f, f, i, p]
    lib.lars_flat_launch.restype = i
    lib.optimizer_update_error_string.argtypes = [i]
    lib.optimizer_update_error_string.restype = ctypes.c_char_p
    return lib


def _check_flat(fn, w, others):
    """Raise unless ``w`` is a flat contiguous fp32/bf16 CUDA tensor and
    each ``(name, tensor, dtype)`` of ``others`` a contiguous tensor of
    ``w``'s shape and device at ``dtype``."""
    if w.device.type != "cuda":
        raise MXNetError("%s needs CUDA tensors, got w on %s"
                         % (fn, w.device))
    if w.dim() != 1:
        raise MXNetError("%s: w must be flat (S,), got %s"
                         % (fn, tuple(w.shape)))
    if w.dtype not in _DTYPE_CODES:
        raise MXNetError("%s: w must be float32 or bfloat16, got %s"
                         % (fn, w.dtype))
    for name, t, dtype in [("w", w, w.dtype)] + others:
        if t.device != w.device:
            raise MXNetError("%s: %s on %s, w on %s"
                             % (fn, name, t.device, w.device))
        if t.shape != w.shape or t.dtype != dtype:
            raise MXNetError("%s: %s must be %s of shape %s, got %s %s"
                             % (fn, name, dtype, tuple(w.shape), t.dtype,
                                tuple(t.shape)))
        if not t.is_contiguous():
            raise MXNetError("%s: %s is not contiguous" % (fn, name))


def _check_scalars(fn, w, scalars, n):
    """Raise unless ``scalars`` is a contiguous fp32 CUDA tensor of
    ``n`` elements on ``w``'s device (the kernel reads it through a
    pointer)."""
    if not isinstance(scalars, torch.Tensor) or scalars.device != w.device \
            or scalars.dtype != torch.float32 or scalars.numel() != n \
            or not scalars.is_contiguous():
        raise MXNetError("%s: the per-step scalars must be a contiguous "
                         "float32 tensor of %d on %s, got %r"
                         % (fn, n, w.device, scalars if not isinstance(
                             scalars, torch.Tensor) else (
                                 scalars.dtype, tuple(scalars.shape),
                                 scalars.device)))


def _raise_on(lib, rc, what):
    if rc != 0:
        raise MXNetError("%s kernel launch failed: %s (%d)" % (
            what, lib.optimizer_update_error_string(rc).decode(), rc))


def lamb_phase1_cuda(w, g, m, v, wd, scalars, beta1=0.9, beta2=0.999,
                     eps=1e-6, clip=0.0):
    """Launch the phase-1 kernel on PyTorch's current stream: ``w``,
    ``g``, ``m``, ``v`` contiguous CUDA ``(S,)`` tensors of one dtype
    (fp32 or bf16), ``wd`` a contiguous fp32 ``(S,)`` tensor,
    ``scalars`` the fp32 ``(3,)`` device tensor ``(rescale, bc1, bc2)``
    the kernel reads; returns ``(gw, m', v')`` as
    :func:`lamb1_reference`."""
    _check_flat("lamb_phase1_cuda", w,
                [("g", g, w.dtype), ("m", m, w.dtype), ("v", v, w.dtype),
                 ("wd", wd, torch.float32)])
    _check_scalars("lamb_phase1_cuda", w, scalars, 3)
    clipv = float(clip) if clip is not None and clip > 0 else 0.0
    lib = _lib()
    gw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nm, nv = torch.empty_like(m), torch.empty_like(v)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.lamb_phase1_launch(
            w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            wd.data_ptr(), gw.data_ptr(), nm.data_ptr(), nv.data_ptr(),
            w.numel(), scalars.data_ptr(), float(beta1), 1.0 - beta1,
            float(beta2), 1.0 - beta2, float(eps), clipv,
            _DTYPE_CODES[w.dtype], stream)
    _raise_on(lib, rc, "lamb_phase1")
    count_launch("lamb_phase1", cost_args=(
        (w, g, m, v, wd, scalars),
        {"beta1": beta1, "beta2": beta2, "eps": eps, "clip": clip}))
    return gw, nm, nv


register_kernel(KernelSpec(
    name="lamb_phase1",
    plain=lamb1_reference,
    launch=lamb_phase1_cuda,
    source="csrc/optimizer_update.cu",
    replaces="mxnet_tpu/kernels/optimizer_update.py:258 lamb_phase1_pallas",
    cost=lamb_phase1_cost,
    category="elementwise_fusion",
    remedies=("memory-bound",),
))


def lars_flat_reference(w, g, m, lr, wd, sign, rescale, momentum=0.9,
                        clip=0.0):
    """Plain version of the ``lars_flat`` kernel (the JAX package's
    ``_lars_math``): returns ``(w', m')`` at ``w``'s and ``m``'s dtype;
    ``lr``, ``wd`` and ``sign`` are fp32 per element, ``rescale`` the
    kernel's fp32 ``(1,)`` tensor (or a number)."""
    wf = w.float()
    gr = g.float() * _scalar_vector(rescale, 1, w.device)
    if clip is not None and clip > 0:
        gr = torch.clamp(gr, -clip, clip)
    step = lr * (gr + wd * wf)
    nm = momentum * m.float() + sign * step
    nw = wf - sign * nm
    return nw.to(w.dtype), nm.to(m.dtype)


def lars_flat_cuda(w, g, m, lr, wd, sign, rescale, momentum=0.9, clip=0.0):
    """Launch the ``lars_flat`` kernel on PyTorch's current stream:
    ``w``, ``g``, ``m`` contiguous CUDA ``(S,)`` tensors of one dtype
    (fp32 or bf16), ``lr``, ``wd``, ``sign`` contiguous fp32 ``(S,)``
    tensors, ``rescale`` the fp32 ``(1,)`` device tensor the kernel
    reads; returns ``(w', m')`` in fresh buffers, as
    :func:`lars_flat_reference`."""
    _check_flat("lars_flat_cuda", w,
                [("g", g, w.dtype), ("m", m, w.dtype),
                 ("lr", lr, torch.float32), ("wd", wd, torch.float32),
                 ("sign", sign, torch.float32)])
    _check_scalars("lars_flat_cuda", w, rescale, 1)
    clipv = float(clip) if clip is not None and clip > 0 else 0.0
    lib = _lib()
    nw, nm = torch.empty_like(w), torch.empty_like(m)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.lars_flat_launch(
            w.data_ptr(), g.data_ptr(), m.data_ptr(), lr.data_ptr(),
            wd.data_ptr(), sign.data_ptr(), nw.data_ptr(), nm.data_ptr(),
            w.numel(), rescale.data_ptr(), float(momentum), clipv,
            _DTYPE_CODES[w.dtype], stream)
    _raise_on(lib, rc, "lars_flat")
    count_launch("lars_flat", w.dtype, cost_args=(
        (w, g, m, lr, wd, sign, rescale),
        {"momentum": momentum, "clip": clip}))
    return nw, nm


register_kernel(KernelSpec(
    name="lars_flat",
    plain=lars_flat_reference,
    launch=lars_flat_cuda,
    source="csrc/optimizer_update.cu",
    replaces="mxnet_tpu/kernels/optimizer_update.py:114 lars_flat_pallas",
    cost=lars_flat_cost,
    category="elementwise_fusion",
    remedies=("memory-bound",),
))


def _replay_grads(plain, saved, out_grads, **kw):
    """The gradients of ``plain(*saved, **kw)``'s outputs, weighted by
    ``out_grads`` (None where an output took none), w.r.t. every saved
    input: autodiff of the plain math."""
    ins = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        outs = plain(*ins, **kw)
    live = [(o, g) for o, g in zip(outs, out_grads) if g is not None]
    return torch.autograd.grad([o for o, _g in live], ins,
                               [g for _o, g in live], allow_unused=True)


class FlatLars(torch.autograd.Function):
    """``lars_flat`` with a gradient: the forward dispatches the kernel
    (or its plain version on the CPU); the backward replays autodiff of
    :func:`lars_flat_reference` over the saved ``(w, g, m, lr, wd, sign,
    rescale)``."""

    @staticmethod
    def forward(ctx, w, g, m, lr, wd, sign, rescale, momentum, clip):
        ctx.save_for_backward(w, g, m, lr, wd, sign, rescale)
        ctx.kw = dict(momentum=momentum, clip=clip)
        return dispatch("lars_flat", w, g, m, lr, wd, sign, rescale,
                        momentum=momentum, clip=clip)

    @staticmethod
    def backward(ctx, dw, dm):
        return _replay_grads(lars_flat_reference, ctx.saved_tensors,
                             (dw, dm), **ctx.kw) + (None, None)


class FlatLamb1(torch.autograd.Function):
    """``lamb_phase1`` with a gradient: the forward dispatches the
    kernel (or its plain version on the CPU); the backward replays
    autodiff of :func:`lamb1_reference` over the saved ``(w, g, m, v,
    wd, scalars)``."""

    @staticmethod
    def forward(ctx, w, g, m, v, wd, scalars, beta1, beta2, eps, clip):
        ctx.save_for_backward(w, g, m, v, wd, scalars)
        ctx.kw = dict(beta1=beta1, beta2=beta2, eps=eps, clip=clip)
        return dispatch("lamb_phase1", w, g, m, v, wd, scalars, **ctx.kw)

    @staticmethod
    def backward(ctx, dgw, dm, dv):
        return _replay_grads(lamb1_reference, ctx.saved_tensors,
                             (dgw, dm, dv), **ctx.kw) + (None,) * 4


def _differentiating(*groups):
    """Whether grad mode is on and a tensor among ``groups`` (tensors,
    or lists holding tensors and numbers) requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    for grp in groups:
        for t in grp if isinstance(grp, (list, tuple)) else [grp]:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return True
    return False


def l2_norm(t):
    """The L2 norm of ``t`` as fp32, accumulated in fp64: PyTorch's fp32
    ``vector_norm`` on the CPU is off by ~1e-3 relative at 2e7
    elements (the BERT embedding and decoder weights)."""
    return torch.linalg.vector_norm(t, dtype=torch.float64).float()


def _segment_norms(buf, shapes):
    """fp32 L2 norm of each piece of a flat buffer."""
    return torch.stack([l2_norm(p) for p in split_group(buf, shapes)])


def _vector(values, device):
    """Per-tensor values as an fp32 vector on ``device``: a tensor as it
    is, numbers through one copy (the eager caller's lists)."""
    if isinstance(values, torch.Tensor):
        return values.to(device, torch.float32)
    return torch.tensor([float(v) for v in values], dtype=torch.float32,
                        device=device)


def _take(vec, ks):
    """``vec[ks]`` for a list of positions, without an index tensor from
    the host: a slice where ``ks`` is a run, else a stack of
    elements."""
    if ks == list(range(ks[0], ks[0] + len(ks))):
        return vec[ks[0]:ks[0] + len(ks)]
    return torch.stack([vec[k] for k in ks])


def _per_element(values, shapes, total, device, diff=False):
    """A flat fp32 ``(total,)`` buffer holding ``values[k]`` over the
    piece of shape ``shapes[k]`` (one fill each; ``repeat_interleave``
    would build an int64 index of ``total`` entries first).  ``values``
    are Python numbers or a ``(P,)`` tensor on ``device``, read without a
    host sync.  With ``diff``, a concatenation that carries the
    gradient of ``values``."""
    if diff:
        return torch.cat([_vector([v] if not isinstance(v, torch.Tensor)
                                  else v, device).reshape(1).expand(
                                      math.prod(shape))
                          for v, shape in zip(values, shapes)])
    out = torch.empty(total, dtype=torch.float32, device=device)
    for k, piece in enumerate(split_group(out, shapes)):
        v = values[k]
        piece.fill_(v if isinstance(v, torch.Tensor) else float(v))
    return out


def _keep_if(finite, new, old):
    """``new`` where ``finite`` (a 0-d bool tensor) holds, else
    ``old``; ``new`` when ``finite`` is None."""
    return new if finite is None else torch.where(finite, new, old)


def lars_bucket_update(ws, gs, ms, lrs, wds, skips, momentum=0.9,
                       eta=0.001, epsilon=1e-9, rescale=1.0, clip=None,
                       finite=None, shard_norms=None):
    """Bucket-flattened LARS over parameter lists (weights, gradients,
    momenta; per-tensor ``lrs``/``wds``, numbers or fp32 ``(P,)``
    tensors; ``skips`` the per-tensor flags of the plain-momentum path;
    ``rescale`` a number or an fp32 tensor of one element).  Writes the
    new weights and momenta into ``ws`` and ``ms`` in place (the old ones
    where ``finite`` is false) and returns them; when an input requires a
    gradient (grad mode on), returns new lists instead, differentiable
    w.r.t. every input.  ``shard_norms(tensors, *norms)``, when given,
    turns per-tensor norms into those of the whole parameters."""
    if not ws:
        return ws, ms
    diff = _differentiating(ws, gs, ms, lrs, wds, rescale)
    with torch.set_grad_enabled(diff):
        return _lars_bucket(ws, gs, ms, lrs, wds, skips, momentum, eta,
                            epsilon, rescale, clip, finite, shard_norms,
                            diff)


def _lars_bucket(ws, gs, ms, lrs, wds, skips, momentum, eta, epsilon,
                 rescale, clip, finite, shard_norms, diff):
    clipv = float(clip) if clip is not None and clip > 0 else 0.0
    new_ws, new_ms = list(ws), list(ms)
    dev0 = ws[0].device
    lrs, wds = _vector(lrs, dev0), _vector(wds, dev0)
    rescale = _scalar_vector(rescale, 1, dev0)
    for _dtype, idxs in dtype_groups(ws):
        dev = ws[idxs[0]].device
        shapes = [ws[i].shape for i in idxs]
        total = sum(ws[i].numel() for i in idxs)
        # lr times the per-tensor trust ratio, on the device; a skipped
        # tensor keeps the ratio 1 and needs no norms
        lr_t = _take(lrs, idxs)
        live = [k for k, i in enumerate(idxs) if not skips[i]]
        if live:
            wn = torch.stack([l2_norm(ws[idxs[k]]) for k in live])
            gn = []
            for k in live:
                gr = gs[idxs[k]].float() * rescale
                if clipv > 0:
                    gr = torch.clamp(gr, -clipv, clipv)
                gn.append(l2_norm(gr))
            gn = torch.stack(gn)
            if shard_norms is not None:
                wn, gn = shard_norms([ws[idxs[k]] for k in live], wn, gn)
            wd_l = _take(wds, [idxs[k] for k in live])
            trust = torch.where((wn > 0) & (gn > 0),
                                eta * wn / (gn + wd_l * wn + epsilon), 1.0)
            scaled = _take(lr_t, live) * trust
            at = {k: j for j, k in enumerate(live)}
            lr_t = torch.stack([scaled[at[k]] if k in at else lr_t[k]
                                for k in range(len(idxs))])
        args = (flatten_group(ws, idxs), flatten_group(gs, idxs),
                flatten_group(ms, idxs),
                _per_element(lr_t, shapes, total, dev, diff),
                _per_element(_take(wds, idxs), shapes, total, dev, diff),
                _per_element([-1.0 if skips[i] else 1.0 for i in idxs],
                             shapes, total, dev),
                rescale)
        nW, nM = FlatLars.apply(*args, momentum, clipv)
        for i, pw, pm in zip(idxs, split_group(nW, shapes),
                             split_group(nM, shapes)):
            if diff:
                new_ws[i] = _keep_if(finite, pw, ws[i])
                new_ms[i] = _keep_if(finite, pm, ms[i])
            else:
                ws[i].copy_(_keep_if(finite, pw, ws[i]))
                ms[i].copy_(_keep_if(finite, pm, ms[i]))
    return (new_ws, new_ms) if diff else (ws, ms)


def lamb_bias_corrections(t, beta1=0.9, beta2=0.999, bias_correction=True):
    """LAMB's ``(bc1, bc2) = (1 / (1 - beta1**t), 1 / (1 - beta2**t))``
    for step ``t`` (``(1, 1)`` without bias correction), on the host."""
    if not bias_correction:
        return 1.0, 1.0
    return 1.0 / (1.0 - beta1 ** t), 1.0 / (1.0 - beta2 ** t)


def lamb_bucket_update(ws, gs, means, variances, lrs, wds, t, beta1=0.9,
                       beta2=0.999, epsilon=1e-6, bias_correction=True,
                       lower_bound=None, upper_bound=None, rescale=1.0,
                       clip=None, finite=None, corrections=None,
                       shard_norms=None):
    """Bucket-flattened LAMB over parameter lists (weights, gradients,
    first and second moments; per-tensor ``lrs``/``wds``, numbers or
    fp32 ``(P,)`` tensors; ``t`` the step count for bias correction,
    unless ``corrections``, an fp32 ``(2,)`` tensor, gives ``(bc1,
    bc2)``; ``rescale`` a number or an fp32 tensor of one element).
    Writes the new weights and moments into ``ws``, ``means`` and
    ``variances`` in place (the old ones where ``finite`` is false) and
    returns them; when an input requires a gradient (grad mode on),
    returns new lists instead, differentiable w.r.t. every input.
    ``shard_norms`` as for :func:`lars_bucket_update`."""
    if not ws:
        return ws, means, variances
    diff = _differentiating(ws, gs, means, variances, lrs, wds, rescale,
                            corrections)
    with torch.set_grad_enabled(diff):
        return _lamb_bucket(ws, gs, means, variances, lrs, wds, t, beta1,
                            beta2, epsilon, bias_correction, lower_bound,
                            upper_bound, rescale, clip, finite, corrections,
                            shard_norms, diff)


def _lamb_bucket(ws, gs, means, variances, lrs, wds, t, beta1, beta2,
                 epsilon, bias_correction, lower_bound, upper_bound,
                 rescale, clip, finite, corrections, shard_norms, diff):
    new = [list(ws), list(means), list(variances)]
    dev0 = ws[0].device
    lrs, wds = _vector(lrs, dev0), _vector(wds, dev0)
    if corrections is None:
        corrections = lamb_bias_corrections(t, beta1, beta2,
                                            bias_correction)
    scalars = torch.cat([_scalar_vector(rescale, 1, dev0),
                         _scalar_vector(corrections, 2, dev0)])
    for _dtype, idxs in dtype_groups(ws):
        dev = ws[idxs[0]].device
        shapes = [ws[i].shape for i in idxs]
        total = sum(ws[i].numel() for i in idxs)
        W = flatten_group(ws, idxs)
        args = (W, flatten_group(gs, idxs), flatten_group(means, idxs),
                flatten_group(variances, idxs),
                _per_element(_take(wds, idxs), shapes, total, dev, diff),
                scalars)
        gw, nm, nv = FlatLamb1.apply(*args, beta1, beta2, epsilon, clip)
        # per-tensor trust ratio (lamb_update_phase2 semantics)
        r1 = _segment_norms(W, shapes)
        r2 = _segment_norms(gw, shapes)
        if shard_norms is not None:
            r1, r2 = shard_norms([ws[i] for i in idxs], r1, r2)
        if lower_bound is not None and lower_bound > 0:
            r1 = torch.clamp_min(r1, lower_bound)
        if upper_bound is not None and upper_bound > 0:
            r1 = torch.clamp_max(r1, upper_bound)
        ratio = torch.where((r1 == 0) | (r2 == 0), 1.0, r1 / r2)
        step = _take(lrs, idxs) * ratio
        # phase 2, w -= lr * ratio * gw, and the moments, written back
        # tensor by tensor
        for k, (i, pg, pm, pv) in enumerate(zip(
                idxs, split_group(gw, shapes), split_group(nm, shapes),
                split_group(nv, shapes))):
            nw = torch.addcmul(ws[i], pg, step[k], value=-1.0) \
                .to(ws[i].dtype)
            for lst, src, val in zip(new, (ws, means, variances),
                                     (nw, pm, pv)):
                kept = _keep_if(finite, val, src[i])
                if diff:
                    lst[i] = kept
                else:
                    src[i].copy_(kept)
    return tuple(new) if diff else (ws, means, variances)


def bucket_supported(opt) -> bool:
    """Whether the optimizer has a bucket-flattened update (LARS and
    LAMB)."""
    from ..optimizer import LAMB, LARS
    return type(opt) in (LARS, LAMB)


@torch.no_grad()
def bucket_update(opt, items, feed=None, finite=None, shard_norms=None):
    """The bucketed update ``TrainStep`` runs: ``items`` is ``[(index,
    weight, grad, state)]``; ``opt``'s update counts must already have
    advanced for this step.  Updates weights and states in place (under
    ``no_grad``: the parameters require gradients, and the step does not
    differentiate its update).

    ``feed``, when given, holds this step's scalars as device tensors
    (``lrs`` and ``wds`` ``(P,)`` in ``items``' order, ``rescale``
    ``(1,)``, ``corrections`` LAMB's ``(bc1, bc2)``): the JAX step's
    traced ``lrs, wds, rescale, t``.  Without it they are read from the
    optimizer on the host.  ``finite`` keeps the old weights and states
    where it is false; ``shard_norms`` as for
    :func:`lars_bucket_update`."""
    if not bucket_supported(opt):
        raise MXNetError("no bucketed update for %s" % type(opt).__name__)
    from ..optimizer import LARS
    idxs = [i for i, _w, _g, _s in items]
    ws = [w for _i, w, _g, _s in items]
    gs = [g for _i, _w, g, _s in items]
    if feed is not None:
        lrs, wds, rescale = feed["lrs"], feed["wds"], feed["rescale"]
    else:
        lrs = [opt._get_lr(i) for i in idxs]
        wds = [opt._get_wd(i) for i in idxs]
        rescale = opt.rescale_grad
    if type(opt) is LARS:
        lars_bucket_update(
            ws, gs, [s for _i, _w, _g, s in items], lrs, wds,
            [opt._skip_lars(i) for i in idxs], momentum=opt.momentum,
            eta=opt.eta, epsilon=opt.epsilon, rescale=rescale,
            clip=opt.clip_gradient, finite=finite, shard_norms=shard_norms)
        return
    t = opt._index_update_count[idxs[0]] if idxs else 0
    lamb_bucket_update(
        ws, gs, [s[0] for _i, _w, _g, s in items],
        [s[1] for _i, _w, _g, s in items], lrs, wds, t,
        beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon,
        bias_correction=opt.bias_correction, lower_bound=opt.lower_bound,
        upper_bound=opt.upper_bound, rescale=rescale,
        clip=opt.clip_gradient, finite=finite,
        corrections=None if feed is None else feed["corrections"],
        shard_norms=shard_norms)
