"""Flash attention forward and backward kernels (counterpart of
``mxnet_tpu/ops/pallas/flash_attention.py`` and its registry entry
``mxnet_tpu/kernels/flash_attention.py``).

Two kernels, each with its plain version:

- ``flash_attention_fwd`` -- ``(out, lse)`` of softmax attention over
  ``(bh, seq, d)`` tensors: ``s = q k^T * scale`` (fp32), masked scores
  set to -1e30, ``lse = logsumexp(s)``, ``out = exp(s - lse) v`` at the
  input dtype;
- ``flash_attention_bwd`` -- ``(dq, dk, dv)`` replayed from ``lse``:
  ``p = exp(s - lse)``, ``dv = p^T do``, ``ds = p (do v^T - delta) *
  scale``, ``dk = ds^T q``, ``dq = ds k``, with ``delta = rowsum(do *
  out)`` from the caller; a row whose keys are all masked gives each
  key 1 / seq, as softmax does (its lse, -1e30 + log(seq), is -1e30 in
  fp32).

The forward kernel runs both products on the tensor cores: 3xTF32 in
fp32 (about fp32's precision), bf16 products with P rounded to bf16
before ``P v`` in bf16, as the JAX package's XLA math rounds it.

Both take the optional ``causal`` flag and the optional ``(b, seq, seq)``
mask (> 0 = attend) shared by the ``heads`` heads folded into ``bh``.
The ``*_cuda`` functions launch ``csrc/flash_attention.cu`` (built on
first use by :mod:`mxnet_tpu_torch._build`) on PyTorch's current stream;
the ``*_reference`` functions are the plain PyTorch versions, which run
the CPU path and are the oracle the kernels are held against on the
card.  The port has no auto gate: the JAX package's seq >= 256 crossover
is a TPU measurement, and the kernels take any ``seq`` and a head dim up
to 128.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from .costs import flash_bwd_cost, flash_fwd_cost
from .registry import KernelSpec, count_launch, register_kernel

__all__ = ["MAX_HEAD_DIM", "NEG_INF", "flash_attention_bwd_cuda",
           "flash_attention_bwd_reference", "flash_attention_fwd_cuda",
           "flash_attention_fwd_reference"]

NEG_INF = -1e30            # a masked score, as in the TPU kernel
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q, k, mask, causal, scale, heads):
    """fp32 ``q k^T * scale`` with masked scores at ``NEG_INF``."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, NEG_INF)
    if mask is not None:
        keep = mask.repeat_interleave(heads, dim=0) > 0
        s = torch.where(keep, s, NEG_INF)
    return s


def flash_attention_fwd_reference(q, k, v, mask=None, causal=False,
                                  scale=1.0, heads=1):
    """Plain version of the forward kernel: ``(out, lse)``.  A row whose
    keys are all masked averages them, as the kernel does."""
    s = _scores(q, k, mask, causal, scale, heads)
    out = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_bwd_reference(q, k, v, lse, dout, delta, mask=None,
                                  causal=False, scale=1.0, heads=1):
    """Plain version of the backward kernels (the math of the JAX
    package's ``_xla_attention_bwd``, replayed from the kernel's inputs
    ``lse`` and ``delta``): ``(dq, dk, dv)``.  A row whose keys are all
    masked gives each key the weight 1 / seq, as softmax does."""
    qf, kf = q.float(), k.float()
    p = torch.exp(_scores(q, k, mask, causal, scale, heads) - lse[..., None])
    # A row with no key has every score at NEG_INF, and fp32 holds its
    # lse, NEG_INF + log(seq), as NEG_INF: exp(s - lse) is then 1 where
    # softmax gives each key 1 / seq.
    p = torch.where(lse[..., None] <= NEG_INF, p / p.shape[-1], p)
    do = dout.float()
    dv = torch.matmul(p.transpose(1, 2), do)
    dp = torch.matmul(do, v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _lib():
    from .. import _build
    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, i,
                                     p]
    lib.flash_fwd_launch.restype = i
    lib.flash_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i,
                                     i, i, f, i, i, p]
    lib.flash_bwd_launch.restype = i
    lib.flash_fwd_attributes.argtypes = [p, p, p, i, i,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.flash_fwd_attributes.restype = i
    lib.flash_mma_test_launch.argtypes = [p, p, p, p, p, i, p]
    lib.flash_mma_test_launch.restype = i
    lib.flash_error_string.argtypes = [i]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn, seqs, vectors, mask, heads):
    """Raise unless every ``(name, tensor)`` of ``seqs`` is a contiguous
    CUDA ``(bh, seq, d)`` tensor of one fp32/bf16 dtype with ``d <=
    MAX_HEAD_DIM``, every one of ``vectors`` a contiguous fp32 ``(bh,
    seq)`` tensor, and ``mask`` (when given) a contiguous fp32 ``(bh /
    heads, seq, seq)`` tensor, all on one device."""
    name0, x = seqs[0]
    dev = x.device
    if dev.type != "cuda":
        raise MXNetError("%s needs CUDA tensors, got %s on %s"
                         % (fn, name0, dev))
    if x.dim() != 3:
        raise MXNetError("%s: %s must be (bh, seq, d), got %s"
                         % (fn, name0, tuple(x.shape)))
    if x.dtype not in _DTYPE_CODES:
        raise MXNetError("%s: inputs must be float32 or bfloat16, got %s"
                         % (fn, x.dtype))
    bh, seq, d = x.shape
    if d > MAX_HEAD_DIM:
        raise MXNetError("%s: head_dim %d > %d is not supported by the "
                         "kernel" % (fn, d, MAX_HEAD_DIM))
    if bh > 65535:
        raise MXNetError("%s: batch*heads %d > 65535" % (fn, bh))
    extra = vectors + ([("mask", mask)] if mask is not None else [])
    for name, t in seqs + extra:
        if t.device != dev:
            raise MXNetError("%s: %s on %s, %s on %s"
                             % (fn, name, t.device, name0, dev))
        if not t.is_contiguous():
            raise MXNetError("%s: %s is not contiguous" % (fn, name))
    for name, t in seqs[1:]:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise MXNetError("%s: %s is %s %s, %s is %s %s"
                             % (fn, name, tuple(t.shape), t.dtype, name0,
                                tuple(x.shape), x.dtype))
    for name, t in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, seq):
            raise MXNetError("%s: %s must be float32 of shape (%d, %d), got "
                             "%s %s" % (fn, name, bh, seq, t.dtype,
                                        tuple(t.shape)))
    if mask is not None:
        if heads < 1 or bh % heads:
            raise MXNetError("%s: batch*heads %d is not a multiple of heads "
                             "%d" % (fn, bh, heads))
        want = (bh // heads, seq, seq)
        if mask.dtype != torch.float32 or tuple(mask.shape) != want:
            raise MXNetError("%s: mask must be float32 of shape %s, got %s "
                             "%s" % (fn, want, mask.dtype,
                                     tuple(mask.shape)))


def _raise_on(lib, rc, what):
    if rc != 0:
        raise MXNetError("%s kernel launch failed: %s (%d)"
                         % (what, lib.flash_error_string(rc).decode(), rc))


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_fwd_cuda(q, k, v, mask=None, causal=False, scale=1.0,
                             heads=1):
    """Launch the forward kernel on PyTorch's current stream; returns
    ``(out, lse)``."""
    _check("flash_attention_fwd_cuda", [("q", q), ("k", k), ("v", v)], [],
           mask, heads)
    lib = _lib()
    bh, seq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            out.data_ptr(), lse.data_ptr(), bh, seq, d, int(heads),
            float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, rc, "flash_attention_fwd")
    count_launch("flash_attention_fwd", q.dtype,
                 None if mask is None else "masked", cost_args=(
                     (q, k, v), {"mask": mask, "heads": heads}))
    return out, lse


def flash_attention_bwd_cuda(q, k, v, lse, dout, delta, mask=None,
                             causal=False, scale=1.0, heads=1):
    """Launch the one-pass backward kernel on PyTorch's current stream
    (read at call time: backward runs on autograd's thread); returns
    ``(dq, dk, dv)``.  dq is summed by fp32 reductions in device memory
    into a zeroed buffer (dq itself in fp32; in bf16 an fp32 scratch
    that the kernel then casts), so its sums run in an order that
    changes from call to call.  One call counts one launch."""
    _check("flash_attention_bwd_cuda",
           [("q", q), ("k", k), ("v", v), ("dout", dout)],
           [("lse", lse), ("delta", delta)], mask, heads)
    lib = _lib()
    bh, seq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        dq = dq_acc = torch.zeros_like(q)
    else:
        dq = torch.empty_like(q)
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(mask), dq_acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, seq, d,
            int(heads), float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, rc, "flash_attention_bwd")
    count_launch("flash_attention_bwd", q.dtype,
                 None if mask is None else "masked", cost_args=(
                     (q, k, v, lse, dout, delta),
                     {"mask": mask, "heads": heads}))
    return dq, dk, dv


register_kernel(KernelSpec(
    name="flash_attention_fwd",
    plain=flash_attention_fwd_reference,
    launch=flash_attention_fwd_cuda,
    source="csrc/flash_attention.cu",
    replaces="mxnet_tpu/ops/pallas/flash_attention.py:101 "
             "flash_attention_fwd_pallas",
    cost=flash_fwd_cost,
    category="conv_dot",
))

register_kernel(KernelSpec(
    name="flash_attention_bwd",
    plain=flash_attention_bwd_reference,
    launch=flash_attention_bwd_cuda,
    source="csrc/flash_attention.cu",
    replaces="mxnet_tpu/ops/pallas/flash_attention.py:250 "
             "flash_attention_bwd_pallas",
    cost=flash_bwd_cost,
    category="conv_dot",
))
