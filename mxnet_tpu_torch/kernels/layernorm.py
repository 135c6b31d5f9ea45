"""LayerNorm forward kernel (counterpart of
``mxnet_tpu/ops/pallas/layernorm.py``).

``layernorm_fwd`` normalises the last axis of a ``(rows, dim)`` tensor
with fp32 statistics (the mean, then the mean of the centred squares)
and stores the result at the input dtype; ``gamma`` and ``beta`` are
applied in fp32.  :func:`layernorm_fwd_cuda` launches
``csrc/layernorm.cu`` on PyTorch's current stream, on the route the
kernel's launcher picks for the shape and pointers
(:func:`layernorm_route`); :func:`layernorm_reference` is its plain
PyTorch version (the JAX package's ``_ln_xla_lastaxis``), which runs
the CPU path, is the oracle the kernel is held against on the card,
and is what the LayerNorm backward differentiates
(:func:`mxnet_tpu_torch.ops.nn.LayerNorm`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from .costs import layernorm_cost
from .registry import KernelSpec, count_launch, register_kernel

__all__ = ["layernorm_fwd_cuda", "layernorm_reference", "layernorm_route"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's routes by their codes in csrc/layernorm.cu
_ROUTES = {1: "ring", 2: "generic"}


def layernorm_reference(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x`` (any rank)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(x.dtype)


@functools.cache
def _lib():
    from .. import _build
    lib = _build.load("layernorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.layernorm_fwd_launch.argtypes = [p, p, p, p, ctypes.c_int64, i,
                                         ctypes.c_float, i, p]
    lib.layernorm_fwd_launch.restype = i
    lib.layernorm_fwd_route.argtypes = [p, p, p, p, i, i]
    lib.layernorm_fwd_route.restype = i
    lib.layernorm_error_string.argtypes = [i]
    lib.layernorm_error_string.restype = ctypes.c_char_p
    return lib


def _checked(x2d, gamma, beta, fn):
    """``gamma`` and ``beta`` as the fp32 vectors the kernel reads, after
    the checks of what it takes."""
    if x2d.device.type != "cuda":
        raise MXNetError("%s needs a CUDA tensor, got x on %s"
                         % (fn, x2d.device))
    if x2d.dim() != 2:
        raise MXNetError("%s: x must be (rows, dim), got %s"
                         % (fn, tuple(x2d.shape)))
    if x2d.dtype not in _DTYPE_CODES:
        raise MXNetError("%s: x must be float32 or bfloat16, got %s"
                         % (fn, x2d.dtype))
    if not x2d.is_contiguous():
        raise MXNetError("%s: x is not contiguous" % fn)
    dim = x2d.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x2d.device:
            raise MXNetError("%s: %s on %s, x on %s"
                             % (fn, name, t.device, x2d.device))
        if tuple(t.shape) != (dim,):
            raise MXNetError("%s: %s must be (%d,), got %s"
                             % (fn, name, dim, tuple(t.shape)))
    return (gamma.detach().float().contiguous(),
            beta.detach().float().contiguous())


def layernorm_fwd_cuda(x2d, gamma, beta, eps=1e-5):
    """Launch the kernel on PyTorch's current stream: ``x2d`` a
    contiguous CUDA ``(rows, dim)`` tensor, fp32 or bf16; ``gamma`` and
    ``beta`` ``(dim,)`` on the same device (applied in fp32)."""
    g, b = _checked(x2d, gamma, beta, "layernorm_fwd_cuda")
    lib = _lib()
    out = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.layernorm_fwd_launch(
            x2d.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
            x2d.shape[0], x2d.shape[1], float(eps), _DTYPE_CODES[x2d.dtype],
            stream)
    if rc != 0:
        raise MXNetError("layernorm_fwd kernel launch failed: %s (%d)"
                         % (lib.layernorm_error_string(rc).decode(), rc))
    count_launch("layernorm_fwd", x2d.dtype,
                 cost_args=((x2d, gamma, beta), {}))
    return out


def layernorm_route(x2d, gamma, beta):
    """The route :func:`layernorm_fwd_cuda` takes for these tensors."""
    g, b = _checked(x2d, gamma, beta, "layernorm_route")
    out_aligned = 0   # the launcher's output comes from the allocator
    code = _lib().layernorm_fwd_route(
        x2d.data_ptr(), g.data_ptr(), b.data_ptr(), out_aligned,
        x2d.shape[1], _DTYPE_CODES[x2d.dtype])
    return _ROUTES[code]


register_kernel(KernelSpec(
    name="layernorm_fwd",
    plain=layernorm_reference,
    launch=layernorm_fwd_cuda,
    source="csrc/layernorm.cu",
    replaces="mxnet_tpu/ops/pallas/layernorm.py:38 layernorm_fwd_pallas",
    cost=layernorm_cost,
    category="elementwise_fusion",
    remedies=("unfused-elementwise",),
))
