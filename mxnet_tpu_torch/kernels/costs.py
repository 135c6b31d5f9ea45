"""Cost functions of the hand kernels: the operations and bytes one
launch needs, from its launch shapes.

A kernel launched through ``ctypes`` is invisible to a
``TorchDispatchMode`` walk (:mod:`mxnet_tpu_torch.profiling.aten`), so
each :class:`~.registry.KernelSpec` carries one of these, and
:func:`~.registry.count_launch` hands it the launch's arguments.  Each
function takes the arguments of its kernel's plain version and
launcher and returns ``(flops, bytes)``: every input read once, every
output written once, and the operations the function needs -- the
formulas of the bound each kernel's time is held against
(``chip_smoke.py :: bn_relu_bound``, ``flash_bounds``,
``paged_attention_bound``, the ``layernorm``, ``lars_flat`` and
``lamb_phase1`` times).  A masked flash launch counts every key's
products: the valid keys are on the card, and a cost function never
reads device memory.
"""
from __future__ import annotations

__all__ = ["KERNEL_NUMERICS", "bn_relu_apply_cost", "bn_relu_bwd_cost", "flash_fwd_cost",
           "flash_bwd_cost", "lamb_phase1_cost", "lars_flat_cost",
           "layernorm_cost", "paged_attention_cost"]


# The type each kernel accumulates in, whatever it reads and writes, and
# whether it reduces (a sum over rows, a norm): the numerics audit counts
# a kernel by these, not by its input dtype.  Every hand kernel holds its
# sums in fp32: the flash kernels their softmax statistics and products
# (mma.sync with fp32 accumulators on bf16), paged attention its dot
# products, LayerNorm its row moments, LARS and LAMB their norms.
KERNEL_NUMERICS = {
    "bn_relu_apply": {"accumulates": "float32", "reduces": False},
    "bn_relu_bwd": {"accumulates": "float32", "reduces": False},
    "flash_attention_fwd": {"accumulates": "float32", "reduces": True},
    "flash_attention_bwd": {"accumulates": "float32", "reduces": True},
    "paged_attention": {"accumulates": "float32", "reduces": True},
    "layernorm_fwd": {"accumulates": "float32", "reduces": True},
    "lars_flat": {"accumulates": "float32", "reduces": False},
    "lamb_phase1": {"accumulates": "float32", "reduces": False},
}


def bn_relu_apply_cost(x2d, scale, offset):
    """x read, out written, two fp32 ``(C,)`` vectors; fma and max."""
    rows, c = x2d.shape
    return 3 * rows * c, 2 * rows * c * x2d.element_size() + 4 * 2 * c


def bn_relu_bwd_cost(x2d, dy2d, y2d, a, mean, inv, c1, c2):
    """x, dy, y read, dx written, five fp32 vectors; ~8 flops an
    element."""
    rows, c = x2d.shape
    return 8 * rows * c, 4 * rows * c * x2d.element_size() + 4 * 5 * c


def _mask_bytes(q, mask, heads):
    if mask is None:
        return 0
    bh, seq = q.shape[0], q.shape[1]
    return (bh // max(int(heads), 1)) * seq * seq * 4


def flash_fwd_cost(q, k, v, mask=None, causal=False, scale=1.0, heads=1):
    """q, k, v read, out and the fp32 lse written (and the fp32 mask
    once per batch element); two products, ``4 bh seq^2 d``."""
    bh, seq, d = q.shape
    n = bh * seq * d * q.element_size()
    return (4 * bh * seq * seq * d,
            4 * n + 4 * bh * seq + _mask_bytes(q, mask, heads))


def flash_bwd_cost(q, k, v, lse, dout, delta, mask=None, causal=False,
                   scale=1.0, heads=1):
    """q, k, v, dout, lse, delta read, dq, dk, dv written; the five
    products the function needs, ``10 bh seq^2 d``."""
    bh, seq, d = q.shape
    n = bh * seq * d * q.element_size()
    return (10 * bh * seq * seq * d,
            7 * n + 8 * bh * seq + _mask_bytes(q, mask, heads))


def layernorm_cost(x2d, gamma, beta, eps=1e-5):
    """The rows read and written once, fp32 gamma and beta; 8 fp32
    operations an element."""
    rows, dim = x2d.shape
    return 8 * rows * dim, 2 * rows * dim * x2d.element_size() + 2 * dim * 4


def lars_flat_cost(w, g, m, lr, wd, sign, rescale, momentum=0.9, clip=0.0):
    """w, g, m and the fp32 lr, wd, sign read, w' and m' written, the
    fp32 rescale; 8 operations an element."""
    n = w.numel()
    return 8 * n, n * (5 * w.element_size() + 12) + 4


def lamb_phase1_cost(w, g, m, v, wd, scalars, beta1=0.9, beta2=0.999,
                     eps=1e-6, clip=0.0):
    """w, g, m, v and the fp32 wd read, the fp32 update and m', v'
    written, the three fp32 scalars; 12 operations an element."""
    n, s = w.numel(), w.element_size()
    return 12 * n, n * (6 * s + 8) + 12


def paged_attention_cost(q, k_cache, v_cache, block_tables, context_lens,
                         scale=1.0):
    """q read and out written, the live table entries and context
    lengths, the live K/V rows; ``4 live heads d`` flops.  The lengths
    are read on the host (a walk is an eager run)."""
    bs, heads, d = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    lens = [int(c) for c in context_lens.flatten().tolist()]
    live = sum(lens)
    nbytes = (2 * q.numel() * q.element_size() + 4 * len(lens)
              + 4 * sum(-(-c // bs) for c in lens)
              + 2 * live * heads * d * k_cache.element_size())
    return 4 * live * heads * d, nbytes
