"""Contrib operators of the layer slice (counterpart of ``im2col``,
``col2im`` and ``CTCLoss`` in ``mxnet_tpu/ops/contrib_ops.py``):
patches of an NCHW image and their adjoint, and the CTC loss as an
operator, the log-space alpha recursion over ``(T, N, C)`` activations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .table import register

__all__ = ["CTCLoss", "col2im", "im2col"]


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, float)) \
        else tuple(int(x) for x in v)


@register("im2col")
def im2col(data, kernel=(3, 3), stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """``(N, C, H, W)`` -> ``(N, C * kh * kw, L)`` patches, channel
    major."""
    return F.unfold(data, _pair(kernel), _pair(dilate), _pair(pad),
                    _pair(stride))


@register("col2im")
def col2im(data, output_size=(0, 0), kernel=(3, 3), stride=(1, 1),
           dilate=(1, 1), pad=(0, 0)):
    """The adjoint of :func:`im2col`: patches summed back into ``(N, C,
    *output_size)``."""
    return F.fold(data, _pair(output_size), _pair(kernel), _pair(dilate),
                  _pair(pad), _pair(stride))


_NEG_INF = -1e30


@register("CTCLoss", args=("data", "label"), aliases=("ctc_loss",))
def CTCLoss(data, label, use_data_lengths=False, use_label_lengths=False,
            blank_label="first"):
    """Negative log-likelihood of each ``(N, L)`` label row under the
    ``(T, N, C)`` activations: the JAX op's recursion.  The blank is
    class 0 (``"first"``) or ``C - 1`` (``"last"``); a negative label is
    padding.  Every sample runs all ``T`` steps: the length flags are
    accepted and unused, as in the JAX op."""
    t_len, n, c = data.shape
    logp = torch.log_softmax(data.float(), dim=-1)
    blank = 0 if blank_label == "first" else c - 1
    lab = label.long()
    s_len = 2 * lab.shape[1] + 1
    dev = data.device
    ext = torch.full((n, s_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    valid = torch.cat([torch.ones(n, 1, dtype=torch.bool, device=dev),
                       (lab >= 0).repeat_interleave(2, dim=1)], dim=1)
    ext = torch.where(valid[:, :s_len], ext, blank)
    label_len = (lab >= 0).sum(dim=1)
    rows = torch.arange(n, device=dev)
    neg = torch.full((n, 1), _NEG_INF, device=dev)
    alpha = torch.full((n, s_len), _NEG_INF, device=dev)
    alpha[:, 0] = logp[0][rows, ext[:, 0]]
    alpha[:, 1] = torch.where(label_len > 0, logp[0][rows, ext[:, 1]],
                              torch.full_like(alpha[:, 1], _NEG_INF))
    alpha = alpha.clone()
    same = torch.cat([torch.zeros(n, 2, dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, t_len):
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        a2 = torch.where(same, _NEG_INF, a2)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        m_safe = torch.clamp_min(m, _NEG_INF)
        summed = torch.exp(alpha - m_safe) + torch.exp(a1 - m_safe) \
            + torch.exp(a2 - m_safe)
        alpha = m_safe + torch.log(summed) + torch.gather(logp[t], 1, ext)
    last_blank = alpha[rows, 2 * label_len]
    last_label = alpha[rows, torch.clamp_min(2 * label_len - 1, 0)]
    # an empty label row has only the all-blank path
    last_label = torch.where(label_len == 0, _NEG_INF, last_label)
    m = torch.maximum(last_blank, last_label)
    ll = m + torch.log(torch.exp(last_blank - m) + torch.exp(last_label - m))
    return (-ll).to(data.dtype)
