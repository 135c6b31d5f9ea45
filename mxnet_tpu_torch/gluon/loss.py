"""Loss blocks (counterpart of ``mxnet_tpu/gluon/loss.py``): each
returns the per-sample loss, averaged over every axis but the batch
axis (``TripletLoss``, ``CosineEmbeddingLoss`` and ``CTCLoss`` return
one value a sample)."""
from __future__ import annotations

import torch
import torch.nn.functional as F_

from .block import HybridBlock

__all__ = ["CTCLoss", "CosineEmbeddingLoss", "HingeLoss", "HuberLoss",
           "KLDivLoss", "L1Loss", "L2Loss", "LogisticLoss", "Loss",
           "SigmoidBCELoss", "SigmoidBinaryCrossEntropyLoss",
           "SoftmaxCELoss", "SoftmaxCrossEntropyLoss", "SquaredHingeLoss",
           "TripletLoss"]


def _batch_mean(loss, batch_axis):
    dims = [d for d in range(loss.dim()) if d != batch_axis % loss.dim()]
    return loss.mean(dim=dims) if dims else loss


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred) ** 2
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of ``softmax(pred)``; ``label`` holds class indices
    (``sparse_label``) or a distribution."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class L1Loss(Loss):
    """``weight * |label - pred|``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of ``sigmoid(pred)`` (``pred`` itself with
    ``from_sigmoid``), the logits form computed stably.  ``pos_weight``
    is accepted and, as in the JAX package, not applied."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            loss = torch.relu(pred) - pred * label \
                + F_.softplus(-pred.abs())
        else:
            eps = 1e-12
            loss = -(torch.log(pred + eps) * label
                     + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities
    (``from_logits``) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HuberLoss(Loss):
    """``|d| - rho / 2`` above ``rho``, ``d^2 / (2 rho)`` below."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss * loss)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss * loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """``softplus(-pred * label)``, labels in {-1, 1} (``signed``) or
    {0, 1} (``binary``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "binary":
            label = 2 * label - 1
        loss = F_.softplus(-pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


def _sum_but(x, batch_axis):
    dims = [d for d in range(x.dim()) if d != batch_axis % x.dim()]
    return x.sum(dim=dims) if dims else x


class TripletLoss(Loss):
    """``relu(|a - p|^2 - |a - n|^2 + margin)`` a sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, anchor, positive, negative,
                       sample_weight=None):
        loss = _sum_but((anchor - positive) ** 2 - (anchor - negative) ** 2,
                        self._batch_axis)
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` where ``label`` is 1, ``relu(cos - margin)``
    elsewhere, the cosine over the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        num = (input1 * input2).sum(dim=-1)
        denom = (input1 * input1).sum(dim=-1).sqrt() \
            * (input2 * input2).sum(dim=-1).sqrt()
        cos = num / (denom + 1e-12)
        loss = torch.where(label.reshape(cos.shape) == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


_NEG_INF = -1e30


class CTCLoss(Loss):
    """Connectionist temporal classification, the JAX layer's own
    log-space alpha recursion (not the op's): blank is class 0, a
    negative label is padding and maps to blank, ``layout`` ``NTC`` or
    ``TNC``; a sample's steps past ``pred_lengths`` carry its alphas
    unchanged, and ``label_lengths`` (by default the count of
    non-negative labels) picks where its paths end."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        logits = pred.transpose(0, 1) if self._layout == "TNC" else pred
        b, t_len, _v = logits.shape
        logp = torch.log_softmax(logits, dim=-1)
        labels = label.long()
        s_len = 2 * labels.shape[1] + 1
        dev = logits.device
        ext = torch.zeros((b, s_len), dtype=torch.long, device=dev)
        ext[:, 1::2] = torch.where(labels >= 0, labels, 0)
        alpha = torch.full((b, s_len), _NEG_INF, dtype=logp.dtype,
                           device=dev)
        alpha[:, 0] = logp[:, 0, 0]
        alpha[:, 1] = torch.gather(logp[:, 0, :], 1, ext[:, 1:2])[:, 0]
        alpha = alpha.clone()
        same = torch.cat([torch.ones((b, 2), dtype=torch.bool, device=dev),
                          ext[:, 2:] == ext[:, :-2]], dim=1)
        pl = pred_lengths.long() if pred_lengths is not None \
            else torch.full((b,), t_len, dtype=torch.long, device=dev)
        neg = torch.full((b, 1), _NEG_INF, dtype=logp.dtype, device=dev)
        for t in range(1, t_len):
            a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
            a2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
            a2 = torch.where(same, _NEG_INF, a2)
            m = torch.maximum(torch.maximum(alpha, a1), a2)
            dead = m <= _NEG_INF / 2
            m_safe = torch.where(dead, 0.0, m)
            summed = torch.exp(alpha - m_safe) + torch.exp(a1 - m_safe) \
                + torch.exp(a2 - m_safe)
            summed = torch.where(dead, 0.0, summed)
            new = m_safe + torch.log(torch.clamp_min(summed, 1e-37))
            new = torch.where(dead, _NEG_INF, new)
            emit = torch.gather(logp[:, t, :], 1, ext)
            active = (t < pl)[:, None]
            alpha = torch.where(active, new + emit, alpha)
        ll = label_lengths.long() if label_lengths is not None \
            else (labels >= 0).sum(dim=1)
        end = 2 * ll
        last1 = torch.gather(alpha, 1, end[:, None])[:, 0]
        last2 = torch.gather(alpha, 1, torch.clamp_min(end - 1, 0)[:, None])
        # an empty label row has only the all-blank path
        last2 = torch.where(ll == 0, _NEG_INF, last2[:, 0])
        m = torch.maximum(last1, last2)
        total = m + torch.log(torch.exp(last1 - m) + torch.exp(last2 - m))
        return -total
