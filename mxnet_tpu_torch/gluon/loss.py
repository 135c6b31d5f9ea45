"""Loss blocks (counterpart of ``mxnet_tpu/gluon/loss.py``): each
returns the per-sample loss, averaged over every axis but the batch
axis."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["L2Loss", "Loss", "SoftmaxCELoss", "SoftmaxCrossEntropyLoss"]


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
