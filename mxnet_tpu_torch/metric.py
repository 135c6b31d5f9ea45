"""Streaming evaluation metrics (the port's own copy of
``mxnet_tpu/metric.py``).  Labels and predictions may be NDArrays,
tensors or numpy arrays; each update reads them on the host (for an
array on the card, a wait for the card)."""
from __future__ import annotations

import numpy as np

import torch

from .base import MXNetError
from .ndarray import NDArray

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    key = str(metric).lower()
    if key == "acc":
        key = "accuracy"
    if key == "ce":
        key = "crossentropy"
    if key not in _METRIC_REGISTRY:
        raise MXNetError("unknown metric %r" % metric)
    return _METRIC_REGISTRY[key](*args, **kwargs)


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def reset_local(self):
        """Reset the rolling window (reference keeps global vs local
        stats; here the two coincide)."""
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        """``(name, value)`` over every process; the port runs one
        process, so this is :meth:`get`."""
        return self.get()

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


def _listify(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(np.int64).ravel()
            label = label.astype(np.int64).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__("%s_%d" % (name, top_k), **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label).astype(np.int64).ravel()
            pred = _as_np(pred)
            topk = np.argsort(-pred, axis=-1)[:, :self.top_k]
            self.sum_metric += (topk == label[:, None]).any(-1).sum()
            self.num_inst += len(label)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            self.sum_metric += ((label.reshape(pred.shape) - pred) ** 2).mean() \
                * len(label)
            self.num_inst += len(label)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            self.sum_metric += np.abs(label.reshape(pred.shape) - pred).mean() \
                * len(label)
            self.num_inst += len(label)


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            self.sum_metric += np.sqrt(
                ((label.reshape(pred.shape) - pred) ** 2).mean()) * len(label)
            self.num_inst += len(label)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label).ravel().astype(np.int64)
            pred = _as_np(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += (-np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label).ravel().astype(np.int64)
            pred = _as_np(pred).reshape(-1, _as_np(pred).shape[-1])
            prob = pred[np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = prob[~ignore]
            self.sum_metric += (-np.log(prob + self.eps)).sum()
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(np.exp(self.sum_metric / self.num_inst)))


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_np(label).ravel().astype(np.int64)
            pred = _as_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(-1)
            pred = pred.ravel().astype(np.int64)
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return (self.name, f1)


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _listify(preds):
            loss = _as_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False):
        super().__init__(name)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            v = self._feval(_as_np(label), _as_np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


def np_metric(fn, name=None):
    return CustomMetric(fn, name or fn.__name__)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return (names, values)
