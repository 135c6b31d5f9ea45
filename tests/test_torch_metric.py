"""The port's metrics (``mxnet_tpu_torch.metric``) against the JAX
package's on the CPU: the behaviour of ``tests/test_metric.py``, and
every metric fed the same NDArrays, tensors and numpy arrays in both
packages (exactly equal: both compute in numpy)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import metric as jmetric

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, metric


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def test_accuracy():
    m = metric.Accuracy()
    pred = mx.nd.array([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]])
    label = mx.nd.array([1, 0, 0])
    m.update(label, pred)
    assert m.get() == ("accuracy", 2 / 3)
    m.reset()
    assert np.isnan(m.get()[1])


def test_topk():
    m = metric.TopKAccuracy(top_k=2)
    pred = mx.nd.array([[0.1, 0.5, 0.4], [0.6, 0.3, 0.1]])
    label = mx.nd.array([2, 1])
    m.update(label, pred)
    assert m.get()[1] == 1.0


def test_mse_mae():
    mse = metric.MSE()
    mse.update(mx.nd.array([1.0, 2.0]), mx.nd.array([0.0, 0.0]))
    assert abs(mse.get()[1] - 2.5) < 1e-6
    mae = metric.MAE()
    mae.update(mx.nd.array([1.0, -3.0]), mx.nd.array([0.0, 0.0]))
    assert abs(mae.get()[1] - 2.0) < 1e-6


def test_crossentropy_perplexity():
    ce = metric.create("ce")
    prob = mx.nd.array([[0.2, 0.8], [0.9, 0.1]])
    label = mx.nd.array([1, 0])
    ce.update(label, prob)
    expect = -(np.log(0.8) + np.log(0.9)) / 2
    assert abs(ce.get()[1] - expect) < 1e-5
    p = metric.Perplexity()
    p.update(label, prob)
    assert abs(p.get()[1] - np.exp(expect)) < 1e-4


def test_f1():
    f1 = metric.F1()
    pred = mx.nd.array([[0.2, 0.8], [0.8, 0.2], [0.3, 0.7]])
    label = mx.nd.array([1, 1, 0])
    f1.update(label, pred)
    assert abs(f1.get()[1] - 0.5) < 1e-6


def test_composite_and_create():
    c = metric.create(["accuracy", metric.TopKAccuracy(top_k=2)])
    pred = mx.nd.array([[0.1, 0.9, 0.0]])
    c.update(mx.nd.array([1]), pred)
    names, values = c.get()
    assert "accuracy" in names[0]
    assert values[0] == 1.0 and values[1] == 1.0
    with pytest.raises(MXNetError, match="unknown metric"):
        metric.create("nope")


def test_custom_metric():
    m = metric.CustomMetric(lambda l, p: float((l == p.argmax(-1)).mean()))
    m.update(mx.nd.array([1]), mx.nd.array([[0.0, 1.0]]))
    assert m.get()[1] == 1.0
    assert metric.np_metric(lambda l, p: 0.5).name == "<lambda>"


def test_loss_metric():
    m = metric.Loss()
    m.update(None, mx.nd.array([2.0, 4.0]))
    assert m.get()[1] == 3.0


@pytest.mark.parametrize("name,kwargs", [
    ("Accuracy", {}), ("TopKAccuracy", {"top_k": 3}), ("MSE", {}),
    ("MAE", {}), ("RMSE", {}), ("CrossEntropy", {}), ("Perplexity", {}),
    ("Perplexity", {"ignore_label": 2}), ("F1", {}), ("Loss", {})])
@pytest.mark.parametrize("kind", ["ndarray", "tensor", "numpy"])
def test_metric_equals_the_jax_package(name, kwargs, kind):
    rng = np.random.RandomState(0)
    classes = 2 if name == "F1" else 5
    got, want = getattr(metric, name)(**kwargs), \
        getattr(jmetric, name)(**kwargs)
    regression = name in ("MSE", "MAE", "RMSE")
    for _ in range(3):
        if regression:
            label = rng.randn(8).astype(np.float32)
            pred = rng.randn(8).astype(np.float32)
        else:
            label = rng.randint(0, classes, 8).astype(np.int32)
            pred = rng.dirichlet(np.ones(classes), 8).astype(np.float32)
        wrap = {"ndarray": lambda a: mx.nd.array(a), "tensor": torch.tensor,
                "numpy": lambda a: a}[kind]
        got.update([wrap(label)], [wrap(pred)])
        want.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    assert got.get() == want.get()
    assert got.get_global() == got.get()


def test_accuracy_reads_card_style_outputs():
    """The MNIST loop's update: int32 labels, float32 logits."""
    m, jm = metric.Accuracy(), jmetric.Accuracy()
    rng = np.random.RandomState(1)
    label = rng.randint(0, 10, 128).astype(np.int32)
    out = rng.randn(128, 10).astype(np.float32)
    m.update([mx.nd.array(label)], [mx.nd.array(out)])
    jm.update([jmx.nd.array(label)], [jmx.nd.array(out)])
    assert m.get() == jm.get()
    assert 0.0 <= m.get()[1] <= 1.0
