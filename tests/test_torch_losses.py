"""The ``gluon.loss`` blocks of the layer slice against the JAX
package's on the CPU, with and without ``sample_weight``: the per-sample
loss and the gradient of the prediction under a head gradient that is
not ones.  ``CTCLoss`` (the layer's own recursion, not the op's) with
padded labels, ``pred_lengths``/``label_lengths`` and both layouts.

Tolerance: 1e-5 relative / 1e-6 absolute (the same fp32 formulas); CTC
1e-5 absolute (log-sum-exp recursions over 12 steps)."""
import numpy as np
import pytest

import jax

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu_and_exact():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _run(mx_, ag, loss, arrays, grad=True):
    """The loss of ``arrays`` (the JAX block takes them positionally:
    ``sample_weight`` and the CTC lengths too; ``None`` skips one) and
    the gradient of the first under a non-unit head."""
    xs = [mx_.nd.array(a) if a is not None else None for a in arrays]
    if grad:
        xs[0].attach_grad()
    with ag.record():
        out = loss(*xs)
    if not grad:
        return out.asnumpy(), None
    head = _rand(*out.shape, seed=5) + 2.0
    out.backward(mx_.nd.array(head))
    return out.asnumpy(), xs[0].grad.asnumpy()


def _same(name, args, arrays, tol=TOL, grad=True):
    jo, jg = _run(jmx, jautograd, getattr(jgluon.loss, name)(**args),
                  arrays, grad)
    to, tg = _run(tmx, autograd, getattr(gluon.loss, name)(**args),
                  arrays, grad)
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, **tol)
    if grad:
        np.testing.assert_allclose(tg, jg, err_msg="pred grad", **tol)
    return to


def _binary(seed):
    return (np.random.default_rng(seed).integers(0, 2, (4, 5))
            .astype(np.float32))


def _signed(seed):
    return 2 * _binary(seed) - 1


LOSSES = [
    ("L1Loss", {}, lambda: [_rand(4, 5), _rand(4, 5, seed=1)]),
    ("L1Loss", dict(weight=0.5, batch_axis=1),
     lambda: [_rand(4, 5), _rand(20, seed=1)]),
    ("SigmoidBinaryCrossEntropyLoss", {},
     lambda: [_rand(4, 5) * 3, _binary(1)]),
    ("SigmoidBinaryCrossEntropyLoss", dict(from_sigmoid=True, weight=2.0),
     lambda: [1 / (1 + np.exp(-_rand(4, 5))), _binary(2)]),
    ("SigmoidBCELoss", {}, lambda: [_rand(4, 5), _binary(3)]),
    ("KLDivLoss", {}, lambda: [
        np.log(np.random.default_rng(0).dirichlet(np.ones(5), 4))
        .astype(np.float32),
        np.random.default_rng(1).dirichlet(np.ones(5), 4)
        .astype(np.float32)]),
    ("KLDivLoss", dict(from_logits=False, axis=1),
     lambda: [_rand(4, 5), np.random.default_rng(1).dirichlet(
         np.ones(5), 4).astype(np.float32)]),
    ("HuberLoss", {}, lambda: [_rand(4, 5) * 2, _rand(4, 5, seed=1)]),
    ("HuberLoss", dict(rho=0.5), lambda: [_rand(4, 5), _rand(4, 5,
                                                             seed=1)]),
    ("HingeLoss", {}, lambda: [_rand(4, 5), _signed(1)]),
    ("HingeLoss", dict(margin=2), lambda: [_rand(4, 5), _signed(2)]),
    ("SquaredHingeLoss", {}, lambda: [_rand(4, 5), _signed(1)]),
    ("LogisticLoss", {}, lambda: [_rand(4, 5), _signed(1)]),
    ("LogisticLoss", dict(label_format="binary"),
     lambda: [_rand(4, 5), _binary(1)]),
    ("TripletLoss", {}, lambda: [_rand(4, 5), _rand(4, 5, seed=1),
                                 _rand(4, 5, seed=2)]),
    ("TripletLoss", dict(margin=3), lambda: [_rand(4, 3, 2),
                                             _rand(4, 3, 2, seed=1),
                                             _rand(4, 3, 2, seed=2)]),
    ("CosineEmbeddingLoss", {}, lambda: [_rand(4, 5), _rand(4, 5, seed=1),
                                         _signed(1)[:, 0]]),
    ("CosineEmbeddingLoss", dict(margin=0.2),
     lambda: [_rand(4, 5), _rand(4, 5, seed=1), _signed(2)[:, 0]]),
]


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "sample_weight"])
@pytest.mark.parametrize("name,args,make", LOSSES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(LOSSES)])
def test_loss(name, args, make, weighted):
    arrays = make()
    if weighted:
        rng = np.random.default_rng(8)
        shape = (4,) if name in ("TripletLoss", "CosineEmbeddingLoss") \
            else (4, 1)
        arrays.append(rng.random(shape).astype(np.float32))
    _same(name, args, arrays)


def test_sigmoid_bce_takes_pos_weight_as_the_jax_package_does():
    """``pos_weight`` is accepted and, as in the JAX package, not
    applied."""
    x, y = _rand(4, 5), _binary(1)
    w = np.full((4, 5), 3.0, np.float32)
    a = _same("SigmoidBinaryCrossEntropyLoss", {}, [x, y, None, w])
    b = _same("SigmoidBinaryCrossEntropyLoss", {}, [x, y])
    np.testing.assert_array_equal(a, b)


T, B, V, L = 12, 4, 6, 5


def _ctc_inputs(seed=0):
    pred = _rand(B, T, V, seed=seed)
    label = np.array([[1, 2, 2, 3, -1], [4, -1, -1, -1, -1],
                      [5, 1, 5, 1, 5], [-1, -1, -1, -1, -1]], np.float32)
    return pred, label


CTC_CASES = [
    ("ntc", dict(), lambda p: p, []),
    ("tnc", dict(layout="TNC"), lambda p: p.transpose(1, 0, 2), []),
    ("pred_lengths", dict(), lambda p: p,
     [np.array([12, 7, 11, 3], np.float32)]),
    ("label_lengths", dict(layout="TNC"), lambda p: p.transpose(1, 0, 2),
     [np.array([9, 12, 12, 5], np.float32),
      np.array([3, 1, 5, 0], np.float32)]),
]


@pytest.mark.parametrize("case,args,arrange,lengths", CTC_CASES,
                         ids=[c[0] for c in CTC_CASES])
def test_ctc_loss(case, args, arrange, lengths):
    """The layer's recursion: negative labels are padding (blank), a
    sample's steps past its ``pred_lengths`` carry its alphas, its
    ``label_lengths`` (by default the count of non-negative labels) pick
    where its paths end; an empty label row has only the blank path.
    The JAX layer returns a value off the tape (no gradient), so only
    the loss is compared; the port's gradient is held against finite
    differences."""
    pred, label = _ctc_inputs()
    out = _same("CTCLoss", args, [arrange(pred), label] + lengths,
                tol=dict(rtol=1e-5, atol=1e-5), grad=False)
    assert out.shape == (B,) and np.isfinite(out).all()


def test_ctc_loss_gradient_against_finite_differences():
    import torch
    pred, label = _ctc_inputs(2)
    loss = gluon.loss.CTCLoss()
    lens = torch.tensor([12.0, 7.0, 11.0, 3.0])
    x = torch.tensor(pred, dtype=torch.float64, requires_grad=True)
    fn = lambda p: loss(p, torch.tensor(label), lens).sum()  # noqa: E731
    fn(x).backward()
    eps, rng = 1e-6, np.random.default_rng(0)
    for _ in range(6):
        i = tuple(rng.integers(0, s) for s in pred.shape)
        up, dn = x.detach().clone(), x.detach().clone()
        up[i] += eps
        dn[i] -= eps
        fd = (float(fn(up)) - float(fn(dn))) / (2 * eps)
        assert abs(fd - float(x.grad[i])) < 1e-5


def test_ctc_layer_differs_from_the_op_where_the_jax_package_differs():
    """The layer maps padding to blank and ends each sample at its own
    label length, as the op does for -1 padding: with full lengths the
    two agree on the same activations (blank first)."""
    pred, label = _ctc_inputs(1)
    layer = gluon.loss.CTCLoss()(tmx.nd.array(pred), tmx.nd.array(label))
    op = tmx.nd.CTCLoss(tmx.nd.array(pred.transpose(1, 0, 2)),
                        tmx.nd.array(label))
    np.testing.assert_allclose(layer.asnumpy(), op.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def test_loss_names_match_the_jax_package():
    for name in ("L1Loss", "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
                 "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
                 "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss",
                 "CTCLoss"):
        assert hasattr(jgluon.loss, name) and hasattr(gluon.loss, name)
    assert gluon.loss.SigmoidBCELoss is \
        gluon.loss.SigmoidBinaryCrossEntropyLoss
