"""``HybridBlock.functionalize`` of the port against the JAX package's,
on the CPU.

Two small nets get the JAX package's weights through
``params_from_numpy``: a channels-last conv + BatchNorm + ReLU (a fused
site of ``HybridSequential``) + Dropout + Dense net, and a 2-layer,
2-head, width-64 BERT fed a ``valid_mask``.  The same numpy inputs go
through the JAX ``pure_fn`` and the port's:

- outputs in eval and in training mode, fp32 within 1e-5 relative and
  1e-6 absolute (the BERT within the flash-attention parity tests'
  2e-5 absolute);
- the auxiliary updates (the running statistics): the same names, the
  values at the outputs' tolerance;
- the gradients of ``sum(out ** 2)`` with respect to the values in
  ``pvals`` of the parameters that take one, against ``jax.grad`` of
  the same loss, within 1e-4 (the running statistics are auxiliary
  states, which the port's BatchNorm reads as constants, as MXNet
  does; ``jax.grad`` differentiates through them in eval);
- every Parameter bitwise unchanged after a training-mode call;
- generators seeded alike give one dropout mask, other seeds another,
  and the device's own generator is not drawn from;
- a hybridized block's ``pure_fn`` bitwise the same block's not
  hybridized.

The two packages draw dropout masks from different generators, so the
parity cases run the conv net at dropout rate 0 in training mode (and
at 0.5 in eval, where dropout is the identity); the masks are checked
on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERTModel

from mxnet_tpu_torch import MXNetError, gluon, random
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel

TOL = dict(rtol=1e-5, atol=1e-6)
BERT_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BERT = dict(vocab_size=64, units=64, hidden_size=128, num_layers=2,
            num_heads=2, max_length=32, dropout=0.0)
BATCH, SEQ = 2, 16


def _conv_net(nn, rate, **init):
    net = nn.HybridSequential(prefix="fnet_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, layout="NHWC", in_channels=3),
                nn.BatchNorm(axis=3, in_channels=8),
                nn.Activation("relu"),
                nn.Dropout(rate),
                nn.Flatten(),
                nn.Dense(5, in_units=8 * 6 * 6))
    net.initialize(**init)
    return net


def _image():
    return np.random.RandomState(3).randn(4, 6, 6, 3).astype(np.float32)


def _tokens():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, BERT["vocab_size"], (BATCH, SEQ)) \
        .astype(np.float32)
    lens = np.array([SEQ, SEQ - 5])
    mask = (np.arange(SEQ)[None, None, :] < lens[:, None, None]) \
        .astype(np.float32).repeat(SEQ, axis=1)
    return ids, mask


def _jax_pure(jnet, training, inputs):
    """The JAX ``pure_fn``'s outputs, aux and ``jax.grad`` of
    ``sum(out ** 2)``, as numpy.  It runs traced, as the JAX package
    runs it: called eagerly, a training call writes the running
    statistics into the Parameters and returns no aux."""
    pure_fn, pnames, pmap = jnet.functionalize(training=training)
    pvals = {n: pmap[n]._data._data for n in pnames}
    xs = [None if v is None else jnp.asarray(v) for v in inputs]
    key = jax.random.PRNGKey(0)
    outs, aux = jax.jit(lambda pv, xv: pure_fn(pv, xv, key))(pvals, xs)

    def loss(pv, xv):
        return jnp.sum(pure_fn(pv, xv, key)[0][0] ** 2)

    grads = jax.jit(jax.grad(loss))(pvals, xs)
    return ([np.asarray(o) for o in outs],
            {k: np.asarray(v) for k, v in aux.items()},
            {k: np.asarray(v) for k, v in grads.items()})


def _port_pure(net, training, inputs, rng=None):
    """The port's outputs, aux and gradients of ``sum(out ** 2)``."""
    pure_fn, pnames, pmap = net.functionalize(training=training)
    pvals = {n: pmap[n]._data.detach().clone().requires_grad_(
        pmap[n].grad_req != "null") for n in pnames}
    outs, aux = pure_fn(pvals, [torch.from_numpy(v) for v in inputs], rng)
    wrt = [n for n in pnames if pvals[n].requires_grad]
    grads = torch.autograd.grad((outs[0] ** 2).sum(),
                                [pvals[n] for n in wrt], allow_unused=True)
    return ([o.detach().numpy() for o in outs],
            {k: v.numpy() for k, v in aux.items()},
            {n: (np.zeros(pvals[n].shape, np.float32) if g is None
                 else g.numpy()) for n, g in zip(wrt, grads)})


def _arrays(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


@pytest.fixture(scope="module")
def conv_pair():
    """The JAX conv net at dropout 0 and the port's with its weights."""
    np.random.seed(0)
    jnet = _conv_net(jgluon.nn, 0.0, ctx=jmx.cpu())
    jnet(jmx.nd.array(_image()))
    net = _conv_net(gluon.nn, 0.0, device="cpu")
    params_from_numpy(net, _arrays(jnet))
    return jnet, net


@pytest.fixture(scope="module")
def bert_pair():
    np.random.seed(0)
    jnet = JBERTModel(prefix="fbert_", **BERT)
    jnet.initialize(ctx=jmx.cpu())
    ids, mask = _tokens()
    jnet(jmx.nd.array(ids), None, jmx.nd.array(mask))
    net = BERTModel(prefix="fbert_", **BERT)
    net.initialize(device="cpu")
    params_from_numpy(net, _arrays(jnet))
    return jnet, net


def _hold(port, ref, tol):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("training", [False, True])
def test_conv_net_against_jax(conv_pair, training):
    jnet, net = conv_pair
    jouts, jaux, jgrads = _jax_pure(jnet, training, [_image()])
    outs, aux, grads = _port_pure(net, training, [_image()])
    _hold(outs, jouts, TOL)
    assert sorted(aux) == sorted(jaux)
    if training:
        assert sorted(aux) == ["fnet_batchnorm0_running_mean",
                               "fnet_batchnorm0_running_var"]
    for k in aux:
        np.testing.assert_allclose(aux[k], jaux[k], **TOL, err_msg=k)
    assert sorted(grads) == sorted(
        n for n, p in net.collect_params().items() if p.grad_req != "null")
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("training", [False, True])
def test_bert_against_jax(bert_pair, training):
    jnet, net = bert_pair
    inputs = [_tokens()[0], np.zeros((BATCH, SEQ), np.float32),
              _tokens()[1]]
    jouts, jaux, jgrads = _jax_pure(jnet, training, inputs)
    outs, aux, grads = _port_pure(net, training, inputs)
    _hold(outs, jouts, BERT_TOL)
    assert aux == {} and jaux == {}
    assert len(grads) == len(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], **GRAD_TOL, err_msg=k)


def test_training_call_leaves_every_parameter_as_it_was(conv_pair):
    _jnet, net = conv_pair
    before = {n: p._data.detach().clone()
              for n, p in net.collect_params().items()}
    _port_pure(net, True, [_image()])
    for n, p in net.collect_params().items():
        assert torch.equal(p._data, before[n]), n
        assert p._data.grad is None, n


def test_dropout_draws_from_the_generator_given():
    torch.manual_seed(0)
    net = _conv_net(gluon.nn, 0.5, device="cpu")
    pure_fn, pnames, pmap = net.functionalize(training=True)
    pvals = {n: pmap[n]._data.detach() for n in pnames}
    x = [torch.from_numpy(_image())]
    device_state = random.generator("cpu").get_state()

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return pure_fn(pvals, x, gen)[0][0]

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(random.generator("cpu").get_state(), device_state)


def test_hybridized_is_bitwise_not_hybridized(conv_pair, bert_pair):
    for net, inputs in ((conv_pair[1], [_image()]),
                        (bert_pair[1], [_tokens()[0], None, _tokens()[1]])):
        tensors = [None if v is None else torch.from_numpy(v)
                   for v in inputs]
        got = {}
        for hybrid in (False, True):
            net.hybridize(hybrid)
            for training in (False, True):
                pure_fn, pnames, pmap = net.functionalize(training)
                pvals = {n: pmap[n]._data for n in pnames}
                with torch.no_grad():
                    got[hybrid, training] = pure_fn(pvals, tensors)
        net.hybridize(False)
        for training in (False, True):
            for a, b in zip(got[False, training][0],
                            got[True, training][0]):
                assert torch.equal(a, b)
            for k, v in got[False, training][1].items():
                assert torch.equal(v, got[True, training][1][k])


def test_uninitialized_parameter_raises_as_in_jax():
    jnet = jgluon.nn.Dense(3, in_units=2)
    net = gluon.nn.Dense(3, in_units=2)
    x = np.ones((1, 2), np.float32)
    jpure, jnames, _ = jnet.functionalize()
    pure, names, _ = net.functionalize()
    assert jnames == names == []
    with pytest.raises(jmx.base.MXNetError, match="not initialized"):
        jpure({}, [jnp.asarray(x)], jax.random.PRNGKey(0))
    with pytest.raises(MXNetError, match="not initialized"):
        pure({}, [torch.from_numpy(x)])


def test_symbol_block_functionalize(tmp_path, conv_pair):
    """An exported net read back as a ``SymbolBlock``: its ``pure_fn``
    is the exported net's eval ``pure_fn``; a training call leaves the
    running statistics as they are (no aux), as the JAX block does."""
    _jnet, net = conv_pair
    net.hybridize()
    x = torch.from_numpy(_image())
    net(x)
    sym_file, params_file = net.export(str(tmp_path / "fnet"))
    net.hybridize(False)
    sb = gluon.SymbolBlock.imports(sym_file, ["data"], params_file,
                                   ctx="cpu")
    pure, names, pmap = sb.functionalize(training=False)
    ref, rnames, rmap = net.functionalize(training=False)
    with torch.no_grad():
        out = pure({n: pmap[n]._data for n in names}, [x])[0][0]
        want = ref({n: rmap[n]._data for n in rnames}, [x])[0][0]
        _outs, aux = sb.functionalize(True)[0](
            {n: pmap[n]._data for n in names}, [x])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    assert aux == {}
