"""The port's BERT pretraining slice as a whole on the CPU: a narrow
``BERTModel`` with the JAX package's weights carried across by
``params_from_numpy``, its forward, and three ``TrainStep``s with LAMB
against the JAX package's ``TrainStep`` with the kernel tier armed
(``MXNET_TPU_KERNELS=1``: the bucketed LAMB with its Pallas phase-1
kernel and, with ``use_flash=True``, the Pallas flash kernels, all in
interpret mode); plus the dropout and embedding layers.

Tolerances: forward outputs 1e-5 absolute; losses 1e-5 relative; every
parameter within 2e-4 relative / 2e-6 absolute after three steps (fp32
products summed in another order by two libraries, through two encoder
cells and three LAMB steps, whose ``m / (sqrt(v) + eps)`` amplifies the
difference of a near-zero gradient up to ``1 / eps``)."""
import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERTModel
from mxnet_tpu.parallel import TrainStep as JTrainStep

from mxnet_tpu_torch import MXNetError, autograd, gluon, random
from mxnet_tpu_torch import ops
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo import BERTModel, bert_small
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.parallel import TrainStep

NARROW = dict(vocab_size=200, units=64, hidden_size=128, num_layers=2,
              num_heads=2, max_length=64)
BATCH, SEQ = 2, 32
LAMB = {"learning_rate": 1e-3, "wd": 0.01, "beta1": 0.9, "beta2": 0.999,
        "epsilon": 1e-6}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, NARROW["vocab_size"], (BATCH, SEQ))
            .astype(np.float32),
            rng.integers(0, NARROW["vocab_size"], (BATCH, SEQ))
            .astype(np.float32))


def _padding_mask():
    """(batch, seq, seq): the second sequence padded after 21 tokens."""
    lens = np.array([SEQ, SEQ - 11])
    return (np.arange(SEQ)[None, None, :] < lens[:, None, None]) \
        .astype(np.float32).repeat(SEQ, axis=1)


def _jax_net():
    np.random.seed(0)
    jnet = JBERTModel(dropout=0.0, use_flash=True, **NARROW)
    jnet.initialize(ctx=mx.cpu())
    with jautograd.pause():
        jnet(mx.nd.array(_batch()[0]))
    return jnet


def _port_net(arrays):
    net = BERTModel(dropout=0.0, **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    return net


def _arrays(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


def _relative(net_or_names, prefix):
    return sorted(n[len(prefix):] for n in net_or_names)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, once: the initial weights, the forward outputs
    (without and with a padding mask), and three LAMB ``TrainStep``s on
    the kernel tier (losses, final weights)."""
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    ids, labels = _batch()
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_TPU_KERNELS", "1")
    try:
        with jax.default_matmul_precision("highest"):
            jnet = _jax_net()
            arrays = _arrays(jnet)
            with jautograd.pause():
                mlm, nsp = jnet(mx.nd.array(ids))
                outs_masked = [o.asnumpy() for o in jnet(
                    mx.nd.array(ids), None, mx.nd.array(_padding_mask()))]
            outs = (mlm.asnumpy(), nsp.asnumpy())
            vocab = NARROW["vocab_size"]
            ce = jgluon.loss.SoftmaxCrossEntropyLoss()

            class MLMLoss(jgluon.HybridBlock):
                def hybrid_forward(self, F, outs, labels):
                    return ce(outs[0].reshape((-1, vocab)),
                              labels.reshape((-1,)))

            tr = jgluon.Trainer(jnet.collect_params(), "lamb", LAMB,
                                kvstore=None)
            step = JTrainStep(jnet, MLMLoss(), tr, mesh=None)
            losses = [float(step(mx.nd.array(ids),
                                 mx.nd.array(labels)).asscalar())
                      for _ in range(3)]
            final = {n[len(jnet.prefix):]: p.data().asnumpy()
                     for n, p in jnet.collect_params().items()}
    finally:
        mp.undo()
    return {"arrays": arrays, "prefix": jnet.prefix, "outs": outs,
            "outs_masked": outs_masked, "losses": losses, "final": final}


class MLMLoss(gluon.HybridBlock):
    """Masked-LM loss of ``bench.py :: bench_bert_base``: summed softmax
    cross entropy over every position, next-sentence scores unused."""

    def __init__(self, vocab, **kwargs):
        super().__init__(**kwargs)
        self._vocab = vocab
        self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, outs, labels):
        mlm, _nsp = outs
        return self._ce(mlm.reshape(-1, self._vocab), labels.reshape(-1))


def test_parameter_names_match_the_jax_package(jax_run):
    net = BERTModel(**NARROW)
    assert _relative(net.collect_params().keys(), net.prefix) \
        == _relative(jax_run["arrays"], jax_run["prefix"])


def test_forward_matches_the_jax_package(jax_run):
    net = _port_net(jax_run["arrays"])
    mlm, nsp = net(torch.from_numpy(_batch()[0]))
    assert mlm.shape == (BATCH, SEQ, NARROW["vocab_size"])
    assert nsp.shape == (BATCH, 2)
    np.testing.assert_allclose(mlm.detach().numpy(), jax_run["outs"][0],
                               atol=1e-5)
    np.testing.assert_allclose(nsp.detach().numpy(), jax_run["outs"][1],
                               atol=1e-5)


def test_masked_forward_matches_the_jax_package(jax_run):
    """A padded batch: ``valid_mask`` rides into the masked flash
    kernels (the JAX side in interpret mode)."""
    net = _port_net(jax_run["arrays"])
    got = net(torch.from_numpy(_batch()[0]), None,
              torch.from_numpy(_padding_mask()))
    for g, w in zip(got, jax_run["outs_masked"]):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5)


def test_masked_attention_with_dropout_in_training_runs_plain_math():
    """A mask with dropout in training takes the score-materializing
    branch; in predict mode the same layer takes the masked flash
    path and agrees with it at dropout 0."""
    from mxnet_tpu_torch.gluon.nn import MultiHeadAttention
    layer = MultiHeadAttention(16, 2, dropout=0.5)
    layer.initialize(device="cpu",
                     generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 9, 16)), dtype=torch.float32)
    mask = torch.ones(2, 9, 9)
    mask[1, :, 6:] = 0
    random.seed(0)
    with autograd.record():
        a = layer(x, mask)
    registry.reset_launches()
    b = layer(x, mask)                    # predict mode: flash path
    assert a.shape == b.shape == (2, 9, 16)
    assert torch.isfinite(a).all() and not torch.allclose(a, b)
    layer._dropout = 0.0
    with autograd.record():
        c = layer(x, mask)                # training, no dropout: flash
    np.testing.assert_allclose(c.detach().numpy(), b.detach().numpy(),
                               atol=1e-6)


def test_lamb_train_steps_match_the_jax_package(jax_run):
    net = _port_net(jax_run["arrays"])
    tr = gluon.Trainer(net.collect_params(), "lamb", LAMB)
    step = TrainStep(net, MLMLoss(NARROW["vocab_size"]), tr)
    ids, labels = _batch()
    registry.reset_launches()
    losses = [step(ids, labels) for _ in range(3)]
    assert all(t.dim() == 0 for t in losses)
    np.testing.assert_allclose([float(t) for t in losses],
                               jax_run["losses"], rtol=1e-5)
    assert jax_run["losses"][-1] < jax_run["losses"][0]
    got = {n[len(net.prefix):]: p.data()._data.detach().numpy()
           for n, p in net.collect_params().items()}
    assert sorted(got) == sorted(jax_run["final"])
    for name, w in jax_run["final"].items():
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=2e-6,
                                   err_msg=name)
    # the CPU ran the plain versions: nothing counted as a launch
    assert registry.launches("flash_attention_fwd") == 0


def test_dropout_masks_follow_the_generator_seed():
    x = torch.ones(64, 256)
    a = ops.Dropout(x, p=0.25, training=True,
                    generator=torch.Generator().manual_seed(7))
    b = ops.Dropout(x, p=0.25, training=True,
                    generator=torch.Generator().manual_seed(7))
    c = ops.Dropout(x, p=0.25, training=True,
                    generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    # keep rate 0.75 over 16384 draws: 5 sigma is 0.017
    assert abs(float(kept.float().mean()) - 0.75) < 0.017
    np.testing.assert_allclose(a[kept].numpy(), 1 / 0.75, rtol=1e-6)
    assert torch.equal(ops.Dropout(x, p=0.25, training=False), x)


def test_dropout_layer_draws_from_the_seeded_device_generator():
    layer = gluon.nn.Dropout(0.5, axes=(1,))
    x = torch.ones(8, 6, 4)
    random.seed(3)
    with autograd.record():
        a = layer(x)
    random.seed(3)
    with autograd.record():
        b = layer(x)
    assert torch.equal(a, b)
    # one draw shared along axis 1
    assert torch.equal(a, a[:, :1, :].expand_as(a))
    assert torch.equal(layer(x), x)        # predict mode: identity


def test_embedding_takes_float_ids_and_scatters_its_gradient():
    w = torch.arange(12.0).reshape(4, 3).requires_grad_()
    ids = torch.tensor([[1.0, 3.0], [1.0, 0.0]])
    out = ops.Embedding(ids, w)
    assert torch.equal(out[0, 1], w.detach()[3])
    out.sum().backward()
    np.testing.assert_array_equal(w.grad[:, 0].numpy(), [1, 2, 0, 1])


def test_tensor_parallel_bert_is_not_ported():
    """Tensor-parallel BERT is ported (tests/
    test_torch_tensor_parallel.py): ``tp_mesh=`` builds the encoder with
    separate q/k/v projections, and ``shard_tp`` without a mesh raises
    as the JAX model's does."""
    net = BERTModel(tp_mesh=object(), **NARROW)
    names = set(net._collect_params_with_prefix())
    assert "encoder.cell0.attention.query_weight" in names
    assert not any("qkv" in n for n in names)
    with pytest.raises(ValueError, match="needs a mesh"):
        bert_small(vocab_size=50).shard_tp()
