"""The everyday Gluon surface of the port against the JAX package's, on
the CPU: each call that works in the JAX package -- ``Trainer`` with its
kvstore arguments and ``allreduce_grads``/``update``, the
``Parameter``/``ParameterDict`` members and ``initialize`` in the
reference's positional order, ``gluon.Constant``, ``Block.apply``,
``register_forward_pre_hook`` and ``summary``, ``autograd.set_recording``
and ``set_training``, ``random.seed(ctx=)``, the initializers,
``use_flash=`` on the transformer layers and BERT, ``Embedding(
sparse_grad=False)``, ``ctx=``/``root=`` on the model zoo and the
``mx.parallel``/``mx.serving``/``mx.kv`` bindings -- runs in the port
and gives what the JAX package gives.

Tolerances: weights after two SGD or Adam steps of a small MLP 1e-6
(a handful of fp32 operations a step); BERT outputs 1e-5 (fp32 sums in
another order through two encoder cells); deterministic initializers
exact; random ones by their distribution (scale within 5% over 4,096
draws, orthonormal rows or columns to 1e-5)."""
import json

import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERTModel

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, NDArray, autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo import BERTModel
from mxnet_tpu_torch.kernels import registry

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _mlp(pkg, in_units=6):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(5, in_units=in_units,
                                   activation="relu"),
                pkg.gluon.nn.Dense(3, in_units=5))
    return net


def _pair():
    """The JAX MLP (seed 0) and the port's with its weights."""
    np.random.seed(0)
    jnet = _mlp(jmx)
    jnet.initialize(ctx=jmx.cpu())
    net = _mlp(tmx)
    net.initialize(device="cpu")
    params_from_numpy(net, {n: p.data().asnumpy()
                            for n, p in jnet.collect_params().items()})
    return jnet, net


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 6)).astype(np.float32),
            rng.standard_normal((4, 3)).astype(np.float32))


def _weights(net):
    return {n: (p.data().asnumpy() if hasattr(p.data(), "asnumpy")
                else p.data()) for n, p in net.collect_params().items()}


def _backward(pkg, net, x, y):
    ag = jautograd if pkg is jmx else autograd
    wrap = (lambda a: jmx.nd.array(a, ctx=jmx.cpu())) if pkg is jmx \
        else (lambda a: NDArray(torch.tensor(a)))
    with ag.record():
        loss = pkg.gluon.loss.L2Loss()(net(wrap(x)), wrap(y))
    loss.backward()


def _train(pkg, net, trainer, steps=2, split=False):
    for s in range(steps):
        _backward(pkg, net, *_batch(s))
        if split:
            trainer.allreduce_grads()
            trainer.update(4)
        else:
            trainer.step(4)


TRAINER_CASES = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, {}),
    ("sgd", {"learning_rate": 0.1}, {"kvstore": "local"}),
    ("sgd", {"learning_rate": 0.1, "wd": 1e-3}, {"kvstore": "nccl"}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9},
     {"kvstore": None, "update_on_kvstore": False}),
    ("adam", {"learning_rate": 1e-2}, {}),
    ("adam", {"learning_rate": 1e-2}, {"kvstore": "device",
                                       "compression_params": {
                                           "type": "2bit",
                                           "threshold": 0.05}}),
]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("opt,hyper,kw", TRAINER_CASES)
def test_trainer_kvstore_arguments_match_jax(opt, hyper, kw, split):
    """``Trainer`` with the default ``kvstore="device"``, ``"local"``,
    ``"nccl"``, ``None``, ``update_on_kvstore=`` and 2-bit compression:
    two steps (or ``allreduce_grads`` + ``update``) of the same MLP give
    the JAX package's weights."""
    jnet, net = _pair()
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(hyper), **kw)
    tr = gluon.Trainer(net.collect_params(), opt, dict(hyper), **kw)
    _train(jmx, jnet, jtr, split=split)
    _train(tmx, net, tr, split=split)
    want, got = _weights(jnet), _weights(net)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)
    spec = kw.get("kvstore", "device")
    assert (tr._kvstore is None) == (spec is None)
    if spec is not None:
        assert tr._kvstore.type == jtr._kvstore.type == spec


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_trainer_sgd_matches_the_grouped_jax_update(monkeypatch, momentum):
    """The JAX package groups plain SGD into ``multi_sgd(_mom)_update``
    calls (here of 3 and 1 of the MLP's 4 parameters); the
    port's per-parameter updater gives the same weights after three
    steps."""
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "3")
    jnet, net = _pair()
    hyper = {"learning_rate": 0.1, "momentum": momentum, "wd": 1e-3}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(hyper))
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(hyper))
    _train(jmx, jnet, jtr, steps=3)
    _train(tmx, net, tr, steps=3)
    want, got = _weights(jnet), _weights(net)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


def test_trainer_refuses_multi_process_kvstores():
    """The multi-process stores are ported (tests/test_torch_kvstore_
    dist.py runs them across processes); outside a world each trains
    like the JAX package's: three steps equal the default store's."""
    jnet, net = _pair()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync")
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1}, kvstore="dist_sync")
    _train(jmx, jnet, jtr, steps=3)
    _train(tmx, net, tr, steps=3)
    want, got = _weights(jnet), _weights(net)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)
    with pytest.raises(MXNetError, match="unknown kvstore"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_nope")


def test_train_step_takes_a_trainer_with_the_default_kvstore():
    from mxnet_tpu_torch.parallel import TrainStep
    _jnet, net = _pair()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    step = TrainStep(net, gluon.loss.L2Loss(), tr)
    x, y = (torch.tensor(a) for a in _batch())
    losses = [float(step(x, y)) for _ in range(3)]
    assert losses[-1] < losses[0]


def test_random_seed_takes_ctx():
    jmx.random.seed(1, ctx="all")
    tmx.random.seed(1, ctx="all")
    tmx.random.seed(0)


def test_parameter_members_match_jax():
    jnet, net = _pair()
    jw, w = jnet[0].weight, net[0].weight
    # the reference's positional order: (init, ctx, default_init,
    # force_reinit)
    jw.initialize(jmx.init.One(), jmx.cpu(), None, True)
    w.initialize(tmx.init.One(), tmx.cpu(), None, True)
    np.testing.assert_array_equal(w.data(tmx.cpu()).asnumpy(),
                                  jw.data(jmx.cpu()).asnumpy())
    assert [str(c) for c in w.list_ctx()] == [str(c) for c in
                                               jw.list_ctx()]
    assert len(w.list_data()) == len(jw.list_data()) == 1
    for pkg, n in ((jmx, jnet), (tmx, net)):
        _backward(pkg, n, *_batch())
    np.testing.assert_allclose(w.grad(tmx.cpu()).asnumpy(),
                               jw.grad(jmx.cpu()).asnumpy(), **TOL)
    np.testing.assert_allclose(w.list_grad()[0].asnumpy(),
                               jw.list_grad()[0].asnumpy(), **TOL)
    np.testing.assert_allclose(w.grad_or_none.asnumpy(),
                               jw.grad_or_none.asnumpy(), **TOL)
    w.zero_grad()
    jw.zero_grad()
    np.testing.assert_array_equal(w.grad().asnumpy(), jw.grad().asnumpy())
    assert not w.grad().asnumpy().any()
    w.reset_ctx(tmx.cpu())
    jw.reset_ctx(jmx.cpu())
    assert w.data()._data.device.type == "cpu"
    np.testing.assert_array_equal(w.data().asnumpy(), jw.data().asnumpy())
    for p in (gluon.Parameter("frozen", grad_req="null", shape=(2,)),
              jgluon.Parameter("frozen", grad_req="null", shape=(2,))):
        assert p.grad_or_none is None
        p.initialize(ctx=tmx.cpu() if isinstance(p, gluon.Parameter)
                     else jmx.cpu())
        assert p.grad_or_none is None


def test_initialize_takes_the_reference_positional_order():
    """``Block.initialize(init, ctx, verbose, force_reinit)`` and
    ``ParameterDict.initialize`` in the same order: ``force_reinit``
    is the fourth argument (the port's third was ``force_reinit`` and
    its fourth ``generator``)."""
    jnet, net = _pair()
    jnet.initialize(jmx.init.One(), jmx.cpu(), False, True)
    net.initialize(tmx.init.One(), tmx.cpu(), False, True)
    want, got = _weights(jnet), _weights(net)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert all((v == 1).all() for n, v in got.items() if "weight" in n)
    jnet.collect_params().initialize(jmx.init.Zero(), jmx.cpu(), False,
                                     True)
    net.collect_params().initialize(tmx.init.Zero(), tmx.cpu(), False, True)
    assert not any(v.any() for v in _weights(net).values())
    assert not any(v.any() for v in _weights(jnet).values())


def test_parameter_dict_members_match_jax():
    jnet, net = _pair()
    jparams, params = jnet.collect_params(), net.collect_params()
    for pkg, n in ((jmx, jnet), (tmx, net)):
        _backward(pkg, n, *_batch())
    params.zero_grad()
    jparams.zero_grad()
    for n, p in params.items():
        np.testing.assert_array_equal(p.grad().asnumpy(),
                                      jparams[n].grad().asnumpy())
    params.setattr("lr_mult", 0.5)
    jparams.setattr("lr_mult", 0.5)
    assert [p.lr_mult for p in params.values()] == \
        [p.lr_mult for p in jparams.values()] == [0.5] * 4
    params.reset_ctx(tmx.cpu())
    jparams.reset_ctx(jmx.cpu())
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    consts = []
    for pd, mx in ((jgluon.ParameterDict("c_"), jmx),
                   (gluon.ParameterDict("c_"), tmx)):
        c = pd.get_constant("table", value)
        assert pd.get_constant("table") is c and c.grad_req == "null"
        c.initialize(ctx=mx.cpu())
        consts.append(c.data().asnumpy())
        other = type(pd)("o_")
        other.get("w", shape=(2,))
        pd.update(other)
        assert sorted(pd.keys()) == ["c_table", "o_w"]
        clash = type(pd)("o_")
        clash.get("w", shape=(2,))
        with pytest.raises(Exception, match="duplicate"):
            pd.update(clash)
    np.testing.assert_array_equal(consts[1], consts[0])


def test_gluon_constant_matches_jax():
    value = [[1.0, 2.0], [3.0, 4.0]]
    got = []
    for c, mx in ((jgluon.Constant("const", value), jmx),
                  (gluon.Constant("const", value), tmx)):
        assert c.grad_req == "null" and tuple(c.shape) == (2, 2)
        c.initialize(ctx=mx.cpu())
        got.append(c.data().asnumpy())
    np.testing.assert_array_equal(got[1], got[0])


def test_block_apply_pre_hooks_and_summary_match_jax():
    jnet, net = _pair()
    seen = {}
    for key, n in (("jax", jnet), ("port", net)):
        names = []
        assert n.apply(lambda b: names.append(type(b).__name__)) is n
        seen[key] = names
    assert seen["port"] == seen["jax"] == ["Dense", "Dense",
                                           "HybridSequential"]
    x = _batch()[0]
    args = {"jax": [], "port": []}
    for key, n, wrap in (("jax", jnet, lambda a: jmx.nd.array(a)),
                         ("port", net, lambda a: NDArray(torch.tensor(a)))):
        def hook(block, a, key=key):
            args[key].append((type(block).__name__, a[0].shape))
        assert n[1].register_forward_pre_hook(hook) is hook
        assert n.register_forward_pre_hook(hook) is hook
        with jautograd.pause() if key == "jax" else autograd.pause():
            n(wrap(x))
    assert args["port"] == args["jax"] == [("HybridSequential", (4, 6)),
                                           ("Dense", (4, 5))]
    jnet, net = _pair()
    want = jnet.summary(jmx.nd.array(x))
    got = net.summary(NDArray(torch.tensor(x)))
    assert got == want
    assert "Total params (direct children): 53" in got


def test_set_recording_and_set_training_match_jax():
    for ag in (jautograd, autograd):
        assert ag.set_recording(True) is False
        assert ag.is_recording()
        assert ag.set_training(True) is False
        assert ag.is_training()
        assert ag.set_recording(False) is True
        assert ag.set_training(False) is True
        assert not ag.is_recording() and not ag.is_training()
    autograd.set_recording(True)
    try:
        assert torch.is_grad_enabled()
    finally:
        autograd.set_recording(False)
    assert not torch.is_grad_enabled()
    torch.set_grad_enabled(True)


def test_model_zoo_takes_ctx_and_root(tmp_path):
    from mxnet_tpu.gluon.model_zoo.vision import resnet18_v1 as jresnet
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    jnet = jresnet(ctx=jmx.cpu(), root=str(tmp_path))
    net = resnet18_v1(ctx=tmx.cpu(), root=str(tmp_path))

    def rel(n):
        return sorted(k[len(n.prefix):] for k in n.collect_params().keys())

    assert rel(net) == rel(jnet)


def test_embedding_takes_sparse_grad():
    jgluon.nn.Embedding(10, 4, sparse_grad=False)
    emb = gluon.nn.Embedding(10, 4, sparse_grad=False)
    emb.initialize(device="cpu")
    assert tuple(emb(torch.tensor([[1.0, 2.0]])).shape) == (1, 2, 4)
    with pytest.raises(MXNetError, match="item 10"):
        gluon.nn.Embedding(10, 4, sparse_grad=True)


def test_mx_binds_parallel_serving_and_kvstore():
    for pkg in (jmx, tmx):
        assert pkg.parallel.TrainStep is not None
        assert pkg.serving.ModelRegistry is not None
        assert pkg.kv is pkg.kvstore
        assert pkg.kv.create("device").type == "device"


NARROW = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
              num_heads=4, max_length=16)


def _bert_inputs():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, NARROW["vocab_size"], (2, 16)).astype(np.float32)
    types = (np.arange(16)[None, :] >= 9).astype(np.float32).repeat(2, 0)
    lens = np.array([16, 10])
    mask = (np.arange(16)[None, None, :] < lens[:, None, None]) \
        .astype(np.float32).repeat(16, axis=1)
    return ids, types, mask


@pytest.mark.parametrize("use_flash", [None, True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_use_flash_matches_jax_and_picks_the_route(use_flash, masked):
    """``BERTModel(use_flash=...)`` forward against the JAX package's
    with the same argument; ``None`` and ``True`` reach the flash
    kernel at every layer (its plain version, on the CPU), ``False`` the
    plain attention math and never the kernel."""
    np.random.seed(0)
    jnet = JBERTModel(dropout=0.0, use_flash=use_flash, **NARROW)
    jnet.initialize(ctx=jmx.cpu())
    ids, types, mask = _bert_inputs()
    args = [ids, types] + ([mask] if masked else [])
    with jautograd.pause():
        jnet(*[jmx.nd.array(a) for a in args])
        want = [o.asnumpy() for o in jnet(*[jmx.nd.array(a) for a in args])]
    net = BERTModel(dropout=0.0, use_flash=use_flash, **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, {n: p.data().asnumpy()
                            for n, p in jnet.collect_params().items()})
    spec = registry.get("flash_attention_fwd")
    plain, calls = spec.plain, []
    spec.plain = lambda *a, **k: calls.append(k.get("mask") is not None) \
        or plain(*a, **k)
    try:
        with torch.no_grad():
            got = net(*[torch.tensor(a) for a in args])
    finally:
        spec.plain = plain
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    n = NARROW["num_layers"]
    assert calls == ([] if use_flash is False else [masked] * n)


def test_use_flash_on_every_layer_constructor():
    from mxnet_tpu_torch.gluon.model_zoo import bert_base, get_bert
    from mxnet_tpu_torch.gluon.nn.transformer import (
        MultiHeadAttention, TransformerEncoder, TransformerEncoderCell)
    for flag in (None, True, False):
        assert MultiHeadAttention(8, 2, use_flash=flag)._use_flash is flag
        cell = TransformerEncoderCell(8, 16, 2, use_flash=flag)
        assert cell.attention._use_flash is flag
        enc = TransformerEncoder(8, 16, 2, 2, max_length=4, use_flash=flag)
        assert [c.attention._use_flash for c in enc.cells] == [flag] * 2
        net = get_bert("bert_small", vocab_size=20, max_length=8,
                       use_flash=flag)
        assert net.encoder.cells[0].attention._use_flash is flag
    assert bert_base(vocab_size=20, max_length=8, use_flash=True) \
        .encoder.cells[11].attention._use_flash is True


# -- initializers ------------------------------------------------------

def _fill(pkg, init, name, shape):
    if pkg is jmx:
        arr = jmx.nd.zeros(shape, ctx=jmx.cpu())
        init(name, arr)
        return arr.asnumpy()
    arr = torch.zeros(shape)
    init(name, arr, torch.Generator().manual_seed(0))
    return arr.numpy()


@pytest.mark.parametrize("make,name,shape", [
    (lambda m: m.init.Constant(0.3), "fc_weight", (3, 4)),
    (lambda m: m.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
    (lambda m: m.init.Bilinear(), "up_weight", (1, 2, 3, 5)),
    (lambda m: m.init.LSTMBias(forget_bias=2.0), "lstm_i2h_weight", (8,)),
    (lambda m: m.init.LSTMBias(forget_bias=2.0), "lstm_i2h_bias", (8,)),
    (lambda m: m.init.Mixed([".*bias", ".*"],
                            [m.init.Zero(), m.init.One()]),
     "fc_weight", (2, 3)),
    (lambda m: m.init.Mixed([".*bias", ".*"],
                            [m.init.One(), m.init.Zero()]),
     "fc_bias", (3,)),
])
def test_deterministic_initializers_match_jax(make, name, shape):
    want = _fill(jmx, make(jmx), name, shape)
    got = _fill(tmx, make(tmx), name, shape)
    np.testing.assert_array_equal(got, want)


def test_init_desc_attrs_and_dumps_match_jax():
    for m in (jmx, tmx):
        with pytest.raises(Exception, match="no initializer pattern"):
            _fill(m, m.init.Mixed(["bias$"], [m.init.Zero()]), "fc_weight",
                  (2,))
    for make in (lambda m: m.init.Xavier(magnitude=2),
                 lambda m: m.init.Uniform(0.1),
                 lambda m: m.init.Constant(0.5),
                 lambda m: m.init.Orthogonal(scale=2.0)):
        assert make(tmx).dumps() == make(jmx).dumps()
    lstm = json.dumps(["lstmbias", {"forget_bias": 3.0}])
    for attrs, shape in (({"__init__": "one"}, (3, 2)),
                         ({"__init__": lstm}, (8,))):
        want = _fill(jmx, jmx.init.Zero(),
                     jmx.init.InitDesc("cell_bias", attrs), shape)
        got = _fill(tmx, tmx.init.Zero(),
                    tmx.init.InitDesc("cell_bias", attrs), shape)
        np.testing.assert_array_equal(got, want)
        assert want.any()


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 2)])
def test_orthogonal_matches_jax_in_distribution(shape, rand_type):
    for pkg in (jmx, tmx):
        q = _fill(pkg, pkg.init.Orthogonal(scale=1.5, rand_type=rand_type),
                  "w_weight", shape).reshape(shape[0], -1)
        small = min(q.shape)
        gram = q @ q.T if q.shape[0] == small else q.T @ q
        np.testing.assert_allclose(gram, 1.5 ** 2 * np.eye(small),
                                   atol=1e-5)


def test_msra_prelu_matches_jax_in_distribution():
    shape = (64, 16, 2, 2)
    stds = [_fill(pkg, pkg.init.MSRAPrelu(slope=0.25), "conv_weight",
                  shape).std() for pkg in (jmx, tmx)]
    want = np.sqrt(2.0 / (1 + 0.25 ** 2) / ((16 * 4 + 64 * 4) / 2.0))
    for s in stds:
        assert abs(s / want - 1) < 0.05, (stds, want)
