"""The port's tensor parallelism against the JAX package's
(``mxnet_tpu_torch.parallel.tensor_parallel`` and the transformer's
``tp_mode``/``shard_tp``), on the CPU.

One 4-rank gloo world (``test_torch_mesh.spawn_world``) runs every case
once for the module on a ``{"dp": 2, "tp": 2}`` mesh (``{"tp": 4}`` for
the rules); the cases assemble each parameter or gradient from the
ranks' shards under its ``PartitionSpec`` and hold it against the JAX
package's GSPMD-partitioned computation on 4 of its CPU devices, at the
JAX tests' tolerances:

- ``TensorParallelMLP``'s forward and the gradients of every parameter
  (column layer: output slices, row layer: input slices, one psum);
- two bucketed-LARS ``TrainStep``s of the MLP over the mesh against
  the JAX step on the global batch (the trust ratios of the sharded
  tensors the whole tensors');
- ``shard_block_tp``'s rules: the same parameter names sharded;
- a 2-layer narrow BERT built with ``tp_mesh`` and ``shard_tp``: its
  forward, then two bucketed-LAMB ``TrainStep``s over the mesh (batch
  split over ``dp``, heads over ``tp``) against the JAX tp-mode BERT's
  ``TrainStep`` on the global batch -- losses and every parameter, so
  the trust ratios of the ``tp``-sharded tensors are the whole
  tensors' (their norms summed over the shards).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERTModel
from mxnet_tpu.parallel import (TensorParallelMLP as JTensorParallelMLP,
                                TrainStep as JTrainStep,
                                make_mesh as jmake_mesh,
                                shard_block_tp as jshard_block_tp)

from test_torch_mesh import WORKER_HEAD, load_ranks, spawn_world

TOL = dict(rtol=2e-4, atol=1e-5)
BERT = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
            num_heads=4, max_length=16, dropout=0.0)
LAMB = {"learning_rate": 1e-3, "wd": 0.01, "beta1": 0.9, "beta2": 0.999,
        "epsilon": 1e-6}

_WORKER = WORKER_HEAD + r"""
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
from mxnet_tpu_torch.parallel import (TensorParallelMLP, TrainStep,
                                      make_mesh, shard_block_tp)

BERT = json.loads(inp["bert_cfg"].tobytes().decode())


def shards(net, prefix):
    # each parameter's local shard (and its gradient, where it has one)
    for k, p in net._collect_params_with_prefix().items():
        arrays[prefix + k] = p.data()._data.detach().numpy().copy()
        if p._data.grad is not None:
            arrays[prefix + "grad." + k] = p._data.grad.numpy().copy()


with mx.cpu():
    mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    dpi = mesh.axis_index("dp")

    # TensorParallelMLP: forward and gradients
    mlp = TensorParallelMLP(64, 32, mesh=mesh)
    mlp.initialize(ctx=mx.cpu())
    with autograd.pause():
        mlp(torch.zeros(1, 32))
    params_from_numpy(mlp, weights_in("mlp."))
    mlp.shard(mesh)
    x = inp["mlp_x"][dpi * 4:(dpi + 1) * 4]
    with autograd.pause():
        arrays["mlp_out"] = mlp(torch.from_numpy(x)).detach().numpy()
    # the same forward as the port's pure function of its shards
    pure, pnames, pmap = mlp.functionalize(training=False)
    with torch.no_grad():
        arrays["mlp_fn_out"] = pure({n: pmap[n]._data for n in pnames},
                                    [torch.from_numpy(x)])[0][0].numpy()

    gmlp = TensorParallelMLP(48, 16, mesh=mesh)
    gmlp.initialize(ctx=mx.cpu())
    with autograd.pause():
        gmlp(torch.zeros(1, 16))
    params_from_numpy(gmlp, weights_in("gmlp."))
    gmlp.shard(mesh)
    x = torch.from_numpy(inp["gmlp_x"][dpi * 2:(dpi + 1) * 2])
    with autograd.record():
        out = gmlp(x)
        loss = (out ** 2).sum()
    loss.backward()
    for p in gmlp.collect_params().values():
        # the batch is split over dp: sum the ranks' partial gradients
        collectives.all_reduce_(p._data.grad, mesh, "dp")
    shards(gmlp, "gmlp.")
    # the same gradients through the port's pure function
    pure, pnames, pmap = gmlp.functionalize(training=False)
    pvals = {n: pmap[n]._data.detach().clone().requires_grad_()
             for n in pnames}
    fn_grads = torch.autograd.grad(
        (pure(pvals, [x])[0][0] ** 2).sum(), [pvals[n] for n in pnames])
    structural = {p.name: k for k, p in
                  gmlp._collect_params_with_prefix().items()}
    for n, g in zip(pnames, fn_grads):
        collectives.all_reduce_(g, mesh, "dp")
        arrays["gmlp_fn.grad." + structural[n]] = g.numpy().copy()

    # shard_block_tp's rules on a {"tp": 4} mesh
    tmesh = make_mesh({"tp": 4}, device="cpu")
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(32, flatten=False, prefix="up_"),
                gluon.nn.Dense(16, flatten=False, prefix="down_"))
    # one seed on every rank: the placement takes rank 0's values
    net.initialize(ctx=mx.cpu(), generator=torch.Generator().manual_seed(0))
    xr = torch.from_numpy(inp["rules_x"])
    with autograd.pause():
        want = net(xr).numpy()
    names = shard_block_tp(net, tmesh)
    values["rules_sharded"] = names
    with autograd.pause():
        arrays["rules_err"] = np.abs(net(xr).numpy() - want).max()

    # bucketed LARS over the mesh: the MLP's trust ratios are the whole
    # tensors' (norms summed over the tp shards)
    lmlp = TensorParallelMLP(64, 32, mesh=mesh)
    lmlp.initialize(ctx=mx.cpu())
    with autograd.pause():
        lmlp(torch.zeros(1, 32))
    params_from_numpy(lmlp, weights_in("lars."))
    lmlp.shard(mesh)
    tr = gluon.Trainer(lmlp.collect_params(), "lars",
                       {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
                       kvstore=None)
    step = TrainStep(lmlp, gluon.loss.L2Loss(), tr, mesh=mesh)
    lx, ly = inp["lars_x"], inp["lars_y"]
    values["lars_losses"] = [float(step(lx[dpi * 4:(dpi + 1) * 4],
                                        ly[dpi * 4:(dpi + 1) * 4]))
                             for _ in range(2)]
    shards(lmlp, "lars_final.")

    # a narrow tensor-parallel BERT: forward, then two LAMB TrainSteps
    net = BERTModel(tp_mesh=mesh, **BERT)
    net.initialize(ctx=mx.cpu())
    ids, labels = inp["bert_ids"], inp["bert_labels"]
    with autograd.pause():
        net(torch.from_numpy(ids[:1]))
    params_from_numpy(net, weights_in("bert."))
    net.shard_tp()
    b = ids.shape[0] // 2
    mine = slice(dpi * b, (dpi + 1) * b)
    with autograd.pause():
        mlm, nsp = net(torch.from_numpy(ids[mine]))
    arrays["bert_mlm"] = mlm.numpy()
    arrays["bert_nsp"] = nsp.numpy()
    vocab = BERT["vocab_size"]
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    class MLMLoss(gluon.HybridBlock):
        def hybrid_forward(self, F, outs, labels):
            return ce(outs[0].reshape(-1, vocab), labels.reshape(-1))

    tr = gluon.Trainer(net.collect_params(), "lamb",
                       json.loads(inp["lamb"].tobytes().decode()),
                       kvstore=None)
    step = TrainStep(net, MLMLoss(), tr, mesh=mesh)
    values["bert_losses"] = [float(step(ids[mine], labels[mine]))
                             for _ in range(2)]
    values["bert_specs"] = {
        k: list(p._sharding.spec) for k, p in
        net._collect_params_with_prefix().items()}
    shards(net, "bert_final.")
    values["tp_index"] = mesh.axis_index("tp")
finish()
"""


def _assemble(ranks, key, spec, tp_of):
    """The full array from the ranks' shards of ``key`` under ``spec``
    (a list over dims of an axis name or None), the ``tp`` index of each
    rank given by ``tp_of``."""
    spec = list(spec) + [None] * 4
    parts = {}
    for r, (arrays, _vals) in enumerate(ranks):
        parts.setdefault(tp_of[r], arrays[key])
    dim = next((d for d, a in enumerate(spec) if a == "tp"), None)
    if dim is None:
        return parts[0]
    return np.concatenate([parts[i] for i in sorted(parts)], axis=dim)


def _update_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tp_index(ranks):
    return [vals["tp_index"] for _arrays, vals in ranks]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    devs = jax.devices("cpu")[:4]
    mesh = jmake_mesh({"dp": 2, "tp": 2}, devices=devs)
    inp, ref = {}, {}
    rng = np.random.RandomState(0)

    def arrays_of(net, prefix):
        return {prefix + k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()}

    # the MLP forward, sharded over the mesh (XLA's partitioning)
    jmx.random.seed(0)
    mlp = JTensorParallelMLP(64, 32, mesh=mesh)
    mlp.initialize()
    inp["mlp_x"] = rng.randn(8, 32).astype(np.float32)
    mlp(jmx.nd.array(inp["mlp_x"]))
    inp.update(arrays_of(mlp, "mlp."))
    mlp.shard(mesh)
    pure_fn, pnames, pmap = mlp.functionalize(training=False)
    pvals = {n: pmap[n]._data._data for n in pnames}
    xs = jax.device_put(jnp.asarray(inp["mlp_x"]),
                        NamedSharding(mesh, P("dp", None)))
    ref["mlp_out"] = np.asarray(jax.jit(
        lambda pv, xv: pure_fn(pv, [xv], jax.random.PRNGKey(0))[0][0])(
            pvals, xs))

    # the MLP's gradients of sum(out ** 2), sharded
    jmx.random.seed(1)
    gmlp = JTensorParallelMLP(48, 16, mesh=mesh)
    gmlp.initialize()
    inp["gmlp_x"] = rng.randn(4, 16).astype(np.float32)
    gmlp(jmx.nd.array(inp["gmlp_x"]))
    inp.update(arrays_of(gmlp, "gmlp."))
    gmlp.shard(mesh)
    pure_fn, pnames, pmap = gmlp.functionalize(training=False)
    pvals = {n: pmap[n]._data._data for n in pnames}

    def loss(pv, xv):
        return jnp.sum(pure_fn(pv, [xv], jax.random.PRNGKey(0))[0][0] ** 2)

    xs = jax.device_put(jnp.asarray(inp["gmlp_x"]),
                        NamedSharding(mesh, P("dp", None)))
    grads = jax.jit(jax.grad(loss))(pvals, xs)
    structural = {p.name: k for k, p in
                  gmlp._collect_params_with_prefix().items()}
    ref["gmlp_grads"] = {structural[n]: np.asarray(g)
                         for n, g in grads.items()}

    # bucketed LARS on the MLP: the JAX step on the global batch
    jmx.random.seed(2)
    lmlp = JTensorParallelMLP(64, 32, mesh=mesh)
    lmlp.initialize()
    inp["lars_x"] = rng.randn(8, 32).astype(np.float32)
    inp["lars_y"] = rng.randn(8, 32).astype(np.float32)
    lmlp(jmx.nd.array(inp["lars_x"]))
    # the up-projection's two tp halves at norms 4x apart: a trust ratio
    # taken per shard would differ from the whole tensor's
    w = lmlp.up.weight.data().asnumpy().copy()
    w[:32] *= 4.0
    lmlp.up.weight.set_data(jmx.nd.array(w))
    inp.update(arrays_of(lmlp, "lars."))
    tr = jgluon.Trainer(lmlp.collect_params(), "lars",
                        {"learning_rate": 0.1, "momentum": 0.9,
                         "wd": 1e-4}, kvstore=None)
    step = JTrainStep(lmlp, jgluon.loss.L2Loss(), tr, mesh=None)
    ref["lars_losses"] = [float(step(jmx.nd.array(inp["lars_x"]),
                                     jmx.nd.array(inp["lars_y"]))
                                .asscalar()) for _ in range(2)]
    ref["lars_final"] = {k: p.data().asnumpy() for k, p in
                         lmlp._collect_params_with_prefix().items()}

    # shard_block_tp on a {"tp": 4} mesh
    tmesh = jmake_mesh({"tp": 4}, devices=devs)
    net = jgluon.nn.HybridSequential()
    with net.name_scope():
        net.add(jgluon.nn.Dense(32, flatten=False, prefix="up_"),
                jgluon.nn.Dense(16, flatten=False, prefix="down_"))
    net.initialize()
    inp["rules_x"] = rng.randn(2, 16).astype(np.float32)
    net(jmx.nd.array(inp["rules_x"]))
    ref["rules_sharded"] = jshard_block_tp(net, tmesh)

    # the narrow tensor-parallel BERT and two LAMB steps, global batch
    np.random.seed(0)
    jmx.random.seed(0)
    jnet = JBERTModel(tp_mesh=mesh, **BERT)
    jnet.initialize(ctx=jmx.cpu())
    inp["bert_ids"] = rng.randint(0, BERT["vocab_size"], (4, 16)) \
        .astype(np.float32)
    inp["bert_labels"] = rng.randint(0, BERT["vocab_size"], (4, 16)) \
        .astype(np.float32)
    with jautograd.pause():
        mlm, nsp = jnet(jmx.nd.array(inp["bert_ids"]))
    ref["bert_mlm"], ref["bert_nsp"] = mlm.asnumpy(), nsp.asnumpy()
    inp.update(arrays_of(jnet, "bert."))
    vocab = BERT["vocab_size"]
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()

    class MLMLoss(jgluon.HybridBlock):
        def hybrid_forward(self, F, outs, labels):
            return ce(outs[0].reshape((-1, vocab)), labels.reshape((-1,)))

    tr = jgluon.Trainer(jnet.collect_params(), "lamb", LAMB, kvstore=None)
    step = JTrainStep(jnet, MLMLoss(), tr, mesh=None)
    ref["bert_losses"] = [float(step(jmx.nd.array(inp["bert_ids"]),
                                     jmx.nd.array(inp["bert_labels"]))
                                .asscalar()) for _ in range(2)]
    ref["bert_final"] = {k: p.data().asnumpy() for k, p in
                         jnet._collect_params_with_prefix().items()}

    import json
    inp["bert_cfg"] = np.frombuffer(json.dumps(BERT).encode(), np.uint8)
    inp["lamb"] = np.frombuffer(json.dumps(LAMB).encode(), np.uint8)
    np.savez(str(tmp / "inputs.npz"), **inp)
    spawn_world(tmp, _WORKER)
    return {"ranks": load_ranks(tmp), "inp": inp, "ref": ref}


def _dp_rows(ranks, key):
    """The global batch's rows of ``key``: the ranks of tp index 0, in
    rank (and so dp) order."""
    return np.concatenate([arrays[key] for arrays, vals in ranks
                           if vals["tp_index"] == 0])


def test_tp_mlp_matches_the_jax_partitioned_forward(world):
    got = _dp_rows(world["ranks"], "mlp_out")
    np.testing.assert_allclose(got, world["ref"]["mlp_out"], rtol=2e-5,
                               atol=2e-5)


def test_tp_mlp_functionalize_matches_the_jax_one(world):
    """The port's ``functionalize`` beside the JAX one: the pure function
    of the shards gives the JAX ``pure_fn``'s partitioned forward."""
    got = _dp_rows(world["ranks"], "mlp_fn_out")
    np.testing.assert_allclose(got, world["ref"]["mlp_out"], rtol=2e-5,
                               atol=2e-5)


MLP_SPECS = {"up.weight": ["tp", None], "up.bias": ["tp"],
             "down.weight": [None, "tp"], "down.bias": []}


@pytest.mark.parametrize("name", sorted(MLP_SPECS))
def test_tp_grad_matches_the_jax_partitioned_grad(world, name):
    ranks = world["ranks"]
    got = _assemble(ranks, "gmlp.grad." + name, MLP_SPECS[name],
                    _tp_index(ranks))
    np.testing.assert_allclose(got, world["ref"]["gmlp_grads"][name],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", sorted(MLP_SPECS))
def test_tp_functionalize_grad_matches_the_jax_one(world, name):
    """``torch.autograd.grad`` through the port's ``pure_fn`` against
    ``jax.grad`` through the JAX one, shard by shard."""
    ranks = world["ranks"]
    got = _assemble(ranks, "gmlp_fn.grad." + name, MLP_SPECS[name],
                    _tp_index(ranks))
    np.testing.assert_allclose(got, world["ref"]["gmlp_grads"][name],
                               rtol=2e-4, atol=2e-5)


def test_tp_lars_train_steps_match(world):
    """Bucketed LARS over a dp x tp mesh: a tp-sharded tensor's trust
    ratio from its whole weight and gradient norms, as XLA's."""
    ranks, ref = world["ranks"], world["ref"]
    for _arrays, vals in ranks:
        np.testing.assert_allclose(vals["lars_losses"], ref["lars_losses"],
                                   **TOL)
    tp = _tp_index(ranks)
    for name, want in ref["lars_final"].items():
        got = _assemble(ranks, "lars_final." + name, MLP_SPECS[name], tp)
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        w0 = world["inp"]["lars." + name]
        assert _update_rel(got - w0, want - w0) < 1e-3, name


def test_shard_block_tp_rules(world):
    for arrays, vals in world["ranks"]:
        assert vals["rules_sharded"] == world["ref"]["rules_sharded"]
        assert any("up_weight" in s for s in vals["rules_sharded"])
        assert any("down_weight" in s for s in vals["rules_sharded"])
        assert float(arrays["rules_err"]) < 1e-5


def test_tp_bert_forward_matches(world):
    ref = world["ref"]
    np.testing.assert_allclose(_dp_rows(world["ranks"], "bert_mlm"),
                               ref["bert_mlm"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_dp_rows(world["ranks"], "bert_nsp"),
                               ref["bert_nsp"], rtol=2e-4, atol=2e-5)


def test_tp_bert_specs_are_megatrons(world):
    specs = world["ranks"][0][1]["bert_specs"]
    att = "encoder.cell0.attention."
    assert specs[att + "query_weight"] == ["tp", None]
    assert specs[att + "key_bias"] == ["tp"]
    assert specs[att + "out_weight"] == [None, "tp"]
    assert specs[att + "out_bias"] == []
    assert specs["encoder.cell1.ffn.ffn_1.weight"] == ["tp", None]
    assert specs["encoder.cell1.ffn.ffn_2.weight"] == [None, "tp"]
    assert specs["word_embed.weight"] == []
    assert specs["mlm_decoder.weight"] == []


def test_tp_bert_lamb_train_steps_match(world):
    ranks, ref = world["ranks"], world["ref"]
    for _arrays, vals in ranks:
        np.testing.assert_allclose(vals["bert_losses"], ref["bert_losses"],
                                   **TOL)
    specs = ranks[0][1]["bert_specs"]
    tp = _tp_index(ranks)
    errs = {}
    for name, want in ref["bert_final"].items():
        got = _assemble(ranks, "bert_final." + name, specs[name], tp)
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        w0 = world["inp"]["bert." + name]
        if not name.endswith("key_bias") and np.any(want != w0):
            errs[name] = _update_rel(got - w0, want - w0)
    # each tensor's update, not only its value: a trust ratio taken per
    # shard moves the sharded tensors' updates by percents
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-3, (worst, errs[worst])
