"""The port's pipeline (``pp``), expert (``ep``) and sequence (``sp``)
parallelism against the JAX package's, on the CPU.

One 4-rank gloo world (``test_torch_mesh.spawn_world``) runs every case
once for the module; the cases hold the ranks' results against the JAX
package's ``shard_map``/GSPMD programs on 4 of its CPU devices, at the
JAX tests' tolerances:

- ``pipeline_apply`` over ``{"pp": 4}``: the outputs (every rank holds
  them), each stage's gradients (each rank holds its stage's) and the
  stage-count error;
- ``MixtureOfExperts`` over ``{"ep": 4}`` with the tokens replicated
  (the JAX test's shardings) and split over ``ep`` (the ``all_to_all``
  dispatch), its gradients, the capacity drops and
  ``moe_load_balancing_loss``;
- ``ring_attention`` over ``{"sp": 4}``, full and causal, its
  gradients, and over ``{"dp": 2, "sp": 2}`` (batch*heads over ``dp``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import mxnet_tpu as jmx
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.ops.transformer import _attention_reference
from mxnet_tpu.parallel import (MixtureOfExperts as JMixtureOfExperts,
                                make_mesh as jmake_mesh,
                                moe_load_balancing_loss as jmoe_lb,
                                pipeline_apply as jpipeline_apply,
                                ring_attention as jring_attention,
                                ring_attention_sharded as jring_sharded,
                                shard_stacked_params as jshard_stacked,
                                stack_stage_params as jstack)

from test_torch_mesh import WORKER_HEAD, load_ranks, spawn_world

TOL = dict(rtol=2e-4, atol=2e-5)

_WORKER = WORKER_HEAD + r"""
from mxnet_tpu_torch.parallel import (MixtureOfExperts, make_mesh,
                                      moe_load_balancing_loss,
                                      pipeline_apply, ring_attention,
                                      ring_attention_sharded, shard_batch,
                                      shard_stacked_params,
                                      stack_stage_params)


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def trees(prefix, n=4):
    return [{"w": torch.from_numpy(inp["%s%d.w" % (prefix, s)]),
             "b": torch.from_numpy(inp["%s%d.b" % (prefix, s)])}
            for s in range(n)]


with mx.cpu():
    pmesh = make_mesh({"pp": 4}, device="cpu")
    st = shard_stacked_params(stack_stage_params(trees("pipe")), pmesh)
    xs = torch.from_numpy(inp["pipe_x"])
    arrays["pipe_out"] = pipeline_apply(stage_fn, st, xs, pmesh).numpy()

    st = shard_stacked_params(stack_stage_params(trees("pgrad")), pmesh)
    for leaf in st.values():
        leaf.requires_grad_(True)
    out = pipeline_apply(stage_fn, st, torch.from_numpy(inp["pgrad_x"]),
                         pmesh)
    (out ** 2).sum().backward()
    arrays["pgrad_w"] = st["w"].grad.numpy()
    arrays["pgrad_b"] = st["b"].grad.numpy()
    try:
        pipeline_apply(stage_fn, stack_stage_params(trees("pipe", 3)), xs,
                       pmesh)
        values["pipe_err"] = None
    except mx.MXNetError as e:
        values["pipe_err"] = str(e)
    values["pp_index"] = pmesh.axis_index("pp")

    # MixtureOfExperts over ep=4
    emesh = make_mesh({"ep": 4}, device="cpu")
    moe = MixtureOfExperts(num_experts=8, d_model=16, d_hidden=32,
                           capacity_factor=2.0, mesh=emesh)
    moe.initialize(ctx=mx.cpu())
    params_from_numpy(moe, weights_in("moe."))
    moe.shard(emesh)
    xm = torch.from_numpy(inp["moe_x"])
    with autograd.pause():
        arrays["moe_rep"] = moe(xm).numpy()
        xl = shard_batch(xm[rank * 16:(rank + 1) * 16], emesh,
                         axis_name="ep")
        arrays["moe_split"] = moe(xl)._data.numpy() \
            if hasattr(moe(xl), "_data") else moe(xl).numpy()
    xg = xm.clone().requires_grad_(True)
    with autograd.record():
        loss = (moe(xg) ** 2).sum()
    loss.backward()
    arrays["moe_gx"] = xg.grad.numpy()
    for k, p in moe._collect_params_with_prefix().items():
        arrays["moe_g." + k] = p._data.grad.numpy()
    # the same forward and gradients through the port's pure function
    pure, pnames, pmap = moe.functionalize(training=False)
    pvals = {n: pmap[n]._data.detach().clone().requires_grad_()
             for n in pnames}
    xf = xm.clone().requires_grad_(True)
    out = pure(pvals, [xf])[0][0]
    arrays["moe_fn_out"] = out.detach().numpy()
    fn_grads = torch.autograd.grad((out ** 2).sum(),
                                   [xf] + [pvals[n] for n in pnames])
    arrays["moe_fn_gx"] = fn_grads[0].numpy()
    structural = {p.name: k for k, p in
                  moe._collect_params_with_prefix().items()}
    for n, g in zip(pnames, fn_grads[1:]):
        arrays["moe_fn_g." + structural[n]] = g.numpy()
    values["ep_index"] = emesh.axis_index("ep")

    drop = MixtureOfExperts(num_experts=2, d_model=4, d_hidden=8,
                            capacity_factor=0.1)
    drop.initialize(ctx=mx.cpu())
    params_from_numpy(drop, weights_in("drop."))
    with autograd.pause():
        arrays["drop_out"] = drop(torch.from_numpy(inp["drop_x"])).numpy()
    arrays["lb"] = moe_load_balancing_loss(
        torch.from_numpy(inp["lb_x"]), torch.from_numpy(inp["lb_g"])).numpy()

    # ring attention over sp=4, then over dp=2 x sp=2
    smesh = make_mesh({"sp": 4}, device="cpu")
    q, k, v = (torch.from_numpy(inp["ring_" + n]) for n in "qkv")
    for causal in (False, True):
        arrays["ring_%d" % causal] = ring_attention_sharded(
            q, k, v, smesh, causal=causal)._data.numpy()
    sl = slice(rank * 16, (rank + 1) * 16)
    ql, kl, vl = (t[:, sl].clone().requires_grad_(True) for t in (q, k, v))
    with autograd.record():
        o = ring_attention(ql, kl, vl, smesh, causal=True)
        loss = (o ** 2).sum()
    loss.backward()
    for n, t in zip("qkv", (ql, kl, vl)):
        arrays["ring_g" + n] = t.grad.numpy()

    dsmesh = make_mesh({"dp": 2, "sp": 2}, device="cpu")
    di, si = dsmesh.axis_index("dp"), dsmesh.axis_index("sp")
    q, k, v = (torch.from_numpy(inp["ds_" + n])[di * 2:(di + 1) * 2,
                                                si * 16:(si + 1) * 16]
               for n in "qkv")
    arrays["ds_out"] = ring_attention(q, k, v, dsmesh, causal=True).numpy()
    values["ds_index"] = [di, si]
finish()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppmoe")
    devs = jax.devices("cpu")[:4]
    inp, ref = {}, {}
    rng = np.random.RandomState(0)

    def stage_fn(params, x):
        return jnp.tanh(x @ params["w"] + params["b"])

    # pipeline forward (tests/test_pipeline_moe.py's shapes)
    pmesh = jmake_mesh({"pp": 4}, devices=devs)
    d = 16
    trees = []
    for s in range(4):
        inp["pipe%d.w" % s] = rng.randn(d, d).astype(np.float32) * 0.3
        inp["pipe%d.b" % s] = rng.randn(d).astype(np.float32) * 0.1
        trees.append({"w": jnp.asarray(inp["pipe%d.w" % s]),
                      "b": jnp.asarray(inp["pipe%d.b" % s])})
    inp["pipe_x"] = rng.randn(6, 8, d).astype(np.float32)
    ref["pipe_out"] = np.asarray(jpipeline_apply(
        stage_fn, jshard_stacked(jstack(trees), pmesh),
        jnp.asarray(inp["pipe_x"]), pmesh))
    with pytest.raises(JMXNetError) as e:
        jpipeline_apply(stage_fn, jstack(trees[:3]),
                        jnp.asarray(inp["pipe_x"]), pmesh)
    ref["pipe_err"] = str(e.value)

    # pipeline gradients
    d = 8
    gtrees = []
    for s in range(4):
        inp["pgrad%d.w" % s] = rng.randn(d, d).astype(np.float32) * 0.3
        inp["pgrad%d.b" % s] = np.zeros(d, np.float32)
        gtrees.append({"w": jnp.asarray(inp["pgrad%d.w" % s]),
                       "b": jnp.asarray(inp["pgrad%d.b" % s])})
    inp["pgrad_x"] = rng.randn(4, 4, d).astype(np.float32)
    xs = jnp.asarray(inp["pgrad_x"])
    g = jax.grad(lambda p: jnp.sum(jpipeline_apply(stage_fn, p, xs,
                                                   pmesh) ** 2))(
        jshard_stacked(jstack(gtrees), pmesh))
    ref["pgrad_w"], ref["pgrad_b"] = np.asarray(g["w"]), np.asarray(g["b"])

    # MoE over ep=4 (tests/test_pipeline_moe.py's layer)
    emesh = jmake_mesh({"ep": 4}, devices=devs)
    jmx.random.seed(0)
    moe = JMixtureOfExperts(num_experts=8, d_model=16, d_hidden=32,
                            capacity_factor=2.0, mesh=emesh)
    moe.initialize()
    inp["moe_x"] = rng.randn(64, 16).astype(np.float32)
    moe(jmx.nd.array(inp["moe_x"]))
    for k, p in moe._collect_params_with_prefix().items():
        inp["moe." + k] = p.data().asnumpy()
    moe.shard(emesh)
    pure_fn, pnames, pmap = moe.functionalize(training=False)
    pvals = {n: pmap[n]._data._data for n in pnames}

    def fwd(pv, xv):
        return pure_fn(pv, [xv], jax.random.PRNGKey(0))[0][0]

    xv = jax.device_put(jnp.asarray(inp["moe_x"]),
                        NamedSharding(emesh, P()))
    ref["moe_out"] = np.asarray(jax.jit(fwd)(pvals, xv))
    gp, gx = jax.grad(lambda pv, xv: jnp.sum(fwd(pv, xv) ** 2),
                      argnums=(0, 1))(pvals, xv)
    structural = {p.name: k for k, p in
                  moe._collect_params_with_prefix().items()}
    ref["moe_gp"] = {structural[n]: np.asarray(v) for n, v in gp.items()}
    ref["moe_gx"] = np.asarray(gx)

    jmx.random.seed(0)
    drop = JMixtureOfExperts(num_experts=2, d_model=4, d_hidden=8,
                             capacity_factor=0.1)
    drop.initialize()
    inp["drop_x"] = np.random.RandomState(1).randn(40, 4).astype(np.float32)
    ref["drop_out"] = drop(jmx.nd.array(inp["drop_x"])).asnumpy()
    for k, p in drop._collect_params_with_prefix().items():
        inp["drop." + k] = p.data().asnumpy()
    inp["lb_x"] = rng.randn(32, 8).astype(np.float32)
    inp["lb_g"] = rng.randn(8, 4).astype(np.float32)
    ref["lb"] = float(jmoe_lb(jnp.asarray(inp["lb_x"]),
                              jnp.asarray(inp["lb_g"])))

    # ring attention over sp=4, and its causal gradients
    smesh = jmake_mesh({"sp": 4}, devices=devs)
    bh, seq, dd = 4, 64, 16
    for n in "qkv":
        inp["ring_" + n] = rng.randn(bh, seq, dd).astype(np.float32)
    q, k, v = (jnp.asarray(inp["ring_" + n]) for n in "qkv")
    for causal in (False, True):
        ref["ring_%d" % causal] = jring_sharded(q, k, v, smesh,
                                                causal=causal).asnumpy()
    gq, gk, gv = jax.grad(
        lambda a, b, c: jnp.sum(_attention_reference(
            a, b, c, True, 1.0 / np.sqrt(dd)) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    ref["ring_g"] = {"q": np.asarray(gq), "k": np.asarray(gk),
                     "v": np.asarray(gv)}

    # dp x sp
    dsmesh = jmake_mesh({"dp": 2, "sp": 2}, devices=devs)
    for n in "qkv":
        inp["ds_" + n] = rng.randn(4, 32, 8).astype(np.float32)
    sh = NamedSharding(dsmesh, P("dp", "sp", None))
    q, k, v = (jax.device_put(jnp.asarray(inp["ds_" + n]), sh)
               for n in "qkv")
    ref["ds_out"] = np.asarray(jax.jit(
        lambda a, b, c: jring_attention(a, b, c, mesh=dsmesh,
                                        causal=True))(q, k, v))

    np.savez(str(tmp / "inputs.npz"), **inp)
    spawn_world(tmp, _WORKER)
    return {"ranks": load_ranks(tmp), "inp": inp, "ref": ref}


def test_pipeline_matches_jax(world):
    for arrays, _vals in world["ranks"]:
        np.testing.assert_allclose(arrays["pipe_out"],
                                   world["ref"]["pipe_out"], rtol=2e-5,
                                   atol=2e-5)


def test_pipeline_grads_match_jax(world):
    ranks, ref = world["ranks"], world["ref"]
    order = sorted(range(4), key=lambda r: ranks[r][1]["pp_index"])
    for name in ("w", "b"):
        got = np.concatenate([ranks[r][0]["pgrad_" + name] for r in order])
        np.testing.assert_allclose(got, ref["pgrad_" + name], rtol=5e-4,
                                   atol=1e-5)


def test_pipeline_stage_count_error_is_jaxs(world):
    for _arrays, vals in world["ranks"]:
        assert vals["pipe_err"] == world["ref"]["pipe_err"]


def test_moe_forward_replicated_tokens(world):
    for arrays, _vals in world["ranks"]:
        np.testing.assert_allclose(arrays["moe_rep"], world["ref"]["moe_out"],
                                   rtol=2e-4, atol=1e-5)


def test_moe_forward_tokens_split_over_ep(world):
    want = world["ref"]["moe_out"]
    for r, (arrays, _vals) in enumerate(world["ranks"]):
        np.testing.assert_allclose(arrays["moe_split"],
                                   want[r * 16:(r + 1) * 16], rtol=2e-4,
                                   atol=1e-5)


def test_moe_grads_match_jax(world):
    ranks, ref = world["ranks"], world["ref"]
    order = sorted(range(4), key=lambda r: ranks[r][1]["ep_index"])
    for arrays, _vals in ranks:
        np.testing.assert_allclose(arrays["moe_gx"], ref["moe_gx"], **TOL)
        np.testing.assert_allclose(arrays["moe_g.gate"],
                                   ref["moe_gp"]["gate"], **TOL)
    for name in ("w_up", "w_down"):
        got = np.concatenate([ranks[r][0]["moe_g." + name] for r in order])
        np.testing.assert_allclose(got, ref["moe_gp"][name], err_msg=name,
                                   **TOL)


def test_moe_functionalize_matches_the_jax_one(world):
    """The port's ``functionalize`` beside the JAX one: its pure
    function's output and gradients (inputs and every parameter's
    shard) against the JAX ``pure_fn``'s and ``jax.grad``'s."""
    ranks, ref = world["ranks"], world["ref"]
    order = sorted(range(4), key=lambda r: ranks[r][1]["ep_index"])
    for arrays, _vals in ranks:
        np.testing.assert_allclose(arrays["moe_fn_out"], ref["moe_out"],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(arrays["moe_fn_gx"], ref["moe_gx"],
                                   **TOL)
        np.testing.assert_allclose(arrays["moe_fn_g.gate"],
                                   ref["moe_gp"]["gate"], **TOL)
    for name in ("w_up", "w_down"):
        got = np.concatenate([ranks[r][0]["moe_fn_g." + name]
                              for r in order])
        np.testing.assert_allclose(got, ref["moe_gp"][name], err_msg=name,
                                   **TOL)


def test_moe_capacity_drops_overflow(world):
    for arrays, _vals in world["ranks"]:
        out = arrays["drop_out"]
        np.testing.assert_allclose(out, world["ref"]["drop_out"], rtol=2e-4,
                                   atol=1e-6)
        assert ((np.abs(out).sum(axis=1) > 1e-7).sum()) <= 4


def test_moe_load_balance_loss(world):
    for arrays, _vals in world["ranks"]:
        np.testing.assert_allclose(float(arrays["lb"]), world["ref"]["lb"],
                                   rtol=1e-5)
        assert float(arrays["lb"]) >= 1.0 - 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(world, causal):
    want = world["ref"]["ring_%d" % causal]
    for r, (arrays, _vals) in enumerate(world["ranks"]):
        np.testing.assert_allclose(arrays["ring_%d" % causal],
                                   want[:, r * 16:(r + 1) * 16], rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_ring_attention_grads(world, name):
    want = world["ref"]["ring_g"][name]
    for r, (arrays, _vals) in enumerate(world["ranks"]):
        np.testing.assert_allclose(arrays["ring_g" + name],
                                   want[:, r * 16:(r + 1) * 16], rtol=2e-4,
                                   atol=5e-5)


def test_ring_attention_composes_with_dp(world):
    want = world["ref"]["ds_out"]
    for arrays, vals in world["ranks"]:
        di, si = vals["ds_index"]
        np.testing.assert_allclose(
            arrays["ds_out"], want[di * 2:(di + 1) * 2, si * 16:(si + 1) * 16],
            rtol=2e-4, atol=2e-5)
