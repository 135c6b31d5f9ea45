"""``mx.sym``, the executor and ``ctx_group`` placement against the JAX
package on the CPU: composition, ``list_*``, ``infer_shape`` (the cases
of ``tests/test_module.py``, with a convolution), ``-symbol.json``
written by each package and loaded by the other, ``eval`` and bound
executors (forward, backward with explicit head gradients, BatchNorm's
running statistics, the CostReports of its keys), the argument names
of every op both op tables hold, and the cases of
``tests/test_ctx_group.py`` on CPU devices.

Tolerance: 1e-5 relative / 1e-6 absolute (fp32 products summed in
another order by two libraries); gradients 1e-5 / 1e-5."""
import json

import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as jmx
from mxnet_tpu import sym as jsym
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.ops.registry import OP_REGISTRY

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, sym
from mxnet_tpu_torch.ops import table

FWD = dict(rtol=1e-5, atol=1e-6)
BWD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_and_exact():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _mlp(s, num_hidden=32, num_classes=4):
    data = s.var("data")
    fc1 = s.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    act = s.Activation(fc1, act_type="relu", name="relu1")
    fc2 = s.FullyConnected(act, num_hidden=num_classes, name="fc2")
    return s.SoftmaxOutput(fc2, name="softmax")


def _convnet(s):
    data = s.var("data")
    c = s.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                      name="conv0")
    b = s.BatchNorm(c, fix_gamma=False, name="bn0")
    a = s.Activation(b, act_type="relu", name="relu0")
    p = s.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool0")
    f = s.FullyConnected(p, num_hidden=5, name="fc0")
    return s.SoftmaxOutput(f, name="softmax")


def _both(build):
    """The same graph built in each package under fresh name counters."""
    with jmx.name.NameManager():
        j = build(jsym)
    with tmx.name.NameManager():
        t = build(sym)
    return j, t


def _composite(s):
    x = s.var("x")
    y = s.var("y", shape=(2, 3))
    z = (x + y) * 2.0 - y / (x * x + 1.0)
    w = 1.0 - s.exp(-z) ** 2
    return s.Group([s.sum(w, axis=1), s.relu(z)])


@pytest.mark.parametrize("build", [_mlp, _convnet, _composite])
def test_composition_and_lists_match(build):
    j, t = _both(build)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert len(t) == len(j) and t.name == j.name


def test_infer_shape_deduces_weights():
    j, t = _both(_mlp)
    want = j.infer_shape(data=(16, 8))
    arg_shapes, out_shapes, aux = t.infer_shape(data=(16, 8))
    shapes = dict(zip(t.list_arguments(), arg_shapes))
    assert shapes["fc1_weight"] == (32, 8) and shapes["fc1_bias"] == (32,)
    assert shapes["fc2_weight"] == (4, 32)
    assert shapes["softmax_label"] == (16,)
    assert out_shapes == [(16, 4)]
    assert (arg_shapes, out_shapes, aux) == want


def test_infer_shape_conv_and_partial():
    j, t = _both(_convnet)
    got = t.infer_shape(data=(2, 3, 8, 8))
    assert got == j.infer_shape(data=(2, 3, 8, 8))
    shapes = dict(zip(t.list_arguments(), got[0]))
    assert shapes["conv0_weight"] == (8, 3, 3, 3)
    assert shapes["bn0_gamma"] == (8,)
    assert got[2] == [(8,), (8,)]
    assert t.infer_shape_partial() == j.infer_shape_partial()
    assert all(a is None for a in t.infer_shape_partial()[0])
    with pytest.raises(MXNetError, match="cannot deduce"):
        t.infer_shape()


@pytest.mark.parametrize("build", [_mlp, _convnet, _composite])
def test_symbol_json_crosses_the_packages(build, tmp_path):
    j, t = _both(build)
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    j.save(str(tmp_path / "j-symbol.json"))
    t.save(str(tmp_path / "t-symbol.json"))
    from_j = sym.load(str(tmp_path / "j-symbol.json"))
    from_t = jsym.load(str(tmp_path / "t-symbol.json"))
    assert from_j.tojson() == j.tojson()
    assert from_t.tojson() == t.tojson()
    assert from_j.list_arguments() == t.list_arguments()


def test_symbol_json_of_an_unknown_op_raises():
    doc = json.loads(_mlp(sym).tojson())
    doc["nodes"][-1]["op"] = "NoSuchOp"
    with pytest.raises(MXNetError, match="unknown op"):
        sym.load_json(json.dumps(doc))


def _feed(s, shapes, seed=0, label_classes=None):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = s.infer_shape(**shapes)
    feed = {n: rng.randn(*sh).astype(np.float32) * 0.5
            for n, sh in zip(s.list_arguments(), arg_shapes)}
    if label_classes:
        feed["softmax_label"] = rng.randint(
            0, label_classes, arg_shapes[-1]).astype(np.float32)
    aux = {n: (rng.rand(*sh).astype(np.float32) + 0.5)
           for n, sh in zip(s.list_auxiliary_states(), aux_shapes)}
    return feed, aux


@pytest.mark.parametrize("build,shapes", [
    (_mlp, {"data": (6, 8)}), (_composite, {"x": (2, 3)})])
def test_eval_matches(build, shapes):
    j, t = _both(build)
    feed, _ = _feed(t, shapes)
    want = j.eval(**{k: jmx.nd.array(v, ctx=jmx.cpu())
                     for k, v in feed.items()})
    got = t.eval(**{k: tmx.nd.array(v) for k, v in feed.items()})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **FWD)


def _bound(pkg, s, feed, aux, ctx, grad_req="write"):
    args = {k: pkg.nd.array(v, ctx=ctx) for k, v in feed.items()}
    grads = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in feed.items()}
    auxs = {k: pkg.nd.array(v, ctx=ctx) for k, v in aux.items()}
    return s.bind(ctx=ctx, args=args, args_grad=grads, grad_req=grad_req,
                  aux_states=auxs)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_bound_executor_trains_as_the_jax_executor(grad_req):
    """Two training forwards and backwards of the conv net: outputs,
    every gradient (written or accumulated) and BatchNorm's running
    statistics, updated in place."""
    j, t = _both(_convnet)
    feed, aux = _feed(t, {"data": (4, 3, 8, 8)}, label_classes=5)
    je = _bound(jmx, j, feed, aux, jmx.cpu(), grad_req)
    te = _bound(tmx, t, feed, aux, tmx.cpu(), grad_req)
    mean_t = te.aux_dict["bn0_moving_mean"]._data
    for _ in range(2):
        jo = je.forward(is_train=True)
        to = te.forward(is_train=True)
        je.backward()
        te.backward()
    np.testing.assert_allclose(to[0].asnumpy(), jo[0].asnumpy(), **FWD)
    for name in t.list_arguments():
        np.testing.assert_allclose(te.grad_dict[name].asnumpy(),
                                   je.grad_dict[name].asnumpy(), **BWD,
                                   err_msg=name)
    for name in t.list_auxiliary_states():
        np.testing.assert_allclose(te.aux_dict[name].asnumpy(),
                                   je.aux_dict[name].asnumpy(), **FWD)
    assert te.aux_dict["bn0_moving_mean"]._data is mean_t
    assert not np.allclose(te.aux_dict["bn0_moving_mean"].asnumpy(),
                           aux["bn0_moving_mean"])
    jo = je.forward(is_train=False, data=jmx.nd.array(feed["data"] * 2,
                                                      ctx=jmx.cpu()))
    to = te.forward(is_train=False, data=tmx.nd.array(feed["data"] * 2))
    np.testing.assert_allclose(to[0].asnumpy(), jo[0].asnumpy(), **FWD)


def test_backward_with_explicit_head_gradients():
    def build(s):
        x = s.var("x")
        return s.FullyConnected(s.tanh(x), num_hidden=3, name="fc")
    j, t = _both(build)
    feed, _ = _feed(t, {"x": (4, 5)})
    je = _bound(jmx, j, feed, {}, jmx.cpu())
    te = _bound(tmx, t, feed, {}, tmx.cpu())
    head = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    je.forward(is_train=True)
    te.forward(is_train=True)
    je.backward(jmx.nd.array(head, ctx=jmx.cpu()))
    te.backward(tmx.nd.array(head))
    for name in t.list_arguments():
        np.testing.assert_allclose(te.grad_dict[name].asnumpy(),
                                   je.grad_dict[name].asnumpy(), **BWD)
    with pytest.raises(MXNetError, match="backward before forward"):
        te.backward()


def test_simple_bind_and_unknown_input():
    t = _mlp(sym)
    exe = t.simple_bind(ctx=tmx.cpu(), data=(2, 8))
    assert exe.arg_dict["fc1_weight"].shape == (32, 8)
    assert exe.grad_dict["fc2_bias"].shape == (4,)
    with pytest.raises(MXNetError, match="unknown input"):
        exe.forward(bogus=tmx.nd.zeros((1,)))
    # the static graph check: a clean graph binds, a broken one raises
    # GraphCheckError (an MXNetError) naming its rule
    checked = t.simple_bind(ctx=tmx.cpu(), check=True, data=(2, 8))
    assert checked.arg_dict["fc1_weight"].shape == (32, 8)
    twin = tmx.sym.var("x") + tmx.sym.var("x")
    with pytest.raises(MXNetError, match="duplicate-input"):
        twin.simple_bind(ctx=tmx.cpu(), check=True, x=(2, 2))


def test_rnn_symbol_names_its_state_cell_by_mode():
    for mode, want in (("lstm", ["data", "rnn_parameters", "rnn_state",
                                 "rnn_state_cell"]),
                       ("gru", ["data", "rnn_parameters", "rnn_state"])):
        j, t = _both(lambda s: s.RNN(s.var("data"), state_size=4,
                                     num_layers=1, mode=mode, name="rnn"))
        assert t.list_arguments() == j.list_arguments() == want
        assert len(t.list_outputs()) == len(j.list_outputs())


SHARED_OPS = sorted(set(OP_REGISTRY) & set(table.names()))


@pytest.mark.parametrize("name", SHARED_OPS)
def test_every_shared_op_takes_the_jax_arguments(name):
    """Each op name both tables hold is the same op with the same tensor
    arguments, so symbols' argument lists (and ``.params``/
    ``-symbol.json`` files) agree.  ``LeakyReLU`` takes ``gamma`` as a
    tensor for ``prelu``, which the JAX op rejects; its symbol makes a
    ``gamma`` variable only for ``prelu``, as the reference's, so every
    act_type the JAX op takes lists the same arguments."""
    jop, spec = OP_REGISTRY[name], table.lookup(name)
    assert spec.name == jop.name and spec.variadic == jop.variadic
    if name == "LeakyReLU":
        for act in ("leaky", "elu", "selu", "gelu"):
            j, t = _both(lambda s: s.LeakyReLU(s.var("data"), act_type=act,
                                               name="lr"))
            assert t.list_arguments() == j.list_arguments() == ["data"]
        return
    assert spec.args == tuple(jop.arg_names)
    assert hasattr(sym, name) == name.isidentifier()


def test_attr_scope_and_name_prefix():
    with tmx.AttrScope(ctx_group="stage1", lr_mult="0.5"):
        v = sym.var("v")
        fc = sym.FullyConnected(v, num_hidden=2, name="fc")
    assert v.attr("ctx_group") == "stage1" and fc.attr("lr_mult") == "0.5"
    with tmx.name.Prefix("net_"):
        a = sym.Activation(v, act_type="relu")
    assert a.name == "net_activation0"


# -- ctx_group placement (tests/test_ctx_group.py, CPU devices) ---------

def _two_stage(pkg, s):
    with pkg.AttrScope(ctx_group="stage1"):
        data = s.var("data")
        h = s.FullyConnected(data, num_hidden=16, name="fc1")
        h = s.Activation(h, act_type="relu")
    with pkg.AttrScope(ctx_group="stage2"):
        out = s.FullyConnected(h, num_hidden=4, name="fc2")
    return out


def _stage_args(pkg, ctx, rng=None):
    shapes = {"data": (2, 8), "fc1_weight": (16, 8), "fc1_bias": (16,),
              "fc2_weight": (4, 16), "fc2_bias": (4,)}
    if rng is None:
        vals = {"data": np.zeros((2, 8)), "fc1_weight": np.ones((16, 8)) * .1,
                "fc1_bias": np.zeros(16), "fc2_weight": np.ones((4, 16)) * .1,
                "fc2_bias": np.zeros(4)}
    else:
        vals = {k: rng.randn(*v) for k, v in shapes.items()}
    return {k: pkg.nd.array(v.astype(np.float32), ctx=ctx)
            for k, v in vals.items()}


def test_group2ctx_places_and_computes():
    out = _two_stage(tmx, sym)
    g2c = {"stage1": tmx.Context("cpu", 1), "stage2": tmx.Context("cpu", 3)}
    exe = out.bind(ctx=tmx.cpu(0), args=_stage_args(tmx, tmx.cpu()),
                   grad_req="null", group2ctx=g2c)
    outs = exe.forward(data=tmx.nd.ones((2, 8)))
    x = np.ones((2, 8), np.float32)
    h = np.maximum(x @ (np.ones((8, 16), np.float32) * 0.1), 0)
    want = h @ (np.ones((16, 4), np.float32) * 0.1)
    np.testing.assert_allclose(outs[0].asnumpy(), want, rtol=1e-5)


def test_group2ctx_matches_ungrouped_and_the_jax_package():
    jout, tout = _two_stage(jmx, jsym), _two_stage(tmx, sym)
    targs = _stage_args(tmx, tmx.cpu(), np.random.RandomState(0))
    jargs = _stage_args(jmx, jmx.cpu(), np.random.RandomState(0))
    plain = tout.bind(ctx=tmx.cpu(), args=dict(targs), grad_req="null")
    want = plain.forward()[0].asnumpy()
    exe = tout.bind(ctx=tmx.cpu(0), args=dict(targs), grad_req="null",
                    group2ctx={"stage1": tmx.Context("cpu", 2),
                               "stage2": tmx.Context("cpu", 5)})
    got = exe.forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jexe = jout.bind(ctx=jmx.cpu(0), args=dict(jargs), grad_req="null",
                     group2ctx={"stage1": jmx.Context("cpu", 2),
                                "stage2": jmx.Context("cpu", 5)})
    np.testing.assert_allclose(got, jexe.forward()[0].asnumpy(), **FWD)


def test_group2ctx_training_raises_naming_parallelism():
    out = _two_stage(tmx, sym)
    exe = out.bind(ctx=tmx.cpu(0), args=_stage_args(tmx, tmx.cpu()),
                   grad_req="null", group2ctx={"stage1": tmx.cpu(1)})
    with pytest.raises(MXNetError, match="parallel"):
        exe.forward(is_train=True)
    jout = _two_stage(jmx, jsym)
    jexe = jout.bind(ctx=jmx.cpu(0), args=_stage_args(jmx, jmx.cpu()),
                     grad_req="null", group2ctx={"stage1": jmx.cpu(1)})
    with pytest.raises(JMXNetError, match="parallel"):
        jexe.forward(is_train=True)


def test_unknown_group_falls_back_to_default_ctx():
    with tmx.AttrScope(ctx_group="nowhere"):
        data = sym.var("data")
        out = sym.FullyConnected(data, num_hidden=4, name="fc")
    exe = out.bind(ctx=tmx.cpu(0),
                   args={"data": tmx.nd.ones((2, 8)),
                         "fc_weight": tmx.nd.ones((4, 8)),
                         "fc_bias": tmx.nd.zeros((4,))},
                   grad_req="null", group2ctx={"stage1": tmx.cpu(1)})
    np.testing.assert_allclose(exe.forward()[0].asnumpy(),
                               np.full((2, 4), 8.0))


def test_executor_keys_register_with_profiling_as_the_jax_executor():
    """Each mode of a bound executor is a CostReport under the JAX
    executor's labels (``executor.train``, ``executor.eval``), walked
    from the key's eager first call, counting at least the MLP's dense
    flops (forward; forward and backward)."""
    from mxnet_tpu import profiling as jprof
    from mxnet_tpu_torch import profiling
    j, t = _both(_mlp)
    feed, _ = _feed(t, {"data": (16, 8)}, label_classes=4)
    jprof.reset()
    profiling.reset()
    jprof.enable()
    profiling.enable()
    try:
        for pkg, s, ctx in ((jmx, j, jmx.cpu()), (tmx, t, tmx.cpu())):
            exe = _bound(pkg, s, feed, {}, ctx)
            for _ in range(2):
                exe.forward(is_train=True)
                exe.backward()
                exe.forward(is_train=False)
        jreps = {r["label"]: r for r in jprof.reports()}
        reps = {r["label"]: r for r in profiling.reports()}
    finally:
        jprof.disable()
        profiling.disable()
        jprof.reset()
        profiling.reset()
    assert {"executor.train", "executor.eval"} <= set(reps)
    for label in ("executor.train", "executor.eval"):
        assert reps[label]["kind"] == jreps[label]["kind"] == "executor"
        assert reps[label]["totals"]["flops"] > 0
    dense = 2 * 16 * (8 * 32 + 32 * 4)      # the two products, forward
    assert reps["executor.eval"]["totals"]["flops"] >= dense
    # forward, and backward but for the data's gradient (no grad_req)
    assert reps["executor.train"]["totals"]["flops"] >= \
        3 * dense - 2 * 16 * 8 * 32
