"""``mx.mod`` (``Module``, ``BucketingModule``), ``mx.model`` and
``mx.callback`` against the JAX package on the CPU: the cases of
``tests/test_module.py``, each run in both packages from the same
initial parameters over the same batches (no shuffling), and
checkpoints crossing the packages (``-symbol.json``, ``.params`` and
``.states``).

Tolerance: 1e-5 relative / 1e-6 absolute on outputs and scores after
a step, 1e-4 / 1e-5 on parameters after a few SGD steps (fp32 products
summed in another order, compounding over the steps)."""
import glob
import logging
import os

import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError

import chip_smoke

FWD = dict(rtol=1e-5, atol=1e-6)
STEPS = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_and_exact():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _mlp(pkg, num_hidden=32, num_classes=4):
    s = pkg.sym
    with pkg.name.NameManager():
        data = s.var("data")
        fc1 = s.FullyConnected(data, num_hidden=num_hidden, name="fc1")
        act = s.Activation(fc1, act_type="relu")
        fc2 = s.FullyConnected(act, num_hidden=num_classes, name="fc2")
        return s.SoftmaxOutput(fc2, name="softmax")


def _toy(n=64, dim=8, num_classes=4, seed=0):
    centers = np.random.RandomState(42).randn(num_classes, dim) * 3
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n)
    x = centers[y] + rng.randn(n, dim) * 0.3
    return x.astype(np.float32), y.astype(np.float32)


def _iter(pkg, n=64, seed=0, batch_size=16):
    return pkg.io.NDArrayIter(*_toy(n, seed=seed), batch_size=batch_size,
                              shuffle=False)


def _init(pkg, shapes, seed=1, ctx=None):
    rng = np.random.RandomState(seed)
    return {n: pkg.nd.array((0.3 * rng.randn(*s)).astype(np.float32),
                            ctx=ctx)
            for n, s in sorted(shapes.items())}


def _mlp_shapes(batch=16):
    s = _mlp(tmx)
    arg_shapes, _, _ = s.infer_shape(data=(batch, 8))
    return {n: sh for n, sh in zip(s.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _params(mod):
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def _assert_params(got, want, tol=STEPS):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


def test_infer_shape_deduces_weights():
    want = _mlp(jmx).infer_shape(data=(16, 8))
    got = _mlp(tmx).infer_shape(data=(16, 8))
    assert got == want
    shapes = dict(zip(_mlp(tmx).list_arguments(), got[0]))
    assert shapes["fc1_weight"] == (32, 8) and shapes["fc2_weight"] == (4, 32)
    assert shapes["softmax_label"] == (16,) and got[1] == [(16, 4)]


def test_infer_shape_conv():
    def build(pkg):
        with pkg.name.NameManager():
            c = pkg.sym.Convolution(pkg.sym.var("data"), num_filter=8,
                                    kernel=(3, 3), pad=(1, 1), name="conv0")
            return pkg.sym.BatchNorm(c, name="bn0")
    got = build(tmx).infer_shape(data=(2, 3, 8, 8))
    assert got == build(jmx).infer_shape(data=(2, 3, 8, 8))
    shapes = dict(zip(build(tmx).list_arguments(), got[0]))
    assert shapes["conv0_weight"] == (8, 3, 3, 3)
    assert shapes["bn0_gamma"] == (8,) and got[1][0] == (2, 8, 8, 8)


def test_infer_shape_partial():
    got = _mlp(tmx).infer_shape_partial()
    assert got == _mlp(jmx).infer_shape_partial()
    assert all(a is None for a in got[0])


def _fit(pkg, ctx, num_epoch, **kw):
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    mod.fit(_iter(pkg), num_epoch=num_epoch, optimizer="sgd",
            arg_params=_init(pkg, _mlp_shapes(), ctx=ctx), **kw)
    return mod


def test_module_fit_matches_and_learns():
    """``Module.fit``: 5 epochs of 4 batches, SGD 0.5, with Speedometer;
    the parameters after the 20 batches equal the JAX Module's, and the
    score on another set clears 0.8 as the reference test asks."""
    kw = dict(optimizer_params={"learning_rate": 0.5}, eval_metric="acc")
    speed = tmx.callback.Speedometer(16, 2)
    tmod = _fit(tmx, tmx.cpu(), 5, batch_end_callback=speed, **kw)
    jmod = _fit(jmx, jmx.cpu(), 5,
                batch_end_callback=jmx.callback.Speedometer(16, 2), **kw)
    _assert_params(_params(tmod), _params(jmod))
    assert speed.last_speed is not None and speed.last_speed > 0
    got = tmod.score(_iter(tmx, seed=1), tmx.metric.Accuracy())
    want = jmod.score(_iter(jmx, seed=1), jmx.metric.Accuracy())
    assert got[0][1] == want[0][1] and got[0][1] > 0.8, (got, want)
    pred = tmod.predict(_iter(tmx, n=40, seed=1))
    jpred = jmod.predict(_iter(jmx, n=40, seed=1))
    assert pred.shape == (40, 4)
    np.testing.assert_allclose(pred.asnumpy(), jpred.asnumpy(), **STEPS)


def test_module_forward_backward_update():
    rng = np.random.RandomState(2)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.float32)
    results = []
    for pkg, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        mod.bind(data_shapes=[("data", (16, 8))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params=_init(pkg, _mlp_shapes(), ctx=ctx))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=ctx)],
                                 label=[pkg.nd.array(y, ctx=ctx)])
        before = _params(mod)
        for _ in range(2):
            mod.forward(batch, is_train=True)
            out = mod.get_outputs()[0].asnumpy()
            mod.backward()
            mod.update()
        results.append((before, out, _params(mod)))
    (_, jout, jafter), (before, out, after) = results
    assert out.shape == (16, 4)
    np.testing.assert_allclose(out.sum(axis=1), np.ones(16), rtol=1e-5)
    np.testing.assert_allclose(out, jout, **FWD)
    assert not np.allclose(before["fc1_weight"], after["fc1_weight"])
    _assert_params(after, jafter)


def test_module_save_load_checkpoint(tmp_path):
    prefix = str(tmp_path / "mlp")
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 8))])
    mod.init_params()
    mod.save_checkpoint(prefix, 3)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0003.params")
    loaded = tmx.mod.Module.load(prefix, 3, context=tmx.cpu())
    loaded.bind(data_shapes=[("data", (4, 8))])
    loaded.init_params()
    _assert_params(_params(loaded), _params(mod), tol=dict(rtol=0, atol=0))
    symbol, arg_params, aux_params = tmx.model.load_checkpoint(prefix, 3)
    assert set(arg_params) == set(_params(mod)) and aux_params == {}
    assert symbol.tojson() == _mlp(tmx).tojson()
    assert all(v.context == tmx.cpu() for v in arg_params.values())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_the_packages(writer, tmp_path):
    """A checkpoint written by one package's ``Module.save_checkpoint``
    loaded by the other's ``Module.load`` scores the same."""
    prefix = str(tmp_path / "cross")
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    sctx = src.cpu()
    mod = src.mod.Module(_mlp(src), context=sctx)
    mod.fit(_iter(src), num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.3},
            arg_params=_init(src, _mlp_shapes(), ctx=sctx))
    mod.save_checkpoint(prefix, 1)
    want = mod.score(_iter(src, seed=1), "acc")
    dctx = dst.cpu()
    kw = {"context": dctx}
    loaded = dst.mod.Module.load(prefix, 1, **kw)
    loaded.bind(data_shapes=[("data", (16, 8))],
                label_shapes=[("softmax_label", (16,))], for_training=False)
    loaded.init_params()
    got = loaded.score(_iter(dst, seed=1), "acc")
    assert got == want
    out = loaded.predict(_iter(dst, seed=1)).asnumpy()
    np.testing.assert_allclose(
        out, mod.predict(_iter(src, seed=1)).asnumpy(), **FWD)


def test_module_optimizer_state_resume(tmp_path):
    """``save_optimizer_states=True`` then ``Module.load(...,
    load_optimizer_states=True)`` restores the momenta; a JAX
    ``.states`` file loads too, and the next epoch from either equals
    the JAX Module's."""
    kw = dict(optimizer="sgd",
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    mods = {}
    for name, pkg, ctx in (("jax", jmx, jmx.cpu()), ("port", tmx, tmx.cpu())):
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        mod.fit(_iter(pkg, n=32), num_epoch=2,
                arg_params=_init(pkg, _mlp_shapes(), ctx=ctx), **kw)
        mod.save_checkpoint(str(tmp_path / name), 2,
                            save_optimizer_states=True)
        mods[name] = mod
    states0 = {k: v.numpy() for k, v in mods["port"]._updater.states.items()}
    jstates = {k: v.asnumpy() for k, v in mods["jax"]._updater.states.items()}
    # the JAX Module trains one more epoch from where it stands
    mods["jax"].fit(_iter(jmx, n=32), num_epoch=1, **kw)
    for name in ("port", "jax"):
        loaded = tmx.mod.Module.load(str(tmp_path / name), 2,
                                     load_optimizer_states=True,
                                     context=tmx.cpu())
        loaded.bind(data_shapes=[("data", (16, 8))],
                    label_shapes=[("softmax_label", (16,))])
        loaded.init_params()
        loaded.init_optimizer(**kw)
        assert set(loaded._updater.states) == set(states0)
        for k, v in loaded._updater.states.items():
            np.testing.assert_allclose(v.numpy(), states0[k], **STEPS)
            np.testing.assert_allclose(v.numpy(), jstates[k], **STEPS)
        loaded.fit(_iter(tmx, n=32), num_epoch=1, **kw)
        _assert_params(_params(loaded), _params(mods["jax"]))


def test_do_checkpoint_callback(tmp_path):
    prefix = str(tmp_path / "cb")
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(_iter(tmx, n=32), num_epoch=2,
            optimizer_params={"learning_rate": 0.1},
            epoch_end_callback=tmx.callback.do_checkpoint(prefix))
    assert sorted(os.path.basename(p)
                  for p in glob.glob(prefix + "-*.params")) == \
        ["cb-0001.params", "cb-0002.params"]
    _, arg, _ = tmx.model.load_checkpoint(prefix, 2)
    _assert_params({k: v.asnumpy() for k, v in arg.items()}, _params(mod),
                   tol=dict(rtol=0, atol=0))


def test_module_and_managed_checkpoint_callbacks(tmp_path):
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    manager = tmx.checkpoint.CheckpointManager(str(tmp_path / "managed"))
    mod.fit(_iter(tmx, n=32), num_epoch=2,
            optimizer_params={"learning_rate": 0.1},
            epoch_end_callback=[
                tmx.callback.module_checkpoint(mod, str(tmp_path / "m"),
                                               period=2,
                                               save_optimizer_states=True),
                tmx.callback.managed_checkpoint(manager)],
            batch_end_callback=[tmx.callback.log_train_metric(1),
                                tmx.callback.ProgressBar(2)],
            eval_data=_iter(tmx, n=32, seed=1),
            eval_end_callback=tmx.callback.LogValidationMetricsCallback())
    assert os.path.exists(str(tmp_path / "m") + "-0002.states")
    assert not os.path.exists(str(tmp_path / "m") + "-0001.params")
    assert manager.all_steps() == [1, 2]


def _bucket_sym_gen(pkg):
    def sym_gen(seq_len):
        s = pkg.sym
        with pkg.name.NameManager():
            data = s.var("data")
            fc = s.FullyConnected(data, num_hidden=8, name="fc_shared",
                                  flatten=False)
            pooled = s.mean(fc, axis=1)
            out = s.FullyConnected(pooled, num_hidden=2, name="out")
            return s.SoftmaxOutput(out, name="softmax"), ("data",), \
                ("softmax_label",)
    return sym_gen


def test_bucketing_module_matches_and_shares_weights():
    rng = np.random.RandomState(4)
    seqs = (10, 5, 10, 7, 5)
    batches = [(rng.randn(4, t, 6).astype(np.float32),
                rng.randint(0, 2, 4).astype(np.float32)) for t in seqs]
    results = []
    for pkg, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        mod = pkg.mod.BucketingModule(_bucket_sym_gen(pkg),
                                      default_bucket_key=10, context=ctx)
        mod.bind(data_shapes=[("data", (4, 10, 6))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params=_init(pkg, {
            "fc_shared_weight": (8, 6), "fc_shared_bias": (8,),
            "out_weight": (2, 8), "out_bias": (2,)}, ctx=ctx))
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
        outs = []
        for x, y in batches:
            batch = pkg.io.DataBatch(
                data=[pkg.nd.array(x, ctx=ctx)],
                label=[pkg.nd.array(y, ctx=ctx)],
                provide_data=[pkg.io.DataDesc("data", x.shape)],
                provide_label=[pkg.io.DataDesc("softmax_label", (4,))])
            batch.bucket_key = x.shape[1]
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
            assert outs[-1].shape == (4, 2)
        results.append((mod, outs))
    (jmod, jouts), (mod, outs) = results
    assert mod.bucket_keys == jmod.bucket_keys == [5, 7, 10]
    for a, b in zip(outs, jouts):
        np.testing.assert_allclose(a, b, **STEPS)
    w7 = mod._buckets[7]._exec.arg_dict["fc_shared_weight"]
    w10 = mod._buckets[10]._exec.arg_dict["fc_shared_weight"]
    assert w7 is w10
    np.testing.assert_allclose(
        w7.asnumpy(),
        jmod._buckets[10]._exec.arg_dict["fc_shared_weight"].asnumpy(),
        **STEPS)


def test_module_names_one_device_and_needs_cuda_by_default(monkeypatch):
    with pytest.raises(MXNetError, match="mxnet_tpu_torch.parallel"):
        tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(0), tmx.cpu(1)])
    assert tmx.mod.Module(_mlp(tmx), context=[tmx.cpu()])._context == \
        tmx.cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # outside the fixture's ``with mx.cpu()``: the default is the card
    import mxnet_tpu_torch.context as context
    monkeypatch.setattr(context.Context._default_ctx, "stack", [],
                        raising=False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.mod.Module(_mlp(tmx))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.mod.Module(_mlp(tmx), context=tmx.gpu(0)).bind(
            data_shapes=[("data", (2, 8))])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.mod.BucketingModule(_bucket_sym_gen(tmx), 10).bind(
            data_shapes=[("data", (4, 10, 6))])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        _mlp(tmx).simple_bind(data=(2, 8))


def test_fit_logs_through_the_module_logger(caplog):
    with caplog.at_level(logging.INFO):
        _fit(tmx, tmx.cpu(), 1, optimizer_params={"learning_rate": 0.1})
    assert any("Epoch[0] Train-accuracy" in r.getMessage()
               for r in caplog.records)


def test_module_mnist_example_matches_the_jax_example(tmp_path):
    """``examples/module_mnist.py``'s loop (784-128-64-10, 2 epochs of
    16 batches, SGD 0.1/0.9) in both packages from the seeded weights
    and batch order of ``chip_smoke.module_mnist_run``: the same
    parameters and validation accuracy.  The JAX package's accuracy is
    ``chip_smoke.MODULE_MNIST_JAX_ACCURACY``, the figure phase 19 holds
    the card to (less 0.02)."""
    jmod, jval = chip_smoke.module_mnist_run(jmx, jmx.cpu())
    tmod, tval = chip_smoke.module_mnist_run(tmx, tmx.cpu())
    want = jmod.score(jval, jmx.metric.Accuracy())[0][1]
    got = tmod.score(tval, tmx.metric.Accuracy())[0][1]
    assert abs(want - chip_smoke.MODULE_MNIST_JAX_ACCURACY) <= 1 / 512
    assert abs(got - want) <= 1 / 512, (got, want)
    _assert_params(_params(tmod), _params(jmod))


_DIST_WORKER = r"""
import os, sys
import numpy as np
import mxnet_tpu_torch as mx
out = sys.argv[1]
mx.distributed_init()
from mxnet_tpu_torch.distributed import world
nproc, rank = world()
with mx.cpu():
    x = np.load(os.path.join(out, "x.npy"))[rank::nproc]
    y = np.load(os.path.join(out, "y.npy"))[rank::nproc]
    it = mx.io.NDArrayIter(x, y, 8, shuffle=False)
    with mx.name.NameManager():
        data = mx.sym.var("data")
        fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act = mx.sym.Activation(fc1, act_type="relu")
        fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
        net = mx.sym.SoftmaxOutput(fc2, name="softmax")
    rng = np.random.RandomState(rank)     # each rank its own start
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={
        n: mx.nd.array((0.3 * rng.randn(*s)).astype(np.float32))
        for n, s in zip(net.list_arguments(),
                        net.infer_shape(data=(8, 8))[0])
        if n not in ("data", "softmax_label")})
    mod.fit(it, num_epoch=2, kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9})
    arg, _ = mod.get_params()
    np.savez(os.path.join(out, "rank%d.npz" % rank),
             **{k: v.asnumpy() for k, v in arg.items()})
print("OK", rank, flush=True)
"""


def test_module_fit_dist_sync_two_ranks_equals_one_jax_module(tmp_path):
    """``Module.fit(kvstore="dist_sync")`` on two CPU ranks (gloo), each
    starting from its own weights on its own half of the batches: rank
    0's weights are broadcast, every step sums both ranks' gradients,
    and the ranks end bitwise equal, within 1e-6 of one JAX Module over
    both halves at once (batch 16, ``rescale_grad`` 1/8, rank 0's
    starting weights)."""
    import socket
    import subprocess
    import sys
    import time
    rng = np.random.RandomState(7)
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    np.save(str(tmp_path / "x.npy"), x)
    np.save(str(tmp_path / "y.npy"), y)
    (tmp_path / "worker.py").write_text(_DIST_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-u", str(tmp_path / "worker.py"), str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=repo + os.pathsep
                 + os.environ.get("PYTHONPATH", ""),
                 MXNET_TPU_COORDINATOR=coord, MXNET_TPU_NUM_PROCS="2",
                 MXNET_TPU_PROC_ID=str(rank),
                 MXNET_TPU_DIST_BARRIER_TIMEOUT_MS="30000"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    deadline = time.time() + 120
    for rank, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        assert p.returncode == 0 and "OK %d" % rank in text, text[-3000:]
    ranks = [dict(np.load(str(tmp_path / ("rank%d.npz" % r))))
             for r in range(2)]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    # one JAX Module over both halves: each batch of 16 is rank 0's 8
    # rows then rank 1's, in the order the ranks take them
    order = np.concatenate([np.concatenate([np.arange(0, 32, 2)[i:i + 8],
                                            np.arange(1, 32, 2)[i:i + 8]])
                            for i in (0, 8)])
    it = jmx.io.NDArrayIter(x[order], y[order], 16, shuffle=False)
    r0 = np.random.RandomState(0)
    with jmx.name.NameManager():
        data = jmx.sym.var("data")
        fc1 = jmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        act = jmx.sym.Activation(fc1, act_type="relu")
        fc2 = jmx.sym.FullyConnected(act, num_hidden=4, name="fc2")
        net = jmx.sym.SoftmaxOutput(fc2, name="softmax")
    init = {n: jmx.nd.array((0.3 * r0.randn(*sh)).astype(np.float32),
                            ctx=jmx.cpu())
            for n, sh in zip(net.list_arguments(),
                             net.infer_shape(data=(8, 8))[0])
            if n not in ("data", "softmax_label")}
    mod = jmx.mod.Module(net, context=jmx.cpu())
    mod.fit(it, num_epoch=2, arg_params=init, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9,
                              "rescale_grad": 1.0 / 8})
    _assert_params(ranks[0], _params(mod), tol=dict(rtol=1e-6, atol=1e-6))
