"""The port's training slice as a whole on the CPU: a narrow NHWC
ResNet v1 through ``gluon.Trainer`` and ``parallel.TrainStep``, against
the JAX package's ``TrainStep`` with the kernel tier armed (Pallas in
interpret mode), weights carried across by ``params_from_numpy``; and
the step's own contract (deferred shapes, dtype drift, non-finite
gradients).

Tolerance of the slice: losses within 1e-5 relative, every parameter
and running statistic within 1e-4 relative / 2e-6 absolute after three
steps (fp32 convolutions summed in another order by two libraries,
carried through twelve BatchNorms and three momentum steps; the
measured worst is 3e-7 absolute)."""
import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.gluon.model_zoo.vision import BottleneckV1 as JBottleneck
from mxnet_tpu.gluon.model_zoo.vision import ResNetV1 as JResNetV1
from mxnet_tpu.parallel import TrainStep as JTrainStep

from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.parallel import TrainStep

NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)
SGD = {"learning_rate": 0.05, "momentum": 0.9}


def _batch(seed=0, n=4, size=32, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.float32))


def _port_net(layout="NHWC", seed=0):
    net = ResNetV1(BottleneckV1, layout=layout, **NARROW)
    net.initialize(device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    return net


def _port_step(net):
    tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
    return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)


def _values(net):
    return {p.name[len(net.prefix):]: p.data()._data.detach().numpy().copy()
            for p in net.collect_params().values()}


def test_narrow_resnet_trains_like_the_jax_package(monkeypatch):
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    x, y = _batch()
    with jax.default_matmul_precision("highest"):
        np.random.seed(0)
        jnet = JResNetV1(JBottleneck, layout="NHWC", **NARROW)
        jnet.initialize(ctx=mx.cpu())
        with jautograd.pause():
            jnet(mx.nd.array(x))
        arrays = {n: p.data().asnumpy() for n, p in
                  jnet.collect_params().items()}
        jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD,
                             kvstore=None)
        jstep = JTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                           jtr, mesh=None)
        jlosses = [float(jstep(mx.nd.array(x), mx.nd.array(y)).asscalar())
                   for _ in range(3)]
        want = {n[len(jnet.prefix):]: p.data().asnumpy()
                for n, p in jnet.collect_params().items()}

    tnet = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    tnet.initialize(device="cpu")
    params_from_numpy(tnet, arrays)
    tstep = _port_step(tnet)
    tlosses = [tstep(x, y) for _ in range(3)]
    assert all(t.dim() == 0 for t in tlosses)
    np.testing.assert_allclose([float(t) for t in tlosses], jlosses,
                               rtol=1e-5)
    assert jlosses[-1] < jlosses[0]
    got = _values(tnet)
    assert sorted(got) == sorted(want) and len(got) == 91
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=2e-6,
                                   err_msg=name)


def test_deferred_shapes_materialize_in_predict_mode():
    """The first step materializes deferred shapes with one forward
    under ``autograd.pause()``: predict mode, so the running statistics
    see exactly one update per step, as with shapes known up front."""
    x, y = _batch(1)
    deferred = _port_net(seed=3)
    assert any(p._deferred_init is not None
               for p in deferred.collect_params().values())
    step = _port_step(deferred)
    losses = [float(step(x, y)) for _ in range(2)]

    known = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    known.initialize(device="cpu")
    fresh = _port_net(seed=3)
    fresh(torch.from_numpy(x))           # materialize, then copy weights
    params_from_numpy(known, {p.name: p.data()._data.detach().numpy()
                              for p in fresh.collect_params().values()},
                      prefix=fresh.prefix)
    step2 = _port_step(known)
    assert [float(step2(x, y)) for _ in range(2)] == losses
    a, b = _values(deferred), _values(known)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_nonfinite_gradients_skip_the_update():
    net = _port_net()
    step = _port_step(net)
    x, y = _batch(2)
    step(x, y)
    before = _values(net)
    opt = step._trainer.optimizer
    count = opt.num_update
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    loss = step(bad, y)
    assert not np.isfinite(float(loss))
    assert step.last_step_finite is False
    assert opt.num_update == count + 1
    after = _values(net)
    for name, v in before.items():
        if "running" in name:
            continue                     # the forward's update stands
        np.testing.assert_array_equal(after[name], v, err_msg=name)


def test_dtype_drift_is_cast_back_before_the_step():
    net = _port_net()
    step = _port_step(net)
    x, y = _batch(3)
    step(x, y)
    w = net.collect_params()[net.prefix + "dense0_weight"]
    w._data = torch.nn.Parameter(w._data.detach().double())
    step(x, y)
    assert w.data()._data.dtype == torch.float32


def test_nchw_resnet_trains_without_fused_sites():
    """NCHW BatchNorms stay unpaired: the net trains through the plain
    BatchNorm and relu, and the loss falls."""
    net = _port_net(layout="NCHW")
    step = _port_step(net)
    x, y = _batch(4)
    x = x.transpose(0, 3, 1, 2).copy()
    before = (registry.launches("bn_relu_apply"),
              registry.launches("bn_relu_bwd"))
    losses = [float(step(x, y)) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert (registry.launches("bn_relu_apply"),
            registry.launches("bn_relu_bwd")) == before


def test_train_step_is_single_device():
    net = _port_net()
    tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
    # without a world the step is one device's; a mesh= that is not a
    # parallel.Mesh raises (the mesh step is tests/test_torch_mesh.py's)
    assert TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     tr)._mesh is None
    with pytest.raises(MXNetError, match="parallel.Mesh"):
        TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                  mesh=object())
