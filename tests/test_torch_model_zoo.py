"""The vision model zoo of the layer slice against the JAX package's on
the CPU:

- each zoo family's eval forward, weights carried across by
  ``params_from_numpy``, at a small input with 10 classes (VGG and
  MobileNet at their narrowest depth or multiplier, DenseNet narrow),
  in NHWC and, where cheap, NCHW;
- every ``get_model`` name at full width held by its parameter names
  and shapes (relative to the net's prefix) in both packages;
- the BatchNorm+ReLU fusion sites of every zoo net in NHWC against the
  JAX plan, and against ``chip_smoke.ZOO_FUSED_SITES``, the counts the
  card's zoo sweep holds its launches to;
- a narrow NHWC ``DenseNet(16, 8, [2, 2])`` at 32 x 32: three
  ``TrainStep``s and three steps of the imperative loop with
  ``Trainer(kvstore="device")``, ``allreduce_grads`` and ``update``,
  against three JAX ``TrainStep``s with the kernel tier armed (Pallas
  in interpret mode).

Tolerances: eval logits 1e-4 relative / 1e-5 absolute (fp32 convolutions
summed in another order through up to 120 layers); the training runs'
losses 1e-5 relative and every parameter and running statistic 1e-4
relative / 2e-6 absolute after three steps (the narrow ResNet's rule,
``tests/test_torch_train_step.py``)."""
import os

import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.nn.basic_layers import \
    _bn_relu_fusion_plan as _jax_plan
from mxnet_tpu.parallel import TrainStep as JTrainStep

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.nn.basic_layers import _bn_relu_fusion_plan
from mxnet_tpu_torch.parallel import TrainStep

import chip_smoke

SGD = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _cpu_and_exact():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _names(net):
    """``{name relative to the net's prefix: declared shape}``; a name
    outside the prefix (MobileNetV2's ``pred_``) whole."""
    out = {}
    for name, p in net.collect_params().items():
        rel = name[len(net.prefix):] if name.startswith(net.prefix) \
            else name
        out[rel] = tuple(p.shape) if p.shape is not None else None
    return out


ALL_NAMES = sorted(vision._MODELS)


def test_get_model_names_unknown_names_as_the_jax_package_does():
    """``get_model`` is case-insensitive and raises ``MXNetError`` for a
    name not in the zoo; every name of its table builds in both packages
    (``test_full_width_parameter_names_and_shapes_match``)."""
    with pytest.raises(MXNetError, match="not in zoo"):
        vision.get_model("resnet9000")
    with pytest.raises(jmx.base.MXNetError, match="not in zoo"):
        jvision.get_model("resnet9000")
    net = vision.get_model("DenseNet121", layout="NHWC", classes=7)
    assert net.output._units == 7


@pytest.mark.parametrize("name", ALL_NAMES)
def test_full_width_parameter_names_and_shapes_match(name):
    layout = "NHWC" if name != "alexnet" else "NCHW"
    assert _names(vision.get_model(name, layout=layout)) == \
        _names(jvision.get_model(name, layout=layout))


def _sites(block, plan, hs, ndim=4):
    """Fused BatchNorm+ReLU sites of ``block``'s forward: the pairs the
    plan makes in every ``HybridSequential`` under it."""
    n = 0
    if isinstance(block, hs):
        kids = list(block._children.values())
        pairs = plan(kids, ndim) if plan is _bn_relu_fusion_plan \
            else plan(kids)
        n += sum(1 for _, fused in pairs if fused)
    return n + sum(_sites(c, plan, hs, ndim)
                   for c in block._children.values())


def test_fusion_sites_match_the_jax_plan_and_the_smoke_constant(
        monkeypatch):
    """With ``layout="NHWC"`` each net has as many fused sites in the
    port as the JAX plan pairs (walked directly, the tier armed), and
    ``chip_smoke.ZOO_FUSED_SITES`` holds those counts for every
    ``get_model`` name."""
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    from mxnet_tpu.gluon.nn import HybridSequential as JHS
    from mxnet_tpu_torch.gluon.nn import HybridSequential as THS
    got = {}
    for name in ALL_NAMES:
        j = _sites(jvision.get_model(name, layout="NHWC"), _jax_plan, JHS)
        t = _sites(vision.get_model(name, layout="NHWC"),
                   _bn_relu_fusion_plan, THS)
        assert t == j, name
        got[name] = t
    assert got == chip_smoke.ZOO_FUSED_SITES
    assert got["densenet121"] == chip_smoke.DENSENET_SITES == 121
    assert (got["inceptionv3"], got["mobilenet1.0"], got["vgg16_bn"]) \
        == (94, 27, 13)
    assert got["mobilenetv2_1.0"] == got["squeezenet1.0"] \
        == got["alexnet"] == 0


def _narrow_densenet(pkg_vision, layout):
    return pkg_vision.densenet.DenseNet(16, 8, [2, 2], classes=10,
                                        layout=layout)


EVAL_CASES = [
    # name, constructor, image side, layouts
    ("alexnet", None, 64, ("NHWC", "NCHW")),
    ("vgg11", None, 32, ("NHWC", "NCHW")),
    ("vgg11_bn", None, 32, ("NHWC", "NCHW")),
    ("squeezenet1.0", None, 64, ("NHWC",)),
    ("squeezenet1.1", None, 64, ("NCHW",)),
    ("mobilenet0.25", None, 32, ("NHWC",)),
    ("mobilenetv2_0.25", None, 32, ("NHWC",)),
    ("densenet_narrow", _narrow_densenet, 32, ("NHWC", "NCHW")),
]
EVAL_PARAMS = [(n, m, s, lay) for n, m, s, lays in EVAL_CASES
               for lay in lays]


@pytest.mark.parametrize("name,make,side,layout", EVAL_PARAMS,
                         ids=["%s-%s" % (c[0], c[3]) for c in EVAL_PARAMS])
def test_eval_forward_with_weights_carried_across(name, make, side,
                                                  layout):
    """Each zoo family's eval forward, hybridized in the port (its
    running statistics random, so BatchNorm is not the identity).  The
    full-width DenseNet-121 and Inception V3 take 25-45 s each through
    the JAX package on the CPU: they are held by their names and shapes
    above, DenseNet's forward by a narrow one of its class."""
    def build(pkg_vision):
        if make is not None:
            return make(pkg_vision, layout)
        return pkg_vision.get_model(name, layout=layout, classes=10)
    rng = np.random.default_rng(0)
    shape = (2, side, side, 3) if layout == "NHWC" else (2, 3, side, side)
    x = rng.standard_normal(shape).astype(np.float32)
    np.random.seed(0)
    jnet = build(jvision)
    jnet.initialize(ctx=jmx.cpu())
    with jautograd.pause():             # sizes the deferred parameters
        jnet(jmx.nd.array(x, ctx=jmx.cpu()))
    # random running statistics, so eval BatchNorm is not the identity
    arrays = {}
    for n, p in sorted(jnet.collect_params().items()):
        a = p.data().asnumpy()
        if n.endswith("running_mean"):
            a = rng.standard_normal(a.shape).astype(np.float32) * 0.1
        elif n.endswith("running_var"):
            a = rng.random(a.shape).astype(np.float32) + 0.5
        arrays[n] = a
        p.set_data(jmx.nd.array(a, ctx=jmx.cpu()))
    with jautograd.pause():
        want = jnet(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy()
    tnet = build(vision)
    tnet.initialize(device="cpu")
    params_from_numpy(tnet, arrays, prefix=jnet.prefix)
    tnet.hybridize()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


NARROW = dict(num_init_features=16, growth_rate=8, block_config=[2, 2],
              classes=10, layout="NHWC")
BATCH = 4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, BATCH).astype(np.float32))


def _values(net):
    return {p.name[len(net.prefix):]: p.data()._data.detach().numpy().copy()
            for p in net.collect_params().values()}


@pytest.fixture(scope="module")
def jax_densenet_run():
    """Three JAX ``TrainStep``s of the narrow DenseNet, the kernel tier
    armed: its initial arrays, losses and final values."""
    if not jkernels.available():
        pytest.skip("no pallas on this backend")
    old = os.environ.get("MXNET_TPU_KERNELS")
    os.environ["MXNET_TPU_KERNELS"] = "1"
    try:
        x, y = _batch()
        with jax.default_matmul_precision("highest"):
            np.random.seed(0)
            jnet = jvision.densenet.DenseNet(**NARROW)
            jnet.initialize(ctx=jmx.cpu())
            with jautograd.pause():
                jnet(jmx.nd.array(x))
            arrays = {n: p.data().asnumpy() for n, p in
                      jnet.collect_params().items()}
            jtr = jgluon.Trainer(jnet.collect_params(), "sgd", SGD,
                                 kvstore=None)
            jstep = JTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                               jtr, mesh=None)
            losses = [float(jstep(jmx.nd.array(x), jmx.nd.array(y))
                            .asscalar()) for _ in range(3)]
            want = {n[len(jnet.prefix):]: p.data().asnumpy()
                    for n, p in jnet.collect_params().items()}
    finally:
        if old is None:
            os.environ.pop("MXNET_TPU_KERNELS", None)
        else:
            os.environ["MXNET_TPU_KERNELS"] = old
    return arrays, losses, want


def _port_densenet(arrays):
    net = vision.DenseNet(**NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    return net


def _hold(net, losses, jlosses, want):
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert jlosses[-1] < jlosses[0]
    got = _values(net)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=2e-6,
                                   err_msg=name)


def test_narrow_densenet_train_step_against_the_jax_package(
        jax_densenet_run):
    arrays, jlosses, want = jax_densenet_run
    net = _port_densenet(arrays)
    assert _sites(net, _bn_relu_fusion_plan,
                  tmx.gluon.nn.HybridSequential) == 11
    tr = gluon.Trainer(net.collect_params(), "sgd", SGD)
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    x, y = _batch()
    losses = [float(step(x, y)) for _ in range(3)]
    _hold(net, losses, jlosses, want)


def test_narrow_densenet_imperative_loop_against_the_jax_package(
        jax_densenet_run):
    """The loop users write: the hybridized net under ``record()``,
    ``loss.backward()``, then ``Trainer(kvstore="device")`` with
    ``allreduce_grads()`` and ``update(batch)``."""
    arrays, jlosses, want = jax_densenet_run
    net = _port_densenet(arrays)
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd", SGD, kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = (tmx.nd.array(a) for a in _batch())
    losses = []
    for _ in range(3):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.allreduce_grads()
        tr.update(BATCH)
        losses.append(float(loss.mean().asscalar()))
    _hold(net, losses, jlosses, want)


def test_chip_smoke_densenet_site_shapes_are_the_nets(monkeypatch):
    """``chip_smoke.densenet_site_shapes`` -- the shapes the card's kernel
    checks run -- are the ``(rows, C)`` a DenseNet-121 NHWC forward at
    224 x 224 hands the fused apply, site by site."""
    from mxnet_tpu_torch.ops import fused_bn_relu as fbr
    seen = []
    real = fbr.dispatch

    def spy(name, *args, **kwargs):
        if name == "bn_relu_apply":
            seen.append(tuple(args[0].shape))
        return real(name, *args, **kwargs)
    monkeypatch.setattr(fbr, "dispatch", spy)
    net = vision.densenet121(layout="NHWC")
    net.initialize(device="cpu")
    with torch.no_grad():
        net(torch.zeros(1, 224, 224, 3))
    want = [(int(np.prod(s[:3])), s[3])
            for s in chip_smoke.densenet_site_shapes(1)]
    assert seen == want and len(seen) == 121
    assert len(set(chip_smoke.densenet_site_shapes(64))) == 65
