"""The port's large-batch ResNet slice as a whole on the CPU: a narrow
NHWC ResNet v1 with LARS (lr 0.1, momentum 0.9, eta 0.001) through
``gluon.Trainer`` and ``TrainStep.run_steps`` (three steps over three
batches), against the JAX package's ``TrainStep.run_steps`` with its
kernel tier armed (``MXNET_TPU_KERNELS=1``: the fused BatchNorm+ReLU
sites and the bucketed LARS update with the Pallas pass in interpret
mode), weights carried across by ``params_from_numpy``.  Each JAX
reference is computed once per module.

Tolerances:

- fp32 (no AMP): losses within 1e-5 relative, every parameter and
  running statistic within 1e-4 relative / 2e-6 absolute, as the SGD
  slice test holds them (measured: losses 2.4e-7, parameters 7e-7
  absolute at worst).
- bf16 (``amp.scope("bfloat16")`` in both), set from the measured floor
  of the JAX bf16 run against the same JAX run with each batch
  permuted (the same function, summed in another order and rounded to
  bf16 in other places): losses within 1e-2 relative (floor 3.1e-3,
  measured 2.4e-3); all parameters and running statistics together
  within 3e-3 norm-wise relative (floor 8.3e-4, measured 1.2e-3); the
  three steps' updates (final minus initial) within 2e-2 norm-wise
  relative (floor 4.3e-3, measured 6.1e-3).  Convolution biases are
  left out of the norm-wise measures: each feeds a BatchNorm, whose
  batch mean cancels it, so its gradient is rounding noise."""
import contextlib

import numpy as np
import pytest

import jax
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.gluon.model_zoo.vision import BottleneckV1 as JBottleneck
from mxnet_tpu.gluon.model_zoo.vision import ResNetV1 as JResNetV1
from mxnet_tpu.parallel import TrainStep as JTrainStep

from mxnet_tpu_torch import amp, gluon
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.parallel import TrainStep

pytestmark = pytest.mark.skipif(not jkernels.available(),
                                reason="no pallas on this backend")

NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)
LARS = {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.001}
K, BATCH, SIZE = 3, 4, 32
BF16_LIMITS = {"loss_rel": 1e-2, "param_rel": 3e-3, "update_rel": 2e-2}


def _batches():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((K, BATCH, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, 10, (K, BATCH)).astype(np.float32))


def _amp_scope(amp_module, bf16):
    return amp_module.scope("bfloat16") if bf16 else contextlib.nullcontext()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_run(request):
    """The JAX package's three LARS steps from seed-0 weights:
    ``(variant, initial weights, losses, final weights)``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_TPU_KERNELS", "1")
    bf16 = request.param == "bfloat16"
    x, y = _batches()
    try:
        with jax.default_matmul_precision("highest"):
            np.random.seed(0)
            jnet = JResNetV1(JBottleneck, layout="NHWC", **NARROW)
            jnet.initialize(ctx=mx.cpu())
            with jautograd.pause():
                jnet(mx.nd.array(x[0]))
            arrays = {n: p.data().asnumpy()
                      for n, p in jnet.collect_params().items()}
            tr = jgluon.Trainer(jnet.collect_params(), "lars", LARS,
                                kvstore=None)
            step = JTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                              tr, mesh=None)
            with _amp_scope(jamp, bf16):
                losses = step.run_steps(mx.nd.array(x),
                                        mx.nd.array(y)).asnumpy()
            final = {n[len(jnet.prefix):]: p.data().asnumpy()
                     for n, p in jnet.collect_params().items()}
    finally:
        mp.undo()
    initial = {n[len(jnet.prefix):]: a for n, a in arrays.items()}
    return request.param, arrays, initial, losses, final


def _port_run(arrays, bf16):
    net = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    tr = gluon.Trainer(net.collect_params(), "lars", LARS)
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    x, y = _batches()
    with _amp_scope(amp, bf16):
        losses = step.run_steps(x, y)
    final = {p.name[len(net.prefix):]: p.data()._data.detach().numpy()
             for p in net.collect_params().values()}
    return losses, final, tr.optimizer


def _rel(a, b):
    """Norm-wise relative error of dicts ``a`` against ``b``, convolution
    biases left out."""
    keys = [k for k in b if not ("conv" in k and k.endswith("bias"))]
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    den = sum(float((b[k] ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def test_narrow_resnet_lars_run_steps_matches_the_jax_package(jax_run):
    variant, arrays, initial, jlosses, want = jax_run
    bf16 = variant == "bfloat16"
    losses, got, opt = _port_run(arrays, bf16)
    assert losses.shape == (K,) and losses.dtype == torch.float32
    assert np.isfinite(losses.numpy()).all()
    assert set(opt._index_update_count.values()) == {K}
    assert sorted(got) == sorted(want) and len(got) == 91
    for name, w in got.items():
        assert w.dtype == np.float32, name      # fp32 master weights
    if not bf16:
        np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=2e-6,
                                       err_msg=name)
        return
    np.testing.assert_allclose(losses.numpy(), jlosses,
                               rtol=BF16_LIMITS["loss_rel"])
    assert _rel(got, want) <= BF16_LIMITS["param_rel"]
    assert _rel({k: got[k] - initial[k] for k in want},
                {k: want[k] - initial[k] for k in want}) \
        <= BF16_LIMITS["update_rel"]
