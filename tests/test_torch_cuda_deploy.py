"""The deployment path on an NVIDIA GPU: an exported channels-last
ResNet run back through ``SymbolBlock`` (its fused nodes launch
``bn_relu_apply`` once each, a replay equals the eager call),
``mx.Predictor``'s graph LRU (an evicted shape class's graph owner is
freed) and ``ModelRegistry.register(symbol=)`` counting one launch per
fused node per executor call.  Every test here needs the card and
skips without one.  The file imports neither JAX nor the JAX package,
so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_deploy.py

The nets are narrow (a one-block-a-stage ResNet v1, 9 fused sites);
TF32 is off and every capture and replay runs under
``_capture.checking_syncs()``.  A replay against its eager call on the
card is held bitwise (the same kernels on the same inputs); a served
answer against the ``SymbolBlock``'s batch-1 forward to 1e-4 relative to
the largest logit (cuDNN may choose another algorithm at each batch).
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture, gluon, telemetry
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (BottleneckV1,
                                                           ResNetV1)
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.serving import ModelRegistry

import chip_smoke

pytestmark = pytest.mark.gpu

SITES = 9       # fused BatchNorm+ReLU sites of the narrow NHWC ResNet


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    with _capture.checking_syncs():
        yield torch.device("cuda")


def narrow():
    return ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                    classes=10, layout="NHWC")


@pytest.fixture
def exported(card, tmp_path):
    net = chip_smoke.deploy_net(narrow, 32, True, "cuda")
    net.hybridize()
    x = torch.randn((4, 32, 32, 3), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    with torch.no_grad():
        live = net(x)
    sym_file, params_file = net.export(str(tmp_path / "narrow"))
    ops, unfused = chip_smoke._graph_ops(sym_file)
    assert ops["fused_batch_norm_relu"] == SITES and not unfused
    return net, x, live, sym_file, params_file


def test_symbol_block_launches_the_kernel_per_fused_node(exported):
    _net, x, live, sym_file, params_file = exported
    sb = gluon.SymbolBlock.imports(sym_file, ["data"], params_file)
    assert all(p.data().context.device_type == "gpu"
               for p in sb.collect_params().values())
    with torch.no_grad():
        registry.reset_launches()
        eager = sb(x)
        assert registry.launches("bn_relu_apply") == SITES
        sb.hybridize()
        for _ in range(2):              # eager warm-up, capture
            sb(x)
        registry.reset_launches()
        replays = [sb(x) for _ in range(3)]
    assert registry.launches("bn_relu_apply") == 3 * SITES
    assert sb.cache_stats()["graphs"]["cuda:0"]["graphs"] == 1
    for r in replays:
        assert torch.equal(r, eager)
    assert chip_smoke._max_rel(eager, live) <= chip_smoke.DEPLOY_SAME_TOL


def test_predictor_lru_frees_the_evicted_class(exported):
    _net, x, live, sym_file, params_file = exported
    was_on = telemetry.enabled()
    telemetry.enable()
    telemetry.reset("serving.")
    try:
        pred = mx.Predictor(sym_file, params_file, jit_cache_size=2)
        for b in (1, 2):
            for _ in range(2):
                pred.forward(data=x[:b])
        first = weakref.ref(pred._jit_cache[next(iter(pred._jit_cache))])
        assert first().graphs == 1
        for _ in range(2):
            got = pred.forward(data=x)[0]
        gc.collect()
        assert first() is None           # its graph and pool went with it
        assert telemetry.counter("serving.compile_evictions").value == 1
        assert [o.graphs for o in pred._jit_cache.values()] == [1, 1]
        assert chip_smoke._max_rel(got, live) <= chip_smoke.DEPLOY_SAME_TOL
    finally:
        telemetry.reset("serving.")
        if not was_on:
            telemetry.disable()


def test_symbol_servable_counts_a_launch_per_site_per_call(exported):
    _net, x, _live, sym_file, params_file = exported
    sb = gluon.SymbolBlock.imports(sym_file, ["data"], params_file)
    reg = ModelRegistry()
    try:
        sv = reg.register("narrow", symbol=sym_file, params=params_file,
                          input_shape=(32, 32, 3), buckets=(1, 2, 4))
        assert sv.source == "symbol"
        images = x.cpu().numpy()
        registry.reset_launches()
        futs = [sv.submit(img) for img in images]
        got = [f.result(timeout=60) for f in futs]
        batches = sv.stats()["batches"]
        assert registry.launches("bn_relu_apply") == SITES * batches
    finally:
        reg.shutdown(drain=True)
    with torch.no_grad():
        for img, g in zip(images, got):
            want = sb(torch.from_numpy(img[None]).cuda())[0]
            assert chip_smoke._max_rel(g, want) <= chip_smoke.SERVE_REL_TOL
    assert np.isfinite(np.stack(got)).all()
