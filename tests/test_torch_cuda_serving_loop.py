"""The always-on loop's concurrency on an NVIDIA GPU: a servable's
buckets captured in one thread while another servable replays and
copies its logits to the host and a third thread trains, each bitwise
equal to the same work alone; two decode engines (the draining one and
its replacement) decoding at once, each stream equal to the engine's
own streams alone; and ``hbm_plan``'s prediction within 15% of the
measured peak at the largest serving bucket.  Every test here needs the
card and skips without one.  The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_serving_loop.py

These run as a server does, outside ``_capture.checking_syncs()``: the
other threads read results on the host while a graph is captured.
TF32 is off and cuDNN deterministic, so the same work gives the same
bits on any stream."""
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.ndarray import NDArray

pytestmark = pytest.mark.gpu

JOIN_S = 120


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    return torch.device("cuda")


def _narrow_resnet(seed):
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, thumbnail=True, layout="NHWC")
    net.initialize(device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    with autograd.pause():
        net(torch.zeros(1, 32, 32, 3, device="cuda"))
    return net


def _pool(net, card, buckets=(1, 4)):
    from mxnet_tpu_torch.serving.registry import ModelRegistry
    from mxnet_tpu_torch.serving.executor import BucketExecutorPool
    fn, device, snapshot, structure = ModelRegistry._from_block(
        net, (32, 32, 3), "float32")
    return BucketExecutorPool(fn, (32, 32, 3), "float32", buckets, device,
                              watch=lambda: snapshot, structure=structure)


def _join(*threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def test_capture_beside_replays_and_training_is_bitwise(card):
    """Pool B captured while pool A replays and copies its logits to the
    host and a training loop launches on the default stream: B's
    answers, A's answers and the trained weights are bitwise those of
    the same work done alone."""
    rng = np.random.default_rng(0)
    xa = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    xb = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    xt = NDArray(torch.tensor(rng.standard_normal((8, 32, 32, 3)),
                              dtype=torch.float32, device=card))
    yt = NDArray(torch.tensor(rng.integers(0, 10, 8), dtype=torch.float32,
                              device=card))

    def train(net, steps):
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(steps):
            with autograd.record():
                loss = loss_fn(net(xt), yt)
            loss.backward()
            tr.step(8)
        torch.cuda.synchronize()
        return [p.data()._data.clone() for p in net.collect_params()
                .values()]

    # alone
    pool_b = _pool(_narrow_resnet(2), card)
    pool_b.warmup()
    want_b = pool_b.call(4, xb)[0].cpu()
    del pool_b
    pool_a = _pool(_narrow_resnet(1), card)
    pool_a.warmup()
    want_a = pool_a.call(4, xa)[0].cpu()
    want_w = train(_narrow_resnet(3), 3)

    # together
    stop, errors, replays = threading.Event(), [], [0]

    def replayer():
        try:
            while not stop.is_set():
                got = pool_a.call(4, xa)[0].cpu()
                assert torch.equal(got, want_a), "pool A moved"
                replays[0] += 1
        except BaseException as e:      # noqa: BLE001 -- asserted below
            errors.append(e)

    trained = []

    def trainer():
        try:
            trained.extend(train(_narrow_resnet(3), 3))
        except BaseException as e:      # noqa: BLE001 -- asserted below
            errors.append(e)

    threads = [threading.Thread(target=replayer),
               threading.Thread(target=trainer)]
    for t in threads:
        t.start()
    try:
        pool_b = _pool(_narrow_resnet(2), card)
        pool_b.warmup()
        got_b = pool_b.call(4, xb)[0].cpu()
    finally:
        threads[1].join(JOIN_S)
        stop.set()
        _join(*threads)
    assert not errors, errors[:3]
    assert replays[0] > 0
    assert torch.equal(got_b, want_b)
    assert len(trained) == len(want_w)
    assert all(torch.equal(a, b) for a, b in zip(trained, want_w))


def test_two_decode_engines_at_once(card):
    """The old and the new engine of a generative swap decode together,
    each on its own capture stream and paged-attention scratch: every
    stream equals the same engine's stream alone."""
    from mxnet_tpu_torch.serving.decode import DecodeEngine, tiny_gpt
    model = tiny_gpt(vocab_size=97, units=64, num_layers=2, num_heads=4,
                     max_seq=64)
    kw = dict(prefill_buckets=(8, 16), decode_buckets=(1, 2, 4),
              block_size=4, num_blocks=128, device=card)
    engines = []
    for seed in (0, 1):
        eng = DecodeEngine(model, model.init_params(seed=seed,
                                                    device=card), **kw)
        eng.warmup()
        eng.start()
        engines.append(eng)
    assert engines[0]._owner.stream != engines[1]._owner.stream
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, n).tolist() for n in (3, 9, 5, 12)]
    try:
        alone = [[e.submit(p, 16).tokens() for p in prompts]
                 for e in engines]
        together = [[None] * len(prompts) for _ in engines]
        errors = []

        def client(i, j):
            try:
                together[i][j] = engines[i].submit(prompts[j],
                                                   16).tokens()
            except BaseException as e:  # noqa: BLE001 -- asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i, j))
                   for i in range(2) for j in range(len(prompts))]
        for t in threads:
            t.start()
        _join(*threads)
    finally:
        for e in engines:
            e.close()
    assert not errors, errors[:3]
    assert together == alone
    assert alone[0] != alone[1]
    assert all(e.live_sequences() == 0 for e in engines)


def test_hbm_plan_predicts_the_largest_bucket(card):
    """ResNet-50 v1 NHWC at 224 x 224 registered at buckets 1-32: the
    plan's line through buckets 1 and 2 predicts bucket 32's measured
    warm-up peak within 15%."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.serving import ModelRegistry
    net = resnet50_v1(layout="NHWC")
    net.initialize(device=card, generator=torch.Generator().manual_seed(0))
    reg = ModelRegistry()
    try:
        sv = reg.register("r", block=net, input_shape=(224, 224, 3),
                          buckets=(1, 2, 4, 8, 16, 32))
        plan = sv._pool.hbm_plan(torch.cuda.mem_get_info()[1])
        peak = sv._pool.warmup_peaks()[32]
        pred = plan["buckets"][-1]["predicted_peak_hbm_bytes"]
        assert abs(pred - peak) <= 0.15 * peak, (
            pred, peak, sv._pool.warmup_peaks(), plan)
        assert plan["largest_fit_bucket"] == 32
        assert reg._validate_hbm("r", sv._pool) is not None
    finally:
        reg.shutdown()
