"""The device feed on an NVIDIA GPU: its pinned ring, side stream and
events.  Every test here needs the card and skips without one.  The
file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_feed.py

- landed batches equal their host batches bit for bit over three epochs
  at depth 1, 2 and 4, from a plain source (copied into the ring) and
  from an ``ImageIter`` (assembled in the ring by ``next_np(out=)``),
  with every landed tensor kept until the epoch ends and the card kept
  busy between batches, so a slot refilled before its copy finished
  would show as a wrong batch;
- a feed keeps running, its producer copying, while a ``TrainStep``
  captures a new key under ``_capture.checking_syncs()`` (any
  synchronizing call then raises, in any thread); the fed steps equal
  the same steps on the same batches given directly, bitwise;
- ``close()`` in the middle of an epoch, and an abandoned feed, leave
  no producer thread behind;
- no feed lands on the host unless ``ctx=mx.cpu()`` asks: the default,
  ``DataLoader(ctx=mx.gpu(0))`` and ``ImageRecordIter(ctx=mx.gpu(0))``
  land on the card; the bf16 ``DeviceTransform`` there equals its CPU
  result bitwise (each stage rounds to bf16 on both).
"""
import gc
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture, gluon, io, recordio
from mxnet_tpu_torch.dataio import DeviceBatch, DeviceFeed, DeviceTransform
from mxnet_tpu_torch.image import ImageIter
from mxnet_tpu_torch.parallel import TrainStep

pytestmark = pytest.mark.gpu


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def _feed_threads():
    return [t for t in threading.enumerate()
            if t.name == "mxnet_tpu_torch.DeviceFeed"]


def _host_batches(n=10, shape=(16, 3, 32, 32), seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, shape, dtype=np.uint8),
             rng.randint(0, 10, shape[0]).astype(np.float32))
            for _ in range(n)]


def _busy(dev, ms=2.0):
    """Keep the card busy for about ``ms`` on the current stream."""
    a = torch.ones(512, 512, device=dev)
    t0 = time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < ms:
        a = a @ a * 1e-3


def _write_rec(tmp_path, n=40, hw=(32, 32)):
    prefix = str(tmp_path / "raw")
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     img.tobytes()))
    w.close()
    return prefix + ".rec"


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_landed_batches_equal_their_host_batches(card, tmp_path, depth):
    host = _host_batches()
    feed = DeviceFeed(host, ctx=mx.gpu(0), depth=depth)
    for epoch in range(3):
        landed = []
        for b in feed:
            assert b.data._data.is_cuda and b.label._data.is_cuda
            landed.append((b.data._data, b.label._data))
            _busy(card)
        assert len(landed) == len(host)
        for (x, y), (hx, hy) in zip(landed, host):
            assert torch.equal(x.cpu(), torch.from_numpy(hx)), epoch
            assert torch.equal(y.cpu(), torch.from_numpy(hy)), epoch
        feed.reset()
    feed.close()
    assert len(feed._ring._bufs) == depth + 1

    rec = _write_rec(tmp_path)
    it = ImageIter(8, (3, 32, 32), path_imgrec=rec, dtype="uint8",
                   shuffle=True, preprocess_threads=2)
    ref = ImageIter(8, (3, 32, 32), path_imgrec=rec, dtype="uint8",
                    shuffle=True, preprocess_threads=0)
    feed = it.device_feed(ctx=mx.gpu(0), depth=depth)
    for epoch in range(3):
        np.random.seed(epoch)
        ref.reset()
        np.random.seed(epoch)
        feed.reset()
        landed = [(b.data._data, b.label._data, _busy(card))[:2]
                  for b in feed]
        want = []
        while True:
            try:
                want.append(ref.next_np())
            except StopIteration:
                break
        assert len(landed) == len(want) == 5
        for (x, y), (hx, hy, _pad) in zip(landed, want):
            assert torch.equal(x.cpu(), torch.from_numpy(hx)), epoch
            assert torch.equal(y.cpu(), torch.from_numpy(hy)), epoch
    feed.close()
    it.close()
    ref.close()


def _dense_step(dev, seed=0):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"), nn.Dense(4))
    net.initialize(device=dev, generator=torch.Generator().manual_seed(seed))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    return net, TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)


def _slow_source(batches, pause_s=0.005):
    for b in batches:
        time.sleep(pause_s)
        yield b


def test_a_running_feed_while_a_trainstep_captures_a_new_key(card):
    rng = np.random.RandomState(1)
    first = [(rng.rand(8, 12).astype(np.float32),
              rng.randint(0, 4, 8).astype(np.float32)) for _ in range(3)]
    second = [(rng.rand(6, 12).astype(np.float32),
               rng.randint(0, 4, 6).astype(np.float32)) for _ in range(12)]
    _net, step = _dense_step(card)
    _ref_net, ref = _dense_step(card)
    with _capture.checking_syncs():
        for x, y in first:          # key (8, 12): eager, capture, replay
            step(torch.from_numpy(x).to(card), torch.from_numpy(y).to(card))
            ref(torch.from_numpy(x).to(card), torch.from_numpy(y).to(card))
        feed = DeviceFeed(_slow_source(second), ctx=mx.gpu(0), depth=2)
        losses = []
        for b in feed:              # key (6, 12) is new: captured here
            losses.append(step(b))
        want = [ref(torch.from_numpy(x).to(card),
                    torch.from_numpy(y).to(card)) for x, y in second]
    feed.close()
    assert len(losses) == len(second)
    assert step.capture_stats()["graphs"] == 2
    for got, exp in zip(losses, want):
        assert torch.equal(got, exp)
    for p, q in zip(step._trainer._params, ref._trainer._params):
        assert torch.equal(p.data()._data, q.data()._data)


def test_close_mid_epoch_and_abandonment_leave_no_thread(card, tmp_path):
    rec = _write_rec(tmp_path)
    it = ImageIter(4, (3, 32, 32), path_imgrec=rec, dtype="uint8",
                   preprocess_threads=2)
    feed = it.device_feed(ctx=mx.gpu(0), depth=2)
    next(feed)
    next(feed)
    assert _feed_threads()
    feed.close()
    assert not _feed_threads()
    feed.reset()
    next(feed)
    del feed
    gc.collect()
    t0 = time.perf_counter()
    while _feed_threads() and time.perf_counter() - t0 < 10:
        time.sleep(0.01)
    assert not _feed_threads()
    it.close()


def test_no_feed_lands_on_the_host_unless_asked(card, tmp_path):
    host = _host_batches(n=2, shape=(4, 3, 8, 8))
    for ctx in (None, mx.gpu(0), "cuda", torch.device("cuda", 0)):
        with DeviceFeed(host, ctx=ctx) as feed:
            b = next(feed)
        assert b.data._data.device.type == "cuda"
        assert b.data.context == mx.gpu(0)
    with DeviceFeed(host, ctx=mx.cpu()) as feed:
        assert next(feed).data._data.device.type == "cpu"

    ds = gluon.data.ArrayDataset(np.arange(24, dtype=np.float32)
                                 .reshape(8, 3), np.arange(8))
    for x, y in gluon.data.DataLoader(ds, batch_size=4, ctx=mx.gpu(0)):
        assert x._data.is_cuda and y._data.is_cuda
        assert y._data.dtype == torch.int32

    rec = _write_rec(tmp_path, n=8)
    tf_kw = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
                 std_r=58.393, std_g=57.12, std_b=57.375)
    feed = io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                              batch_size=4, ctx=mx.gpu(0), dtype="bfloat16",
                              preprocess_threads=0, **tf_kw)
    tf = DeviceTransform(dtype="bfloat16",
                         mean=(123.68, 116.779, 103.939),
                         std=(58.393, 57.12, 57.375))
    for b in feed:
        assert isinstance(b, DeviceBatch)
        assert b.data._data.is_cuda and b.data._data.dtype == torch.bfloat16
        assert b.raw[0].dtype == torch.uint8
        assert torch.equal(b.data._data.cpu(), tf(b.raw[0].cpu()))
    feed.close()
