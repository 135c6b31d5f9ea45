"""The port's device feed (``mx.dataio``) on the CPU, against the JAX
package's where both run: ``ctx=mx.cpu()`` everywhere, since landing on
the host must be asked for (the card's ring, stream and event are held
in ``tests/test_torch_cuda_feed.py``).

These mirror ``tests/test_dataio.py``'s tests that need no mesh: order,
``DeviceBatch``, producer errors, ``close``/``reset``/abandonment,
compact staging, overlap, ``DataLoader(ctx=)``, ``ImageRecordIter(ctx=)``,
``ImageIter.device_feed`` and ``TrainStep`` on a fed batch.  Tolerances:
``DeviceTransform`` against the JAX transform on the same uint8 batch
within 1 ulp in float32 and 1 bf16 ulp in bfloat16 (XLA may keep float32
between the fused stages where torch rounds each to bf16; with a scale
and a mean it contracts them into one FMA, so that case is held to one
ulp of the product, the rounding torch adds); its random
crop and mirror, whose draws cannot match ``jax.random``, by their
properties.  Last, the slice as a whole: a 64-image raw ``.rec`` through
``ImageRecordIter(ctx=mx.cpu(), dtype="bfloat16")``, the NHWC transpose
and two ``TrainStep(batch)`` calls of a narrow NHWC ResNet under bf16 AMP
with LARS, against the JAX package's same path with its kernel tier
armed, at ``tests/test_torch_resnet_amp_lars.py``'s bf16 tolerances."""
import gc
import time

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import io as jio
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.dataio import DeviceBatch as JDeviceBatch
from mxnet_tpu.dataio import DeviceFeed as JDeviceFeed
from mxnet_tpu.dataio import DeviceTransform as JDeviceTransform
from mxnet_tpu.gluon.model_zoo.vision import BottleneckV1 as JBottleneck
from mxnet_tpu.gluon.model_zoo.vision import ResNetV1 as JResNetV1
from mxnet_tpu.parallel import TrainStep as JTrainStep

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, gluon, io, recordio
from mxnet_tpu_torch.dataio import DeviceBatch, DeviceFeed, DeviceTransform
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.parallel import TrainStep

@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _src(n, shape=(4, 3), dtype=np.float32, decode_s=0.0, fail_at=None):
    for i in range(n):
        if decode_s:
            time.sleep(decode_s)
        if fail_at is not None and i == fail_at:
            raise ValueError("decode blew up at %d" % i)
        yield (np.full(shape, i, dtype), np.full((shape[0],), i,
                                                 np.float32))


def _bf16_ulps(a, b):
    """Largest distance in bf16 ulps between two bf16-valued arrays."""
    def ordered(x):
        bits = (np.ascontiguousarray(x, np.float32).view(np.uint32)
                >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


# -- core semantics ----------------------------------------------------

def test_ordering_under_prefetch_depth():
    feed = DeviceFeed(_src(10), ctx=mx.cpu(), depth=4)
    seen = [float(b.data.asnumpy()[0, 0]) for b in feed]
    assert seen == [float(i) for i in range(10)]


def test_yields_device_batches():
    feed = DeviceFeed(_src(2), ctx=mx.cpu())
    b = next(feed)
    assert isinstance(b, DeviceBatch)
    assert isinstance(b.data, mx.nd.NDArray)
    assert b.label.shape == (4,) and b.data.context == mx.cpu()
    x, y = b
    assert x is b.data and y is b.label
    assert b[0] is b.data and len(b) == 2
    assert "DeviceBatch((4, 3)" in repr(b)
    feed.close()


def test_producer_exception_reraises_at_next():
    feed = DeviceFeed(_src(10, fail_at=2), ctx=mx.cpu())
    next(feed)
    next(feed)
    with pytest.raises(ValueError, match="decode blew up"):
        next(feed)
    with pytest.raises(ValueError):
        next(feed)
    assert feed._thread is None


def test_clean_close_mid_epoch():
    feed = DeviceFeed(_src(100), ctx=mx.cpu(), depth=2)
    next(feed)
    th = feed._thread
    feed.close()
    assert not th.is_alive()
    feed.close()


def test_no_leaked_thread_between_epochs():
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    feed = DeviceFeed(io.NDArrayIter(x, x[:, 0], batch_size=4), ctx=mx.cpu())
    assert len(list(feed)) == 3
    assert feed._thread is None
    feed.reset()
    assert len(list(feed)) == 3
    assert feed._thread is None


def test_uint8_stage_plus_device_cast_matches_host_cast():
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (6, 3, 5, 5), np.uint8)
    mean, std = (10.0, 20.0, 30.0), (2.0, 3.0, 4.0)
    feed = DeviceFeed(iter([(raw,)]), ctx=mx.cpu(),
                      transform=DeviceTransform(dtype="float32", mean=mean,
                                                std=std))
    b = next(feed)
    assert b.raw[0].dtype == torch.uint8
    host = (raw.astype(np.float32)
            - np.asarray(mean, np.float32).reshape(1, 3, 1, 1)) \
        / np.asarray(std, np.float32).reshape(1, 3, 1, 1)
    np.testing.assert_allclose(b.data.asnumpy(), host, rtol=1e-6)
    feed.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stages", ["normalize", "scale_mean", "cast_only"])
def test_device_transform_matches_the_jax_transform(dtype, stages):
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, (5, 3, 7, 6), np.uint8)
    kw = {"normalize": dict(mean=(123.68, 116.779, 103.939),
                            std=(58.393, 57.12, 57.375)),
          "scale_mean": dict(scale=1 / 255.0, mean=0.5),
          "cast_only": dict()}[stages]
    feed = DeviceFeed(iter([(raw,)]), ctx=mx.cpu(),
                      transform=DeviceTransform(dtype=dtype, **kw))
    jfeed = JDeviceFeed(iter([(raw,)]), ctx=jmx.cpu(),
                        transform=JDeviceTransform(dtype=dtype, **kw))
    got = next(feed).data._data
    want = np.asarray(next(jfeed).data._data.astype(np.float32))
    feed.close()
    jfeed.close()
    assert got.dtype == getattr(torch, dtype) and got.shape == raw.shape
    got = got.float().numpy()
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want) <= 1
    elif stages == "scale_mean":
        # XLA contracts x * scale - mean into one FMA where torch rounds
        # the product first: they differ by that one rounding, one ulp
        # of the product (at most 1.0 here), not of the difference
        assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_compact_off_precasts_host_side(monkeypatch):
    raw = np.arange(12, dtype=np.uint8).reshape(1, 12)
    feed = DeviceFeed(iter([(raw,)]), ctx=mx.cpu(),
                      transform=DeviceTransform(dtype="float32"),
                      compact=False)
    b = next(feed)
    assert b.raw[0].dtype == torch.float32
    np.testing.assert_allclose(b.data.asnumpy(), raw.astype(np.float32))
    feed.close()
    monkeypatch.setenv("MXNET_TPU_FEED_COMPACT", "0")
    monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", "5")
    feed = DeviceFeed(iter([(raw,)]), ctx=mx.cpu(),
                      transform=DeviceTransform(dtype="bfloat16"))
    assert feed._depth == 5 and feed._queue.maxsize == 5
    assert next(feed).raw[0].dtype == torch.bfloat16
    feed.close()


def test_overlap_positive_on_threaded_path():
    feed = DeviceFeed(_src(6, decode_s=0.01), ctx=mx.cpu(), depth=2)
    for _ in feed:
        time.sleep(0.03)
    s = feed.stats()
    assert s["batches"] == 6 and s["bytes_staged"] == 6 * (48 + 16)
    assert s["consumer_wait"] < s["producer_busy"]
    assert feed.overlap_frac() > 0


def test_random_transform_stages_by_their_properties():
    """Every output is a crop of its input, mirrored or not; one crop
    offset a batch; the mirror is drawn per image, about half of them."""
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, (64, 3, 10, 10), np.uint8)
    tf = DeviceTransform(dtype="float32", rand_mirror=True, crop=(8, 8))
    gen = torch.Generator().manual_seed(0)
    flips, offsets = 0, set()
    for _ in range(8):
        out = tf(torch.from_numpy(raw), gen).numpy()
        assert out.shape == (64, 3, 8, 8) and out.dtype == np.float32
        for i in range(64):
            hits = [(y0, x0, m) for y0 in range(3) for x0 in range(3)
                    for m in (False, True)
                    if np.array_equal(out[i], (lambda w: w[..., ::-1] if m
                                               else w)(raw[i, :, y0:y0 + 8,
                                                           x0:x0 + 8]))]
            assert hits, i
            flips += hits[0][2]
            offsets.add(hits[0][:2])
    assert 0.4 < flips / (8 * 64) < 0.6
    assert len(offsets) > 1
    same = tf(torch.from_numpy(raw), torch.Generator().manual_seed(3))
    again = tf(torch.from_numpy(raw), torch.Generator().manual_seed(3))
    assert torch.equal(same, again)


def test_already_resident_batch_not_retransferred():
    x = mx.nd.ones((2, 2), ctx=mx.cpu())
    feed = DeviceFeed(iter([(x,)]), ctx=mx.cpu())
    b = next(feed)
    assert b.raw[0] is x._data
    assert feed.stats()["bytes_staged"] == 0
    feed.close()


def test_without_cuda_a_feed_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("holds the behaviour without CUDA")
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        DeviceFeed(_src(2))
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        DeviceFeed(_src(2), ctx=mx.gpu(0))
    ds = gluon.data.ArrayDataset(np.zeros((4, 2), np.float32))
    with pytest.raises(mx.MXNetError):
        next(iter(gluon.data.DataLoader(ds, batch_size=2, ctx=mx.gpu())))
    DeviceFeed(_src(2), ctx="cpu").close()


def test_mesh_and_sharding_raise_naming_item_9():
    """A mesh= or sharding= that is not the port's Mesh or
    NamedSharding raises, naming what each takes (the mesh route itself
    runs in tests/test_torch_mesh.py's world)."""
    for kw in ({"mesh": object()}, {"sharding": object()}):
        with pytest.raises(mx.MXNetError, match="parallel.Mesh"):
            DeviceFeed(_src(2), ctx=mx.cpu(), **kw)
        with pytest.raises(mx.MXNetError, match="parallel.Mesh"):
            gluon.data.DataLoader(gluon.data.ArrayDataset(np.zeros(4)),
                                  batch_size=2, **kw)
        with pytest.raises(mx.MXNetError, match="parallel.Mesh"):
            io.ImageRecordIter(path_imgrec="unused.rec",
                               data_shape=(3, 8, 8), **kw)


# -- integration paths -------------------------------------------------

def test_dataloader_ctx_path_matches_host_path():
    X = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    ds = gluon.data.ArrayDataset(X, y)
    host = [(x.asnumpy(), lab.asnumpy())
            for x, lab in gluon.data.DataLoader(ds, batch_size=4)]
    loader = gluon.data.DataLoader(ds, batch_size=4, ctx=mx.cpu(),
                                   feed_depth=3)
    fed = [(x.asnumpy(), lab.asnumpy()) for x, lab in loader]
    assert isinstance(next(iter(loader)), DeviceBatch)
    assert len(host) == len(fed) == 3
    for (hx, hl), (fx, fl) in zip(host, fed):
        np.testing.assert_array_equal(hx, fx)
        np.testing.assert_array_equal(hl, fl)
    assert loader._feed._depth == 3 and loader._feed.stats()["batches"] >= 1


def test_dataloader_ctx_path_workers_reiter_and_transform():
    ds = gluon.data.ArrayDataset(np.arange(16, dtype=np.uint8))
    tf = DeviceTransform(dtype="float32", scale=0.5)
    loader = gluon.data.DataLoader(ds, batch_size=4, num_workers=2,
                                   ctx=mx.cpu(), device_transform=tf)
    for _ in range(2):
        out = np.concatenate([b.asnumpy() for b in loader])
        np.testing.assert_array_equal(out, np.arange(16) * 0.5)
    jloader = jgluon.data.DataLoader(
        jgluon.data.ArrayDataset(np.arange(16, dtype=np.uint8)),
        batch_size=4, ctx=jmx.cpu(),
        device_transform=JDeviceTransform(dtype="float32", scale=0.5))
    np.testing.assert_array_equal(
        out, np.concatenate([b.asnumpy() for b in jloader]))


def _make_rec(tmp_path, n=8, hw=(28, 30), fmt="jpg", classes=3):
    prefix = str(tmp_path / "ds")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, hw + (3,), dtype=np.uint8)
        header = recordio.IRHeader(0, float(i % classes), i, 0)
        if fmt == "raw":
            rec.write_idx(i, recordio.pack(header, img.tobytes()))
        else:
            rec.write_idx(i, recordio.pack_img(header, img))
    rec.close()
    return prefix


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_image_record_iter_ctx_path(tmp_path, dtype):
    prefix = _make_rec(tmp_path)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 24, 24),
              batch_size=4, mean_r=128, mean_g=128, mean_b=128,
              std_r=2, std_g=2, std_b=2, preprocess_threads=0,
              shuffle=True, rand_mirror=True)
    np.random.seed(7)
    host = [b.data[0].asnumpy() for b in io.ImageRecordIter(**kw)]
    np.random.seed(7)
    feed = io.ImageRecordIter(ctx=mx.cpu(), dtype=dtype, **kw)
    assert isinstance(feed, DeviceFeed)
    fed = []
    for b in feed:
        assert b.raw[0].dtype == torch.uint8
        assert b.data._data.dtype == getattr(torch, dtype)
        fed.append(b.data._data.float().numpy())
    np.random.seed(7)
    jfed = [np.asarray(b.data._data.astype(np.float32))
            for b in jio.ImageRecordIter(ctx=jmx.cpu(), dtype=dtype, **kw)]
    assert len(fed) == len(host) == len(jfed) == 2
    for h, f, j in zip(host, fed, jfed):
        if dtype == "float32":
            np.testing.assert_allclose(h, f, rtol=1e-5)
            np.testing.assert_array_max_ulp(f, j, maxulp=1)
        else:
            assert _bf16_ulps(f, j) <= 1


def test_image_iter_device_feed_method(tmp_path):
    from mxnet_tpu_torch.image import ImageIter
    prefix = _make_rec(tmp_path)
    it = ImageIter(4, (3, 24, 24), path_imgrec=prefix + ".rec",
                   preprocess_threads=0, dtype="uint8")
    with it:
        feed = it.device_feed(ctx=mx.cpu(),
                              transform=DeviceTransform(dtype="float32"))
        batches = list(feed)
        assert len(batches) == 2
        assert batches[0].data.dtype == np.float32
        assert batches[0].label.shape == (4,)
        again = feed.apply_transform(batches[1].raw[0])
        assert torch.equal(again, batches[1].data._data)


def test_trainstep_accepts_fed_batch():
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    step = TrainStep(net, gluon.loss.L2Loss(), trainer)
    src = iter([(np.ones((4, 3), np.float32), np.ones((4, 2), np.float32))
                for _ in range(2)])
    losses = [float(step(b)) for b in DeviceFeed(src, ctx=mx.cpu())]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
    with pytest.raises(mx.MXNetError, match="DeviceBatch"):
        step(mx.nd.ones((4, 3)))
    with pytest.raises(mx.MXNetError, match="DeviceBatch"):
        step(DeviceBatch([torch.ones(4, 3)]))


def test_host_batchify_keeps_numpy_compact():
    from mxnet_tpu_torch.gluon.data.dataloader import host_batchify_fn
    out = host_batchify_fn([np.full((2,), i, np.uint8) for i in range(4)])
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8
    pair = host_batchify_fn([(np.ones(2, np.uint8), 1.0),
                             (np.zeros(2, np.uint8), 2.0)])
    assert pair[0].dtype == np.uint8 and pair[1].dtype == np.float32


# -- abandoned consumers cannot strand a producer ----------------------

def test_abandoned_feed_releases_producer_thread():
    src = [np.ones((2, 2), np.float32) for _ in range(64)]
    feed = DeviceFeed(src, ctx=mx.cpu(), depth=1)
    next(feed)
    th = feed._thread
    assert th.is_alive()
    del feed
    gc.collect()
    th.join(timeout=10)
    assert not th.is_alive()


def test_abandoned_prefetching_iter_releases_producer_thread():
    from mxnet_tpu_torch.io.io import NDArrayIter, PrefetchingIter
    pf = PrefetchingIter(NDArrayIter(np.ones((64, 2), np.float32),
                                     batch_size=2), prefetch_depth=1)
    pf.next()
    th = pf._thread
    assert th.is_alive()
    del pf
    gc.collect()
    th.join(timeout=10)
    assert not th.is_alive()


def test_feed_close_detaches_finalizer_and_joins():
    src = [np.ones((2, 2), np.float32) for _ in range(8)]
    feed = DeviceFeed(src, ctx=mx.cpu(), depth=1)
    next(feed)
    fin = feed._finalizer
    feed.close()
    assert not fin.alive
    assert feed._thread is None
    feed.close()
    feed.reset()                     # an iterable restarts its epoch
    assert len(list(feed)) == 8


# -- the slice as a whole ----------------------------------------------

NARROW = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)
LARS = {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.001}
BF16_LIMITS = {"loss_rel": 1e-2, "param_rel": 3e-3, "update_rel": 2e-2}
ITER = dict(data_shape=(3, 32, 32), batch_size=32, shuffle=True,
            rand_mirror=True, mean_r=123.68, mean_g=116.779, mean_b=103.939,
            std_r=58.393, std_g=57.12, std_b=57.375, preprocess_threads=0,
            dtype="bfloat16")


def _rel(a, b):
    keys = [k for k in b if not ("conv" in k and k.endswith("bias"))]
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    den = sum(float((b[k] ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


@pytest.mark.skipif(not jkernels.available(), reason="no pallas here")
def test_the_imagenet_input_slice_matches_the_jax_package(tmp_path,
                                                          monkeypatch):
    rec = _make_rec(tmp_path, n=64, hw=(32, 32), fmt="raw",
                    classes=10) + ".rec"
    monkeypatch.setenv("MXNET_TPU_KERNELS", "1")
    with jax.default_matmul_precision("highest"):
        np.random.seed(0)
        jnet = JResNetV1(JBottleneck, layout="NHWC", **NARROW)
        jnet.initialize(ctx=jmx.cpu())
        with jmx.autograd.pause():
            jnet(jmx.nd.zeros((2, 32, 32, 3)))
        arrays = {n: p.data().asnumpy()
                  for n, p in jnet.collect_params().items()}
        jstep = JTrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                           jgluon.Trainer(jnet.collect_params(), "lars",
                                          LARS, kvstore=None), mesh=None)
        np.random.seed(1)
        jlosses, jbatches = [], []
        with jamp.scope("bfloat16"):
            for b in jio.ImageRecordIter(path_imgrec=rec, ctx=jmx.cpu(),
                                         **ITER):
                x = jmx.nd.transpose(b.data, axes=(0, 2, 3, 1))
                jbatches.append(np.asarray(x._data.astype(np.float32)))
                jlosses.append(float(jstep(JDeviceBatch(
                    [x, b.label])).asscalar()))
        want = {n[len(jnet.prefix):]: p.data().asnumpy()
                for n, p in jnet.collect_params().items()}
    initial = {n[len(jnet.prefix):]: a for n, a in arrays.items()}

    net = ResNetV1(BottleneckV1, layout="NHWC", **NARROW)
    net.initialize(device="cpu")
    params_from_numpy(net, arrays)
    step = TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                     gluon.Trainer(net.collect_params(), "lars", LARS))
    np.random.seed(1)
    losses, batches = [], []
    feed = io.ImageRecordIter(path_imgrec=rec, ctx=mx.cpu(), **ITER)
    with amp.scope("bfloat16"):
        for b in feed:
            x = b.data._data.permute(0, 2, 3, 1).contiguous()
            assert x.dtype == torch.bfloat16
            batches.append(x.float().numpy())
            losses.append(float(step(DeviceBatch([x, b.label]))))
    got = {p.name[len(net.prefix):]: p.data()._data.detach().numpy()
           for p in net.collect_params().values()}

    assert len(losses) == len(jlosses) == 2
    for x, jx in zip(batches, jbatches):
        assert x.shape == (32, 32, 32, 3) and _bf16_ulps(x, jx) <= 1
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jlosses, rtol=BF16_LIMITS["loss_rel"])
    assert sorted(got) == sorted(want)
    assert _rel(got, want) <= BF16_LIMITS["param_rel"]
    assert _rel({k: got[k] - initial[k] for k in want},
                {k: want[k] - initial[k] for k in want}) \
        <= BF16_LIMITS["update_rel"]
