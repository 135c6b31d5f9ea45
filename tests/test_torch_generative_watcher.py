"""The generative tier's hot swap on the CPU, from
``tests/test_serving_decode.py``'s swap cases, at the JAX package's test
geometry: a mid-decode swap drains the old engine with zero dropped
(held at the ``serving.decode.step`` fail point until the replacement
installs), a swap aborted at ``serving.swap`` leaves the old engine
serving, ``GenerativeWatcher`` swaps on each new checkpoint step, the
engine's ``live_sequences``/``active_sequences`` and ``fingerprint``,
and greedy streams through the in-graph prefill scatter equal to the JAX
engine's on the same weights."""
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving.decode import tiny_gpt as jax_tiny_gpt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.serving import GenerativeWatcher, ModelRegistry
from mxnet_tpu_torch.serving.decode import params_from_numpy, tiny_gpt

GEOM = dict(vocab_size=32, units=16, num_layers=2, num_heads=2, max_seq=32)
MODEL = tiny_gpt(**GEOM)
JMODEL = jax_tiny_gpt(**GEOM)
ENGINE_KW = dict(prefill_buckets=(8, 16), decode_buckets=(1, 2, 4),
                 block_size=4, num_blocks=64, max_queue=16)
PROMPTS = [[3, 7, 1, 9, 2], [5, 5, 6], [1, 2, 3, 4, 8, 8, 1, 2, 3],
           [9, 8, 7]]
JOIN_S = 30


@pytest.fixture(scope="module")
def jax_params():
    return {seed: JMODEL.init_params(seed) for seed in (0, 1)}


@pytest.fixture(scope="module")
def params(jax_params):
    return {seed: params_from_numpy({k: np.asarray(v)
                                     for k, v in jp.items()}, "cpu")
            for seed, jp in jax_params.items()}


@pytest.fixture()
def registry():
    chaos.reset()
    reg = ModelRegistry()
    with mx.cpu():
        yield reg
    reg.shutdown(drain=False)
    chaos.disarm()
    chaos.reset()


def _reference(p, prompt, n):
    return MODEL.reference_decode(p, prompt, n)


def test_streams_equal_the_jax_engine(registry, params, jax_params):
    """The in-graph prefill scatter (padded positions into the scratch
    block): greedy streams equal the JAX engine's on the same weights,
    prompts at both prefill buckets, decoded together."""
    jreg = jserving.ModelRegistry(compile_cache=False)
    try:
        jreg.register_generative("gpt", JMODEL, params=jax_params[0],
                                 **ENGINE_KW)
        registry.register_generative("gpt", MODEL, params=params[0],
                                     device="cpu", **ENGINE_KW)
        streams = [registry.generate("gpt", p, 10) for p in PROMPTS]
        got = [s.tokens() for s in streams]
        want = [jreg.generate("gpt", p, 10).tokens() for p in PROMPTS]
    finally:
        jreg.shutdown()
    assert got == want


def test_mid_decode_swap_drains_old_zero_dropped(registry, params):
    telemetry.enable()
    telemetry.reset("chaos.")
    try:
        registry.register_generative("gpt", MODEL, params=params[0],
                                     device="cpu", **ENGINE_KW)
        old = registry.servable("gpt")
        with chaos.scenario(seed=0):
            deadline = time.monotonic() + JOIN_S

            def hold_until_swapped(ctx):
                # every old decode step waits for the replacement to
                # install: the swap lands mid-generation
                while registry._servables.get("gpt") is old \
                        and time.monotonic() < deadline:
                    time.sleep(0.002)

            chaos.on("serving.decode.step", action=hold_until_swapped)
            stream = registry.generate("gpt", [3, 7, 1, 9, 2], 20)
            first = next(stream)
            assert old.engine.live_sequences() == 1
            registry.register_generative("gpt", MODEL, params=params[1],
                                         device="cpu", **ENGINE_KW)
            drained = [first] + list(stream)
            assert drained == _reference(params[0], [3, 7, 1, 9, 2], 20)
            assert stream.finish_reason == "length"
            assert chaos.stats()["survived"].get(
                "serving.decode_swap") == 1
            assert registry.generate("gpt", [3, 7, 1], 5).tokens() \
                == _reference(params[1], [3, 7, 1], 5)
        assert old.engine.live_sequences() == 0
        assert old.engine.active_sequences() == 0
        assert telemetry.counter(
            "chaos.survived.serving.decode_swap").value == 1
    finally:
        telemetry.disable()


def test_swap_abort_leaves_old_serving(registry, params):
    registry.register_generative("gpt", MODEL, params=params[0],
                                 device="cpu", **ENGINE_KW)
    old = registry.servable("gpt")
    with chaos.scenario(seed=0):
        chaos.on("serving.swap", action=chaos.RAISE, times=1)
        with pytest.raises(chaos.ChaosInjected):
            registry.register_generative("gpt", MODEL, params=params[1],
                                         device="cpu", **ENGINE_KW)
    assert registry.servable("gpt") is old
    assert registry.generate("gpt", [3, 7, 1], 5).tokens() \
        == _reference(params[0], [3, 7, 1], 5)


def test_generative_watcher_swaps_on_new_step(registry, params,
                                              jax_params, tmp_path):
    """The JAX case, and the same swaps through the JAX watcher over the
    same checkpoint root (both packages read its files)."""
    from mxnet_tpu.serving.decode import GenerativeWatcher as JWatcher
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"params": params[0]})
    w = GenerativeWatcher(registry, "gpt", mgr, MODEL, device="cpu",
                          poll_s=0.02, **ENGINE_KW)
    jreg = jserving.ModelRegistry(compile_cache=False)
    jw = JWatcher(jreg, "gpt", str(tmp_path / "ckpt"), JMODEL,
                  **ENGINE_KW)
    try:
        assert w.poll_once() == jw.poll_once() == 1
        assert registry.generate("gpt", [3, 7, 1], 5).tokens() \
            == _reference(params[0], [3, 7, 1], 5) \
            == jreg.generate("gpt", [3, 7, 1], 5).tokens()
        assert w.poll_once() is None
        mgr.save(2, {"params": params[1]})
        w.start()
        for _ in range(int(JOIN_S / 0.02)):
            if w.served_step == 2:
                break
            time.sleep(0.02)
        assert w.served_step == 2 and jw.poll_once() == 2
        assert registry.generate("gpt", [3, 7, 1], 5).tokens() \
            == _reference(params[1], [3, 7, 1], 5) \
            == jreg.generate("gpt", [3, 7, 1], 5).tokens()
    finally:
        w.close()
        jw.close()
        jreg.shutdown()


def test_watcher_swap_under_streams_drops_none(registry, params, tmp_path):
    """Streams in flight while the watcher swaps in a new step: each
    completes, on the weights of the step it was admitted under."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"params": params[0]})
    w = GenerativeWatcher(registry, "gpt", mgr, MODEL, device="cpu",
                          **ENGINE_KW)
    assert w.poll_once() == 1
    old = registry.servable("gpt")
    gate = threading.Event()
    step = old.engine._step

    def held():
        gate.wait(JOIN_S)
        step()
    old.engine._step = held
    streams = [registry.generate("gpt", p, 8) for p in PROMPTS]
    for _ in range(1000):
        if old.engine.active_sequences() == len(PROMPTS):
            break
        time.sleep(0.002)
    assert old.engine.active_sequences() == len(PROMPTS)
    mgr.save(2, {"params": params[1]})
    t = threading.Timer(0.05, gate.set)
    t.start()
    assert w.poll_once() == 2
    t.join(JOIN_S)
    for p, s in zip(PROMPTS, streams):
        assert s.tokens() == _reference(params[0], p, 8)
    assert old.engine.live_sequences() == 0
    assert registry.generate("gpt", PROMPTS[0], 8).tokens() == \
        _reference(params[1], PROMPTS[0], 8)


def test_engine_fingerprints(registry, params):
    sv = registry.register_generative("gpt", MODEL, params=params[0],
                                      device="cpu", **ENGINE_KW)
    eng = sv.engine
    fps = {(k, b): eng.fingerprint(k, b)
           for k, bs in (("prefill", eng.prefill_buckets),
                         ("decode", eng.decode_buckets)) for b in bs}
    assert all(fps.values()) and len(set(fps.values())) == len(fps)
    assert eng.fingerprint("decode", 64) is None
    sv2 = registry.register_generative("gpt", MODEL, params=params[1],
                                       device="cpu", **ENGINE_KW)
    assert {key: sv2.engine.fingerprint(*key) for key in fps} == fps
    wider = tiny_gpt(**dict(GEOM, units=32))
    sv3 = registry.register_generative(
        "w", wider, params=wider.init_params(0, device="cpu"),
        device="cpu", **ENGINE_KW)
    assert sv3.engine.fingerprint("decode", 1) != fps[("decode", 1)]
