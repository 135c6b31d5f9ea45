"""The PyTorch port's decode engine and registry on the CPU, at the JAX
package's test geometry: tokens equal to the JAX model's greedy decode
on the same weights, continuous batching (join mid-batch identical to a
solo run), admission shedding, cancel / timeout / close, and a hot swap
that drains the old engine.  Steps are slowed by wrapping the engine's
``_step`` where a test needs a sequence to stay in flight."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mxnet_tpu.serving.decode import tiny_gpt as jax_tiny_gpt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.serving import (ModelRegistry, RequestTimeout,
                                     ServableClosed, ServingQueueFull)
from mxnet_tpu_torch.serving.decode import (DecodeEngine, params_from_numpy,
                                            tiny_gpt)

GEOM = dict(vocab_size=32, units=16, num_layers=2, num_heads=2, max_seq=32)
MODEL = tiny_gpt(**GEOM)
JMODEL = jax_tiny_gpt(**GEOM)
ENGINE_KW = dict(prefill_buckets=(8, 16), decode_buckets=(1, 2, 4),
                 block_size=4, num_blocks=64, max_queue=16)
PROMPTS = [[3, 7, 1, 9, 2], [5, 5, 6], [1, 2, 3, 4], [9, 8, 7]]


@pytest.fixture(scope="module")
def jax_params():
    return JMODEL.init_params(2)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_numpy({k: np.asarray(v)
                              for k, v in jax_params.items()}, "cpu")


@pytest.fixture()
def make_engine(params):
    engines = []

    def _make(**overrides):
        kw = dict(ENGINE_KW, **overrides)
        eng = DecodeEngine(MODEL, params, device="cpu", **kw)
        eng.warmup()
        eng.start()
        engines.append(eng)
        return eng

    yield _make
    for eng in engines:
        eng.close(drain=False)


@pytest.fixture()
def registry():
    reg = ModelRegistry()
    yield reg
    reg.shutdown(drain=False)


def _throttle(eng, seconds):
    """Sleep before every decode step of ``eng``."""
    step = eng._step

    def slow():
        time.sleep(seconds)
        step()
    eng._step = slow


def _reference(params, prompt, max_new, eos_id=None):
    return MODEL.reference_decode(params, prompt, max_new, eos_id=eos_id)


def _jax_greedy(jp, prompt, n):
    """JAX ``reference_decode``'s loop -- one full forward per token --
    over a jitted ``full_logits`` at the fixed width max_seq (the causal
    mask makes the padding inert), so it compiles once."""
    fwd = jax.jit(JMODEL.full_logits)
    toks = list(prompt)
    for _ in range(n):
        row = np.zeros((1, GEOM["max_seq"]), np.int32)
        row[0, :len(toks)] = toks
        toks.append(int(jnp.argmax(fwd(jp, jnp.asarray(row))[0,
                                                          len(toks) - 1])))
    return toks[len(prompt):]


# ---------------------------------------------------------------------
# numerics + streaming
# ---------------------------------------------------------------------

def test_engine_matches_jax_greedy_decode(make_engine, jax_params):
    eng = make_engine()
    for prompt in PROMPTS[:3]:
        assert eng.submit(prompt, 8).tokens() \
            == _jax_greedy(jax_params, prompt, 8)
    assert eng.cache.blocks_in_use() == 0


def test_warmup_runs_every_decode_bucket_once(make_engine, params):
    eng = make_engine()
    assert eng.decode_steps == len(ENGINE_KW["decode_buckets"])
    assert eng.submit([1, 2], 4).tokens() == _reference(params, [1, 2], 4)
    assert eng.decode_steps == len(ENGINE_KW["decode_buckets"]) + 3


def test_engine_streams_incrementally(make_engine):
    eng = make_engine()
    stream = eng.submit([3, 7, 1], 6)
    seen = []
    for tok in stream:
        seen.append(tok)
        assert stream.ttft_s is not None and stream.ttft_s >= 0
    assert len(seen) == 6
    assert stream.finish_reason == "length"


def test_engine_eos_stops_and_frees(make_engine, params):
    eng = make_engine()
    ref = _reference(params, [5, 5, 6], 10)
    eos = ref[2]                         # an id the model will emit
    stream = eng.submit([5, 5, 6], 10, eos_id=eos)
    toks = stream.tokens()
    assert toks == _reference(params, [5, 5, 6], 10, eos_id=eos)
    assert toks[-1] == eos and len(toks) <= 10
    assert stream.finish_reason == "eos"
    assert eng.cache.blocks_in_use() == 0


def test_engine_rejects_over_budget_prompts(make_engine):
    eng = make_engine()
    with pytest.raises(MXNetError):
        eng.submit(list(range(17)), 4)   # > largest prefill bucket
    with pytest.raises(MXNetError):
        eng.submit([1, 2, 3], 30)        # 33 > max_seq 32
    with pytest.raises(MXNetError):
        eng.submit([], 4)


def test_prefill_buckets_capped_at_max_seq(params):
    eng = DecodeEngine(MODEL, params, prefill_buckets=(16, 64, 128),
                       decode_buckets=(1,), block_size=4, num_blocks=16,
                       device="cpu")
    assert eng.prefill_buckets == (16, 32)
    assert eng.max_blocks_per_seq == 8


# ---------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------

def test_join_mid_batch_is_bit_identical(make_engine, params):
    eng = make_engine()
    _throttle(eng, 0.02)   # keeps stream 0 running when the others join
    solo = [_reference(params, p, 10) for p in PROMPTS]
    results = {}

    def run(i, delay):
        time.sleep(delay)
        results[i] = eng.submit(PROMPTS[i], 10).tokens()

    threads = [threading.Thread(target=run, args=(i, 0.03 * i))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for i in range(len(PROMPTS)):
        assert results[i] == solo[i], "slot %d diverged" % i
    # occupancy > 1 at some step <=> fewer steps than decoded tokens
    steps = eng.decode_steps - len(ENGINE_KW["decode_buckets"])
    assert steps < len(PROMPTS) * 9
    assert eng.cache.blocks_in_use() == 0


def test_finished_sequences_vacate_immediately(make_engine, params):
    eng = make_engine()
    short = eng.submit([5, 5, 6], 2)
    long = eng.submit([3, 7, 1, 9, 2], 12)
    assert short.tokens() == _reference(params, [5, 5, 6], 2)
    assert long.tokens() == _reference(params, [3, 7, 1, 9, 2], 12)
    assert eng.cache.blocks_in_use() == 0


# ---------------------------------------------------------------------
# admission backpressure + lifecycle
# ---------------------------------------------------------------------

def test_admission_sheds_on_kv_exhaustion_never_midflight(make_engine,
                                                          params):
    # 9 usable blocks of 4 = 36 token slots; one request budgets
    # 5 + 12 = 17 -> 5 blocks, so a second identical one must shed
    eng = make_engine(num_blocks=10)
    _throttle(eng, 0.02)
    first = eng.submit([3, 7, 1, 9, 2], 12)
    time.sleep(0.05)                     # first is mid-generation now
    with pytest.raises(ServingQueueFull, match="shed at admission"):
        eng.submit([3, 7, 1, 9, 2], 12)
    assert first.tokens() == _reference(params, [3, 7, 1, 9, 2], 12)
    assert eng.cache.blocks_in_use() == 0
    assert len(eng.submit([1], 2).tokens()) == 2     # sheds recover


def test_admission_sheds_on_queue_full(make_engine):
    eng = make_engine(max_queue=1)
    _throttle(eng, 0.05)
    streams, shed = [], 0
    for _ in range(12):                  # 4 slots + 1 pending at most
        try:
            streams.append(eng.submit([1], 8))
        except ServingQueueFull:
            shed += 1
    assert shed >= 1
    for s in streams:
        assert len(s.tokens()) == 8      # accepted work still completes
    assert eng.cache.blocks_in_use() == 0


def test_cancel_frees_blocks(make_engine):
    eng = make_engine()
    _throttle(eng, 0.02)
    stream = eng.submit([3, 7, 1], 20)
    first = next(stream)
    stream.cancel()
    tail = list(stream)
    assert stream.finish_reason == "cancel"
    assert 1 + len(tail) < 20
    assert isinstance(first, int)
    assert eng.cache.blocks_in_use() == 0


def test_timeout_while_pending_frees_blocks(make_engine):
    eng = make_engine(decode_buckets=(1,), max_queue=8)
    _throttle(eng, 0.03)
    blocker = eng.submit([1], 10)        # owns the single slot
    time.sleep(0.02)
    late = eng.submit([2], 4, timeout=0.01)
    with pytest.raises(RequestTimeout):
        late.tokens()
    assert blocker.tokens()              # the running one is unharmed
    assert late.finish_reason == "timeout"
    assert eng.cache.blocks_in_use() == 0


def test_close_without_drain_resolves_streams(make_engine):
    eng = make_engine()
    _throttle(eng, 0.02)
    stream = eng.submit([3, 7, 1], 20)
    next(stream)
    assert eng.close(drain=False) == 1
    with pytest.raises(ServableClosed):
        list(stream)
    assert stream.finish_reason == "closed"
    assert eng.cache.blocks_in_use() == 0
    with pytest.raises(ServableClosed):
        eng.submit([1], 2)


# ---------------------------------------------------------------------
# registry surface + hot swap
# ---------------------------------------------------------------------

def test_registry_generate_and_surface(registry, params):
    sv = registry.register_generative("gpt", MODEL, params=params,
                                      device="cpu", **ENGINE_KW)
    assert "gpt" in registry and registry.names() == ["gpt"]
    assert len(registry) == 1 and registry.servable("gpt") is sv
    assert sv.queue_depth() == 0 and sv.queue_capacity == 16
    assert sv.buckets == (1, 2, 4) and sv.prefill_buckets == (8, 16)
    assert sv.kvcache_stats()["blocks_in_use"] == 0
    toks = registry.generate("gpt", [3, 7, 1], 5).tokens()
    assert toks == _reference(params, [3, 7, 1], 5)
    registry.unregister("gpt")
    assert sv.closed and "gpt" not in registry
    with pytest.raises(MXNetError, match="no servable"):
        registry.generate("gpt", [3], 2)


def test_registry_takes_numpy_params_and_rejects_bad_sources(registry,
                                                             jax_params,
                                                             params,
                                                             tmp_path):
    numpy_params = {k: np.asarray(v) for k, v in jax_params.items()}
    registry.register_generative("np", MODEL, params=numpy_params,
                                 device="cpu", **ENGINE_KW)
    assert registry.generate("np", [5, 5, 6], 4).tokens() \
        == _reference(params, [5, 5, 6], 4)
    with pytest.raises(MXNetError, match="exactly one"):
        registry.register_generative("x", MODEL, device="cpu")
    with pytest.raises(MXNetError, match="exactly one"):
        registry.register_generative("x", MODEL, params=numpy_params,
                                     checkpoint=str(tmp_path),
                                     device="cpu")
    with pytest.raises(MXNetError, match="no intact checkpoint"):
        registry.register_generative("x", MODEL, checkpoint=str(tmp_path),
                                     device="cpu")


def test_mid_decode_swap_drains_old_engine(registry, params):
    p1 = params_from_numpy({k: np.asarray(v) for k, v in
                            JMODEL.init_params(1).items()}, "cpu")
    registry.register_generative("gpt", MODEL, params=params,
                                 device="cpu", **ENGINE_KW)
    old = registry.servable("gpt")
    step = old.engine._step
    deadline = time.monotonic() + 10.0

    def held_until_swapped():
        # every old decode step waits for the replacement to install,
        # so the swap provably lands mid-generation
        while registry._servables.get("gpt") is old \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        step()
    old.engine._step = held_until_swapped

    stream = registry.generate("gpt", [3, 7, 1, 9, 2], 20)
    first = next(stream)                 # from prefill: mid-generation now
    registry.register_generative("gpt", MODEL, params=p1, device="cpu",
                                 **ENGINE_KW)
    drained = [first] + list(stream)
    assert drained == _reference(params, [3, 7, 1, 9, 2], 20)
    assert stream.finish_reason == "length"
    assert old.closed and old.engine._drained_live == 1
    assert registry.generate("gpt", [3, 7, 1], 5).tokens() \
        == _reference(p1, [3, 7, 1], 5)
