"""Hot-path recording helpers (counterpart of
``mxnet_tpu/telemetry/hooks.py``).

Every instrumented module of the port guards a single call into this
module with the one module-level flag check::

    if _telemetry._ENABLED:
        _telemetry.hooks.serving_request(label, depth)

Keeping the recording logic here means the hot modules carry exactly
one branch when telemetry is off, and the instrument naming stays in
one place.  Names, kinds and payloads are the JAX package's, so a
dashboard or alert written for one package reads the other.

The hooks ported are those of the modules the port has: the serving
and decode tiers, the KV cache, checkpoints, the always-on loop, the
trainer, AMP, the numerics sentinel, the sync layer, chaos, preemption,
the single-process ops plane (op dispatch and host syncs, graph
warm-ups and captures, the data loader and device feed, the leak
sentinel, profiling, the supervisor, the goodput ledger and the
environment-health gauges), the kvstore, the cross-process collectives
and rank failures, and the fleet plane.  :data:`INSTRUMENTS` keeps the
JAX catalogue's entries of the instruments they write.
"""
from __future__ import annotations

__all__ = [
    "trainer_step",
    "amp_overflow",
    "amp_rescale",
    "numerics_check",
    "numerics_nonfinite",
    "checkpoint",
    "checkpoint_wait",
    "sync_contention",
    "sync_hold",
    "sync_watchdog",
    "sync_inversion",
    "serving_request",
    "serving_shed",
    "serving_timeout",
    "serving_error",
    "serving_batch",
    "serving_latency",
    "serving_warmup",
    "serving_model",
    "serving_compile_cache",
    "serving_evict",
    "serving_swap",
    "decode_request",
    "decode_shed",
    "decode_prefill",
    "decode_step",
    "decode_ttft",
    "decode_inter_token",
    "decode_finish",
    "kvcache_alloc",
    "kvcache_free",
    "kvcache_alloc_failure",
    "train_publish",
    "checkpoint_quarantine",
    "checkpoint_retry",
    "checkpoint_write_failed",
    "preemption_reentry",
    "chaos_inject",
    "chaos_survive",
    "checkpoint_commit_aborted",
    "serving_watcher_suspended",
    "op_dispatch",
    "host_sync",
    "compile_event",
    "samples_per_sec",
    "dataloader_wait",
    "feed_produce",
    "feed_wait",
    "feed_overlap",
    "memory_census",
    "memory_leak",
    "profiling_capture",
    "profiling_step",
    "supervisor_restart",
    "supervisor_exhausted",
    "goodput_window",
    "goodput_regression",
    "goodput_env_degraded",
    "env_health",
    "kv_op",
    "dist_collective",
    "dist_rank_failure",
    "fleet_scrape",
    "fleet_replica_down",
    "fleet_round",
    "fleet_alert",
    "fleet_alerts_firing",
]


def _registry():
    # late import: resolving through the package keeps hooks working
    # whichever registry the package holds
    from . import _registry
    return _registry


def trainer_step(seconds, batch_size):
    reg = _registry()
    reg.timer("trainer.step_time").observe(seconds)
    reg.counter("trainer.steps").inc()
    if batch_size:
        reg.counter("trainer.samples").inc(int(batch_size))
        if seconds > 0:
            reg.gauge("trainer.samples_per_sec").set(batch_size / seconds)


def amp_overflow(scale_before, scale_after):
    reg = _registry()
    reg.counter("amp.overflows").inc()
    reg.gauge("amp.loss_scale").set(scale_after)
    reg.event("amp.overflow").emit(scale_before=scale_before,
                                   scale_after=scale_after)


def amp_rescale(scale_before, scale_after):
    reg = _registry()
    reg.gauge("amp.loss_scale").set(scale_after)
    reg.event("amp.rescale").emit(scale_before=scale_before,
                                  scale_after=scale_after)


def numerics_check(seconds=None):
    """One non-finite sentinel check ran (analysis.numerics; armed by
    MXNET_TPU_NUMERICS_CHECK=1).  ``seconds`` is the host wall spent on
    the one boolean host read."""
    reg = _registry()
    reg.counter("numerics.checks").inc()
    if seconds is not None:
        reg.timer("numerics.check_time").observe(seconds)


def numerics_nonfinite(param, step, kind):
    """The sentinel attributed a non-finite step: ``param`` is the
    first offending parameter (or ``loss``), ``kind`` nan/inf."""
    reg = _registry()
    reg.counter("numerics.nonfinite_steps").inc()
    reg.event("numerics.nonfinite").emit(param=param, step=step,
                                         kind=kind)


def checkpoint(action, nbytes=None, seconds=None, **payload):
    reg = _registry()
    reg.counter("checkpoint.%ss" % action).inc()
    if nbytes:
        reg.counter("checkpoint.bytes_read" if action == "restore"
                    else "checkpoint.bytes_written").inc(int(nbytes))
    if seconds is not None:
        reg.timer("checkpoint.%s_time" % action).observe(seconds)
    reg.event("checkpoint").emit(action=action, nbytes=nbytes,
                                 seconds=seconds, **payload)


def checkpoint_wait(seconds, step=None):
    reg = _registry()
    reg.timer("checkpoint.async_wait").observe(
        seconds, **({} if step is None else {"step": step}))


def sync_contention(lock_name, seconds):
    _registry().timer("sync.contention_wait").observe(seconds,
                                                      lock=lock_name)


def sync_hold(lock_name, seconds):
    _registry().timer("sync.hold_time").observe(seconds, lock=lock_name)


def sync_watchdog(lock_name):
    reg = _registry()
    reg.counter("sync.watchdog_fires").inc()
    reg.event("sync.watchdog").emit(lock=lock_name)


def sync_inversion(outer, inner):
    reg = _registry()
    reg.counter("sync.inversions").inc()
    reg.event("sync.inversion").emit(outer=outer, inner=inner)


def serving_request(model, queue_depth):
    reg = _registry()
    reg.counter("serving.requests").inc()
    reg.gauge("serving.queue_depth").set(queue_depth)


def serving_shed(model):
    _registry().counter("serving.shed").inc()


def serving_timeout(model):
    _registry().counter("serving.timeouts").inc()


def serving_error(model):
    """A compiled dispatch raised: the batch's requests were failed but
    the worker survived -- the error_ratio numerator the fleet plane
    scrapes."""
    _registry().counter("serving.errors").inc()


def serving_batch(model, occupancy, bucket, seconds):
    """One compiled batch dispatched: ``occupancy`` real requests
    padded to ``bucket``."""
    reg = _registry()
    reg.counter("serving.batches").inc()
    reg.counter("serving.responses").inc(int(occupancy))
    reg.gauge("serving.batch_occupancy").set(occupancy)
    reg.timer("serving.dispatch_time").observe(seconds, model=model,
                                               bucket=bucket,
                                               occupancy=occupancy)


def serving_latency(seconds):
    _registry().timer("serving.latency").observe(seconds)


def serving_warmup(model, seconds, n_buckets):
    _registry().timer("serving.warmup_time").observe(
        seconds, model=model, buckets=n_buckets)


def serving_model(model, source, n_buckets):
    reg = _registry()
    reg.counter("serving.models").inc()
    reg.event("serving.register").emit(model=model, source=source,
                                       buckets=n_buckets)


def serving_compile_cache(hit):
    _registry().counter("serving.compile_cache_hits" if hit
                        else "serving.compile_cache_misses").inc()


def serving_evict():
    _registry().counter("serving.compile_evictions").inc()


def serving_swap(model, step, seconds, ok, from_step=None, attempt=1,
                 error=None):
    """One hot-swap attempt by a RegistryWatcher finished."""
    reg = _registry()
    if ok:
        reg.counter("serving.swaps").inc()
        reg.timer("serving.swap_time").observe(seconds, model=model,
                                               step=step)
        reg.gauge("serving.served_step").set(step)
    else:
        reg.counter("serving.swap_failures").inc()
    reg.event("serving.swap").emit(model=model, step=step, ok=bool(ok),
                                   from_step=from_step, attempt=attempt,
                                   seconds=seconds, error=error)


def decode_request(model, queue_depth):
    """One generation request admitted to a decode engine."""
    reg = _registry()
    reg.counter("decode.requests").inc()
    reg.gauge("decode.queue_depth").set(queue_depth)


def decode_shed(model, reason):
    """Admission backpressure: a generation request was shed at submit
    (``reason``: ``queue`` = pending queue full, ``kvcache`` = the KV
    cache cannot cover the request's whole token budget)."""
    reg = _registry()
    reg.counter("decode.shed").inc()
    reg.counter("decode.shed." + reason).inc()


def decode_prefill(model, bucket, prompt_len, seconds):
    """One prompt prefilled into cache blocks (the first token's
    compiled call, bucketed by padded prompt length)."""
    reg = _registry()
    reg.counter("decode.prefills").inc()
    reg.timer("decode.prefill_time").observe(seconds, model=model,
                                             bucket=bucket,
                                             prompt_len=prompt_len)


def decode_step(model, occupancy, bucket, seconds):
    """One continuous-batching decode iteration: ``occupancy`` live
    sequences padded to the ``bucket`` slot count."""
    reg = _registry()
    reg.counter("decode.steps").inc()
    reg.counter("decode.tokens").inc(int(occupancy))
    reg.gauge("decode.occupancy").set(occupancy)
    reg.timer("decode.step_time").observe(seconds, model=model,
                                          bucket=bucket,
                                          occupancy=occupancy)


def decode_ttft(seconds):
    """Submit -> first streamed token (the product-layer TTFT)."""
    _registry().timer("decode.ttft").observe(seconds)


def decode_inter_token(seconds):
    """Gap between consecutive streamed tokens of one request."""
    _registry().timer("decode.inter_token").observe(seconds)


def decode_finish(model, reason, tokens):
    """One generation finished (``reason``: eos / length / cancel /
    timeout / error / closed)."""
    reg = _registry()
    reg.counter("decode.finished").inc()
    reg.event("decode.finish").emit(model=model, reason=reason,
                                    tokens=int(tokens))


def kvcache_alloc(in_use, fragmentation):
    """A block-table allocation succeeded; gauges carry the cache's
    post-alloc occupancy and internal fragmentation (unused fraction
    of allocated blocks)."""
    reg = _registry()
    reg.counter("kvcache.allocs").inc()
    reg.gauge("kvcache.blocks_in_use").set(in_use)
    reg.gauge("kvcache.fragmentation").set(fragmentation)


def kvcache_free(in_use, fragmentation):
    """A finished/cancelled sequence returned its blocks."""
    reg = _registry()
    reg.counter("kvcache.frees").inc()
    reg.gauge("kvcache.blocks_in_use").set(in_use)
    reg.gauge("kvcache.fragmentation").set(fragmentation)


def kvcache_alloc_failure():
    """An allocation found too few free blocks (the admission-shed
    trigger; never fires mid-generation by construction)."""
    _registry().counter("kvcache.alloc_failures").inc()


def train_publish(step, seconds):
    """ContinuousTrainer published a checkpoint for the watcher."""
    reg = _registry()
    reg.counter("train_loop.publishes").inc()
    reg.gauge("train_loop.published_step").set(step)
    reg.event("train_loop.publish").emit(step=step, seconds=seconds)


def checkpoint_quarantine(step, path):
    """Discovery renamed a verification-failed step to .corrupt."""
    reg = _registry()
    reg.counter("checkpoint.quarantined").inc()
    reg.event("checkpoint.quarantine").emit(step=step, path=path)


def checkpoint_retry(attempt, error, step=None):
    """The async writer retried a failed background write."""
    reg = _registry()
    reg.counter("checkpoint.write_retries").inc()
    reg.event("checkpoint.write_retry").emit(attempt=attempt,
                                             error=error, step=step)


def checkpoint_write_failed(attempts, error, step=None):
    """An async write failed every attempt (error re-raises at the
    next save/wait; this event is the operator-visible surface)."""
    reg = _registry()
    reg.counter("checkpoint.write_failures").inc()
    reg.event("checkpoint.write_failed").emit(attempts=attempts,
                                              error=error, step=step)


def preemption_reentry():
    _registry().counter("preemption.reentrant_signals").inc()


def chaos_inject(point, action):
    """An armed fail point fired."""
    reg = _registry()
    reg.counter("chaos.injected").inc()
    reg.counter("chaos.injected." + point).inc()
    reg.event("chaos.inject").emit(point=point, action=action)


def chaos_survive(point, how):
    """A recovery path tolerated a fault (injected or real)."""
    reg = _registry()
    reg.counter("chaos.survived").inc()
    reg.counter("chaos.survived." + point).inc()
    reg.event("chaos.survive").emit(point=point, how=how)


def checkpoint_commit_aborted(step, reason, rank=None):
    """A sharded save aborted cleanly instead of committing -- staged
    tmp swept, manifest never renamed in (the rank-death-safe commit
    contract, checkpoint/sharded.py)."""
    reg = _registry()
    reg.counter("checkpoint.commit_aborted").inc()
    reg.event("checkpoint.commit_abort").emit(step=step, reason=reason,
                                              rank=rank)


def serving_watcher_suspended(model, step, budget):
    """A RegistryWatcher exhausted its swap failure budget and went
    terminal -- it will never retry on its own, so this is the event an
    operator alert must hang off (and /healthz reads NOT_READY)."""
    reg = _registry()
    reg.counter("serving.watcher_suspensions").inc()
    reg.event("serving.watcher_suspended").emit(model=model, step=step,
                                                budget=budget)


# -- the ops plane: dispatch, compile, input, memory, profiling,
# -- supervisor, goodput and environment health

def op_dispatch(opname):
    reg = _registry()
    reg.counter("dispatch.op_calls").inc()
    reg.counter("dispatch.op." + opname).inc()


def host_sync(kind, seconds=None):
    reg = _registry()
    reg.counter("dispatch.host_sync").inc()
    reg.counter("dispatch.host_sync." + kind).inc()
    if seconds is not None:
        # the goodput ledger's host_sync category: wall the host spent
        # blocked on device results (asnumpy / wait_to_read / waitall)
        reg.timer("dispatch.host_sync_time").observe(seconds, sync=kind)


def compile_event(site, seconds=None, retrace=False, **payload):
    """One shape-keyed program was built at ``site``: the port's
    counterpart of a compile is a key's eager warm-up and its CUDA-graph
    capture (``hybrid_cache``, ``train_step``; ``payload`` names the
    owner and the stage).  ``retrace`` marks a build that joined a
    non-empty cache."""
    reg = _registry()
    reg.counter("compile.count").inc()
    if retrace:
        reg.counter("compile.retraces").inc()
    if seconds is not None:
        reg.timer("compile.build_time").observe(seconds, site=site)
    reg.event("compile").emit(site=site, retrace=bool(retrace),
                              seconds=seconds, **payload)


def samples_per_sec(value):
    """Throughput reported by an outer logger: the gauge the Trainer
    feeds, so every training loop reports through one channel."""
    _registry().gauge("trainer.samples_per_sec").set(value)


def dataloader_wait(seconds):
    reg = _registry()
    reg.counter("data.batches").inc()
    reg.timer("data.wait_time").observe(seconds)


def feed_produce(seconds, nbytes):
    reg = _registry()
    reg.counter("feed.batches").inc()
    if nbytes:
        reg.counter("feed.bytes_staged").inc(int(nbytes))
    reg.timer("feed.producer_busy").observe(seconds)


def feed_wait(seconds):
    _registry().timer("feed.consumer_wait").observe(seconds)


def feed_overlap(frac):
    _registry().gauge("feed.overlap_frac").set(frac)


def memory_census(live_bytes, live_arrays):
    """One live-buffer census ran (analysis.memory; armed by
    MXNET_TPU_MEMORY_WATCH=1): publish the live totals as gauges."""
    reg = _registry()
    reg.counter("memory.censuses").inc()
    reg.gauge("memory.live_bytes").set(live_bytes)
    reg.gauge("memory.live_arrays").set(live_arrays)


def memory_leak(bucket, growth_bytes, live_bytes, window):
    """The leak sentinel flagged monotonic live-bytes growth; payload
    names the top-growing shape/dtype bucket."""
    reg = _registry()
    reg.counter("memory.leaks").inc()
    reg.event("memory.leak").emit(bucket=bucket,
                                  growth_bytes=growth_bytes,
                                  live_bytes=live_bytes, window=window)


def profiling_capture(label, seconds, flops=None):
    """One CostReport was materialized by the mx.profiling store."""
    reg = _registry()
    reg.counter("profiling.reports").inc()
    reg.timer("profiling.capture_time").observe(seconds, label=label)
    reg.event("profiling.capture").emit(label=label, seconds=seconds,
                                        flops=flops)


def profiling_step(label, seconds):
    """One step wall time recorded for the roofline clock."""
    _registry().timer("profiling.step_time").observe(seconds,
                                                     label=label)


def supervisor_restart(generation, rank, exit_code, restarts):
    """The restart supervisor relaunched the workers after a death
    (:mod:`mxnet_tpu_torch.supervisor`)."""
    reg = _registry()
    reg.counter("supervisor.restarts").inc()
    reg.gauge("supervisor.generation").set(generation)
    reg.event("supervisor.restart").emit(generation=generation,
                                         rank=rank,
                                         exit_code=exit_code,
                                         restarts=restarts)


def supervisor_exhausted(generation, budget):
    """The supervisor's restart budget ran out -- it stops relaunching
    and /healthz reads NOT_READY off the same state; alert here."""
    reg = _registry()
    reg.counter("supervisor.budget_exhausted").inc()
    reg.event("supervisor.exhausted").emit(generation=generation,
                                           budget=budget)


def goodput_window(report):
    """One StepLedger window closed (obs.goodput): publish the
    attribution as gauges (shares, MFU -- the live/Prometheus view),
    timers (per-category seconds -- the per-rank offline view: timer
    sums survive into summarize, so rank files carry per-category
    totals), and one compact ``goodput.window`` event."""
    reg = _registry()
    reg.counter("goodput.windows").inc()
    if report["steps"]:
        reg.counter("goodput.steps").inc(int(report["steps"]))
    for cat, c in report["categories"].items():
        reg.timer("goodput." + cat + "_s").observe(c["seconds"])
        reg.gauge("goodput." + cat + "_share").set(c["share"])
    if report.get("mfu") is not None:
        reg.gauge("goodput.mfu").set(report["mfu"])
    reg.gauge("goodput.reconciliation_error").set(
        report["reconciliation"]["error"])
    reg.event("goodput.window").emit(
        index=report["index"], reason=report["reason"],
        steps=report["steps"], wall_s=round(report["wall_s"], 6),
        mfu=report.get("mfu"),
        shares={cat: round(c["share"], 4)
                for cat, c in report["categories"].items()},
        verdict=report["verdict"]["detail"],
        bound=report["verdict"]["bound"],
        reconciled=report["reconciliation"]["ok"],
        env_degraded=report["env_degraded"])


def goodput_regression(category, per_step_s, baseline_per_step_s,
                       ratio, window):
    """The sentinel flagged one category as regressed vs its EWMA+MAD
    baseline -- the event NAMES the category that moved."""
    reg = _registry()
    reg.counter("goodput.regressions").inc()
    reg.event("goodput.regression").emit(
        category=category, per_step_s=per_step_s,
        baseline_per_step_s=baseline_per_step_s, ratio=ratio,
        window=window)


def goodput_env_degraded(window, dispatch_roundtrip_us):
    """The sentinel's env guard tripped: the window ran on a degraded
    environment (a slow dispatch round trip), so it is reported here
    and not as a regression."""
    reg = _registry()
    reg.counter("goodput.env_degraded_windows").inc()
    reg.event("goodput.env_degraded").emit(
        window=window, dispatch_roundtrip_us=dispatch_roundtrip_us)


def env_health(dispatch_roundtrip_us, h2d_mb_per_s=None):
    """An environment-health probe's numbers (dispatch round trip,
    host-to-device rate), recorded so the basis of a degraded-window
    verdict appears in summarize and in the flight-recorder dump."""
    reg = _registry()
    reg.gauge("env.dispatch_roundtrip_us").set(dispatch_roundtrip_us)
    if h2d_mb_per_s is not None:
        reg.gauge("env.h2d_mb_per_s").set(h2d_mb_per_s)
    reg.event("env.health").emit(
        dispatch_roundtrip_us=dispatch_roundtrip_us,
        h2d_mb_per_s=h2d_mb_per_s)


# ----------------------------------------------------------------------
# the instrument catalogue of the hooks above
# ----------------------------------------------------------------------

def kv_op(verb, nbytes, seconds=None):
    """One kvstore verb (push/pull/pushpull) and its payload bytes."""
    reg = _registry()
    reg.counter("kvstore." + verb).inc()
    if nbytes:
        reg.counter("kvstore.bytes").inc(int(nbytes))
    if seconds is not None:
        reg.timer("kvstore.time").observe(seconds, verb=verb)


def dist_collective(kind, nbytes, ntensors=1):
    """One host-side cross-process collective (distributed.py); the
    bucketed wrappers coalesce N tensors into one call --
    ``dist.collectives`` vs ``dist.tensors_coalesced`` is the
    call-count drop."""
    reg = _registry()
    reg.counter("dist.collectives").inc()
    reg.counter("dist." + kind).inc()
    if nbytes:
        reg.counter("dist.bytes").inc(int(nbytes))
    if ntensors:
        reg.counter("dist.tensors_coalesced").inc(int(ntensors))


def dist_rank_failure(kind, tag, ranks, elapsed_s=None):
    """A host collective or barrier gave up on peer rank(s) -- the
    typed RankFailure/BarrierTimeout surface (distributed.py), never a
    raw store or gloo error.  ``kind``: barrier/collective/abort/
    store."""
    reg = _registry()
    reg.counter("dist.rank_failures").inc()
    reg.event("dist.rank_failure").emit(kind=kind, tag=tag,
                                        ranks=list(ranks),
                                        elapsed_s=elapsed_s)


def fleet_scrape(ok):
    """One replica scrape attempt by a FleetMonitor finished."""
    reg = _registry()
    reg.counter("fleet.scrapes").inc()
    if not ok:
        reg.counter("fleet.scrape_failures").inc()


def fleet_replica_down(rank, generation, error):
    """A replica flipped to presumed-down (dead pid, stale past TTL,
    or scrape failures outliving the lease) -- the event NAMES the
    rank and generation so the page is actionable."""
    reg = _registry()
    reg.counter("fleet.replica_downs").inc()
    reg.event("fleet.replica_down").emit(rank=rank,
                                         generation=generation,
                                         error=error)


def fleet_round(agg):
    """One fleet aggregation round: publish the pooled view as gauges
    (obs.fleet.FleetMonitor)."""
    reg = _registry()
    reg.gauge("fleet.replicas").set(agg["replicas"])
    reg.gauge("fleet.replicas_down").set(agg["down"])
    if agg.get("qps") is not None:
        reg.gauge("fleet.qps").set(agg["qps"])
    reg.gauge("fleet.queue_depth").set(agg["queue_depth"])
    if agg.get("shed_ratio") is not None:
        reg.gauge("fleet.shed_ratio").set(agg["shed_ratio"])
    if agg.get("error_ratio") is not None:
        reg.gauge("fleet.error_ratio").set(agg["error_ratio"])
    lat = agg.get("latency_ms") or {}
    for q in ("p50", "p95", "p99"):
        if lat.get(q) is not None:
            reg.gauge("fleet.latency_%s_ms" % q).set(lat[q])
    skew = (agg.get("served_step") or {}).get("skew")
    if skew is not None:
        reg.gauge("fleet.served_step_skew").set(skew)


def fleet_alert(rule, state, reason, value):
    """One alert state transition (obs.alerts.AlertEngine)."""
    _registry().event("fleet.alert").emit(rule=rule, state=state,
                                          reason=reason, value=value)


def fleet_alerts_firing(n):
    """Currently-firing alert count (the pageable surface)."""
    _registry().gauge("fleet.alerts_firing").set(n)


class InstrumentInfo:
    """One catalogued instrument: (name, kind, subsystem, since-PR,
    meaning).  ``name`` may carry a ``<placeholder>`` segment for
    per-key instrument families (``chaos.injected.<point>``).  ``since``
    is the PR of the JAX package that added it."""

    __slots__ = ("name", "kind", "subsystem", "since", "doc")

    def __init__(self, name, kind, subsystem, since, doc):
        self.name = name
        self.kind = kind
        self.subsystem = subsystem
        self.since = since
        self.doc = doc


def _ii(name, kind, subsystem, since, doc):
    return InstrumentInfo(name, kind, subsystem, since, doc)


INSTRUMENTS = [
    _ii("trainer.step_time", "timer", "trainer", 2,
        "Trainer.step wall time"),
    _ii("trainer.steps", "counter", "trainer", 2,
        "optimizer steps taken"),
    _ii("trainer.samples", "counter", "trainer", 2,
        "samples pushed through step()"),
    _ii("trainer.samples_per_sec", "gauge", "trainer", 2,
        "throughput (Trainer.step + Speedometer)"),
    _ii("amp.overflow", "event", "amp", 2,
        "fp16 grad overflow (scale halved)"),
    _ii("amp.overflows", "counter", "amp", 2, "total overflow steps"),
    _ii("amp.rescale", "event", "amp", 2,
        "loss-scale growth after a clean window"),
    _ii("amp.loss_scale", "gauge", "amp", 2, "current loss scale"),
    _ii("numerics.checks", "counter", "numerics", 16,
        "non-finite sentinel checks run (MXNET_TPU_NUMERICS_CHECK=1)"),
    _ii("numerics.check_time", "timer", "numerics", 16,
        "host wall per sentinel check (the one boolean device_get)"),
    _ii("numerics.nonfinite_steps", "counter", "numerics", 16,
        "steps the sentinel attributed a NaN/Inf gradient on"),
    _ii("numerics.nonfinite", "event", "numerics", 16,
        "one per attributed non-finite step; payload names the first "
        "offending parameter, the step, and nan-vs-inf"),
    _ii("checkpoint", "event", "checkpoint", 2,
        "checkpoint save/restore; payload carries step/bytes/duration"),
    _ii("checkpoint.saves", "counter", "checkpoint", 3,
        "saves (incl. provisional)"),
    _ii("checkpoint.restores", "counter", "checkpoint", 3,
        "restores (preemption resume + manager)"),
    _ii("checkpoint.bytes_written", "counter", "checkpoint", 3,
        "bytes committed by saves"),
    _ii("checkpoint.bytes_read", "counter", "checkpoint", 3,
        "bytes loaded by restores"),
    _ii("checkpoint.save_time", "timer", "checkpoint", 3,
        "wall time serializing+committing a save"),
    _ii("checkpoint.restore_time", "timer", "checkpoint", 3,
        "wall time verifying+loading a restore"),
    _ii("checkpoint.async_wait", "timer", "checkpoint", 3,
        "time a save spent draining the previous in-flight async "
        "write"),
    _ii("checkpoint.quarantined", "counter", "checkpoint", 12,
        "verification-failed steps renamed step_<N>.corrupt during "
        "discovery"),
    _ii("checkpoint.write_retries", "counter", "checkpoint", 12,
        "async-writer attempts retried after a transient failure"),
    _ii("checkpoint.write_retry", "event", "checkpoint", 12,
        "one async-writer retry; payload carries attempt + error"),
    _ii("checkpoint.write_failures", "counter", "checkpoint", 12,
        "async writes that failed EVERY attempt (also re-raises at "
        "next save/wait; flips /healthz NOT_READY)"),
    _ii("checkpoint.write_failed", "event", "checkpoint", 12,
        "terminal async write failure; payload carries attempts + "
        "error"),
    _ii("checkpoint.quarantine", "event", "checkpoint", 12,
        "one quarantine rename; payload carries step + path"),
    _ii("sync.contention_wait", "timer", "sync", 5,
        "time blocked acquiring a contended lock (TSAN only; labeled "
        "by lock role)"),
    _ii("sync.hold_time", "timer", "sync", 5,
        "lock hold duration (TSAN only)"),
    _ii("sync.watchdog_fires", "counter", "sync", 5,
        "deadlock-watchdog expiries (TSAN only)"),
    _ii("sync.watchdog", "event", "sync", 5,
        "one watchdog expiry; payload names the lock"),
    _ii("sync.inversions", "counter", "sync", 5,
        "lock-order inversions observed (report-only mode)"),
    _ii("sync.inversion", "event", "sync", 5,
        "one inversion; payload carries outer/inner roles"),
    _ii("serving.requests", "counter", "serving", 8,
        "requests accepted by serving submit()"),
    _ii("serving.responses", "counter", "serving", 8,
        "responses scattered from dispatched batches"),
    _ii("serving.batches", "counter", "serving", 8,
        "compiled batch dispatches (mean occupancy = responses / "
        "batches)"),
    _ii("serving.batch_occupancy", "gauge", "serving", 8,
        "requests in the last dispatched batch (>1 = dynamic batching "
        "works)"),
    _ii("serving.queue_depth", "gauge", "serving", 8,
        "request-queue depth at last submit"),
    _ii("serving.shed", "counter", "serving", 8,
        "submits rejected by a full queue (ServingQueueFull)"),
    _ii("serving.timeouts", "counter", "serving", 8,
        "requests expired while queued (RequestTimeout)"),
    _ii("serving.latency", "timer", "serving", 8,
        "per-request round trip submit -> response (the SLO metric)"),
    _ii("serving.dispatch_time", "timer", "serving", 8,
        "compiled-call + device_get wall per batch (reconciles with "
        "the serving.dispatch + serving.device_get trace spans)"),
    _ii("serving.warmup_time", "timer", "serving", 8,
        "per-servable registration warm-up"),
    _ii("serving.models", "counter", "serving", 8,
        "servables registered"),
    _ii("serving.register", "event", "serving", 8,
        "one servable registration; payload carries source + buckets"),
    _ii("serving.compile_cache_hits", "counter", "serving", 8,
        "bucket executables served from the persistent compile cache"),
    _ii("serving.compile_cache_misses", "counter", "serving", 8,
        "bucket executables compiled fresh"),
    _ii("serving.compile_evictions", "counter", "serving", 8,
        "Predictor per-shape jit programs evicted by the LRU bound"),
    _ii("serving.swaps", "counter", "serving", 12,
        "successful hot-swaps to a newer verified step"),
    _ii("serving.swap_failures", "counter", "serving", 12,
        "swap attempts that aborted (previous servable kept serving)"),
    _ii("serving.swap_time", "timer", "serving", 12,
        "wall per successful swap (restore + warm + install + drain)"),
    _ii("serving.swap", "event", "serving", 12,
        "one swap attempt; payload carries step/ok/attempt/error "
        "(the /statusz swap history)"),
    _ii("serving.served_step", "gauge", "serving", 12,
        "checkpoint step the live servable was loaded from"),
    _ii("serving.watcher_suspensions", "counter", "serving", 13,
        "watchers that exhausted the swap failure budget and went "
        "terminal"),
    _ii("serving.watcher_suspended", "event", "serving", 13,
        "the terminal suspension; payload names model/step/budget -- "
        "alert on this, /healthz reads NOT_READY off the same state"),
    _ii("train_loop.publishes", "counter", "serving", 12,
        "checkpoints published by ContinuousTrainer"),
    _ii("train_loop.published_step", "gauge", "serving", 12,
        "newest step the trainer published"),
    _ii("train_loop.publish", "event", "serving", 12,
        "one publish; payload carries step + seconds"),
    _ii("preemption.reentrant_signals", "counter", "preemption", 12,
        "re-entrant SIGTERM deliveries suppressed mid-commit"),
    _ii("chaos.injected", "counter", "chaos", 12,
        "faults injected by armed fail points"),
    _ii("chaos.injected.<point>", "counter", "chaos", 12,
        "per-point injected count"),
    _ii("chaos.inject", "event", "chaos", 12,
        "one injection; payload carries point + action"),
    _ii("chaos.survived", "counter", "chaos", 12,
        "faults tolerated by a recovery path (injected or real)"),
    _ii("chaos.survived.<point>", "counter", "chaos", 12,
        "per-point survived count"),
    _ii("chaos.survive", "event", "chaos", 12,
        "one tolerated fault; payload carries point + how"),
    _ii("checkpoint.commit_aborted", "counter", "checkpoint", 15,
        "sharded saves that aborted cleanly on a rank failure "
        "(staging swept, manifest never committed -- the rank-death-"
        "safe commit contract)"),
    _ii("checkpoint.commit_abort", "event", "checkpoint", 15,
        "one clean abort; payload carries step/reason/rank"),
    _ii("serving.errors", "counter", "serving", 17,
        "compiled dispatches that raised (requests failed, worker "
        "survived) -- the fleet error_ratio numerator"),
    _ii("decode.requests", "counter", "serving", 18,
        "generation requests admitted to a decode engine"),
    _ii("decode.queue_depth", "gauge", "serving", 18,
        "generation requests waiting for a decode slot"),
    _ii("decode.shed", "counter", "serving", 18,
        "generation requests shed at admission (queue full or KV "
        "budget unavailable; never mid-generation)"),
    _ii("decode.shed.<reason>", "counter", "serving", 18,
        "per-reason shed count (queue / kvcache)"),
    _ii("decode.prefills", "counter", "serving", 18,
        "prompt prefill calls (one per admitted request)"),
    _ii("decode.prefill_time", "timer", "serving", 18,
        "prefill call wall time, tagged bucket + prompt_len"),
    _ii("decode.steps", "counter", "serving", 18,
        "continuous-batching decode iterations"),
    _ii("decode.tokens", "counter", "serving", 18,
        "tokens decoded (occupancy summed over steps)"),
    _ii("decode.occupancy", "gauge", "serving", 18,
        "live sequences in the running decode batch"),
    _ii("decode.step_time", "timer", "serving", 18,
        "decode iteration wall time, tagged bucket + occupancy"),
    _ii("decode.ttft", "timer", "serving", 18,
        "submit -> first streamed token (product-layer TTFT)"),
    _ii("decode.inter_token", "timer", "serving", 18,
        "gap between consecutive streamed tokens of one request"),
    _ii("decode.finished", "counter", "serving", 18,
        "generations finished (any reason)"),
    _ii("decode.finish", "event", "serving", 18,
        "one finished generation; payload carries reason (eos/length/"
        "cancel/timeout/error/closed) + token count"),
    _ii("kvcache.allocs", "counter", "serving", 18,
        "block-table allocations (one per admitted request)"),
    _ii("kvcache.frees", "counter", "serving", 18,
        "block tables returned (EOS/length/cancel/timeout/error)"),
    _ii("kvcache.alloc_failures", "counter", "serving", 18,
        "allocations refused for too few free blocks (admission-shed "
        "trigger)"),
    _ii("kvcache.blocks_in_use", "gauge", "serving", 18,
        "KV cache blocks currently allocated across live sequences"),
    _ii("kvcache.fragmentation", "gauge", "serving", 18,
        "unused fraction of allocated KV blocks (internal "
        "fragmentation; at worst one partial block per sequence)"),
    _ii("dispatch.op_calls", "counter", "ndarray", 2,
        "imperative op invocations (total)"),
    _ii("dispatch.op.<op>", "counter", "ndarray", 2,
        "per-op invocation count"),
    _ii("dispatch.host_sync", "counter", "ndarray", 2,
        "host sync points (asnumpy/wait/waitall)"),
    _ii("dispatch.host_sync.<kind>", "counter", "ndarray", 2,
        "per-kind sync count"),
    _ii("compile", "event", "compile", 2,
        "one per XLA trace/compile; payload says where and why "
        "(cache-key diff on retrace)"),
    _ii("compile.count", "counter", "compile", 2, "total compiles"),
    _ii("compile.retraces", "counter", "compile", 2,
        "compiles that REPLACED warm cache state"),
    _ii("compile.build_time", "timer", "compile", 2,
        "wall time spent tracing/compiling"),
    _ii("data.batches", "counter", "dataio", 2,
        "batches produced by DataLoader"),
    _ii("data.wait_time", "timer", "dataio", 2,
        "consumer wait per batch (input starvation when this rivals "
        "step_time)"),
    _ii("feed.batches", "counter", "dataio", 4,
        "batches staged by dataio.DeviceFeed"),
    _ii("feed.bytes_staged", "counter", "dataio", 4,
        "bytes shipped host->device by the feed"),
    _ii("feed.producer_busy", "timer", "dataio", 4,
        "per-batch producer time (host batch + async device_put "
        "issue)"),
    _ii("feed.consumer_wait", "timer", "dataio", 4,
        "per-batch consumer wait on the staging queue"),
    _ii("feed.overlap_frac", "gauge", "dataio", 4,
        "share of producer time hidden behind compute: 1 - wait/busy"),
    _ii("memory.censuses", "counter", "memory", 19,
        "live-buffer censuses run (MXNET_TPU_MEMORY_WATCH=1)"),
    _ii("memory.live_bytes", "gauge", "memory", 19,
        "total bytes of jax.live_arrays() at the last census"),
    _ii("memory.live_arrays", "gauge", "memory", 19,
        "live device-array count at the last census"),
    _ii("memory.leaks", "counter", "memory", 19,
        "windows the leak sentinel flagged monotonic live-bytes "
        "growth on"),
    _ii("memory.leak", "event", "memory", 19,
        "one per flagged leak window; payload names the top-growing "
        "shape/dtype bucket, the growth bytes, and the window index"),
    _ii("profiling.reports", "counter", "profiling", 6,
        "CostReports materialized by the mx.profiling store"),
    _ii("profiling.capture_time", "timer", "profiling", 6,
        "wall time lowering/parsing one report"),
    _ii("profiling.capture", "event", "profiling", 6,
        "one per report; payload carries label + FLOPs"),
    _ii("profiling.step_time", "timer", "profiling", 6,
        "per-dispatch step wall recorded by TrainStep (feeds the "
        "roofline)"),
    _ii("dispatch.host_sync_time", "timer", "ndarray", 14,
        "wall the host spent blocked on device results "
        "(asnumpy/wait_to_read/waitall) -- the goodput ledger's "
        "host_sync category"),
    _ii("goodput.windows", "counter", "goodput", 14,
        "StepLedger windows closed"),
    _ii("goodput.steps", "counter", "goodput", 14,
        "training steps attributed by the ledger"),
    _ii("goodput.<category>_s", "timer", "goodput", 14,
        "per-window seconds attributed to the category "
        "(device_compute/input_wait/host_sync/checkpoint_stall/"
        "recompile/other); timer sums give per-rank category totals "
        "offline"),
    _ii("goodput.<category>_share", "gauge", "goodput", 14,
        "last window's share of wall per category"),
    _ii("goodput.mfu", "gauge", "goodput", 14,
        "rolling MFU: window flops (executable cost report) / wall / "
        "device peak"),
    _ii("goodput.reconciliation_error", "gauge", "goodput", 14,
        "last window's attribution overshoot vs wall (0 unless "
        "categories double-count; CI gates <= tol)"),
    _ii("goodput.window", "event", "goodput", 14,
        "one closed window; payload carries steps/wall/shares/mfu + "
        "the bottleneck verdict sentence"),
    _ii("goodput.regressions", "counter", "goodput", 14,
        "windows where the sentinel flagged a category vs its "
        "EWMA+MAD baseline"),
    _ii("goodput.regression", "event", "goodput", 14,
        "one flagged regression; payload NAMES the category that "
        "moved (per-step seconds vs baseline, ratio)"),
    _ii("goodput.env_degraded_windows", "counter", "goodput", 14,
        "windows the sentinel attributed to a degraded environment "
        "(env guard) instead of a regression"),
    _ii("goodput.env_degraded", "event", "goodput", 14,
        "one env-guarded window; payload carries the dispatch RTT -- "
        "must agree with the bench line's degraded_env flag"),
    _ii("supervisor.restarts", "counter", "supervisor", 15,
        "elastic world relaunches after a rank death "
        "(tools/launch.py --supervise)"),
    _ii("supervisor.generation", "gauge", "supervisor", 15,
        "current supervisor generation id (namespaces the "
        "coordination-KV keys; bumped on every relaunch)"),
    _ii("supervisor.restart", "event", "supervisor", 15,
        "one relaunch; payload carries generation/dead rank/exit "
        "code/restart count"),
    _ii("supervisor.budget_exhausted", "counter", "supervisor", 15,
        "supervisors whose restart budget ran out (terminal; "
        "/healthz reads NOT_READY)"),
    _ii("supervisor.exhausted", "event", "supervisor", 15,
        "the terminal budget exhaustion; payload carries generation + "
        "budget -- alert on this"),
    _ii("env.dispatch_roundtrip_us", "gauge", "bench", 13,
        "bench env-health dispatch round trip (the degraded_env "
        "basis)"),
    _ii("env.h2d_mb_per_s", "gauge", "bench", 13,
        "bench env-health host->device bandwidth"),
    _ii("env.health", "event", "bench", 13,
        "one env-health probe; payload carries both numbers"),
    _ii("kvstore.push", "counter", "kvstore", 2,
        "kvstore push calls"),
    _ii("kvstore.pull", "counter", "kvstore", 2,
        "kvstore pull calls"),
    _ii("kvstore.pushpull", "counter", "kvstore", 2,
        "kvstore fused pushpull calls"),
    _ii("kvstore.bytes", "counter", "kvstore", 2,
        "gradient bytes moved through kvstore (ZERO on the SPMD hot "
        "path -- gradients reduce in-graph)"),
    _ii("kvstore.time", "timer", "kvstore", 2,
        "wall time in pushpull (dispatch side)"),
    _ii("dist.collectives", "counter", "distributed", 9,
        "host-side cross-process collectives issued"),
    _ii("dist.<kind>", "counter", "distributed", 9,
        "per-kind collective count (allreduce/broadcast/...)"),
    _ii("dist.bytes", "counter", "distributed", 9,
        "bytes moved by host collectives"),
    _ii("dist.tensors_coalesced", "counter", "distributed", 9,
        "tensors folded into bucketed collectives (vs dist.collectives "
        "= the coalescing win)"),
    _ii("dist.rank_failures", "counter", "distributed", 15,
        "host collectives/barriers that gave up on peer rank(s) -- "
        "surfaced as typed RankFailure/BarrierTimeout naming the "
        "rank, never a raw jaxlib deadline"),
    _ii("dist.rank_failure", "event", "distributed", 15,
        "one attributed failure; payload carries kind/tag/ranks/"
        "elapsed"),
    _ii("fleet.scrapes", "counter", "fleet", 17,
        "replica scrape attempts by a FleetMonitor"),
    _ii("fleet.scrape_failures", "counter", "fleet", 17,
        "scrape attempts that failed every retry"),
    _ii("fleet.replicas", "gauge", "fleet", 17,
        "replicas currently tracked by the monitor"),
    _ii("fleet.replicas_down", "gauge", "fleet", 17,
        "replicas presumed down (dead pid / stale past TTL)"),
    _ii("fleet.replica_downs", "counter", "fleet", 17,
        "down transitions observed"),
    _ii("fleet.replica_down", "event", "fleet", 17,
        "one down transition; payload NAMES rank + generation + the "
        "last scrape error"),
    _ii("fleet.qps", "gauge", "fleet", 17,
        "pooled accepted-request rate over the rolling window"),
    _ii("fleet.queue_depth", "gauge", "fleet", 17,
        "summed request-queue depth across up replicas"),
    _ii("fleet.shed_ratio", "gauge", "fleet", 17,
        "shed / (accepted + shed) over the rolling window"),
    _ii("fleet.error_ratio", "gauge", "fleet", 17,
        "(errors + timeouts) / responses over the rolling window"),
    _ii("fleet.latency_<q>_ms", "gauge", "fleet", 17,
        "fleet latency percentile (p50/p95/p99) from MERGED Timer "
        "histogram buckets across replicas -- never an average of "
        "per-replica percentiles"),
    _ii("fleet.served_step_skew", "gauge", "fleet", 17,
        "max - min served checkpoint step across up replicas"),
    _ii("fleet.alerts_firing", "gauge", "fleet", 17,
        "currently-firing SLO alerts (page while > 0; mxtelemetry "
        "fleet exits 1)"),
    _ii("fleet.alert", "event", "fleet", 17,
        "one alert state transition (pending/firing/resolved/"
        "cancelled); payload carries rule + reason naming the "
        "replica"),
]


def instrument_index_md():
    """The markdown instrument index of :data:`INSTRUMENTS`."""
    lines = ["| Instrument | Kind | Subsystem | Since | Meaning |",
             "|---|---|---|---|---|"]
    for ii in INSTRUMENTS:
        lines.append("| `%s` | %s | %s | PR %d | %s |"
                     % (ii.name, ii.kind, ii.subsystem, ii.since,
                        ii.doc))
    return "\n".join(lines) + "\n"


_INDEX_BEGIN = "<!-- instrument-index:begin (generated; do not edit" \
    " -- python -c 'from mxnet_tpu_torch.telemetry import hooks; " \
    "hooks.update_observability_doc(PATH)') -->"
_INDEX_END = "<!-- instrument-index:end -->"


def update_observability_doc(path=None):
    """Regenerate the instrument index (:func:`instrument_index_md`)
    between the markers of the observability doc at ``path`` and return
    the new text.  The port keeps no observability doc of its own, so
    without ``path`` -- or when ``path`` does not exist or lacks the
    markers -- it raises :class:`MXNetError` naming the doc."""
    import os
    from ..base import MXNetError
    if path is None or not os.path.exists(path):
        raise MXNetError(
            "update_observability_doc: no observability doc %s: the port "
            "keeps none of its own; pass the path of a doc with the "
            "instrument-index markers" % (path or "(none given)"))
    with open(path) as f:
        text = f.read()
    try:
        head, rest = text.split(_INDEX_BEGIN, 1)
        _old, tail = rest.split(_INDEX_END, 1)
    except ValueError:
        raise MXNetError("update_observability_doc: observability doc %s "
                         "is missing the instrument-index markers" % path)
    new = (head + _INDEX_BEGIN + "\n" + instrument_index_md()
           + _INDEX_END + tail)
    with open(path, "w") as f:
        f.write(new)
    return new
