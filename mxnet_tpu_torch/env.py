"""Typed registry of the ``MXNET_*`` environment variables the port reads.

Counterpart of ``mxnet_tpu/env.py``, holding only the variables the
port reads: checkpoints, serving and the always-on loop, the numerics
sentinel, the device feed, telemetry, tracing, chaos, the concurrency
sanitizer, the ops plane (profiling, the goodput ledger, the leak
sentinel, the flight recorder, the obs server and the supervisor), the
multi-process world (barriers, leases, store retries) and the fleet
plane.  Names, defaults and the boolean convention (only ``"0"`` is
false) are the JAX package's, so one environment configures both.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

from .base import MXNetError

__all__ = ["EnvVar", "REGISTRY", "get"]


@dataclass(frozen=True)
class EnvVar:
    name: str
    type: Callable
    default: Any
    doc: str

    def read(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        try:
            if self.type is bool:
                return raw != "0"
            return self.type(raw)
        except (TypeError, ValueError) as e:
            raise MXNetError("env var %s=%r is not a valid %s"
                             % (self.name, raw, self.type.__name__)) from e


_VARS = [
    EnvVar("MXNET_TPU_CKPT_ASYNC", bool, False,
           "'1' makes CheckpointManager saves asynchronous by default: "
           "the state is copied to host memory at save(), then "
           "serialized and committed on a background thread.  "
           "Per-manager override: CheckpointManager(async_save=...)."),
    EnvVar("MXNET_TPU_CKPT_MAX_TO_KEEP", int, 0,
           "Default retention for CheckpointManager: keep at most this "
           "many step checkpoints (steps matching keep_every_n_steps "
           "are exempt).  0 keeps everything."),
    EnvVar("MXNET_TPU_SERVING_BUCKETS", str, "1,2,4,8,16,32",
           "Default padded batch buckets of a fixed-shape servable: a "
           "micro-batch of n requests pads to the smallest bucket >= n; "
           "every bucket is warmed at registration.  Per-servable "
           "override: ModelRegistry.register(buckets=...)."),
    EnvVar("MXNET_TPU_SERVING_MAX_WAIT_MS", float, 5.0,
           "Micro-batch assembly deadline (milliseconds): a batch "
           "dispatches when the largest bucket fills or the oldest "
           "queued request has waited this long.  Per-servable "
           "override: ModelRegistry.register(max_wait_ms=...)."),
    EnvVar("MXNET_TPU_SERVING_QUEUE", int, 256,
           "Bounded request-queue depth per servable; a submit against "
           "a full queue raises ServingQueueFull."),
    EnvVar("MXNET_TPU_SERVING_KV_BLOCK", int, 16,
           "Tokens per KV-cache block.  Per-model override: "
           "register_generative(block_size=...)."),
    EnvVar("MXNET_TPU_SERVING_KV_BLOCKS", int, 512,
           "Preallocated KV-cache blocks per generative servable "
           "(block 0 is the scratch block).  Per-model override: "
           "register_generative(num_blocks=...)."),
    EnvVar("MXNET_TPU_SERVING_DECODE_BUCKETS", str, "1,2,4,8",
           "Slot-count buckets of the continuous-batching decode step; "
           "the largest bounds concurrent sequences."),
    EnvVar("MXNET_TPU_NUMERICS_CHECK", bool, False,
           "'1' arms the non-finite sentinel (analysis.numerics): "
           "TrainStep reads its step's finite flag once after the step "
           "and, on the first non-finite step, recomputes the gradients "
           "from the kept weights to name WHICH parameter went NaN/Inf, "
           "then raises NonFiniteError.  Off: no host read."),
    EnvVar("MXNET_TPU_SERVING_PREFILL_BUCKETS", str, "16,32,64,128",
           "Prompt-length buckets of prefill (batch 1); the largest is "
           "the longest admissible prompt."),
    EnvVar("MXNET_TPU_FEED_DEPTH", int, 2,
           "Default bounded-queue depth of mx.dataio.DeviceFeed: how "
           "many landed batches the background producer may run ahead "
           "of the consumer (its pinned ring holds one slot more).  2 = "
           "double buffering.  Per-feed override: "
           "DeviceFeed(depth=...)."),
    EnvVar("MXNET_TPU_FEED_COMPACT", bool, True,
           "Ship feed batches to the card in their compact source dtype "
           "(uint8 stays uint8 -- 4x less copy traffic than its float32 "
           "cast) and expand them there with the feed's transform.  "
           "'0' casts on the host to the transform's dtype before the "
           "copy (A/B numerics debugging).  Per-feed override: "
           "DeviceFeed(compact=...)."),
    EnvVar("MXNET_CHECKPOINT_ON_SIGTERM", str, "",
           "Checkpoint prefix used by preemption.install() when no "
           "prefix argument is given: SIGTERM drains pending work and "
           "writes <prefix>-preempt.params/.states/.meta before exit."),
    EnvVar("MXNET_TPU_TELEMETRY", bool, False,
           "'1' enables the runtime telemetry subsystem (telemetry) at "
           "import: counters/timers/events over serving, decode, "
           "checkpoints, the trainer, AMP, the numerics sentinel, "
           "chaos and preemption.  Off (the default), every hook is a "
           "single module-flag check with zero instrument calls.  "
           "Runtime toggle: telemetry.enable()/disable()."),
    EnvVar("MXNET_TPU_TELEMETRY_JSONL", str, "",
           "Path of the telemetry JSONL run log, attached at import "
           "(events and timer samples stream; the aggregate snapshot "
           "lands at exit or telemetry.flush())."),
    EnvVar("MXNET_TPU_TSAN", bool, False,
           "'1' arms the concurrency sanitizer (sync): every "
           "Lock/RLock/Condition/Event the framework creates records "
           "per-thread acquisition stacks, keeps the lock-order graph "
           "and raises LockOrderError on an A/B-B/A inversion, and "
           "time-bounds every untimed blocking acquisition/wait with a "
           "deadlock watchdog that dumps all thread stacks.  Off (the "
           "default), the factories return raw threading primitives."),
    EnvVar("MXNET_TPU_TSAN_WATCHDOG_S", float, 20.0,
           "Deadlock-watchdog budget (seconds) for untimed lock "
           "acquisitions and Condition/Event waits under "
           "MXNET_TPU_TSAN=1."),
    EnvVar("MXNET_TPU_CKPT_QUARANTINE", bool, True,
           "Checkpoint discovery quarantine: a step that fails "
           "manifest/CRC verification during "
           "CheckpointManager.latest_step() is renamed step_<N>.corrupt "
           "(counted in checkpoint.quarantined) instead of silently "
           "skipped.  '0' restores skip-only discovery.  Per-manager "
           "override: CheckpointManager(quarantine=...)."),
    EnvVar("MXNET_TPU_CKPT_WRITE_RETRIES", int, 2,
           "How many times the async checkpoint writer retries a failed "
           "background write (exponential backoff from "
           "MXNET_TPU_CKPT_RETRY_BACKOFF_S) before surfacing the error "
           "through the checkpoint.write_failed telemetry event and the "
           "next save()/wait_until_finished().  Per-writer override: "
           "AsyncWriter(retries=...)."),
    EnvVar("MXNET_TPU_CKPT_RETRY_BACKOFF_S", float, 0.25,
           "Initial backoff (seconds) between async checkpoint write "
           "retries; doubles per attempt."),
    EnvVar("MXNET_TPU_CHAOS_SEED", int, 0,
           "Default seed for chaos.arm(): per-rule probability streams "
           "derive from (seed, fail point, rule index), so a chaos "
           "scenario replays identically for a fixed seed.  Chaos is "
           "only ever armed programmatically."),
    EnvVar("MXNET_TPU_CHAOS_SPEC", str, "",
           "Serialized chaos scenario (chaos.make_spec() JSON) that a "
           "launched process replays only by calling "
           "chaos.arm_from_spec(); never arms anything by itself."),
    EnvVar("MXNET_TPU_SERVING_POLL_S", float, 0.5,
           "RegistryWatcher poll interval (seconds).  Per-watcher "
           "override: RegistryWatcher(poll_s=...)."),
    EnvVar("MXNET_TPU_SERVING_SWAP_RETRIES", int, 2,
           "How many times a RegistryWatcher retries an aborted "
           "hot-swap (exponential backoff from "
           "MXNET_TPU_SERVING_SWAP_BACKOFF_S) before marking the step "
           "bad and keeping the previous model in service."),
    EnvVar("MXNET_TPU_SERVING_SWAP_BACKOFF_S", float, 0.25,
           "Initial backoff (seconds) between hot-swap retries; doubles "
           "per attempt."),
    EnvVar("MXNET_TPU_SERVING_SWAP_BUDGET", int, 3,
           "RegistryWatcher failure budget: after this many CONSECUTIVE "
           "steps fail to swap (each already retried), the watcher "
           "suspends itself instead of flapping; the last good model "
           "keeps serving."),
    EnvVar("MXNET_TPU_OBS_TRACE", bool, False,
           "'1' arms request/step tracing (obs): trace/span IDs through "
           "the serving path and the training loop, streamed into the "
           "telemetry sinks as span records and exportable as "
           "Chrome-trace JSON (obs.export_chrome_trace).  Off (the "
           "default), every traced site is a single module-flag check."),
    EnvVar("MXNET_TPU_OBS_GOODPUT", bool, False,
           "'1' arms the goodput ledger (obs.goodput): the "
           "ContinuousTrainer loop ticks a per-process StepLedger that "
           "splits every rolling window of training steps into "
           "device_compute / input_wait / host_sync / checkpoint_stall "
           "/ recompile / other (reconciled to the window wall within "
           "MXNET_TPU_OBS_GOODPUT_TOL), publishes a rolling MFU gauge "
           "and runs the EWMA+MAD regression sentinel (goodput.* "
           "instruments, the statusz goodput row).  Needs "
           "MXNET_TPU_TELEMETRY=1 for non-empty attribution.  Off (the "
           "default): one module-flag check per loop step.  Runtime "
           "toggle: obs.enable_goodput()/disable_goodput()."),
    EnvVar("MXNET_TPU_OBS_GOODPUT_WINDOW", int, 20,
           "Training steps per goodput-ledger window (and per "
           "leak-sentinel census).  Per-ledger override: "
           "StepLedger(window_steps=...)."),
    EnvVar("MXNET_TPU_OBS_GOODPUT_TOL", float, 0.25,
           "Reconciliation tolerance of the goodput ledger: the "
           "attributed categories may exceed the window wall by at most "
           "this fraction ('other' absorbs undershoot, so only "
           "overshoot -- double counting -- fails a window)."),
    EnvVar("MXNET_TPU_OBS_GOODPUT_MAD_K", float, 4.0,
           "Regression-sentinel sensitivity: a category regresses when "
           "its per-step seconds exceed the EWMA mean by this many EWMA "
           "absolute deviations (and move at least 5% of the window "
           "wall).  Per-ledger override: StepLedger(mad_k=...)."),
    EnvVar("MXNET_TPU_MEMORY_WATCH", bool, False,
           "'1' arms the live-memory leak sentinel "
           "(analysis.memory.LeakSentinel): ContinuousTrainer takes a "
           "census at every goodput-window boundary -- the caching "
           "allocator's allocated bytes and blocks on the card (graph "
           "pools included), the live tensors on the CPU -- into the "
           "memory.live_bytes / memory.live_arrays gauges, and flags "
           "monotonic growth past the EWMA+MAD baseline, naming the "
           "top-growing shape/dtype bucket (the live tensors are walked "
           "only when a window flags).  Publish-guarded.  Off: one "
           "module-flag check, no per-step work."),
    EnvVar("MXNET_TPU_PROFILING", bool, False,
           "'1' enables step cost accounting (mx.profiling) at import: "
           "each hybridized block's and TrainStep key's warm-up (eager) "
           "run is walked op by op into a CostReport (flops and bytes by "
           "category, hand kernels by their cost functions), TrainStep "
           "dispatch walls feed the roofline, and host spans land on the "
           "Chrome-trace step timeline.  Off (the default), every hook "
           "is a single module-flag check.  Runtime toggle: "
           "mx.profiling.enable()/disable(); render with the mxprof "
           "CLI."),
    EnvVar("MXNET_TPU_PROFILING_DIR", str, "",
           "Directory for mx.profiling CostReport artifacts.  When set "
           "(with profiling enabled), per-report *.cost.json files and "
           "the combined report.json are written at interpreter exit "
           "(and by mx.profiling.save_reports()); 'mxprof report' and "
           "'mxprof diff' read them."),
    EnvVar("MXNET_TPU_OBS_BLACKBOX", str, "",
           "Path of the crash-safe flight recorder (obs.flight).  When "
           "set, an mmap'd ring of the most recent telemetry records "
           "and spans is installed at import and survives "
           "os._exit/SIGKILL; the preemption handler, the chaos KILL "
           "path and SIGUSR2 (with every thread's stack) mark and "
           "msync it.  Render with 'mxtelemetry blackbox <path>'."),
    EnvVar("MXNET_TPU_OBS_BLACKBOX_KB", int, 256,
           "Flight-recorder ring capacity in KiB.  Per-recorder "
           "override: obs.install_blackbox(capacity=...)."),
    EnvVar("MXNET_TPU_OBS_PORT", int, 0,
           "Port of the introspection HTTP server (obs.server, "
           "localhost): /healthz (READY/NOT_READY), /metrics "
           "(Prometheus text of the live registry), /statusz (the "
           "operator JSON), /alertz.  0 (the default) = not started; "
           "obs.serve(0) binds an ephemeral port."),
    EnvVar("MXNET_TPU_GENERATION", int, 0,
           "Supervisor generation of this worker world, bumped by the "
           "restart supervisor (supervisor.Supervisor, python -m "
           "mxnet_tpu_torch.launch --supervise) on every relaunch.  "
           "Namespaces every coordination-store key (barriers, leases), "
           "and statusz and the endpoint files carry it."),
    EnvVar("MXNET_TPU_DIST_BARRIER_TIMEOUT_MS", int, 60000,
           "Default bound on every attributed barrier rendezvous "
           "(distributed.barrier and the sharded-checkpoint commit "
           "gates), and the gloo process group's timeout.  On expiry "
           "survivors raise a typed BarrierTimeout naming the missing "
           "rank(s).  Per-call override: barrier(timeout_ms=...)."),
    EnvVar("MXNET_TPU_DIST_LEASE_TTL_S", float, 10.0,
           "Liveness-lease staleness bound: a rank whose "
           "mxlive/g<gen>/<rank> store key is older than this (or "
           "absent) is reported 'presumed dead' in "
           "BarrierTimeout/RankFailure attribution.  The training "
           "loop beats the lease every step; every barrier entry "
           "refreshes it too."),
    EnvVar("MXNET_TPU_DIST_KV_RETRIES", int, 2,
           "Bounded retries (doubling backoff from 50 ms) for "
           "transient coordination-store errors in barriers, leases "
           "and aborts.  Deadline expiries are not transient -- they "
           "attribute a missing peer and raise typed errors "
           "immediately.  0 disables retries."),
    EnvVar("MXNET_TPU_SUPERVISOR_RESTARTS", int, 3,
           "Restart budget: how many times the supervisor relaunches "
           "the workers after a death before going terminal "
           "(supervisor.exhausted event, /healthz NOT_READY).  "
           "Per-supervisor override: Supervisor(max_restarts=...)."),
    EnvVar("MXNET_TPU_SUPERVISOR_GRACE_S", float, 15.0,
           "After the first worker exit of a generation, how long the "
           "supervisor waits for the others to exit on their own "
           "before killing the process tree."),
    EnvVar("MXNET_TPU_OBS_ENDPOINTS_DIR", str, "",
           "Endpoint-discovery directory: every obs server atomically "
           "publishes its {pid, rank, generation, port} there on "
           "serve() and withdraws it on stop(); the supervisor threads "
           "it into every launched worker.  Empty (the default) "
           "disables publication."),
    EnvVar("MXNET_TPU_OBS_SCRAPE_MS", float, 1000.0,
           "FleetMonitor scrape interval in milliseconds.  The "
           "presumed-down TTL defaults to 3x this, so a replica that "
           "stops answering is declared down within ~3 scrape "
           "rounds."),
    EnvVar("MXNET_TPU_OBS_ALERT_RULES", str, "",
           "JSON list of SLO alert-rule overrides merged onto the "
           "stock rules by name (obs.alerts.parse_rules): e.g. "
           "'[{\"name\": \"p99_latency_ms\", \"threshold\": 250}]'.  "
           "Unparseable specs raise loudly -- a silently-ignored "
           "alert config is the worst failure mode an alerting plane "
           "can have."),
]

REGISTRY = {v.name: v for v in _VARS}


def get(name):
    """Typed read of a registered variable (its default when unset)."""
    try:
        var = REGISTRY[name]
    except KeyError:
        raise MXNetError("unregistered env var %r" % name) from None
    return var.read()
