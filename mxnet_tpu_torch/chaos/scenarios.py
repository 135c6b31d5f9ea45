"""Composed chaos scenarios (counterpart of
``mxnet_tpu/chaos/scenarios.py``): the experiments the tests share.

Each scenario is deterministic for a fixed seed, runs on the CPU in a
few seconds (``device="cpu"``; the card by default, as every entry point
of the port), and returns a plain report dict the caller gates on; the
assertions live with the callers, so a failure names the violated
contract, not just "scenario failed".
"""
from __future__ import annotations

import os
import threading
import time
import warnings

import numpy as np

from . import core as chaos

__all__ = ["make_mlp", "train_fixtures", "corrupt_dirs",
           "hotswap_scenario", "flood_scenario"]

# a client thread that outlives this is a hung swap, not a slow one
_JOIN_S = 120.0


def make_mlp(in_dim=8, hidden=16, out=4, device=None):
    """A tiny MLP, hybridized and sized by one probe forward (the
    scenario workhorse: params small enough to checkpoint per step)."""
    import torch
    from .. import autograd, gluon
    from ..context import resolve_device
    dev = resolve_device(device)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(hidden, activation="relu"),
            gluon.nn.Dense(out))
    net.initialize(force_reinit=True, device=dev)
    net.hybridize()
    with autograd.pause():
        net(torch.zeros((1, in_dim), device=dev))
    return net


def train_fixtures(seed=0, in_dim=8, out=4, batch=8, device=None):
    """(net, trainer, loss_fn, (x, y)) for a ContinuousTrainer; the
    batch is the JAX package's for the seed (numpy's RandomState)."""
    from .. import gluon
    from ..context import resolve_device
    from ..ndarray import NDArray
    import torch
    dev = resolve_device(device)
    net = make_mlp(in_dim=in_dim, out=out, device=dev)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05}, kvstore=None)
    loss_fn = gluon.loss.L2Loss()
    rng = np.random.RandomState(seed)
    x = NDArray(torch.from_numpy(
        rng.rand(batch, in_dim).astype(np.float32)).to(dev))
    y = NDArray(torch.from_numpy(
        rng.rand(batch, out).astype(np.float32)).to(dev))
    return net, trainer, loss_fn, (x, y)


def corrupt_dirs(root):
    """The ``step_*.corrupt`` quarantine dirs under a checkpoint root."""
    try:
        return sorted(d for d in os.listdir(root)
                      if d.endswith(".corrupt"))
    except OSError:
        return []


def _join(threads):
    for t in threads:
        t.join(_JOIN_S)
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        from ..base import MXNetError
        raise MXNetError("chaos scenario: threads %s still running after "
                         "%.0f s" % (hung, _JOIN_S))


def hotswap_scenario(root, torn=False, seed=0, clients=3,
                     requests_per_client=20, publish_every=2,
                     buckets=(1, 2, 4), max_wait_ms=2.0,
                     request_timeout=30.0, device=None):
    """Continuous-train -> hot-swap under concurrent client load.

    Phase 1 trains and publishes step ``publish_every``; the watcher
    swaps it in.  Client threads then send ``registry.infer`` throughout
    phase 2, which trains and publishes step ``2 * publish_every`` --
    torn after its commit by an armed chaos rule when ``torn=True`` --
    and the watcher polls again.

    Report keys: ``served_step`` (the rollback proof: stays at the first
    step when the newer one is torn), ``published_step``,
    ``quarantined`` (the ``*.corrupt`` renames), ``completed`` /
    ``shed`` / ``errors`` per-request outcomes (the zero-dropped proof),
    ``completed_after_swap``, and ``chaos`` stats.
    """
    from .. import serving
    from ..context import resolve_device
    from ..serving.loop import ContinuousTrainer, RegistryWatcher

    dev = resolve_device(device)
    net, trainer, loss_fn, data = train_fixtures(seed=seed, device=dev)
    mgr_root = os.fspath(root)
    ct = ContinuousTrainer(net, trainer, loss_fn, data, mgr_root,
                           publish_every=publish_every)
    reg = serving.ModelRegistry(compile_cache=False)
    watcher = RegistryWatcher(reg, "model", ct.manager,
                              make_mlp(device=dev), input_shape=(8,),
                              poll_s=0.05, swap_retries=0,
                              buckets=buckets, max_wait_ms=max_wait_ms,
                              max_queue=256)
    outcomes = {"completed": 0, "shed": 0, "errors": [],
                "completed_after_swap": 0}
    outcomes_lock = threading.Lock()
    sample = np.random.RandomState(seed).rand(8).astype(np.float32)
    start_gate = threading.Event()
    stop_clients = threading.Event()
    swap_done = threading.Event()

    def client():
        start_gate.wait(10)
        sent = 0
        # at least requests_per_client requests, then keep the load on
        # until the swap window has closed -- so requests provably
        # overlap the drain-then-replace
        while sent < requests_per_client or not stop_clients.is_set():
            sent += 1
            try:
                reg.infer("model", sample, timeout=request_timeout)
            except serving.ServingQueueFull:
                with outcomes_lock:
                    outcomes["shed"] += 1
                continue
            except Exception as e:  # noqa: BLE001 -- the report's errors
                with outcomes_lock:
                    outcomes["errors"].append(type(e).__name__)
                continue
            with outcomes_lock:
                outcomes["completed"] += 1
                if swap_done.is_set():
                    outcomes["completed_after_swap"] += 1
            # the client's pacing between requests, not a wait on a
            # condition
            time.sleep(0.002)  # mxlint: disable=sleep-poll

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    report = {}
    try:
        with chaos.scenario(seed=seed):
            if torn:
                # the second publish tears right after its atomic
                # commit -- the bytes a killed non-atomic writer leaves
                chaos.on("checkpoint.commit.post_commit", nth=2,
                         action=chaos.truncate("params.params"))
            ct.run_steps(publish_every)           # publish step N
            first = watcher.poll_once()
            for t in threads:
                t.start()
            start_gate.set()
            ct.run_steps(publish_every)           # publish step 2N
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                second = watcher.poll_once()      # torn => quarantine
            swap_done.set()
            time.sleep(0.1)     # a post-swap request window per client
            stop_clients.set()
            _join(threads)
            report["chaos"] = chaos.stats()
    finally:
        stop_clients.set()
        start_gate.set()
        ct.close()
        watcher.close()
        reg.shutdown(drain=True)
    report.update(outcomes)
    report.update({
        "first_swap_step": first,
        "second_swap_step": second,
        "served_step": watcher.served_step,
        "published_step": ct.published_step,
        "quarantined": corrupt_dirs(mgr_root),
        "requests": outcomes["completed"] + outcomes["shed"]
        + len(outcomes["errors"]),
    })
    return report


def flood_scenario(seed=0, max_queue=4, clients=8, per_client=8,
                   hold_s=0.03, request_timeout=30.0, device=None):
    """Flood the dynamic batcher past its queue bound.

    A chaos rule stalls every dispatch by ``hold_s`` (the wedged-device
    weather), ``clients`` threads release together and submit
    ``per_client`` requests each with no pacing against a single-slot
    bucket and a ``max_queue``-deep queue -- so intake outruns service
    and the bounded queue MUST shed.

    The contracts the report proves: sheds raise the distinct
    ``ServingQueueFull`` (counted), every *accepted* request still
    completes (``completed + shed == requests``, no other errors), and
    the max completed latency stays bounded by the queue depth times
    the injected stall.
    """
    from .. import serving, telemetry

    net = make_mlp(device=device)
    reg = serving.ModelRegistry(compile_cache=False)
    shed_before = telemetry.counter("serving.shed").value \
        if telemetry.enabled() else None
    outcomes = {"completed": 0, "shed": 0, "errors": []}
    outcomes_lock = threading.Lock()
    latencies = []
    sample = np.random.RandomState(seed).rand(8).astype(np.float32)
    barrier = threading.Barrier(clients)

    def client():
        barrier.wait(10)
        for _ in range(per_client):
            t0 = time.perf_counter()
            try:
                reg.infer("flood", sample, timeout=request_timeout)
            except serving.ServingQueueFull:
                with outcomes_lock:
                    outcomes["shed"] += 1
                continue
            except Exception as e:  # noqa: BLE001 -- the report's errors
                with outcomes_lock:
                    outcomes["errors"].append(type(e).__name__)
                continue
            with outcomes_lock:
                outcomes["completed"] += 1
                latencies.append(time.perf_counter() - t0)

    report = {}
    try:
        with chaos.scenario(seed=seed):
            chaos.on("serving.dispatch", action=chaos.sleep(hold_s))
            reg.register("flood", block=net, input_shape=(8,),
                         buckets=(1,), max_wait_ms=1.0,
                         max_queue=max_queue)
            threads = [threading.Thread(target=client, daemon=True)
                       for _ in range(clients)]
            for t in threads:
                t.start()
            _join(threads)
            report["chaos"] = chaos.stats()
    finally:
        reg.shutdown(drain=True)
    report.update(outcomes)
    lat = sorted(latencies)
    report.update({
        "requests": clients * per_client,
        "max_queue": max_queue,
        "hold_s": hold_s,
        "max_latency_s": lat[-1] if lat else None,
        "p99_latency_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        if lat else None,
        # worst admissible wait: a full queue ahead of you plus your own
        # dispatch, each stalled hold_s (+1 s for the in-flight batch
        # and scheduler jitter)
        "latency_bound_s": (max_queue + 2) * hold_s + 1.0,
        "shed_counter_delta":
        (telemetry.counter("serving.shed").value - shed_before)
        if shed_before is not None else None,
    })
    return report
