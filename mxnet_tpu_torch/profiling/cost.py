"""CostReport: per-category attribution of one step's walked ops
(counterpart of ``mxnet_tpu/profiling/cost.py``).

One report per shape-keyed program (a ``TrainStep`` key, a hybridized
block's key), built from the :class:`~.aten.Walk` of its eager warm-up
run: the ``mxprof.cost_report.v1`` dict of the JAX package, key for
key.  There are no compiler totals to reconcile against: the walk's
sums are the totals (the JAX package's path for a backend without
them), so ``sum(categories[*].flops) == totals.flops`` exactly, the
``mxprof report`` contract.  ``fingerprint`` digests the walked op
sequence; ``memory`` holds the step's argument and output bytes and,
the bytes of the arguments the step writes in place as its
``alias_bytes`` (the JAX package's donated buffers), and on the card,
``peak_hbm_bytes`` from ``torch.cuda.max_memory_allocated``
over the warm-up (at least the arguments plus the graph pool's bytes
once the key is captured); on the CPU, which has no device allocator,
the arguments plus the outputs.
"""
from __future__ import annotations

import torch

from .aten import CATEGORIES

__all__ = ["SCHEMA", "analyze_walk", "device_of"]

SCHEMA = "mxprof.cost_report.v1"


def _reconcile(cats, total, key):
    """Scale category ``key`` estimates so they sum exactly to
    ``total`` (int); with no estimate the total lands on 'other'."""
    total = int(round(total))
    est = {c: cats[c][key] for c in CATEGORIES}
    est_sum = sum(est.values())
    if total <= 0:
        return {c: 0 for c in CATEGORIES}
    if est_sum <= 0:
        out = {c: 0 for c in CATEGORIES}
        out["other"] = total
        return out
    out = {c: int(round(v * total / est_sum)) for c, v in est.items()}
    drift = total - sum(out.values())
    out[max(out, key=out.get)] += drift
    return out


def device_of(device):
    """``(device name, backend)`` of a torch device: the card's
    ``torch.cuda.get_device_name`` and ``"cuda"``, or ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device), "cuda"
    return "cpu", "cpu"


def analyze_walk(walk, label="executable", kind="jit", device="cpu",
                 argument_bytes=0, output_bytes=0, peak_bytes=None,
                 alias_bytes=0, **meta):
    """Build a CostReport dict from a finished :class:`~.aten.Walk`."""
    est = walk.categories
    totals = {"flops": float(sum(c["flops"] for c in est.values())),
              "bytes_accessed": float(sum(c["bytes"] for c in est.values())),
              "transcendentals": 0.0}
    flops_rec = _reconcile(est, totals["flops"], "flops")
    bytes_rec = _reconcile(est, totals["bytes_accessed"], "bytes")
    tf, tb = max(totals["flops"], 1.0), max(totals["bytes_accessed"], 1.0)
    categories = {
        c: {"flops": flops_rec[c], "bytes": bytes_rec[c],
            "instructions": est[c]["instructions"],
            "flops_share": round(flops_rec[c] / tf, 4),
            "bytes_share": round(bytes_rec[c] / tb, 4)}
        for c in CATEGORIES}
    argument_bytes, output_bytes = int(argument_bytes), int(output_bytes)
    peak = int(peak_bytes) if peak_bytes is not None \
        else argument_bytes + output_bytes
    memory = {"argument_bytes": argument_bytes,
              "output_bytes": output_bytes,
              "temp_bytes": max(0, peak - argument_bytes - output_bytes),
              "alias_bytes": int(alias_bytes), "generated_code_bytes": 0,
              "peak_hbm_bytes": peak}
    name, backend = device_of(device)
    return {
        "schema": SCHEMA,
        "label": label,
        "kind": kind,
        "fingerprint": walk.fingerprint(),
        "device": name,
        "backend": backend,
        "totals": totals,
        "memory": memory,
        "categories": categories,
        "estimates": {c: {"flops": est[c]["flops"],
                          "bytes": est[c]["bytes"]} for c in CATEGORIES},
        "provenance": walk.provenance(),
        # the in-graph collectives by kind (analysis.sharding's contract)
        **({"collectives": walk.collectives()}
           if walk.collectives() else {}),
        "step": None,
        "roofline": None,
        **({"meta": meta} if meta else {}),
    }
