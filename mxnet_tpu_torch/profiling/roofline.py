"""Analytic roofline: measured step time x CostReport -> bound labels
(counterpart of ``mxnet_tpu/profiling/roofline.py``).

Given a CostReport and a measured step time, computes achieved FLOP/s
and bytes/s against the device's peak compute and memory bandwidth, and
labels every category compute- or memory-bound by comparing its
arithmetic intensity (FLOPs per byte moved) with the device's ridge
point ``peak_flops / peak_bandwidth``.

The peak table holds the NVIDIA H100 only, from NVIDIA's data sheet
(SXM part, dense rates, at its full 700 W power limit): 3.35 TB/s of
HBM3, 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in fp32 on
the CUDA cores.  ``device_peaks`` returns the bf16 rate unless asked
for ``dtype="float32"``.  Any other device (the CPU of a test run)
takes conservative assumed peaks, flagged ``peaks_assumed`` in the
output so a CPU roofline is never mistaken for the card's.
"""
from __future__ import annotations

__all__ = ["build", "device_peaks"]

# (device-name prefix, {dtype: peak FLOP/s}, peak bytes/s)
_DEVICE_PEAKS = (
    ("NVIDIA H100", {"bfloat16": 989e12, "float32": 67e12}, 3.35e12),
)

# dev-box fallback so the roofline section always renders; flagged
# assumed=True (the JAX package's numbers, for a generic server core)
_ASSUMED_PEAKS = (5e11, 5e10)


def _current_device_kind():
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except (ImportError, RuntimeError):
        pass
    return ""


def device_peaks(device_kind=None, dtype="bfloat16"):
    """(peak_flops, peak_bytes_per_s, assumed) for the current (or
    named) device, at ``dtype``'s rate."""
    if device_kind is None:
        device_kind = _current_device_kind()
    for prefix, rates, bw in _DEVICE_PEAKS:
        if device_kind.startswith(prefix):
            return rates[dtype], bw, False
    return _ASSUMED_PEAKS[0], _ASSUMED_PEAKS[1], True


def build(report, step_time_s, peak_flops=None, peak_bytes_per_s=None,
          items_per_step=None):
    """Roofline section dict for ``report`` at ``step_time_s``."""
    fl, bw, assumed = device_peaks(report.get("device"))
    if peak_flops is not None:
        fl, assumed = peak_flops, False
    if peak_bytes_per_s is not None:
        bw = peak_bytes_per_s
    step_time_s = max(float(step_time_s), 1e-12)
    tot_f = report["totals"]["flops"]
    tot_b = report["totals"]["bytes_accessed"]
    achieved_f = tot_f / step_time_s
    achieved_b = tot_b / step_time_s
    ridge = fl / bw
    cats = {}
    time_est = {}
    for name, c in report["categories"].items():
        f, b = c["flops"], c["bytes"]
        if f == 0 and b == 0:
            continue
        intensity = (f / b) if b else float("inf")
        bound = "compute" if intensity >= ridge else "memory"
        # the category's floor time under the roofline model: whichever
        # wall (compute or bandwidth) it hits first
        time_est[name] = max(f / fl, b / bw)
        cats[name] = {"intensity": round(intensity, 3)
                      if intensity != float("inf") else None,
                      "bound": bound}
    t_total = sum(time_est.values()) or 1.0
    for name, t in time_est.items():
        cats[name]["time_share"] = round(t / t_total, 4)
        cats[name]["floor_s"] = round(t, 9)
    out = {
        "step_time_s": step_time_s,
        "peak_flops": fl,
        "peak_bytes_per_s": bw,
        "peaks_assumed": assumed,
        "ridge_intensity": round(ridge, 3),
        "achieved_flops_per_s": achieved_f,
        "achieved_bytes_per_s": achieved_b,
        "mfu": round(achieved_f / fl, 4),
        "bandwidth_util": round(achieved_b / bw, 4),
        # the roofline's floor for this program on this card: the
        # measured/floor ratio says how much headroom is model-side
        "floor_step_s": round(t_total if time_est else 0.0, 9),
        "categories": cats,
    }
    if items_per_step:
        out["items_per_step"] = items_per_step
        out["items_per_sec"] = round(items_per_step / step_time_s, 1)
    return out
