"""Post-training int8 quantization (counterpart of
``mxnet_tpu/contrib/quantization.py``), exported as
``mx.contrib.quantization``.

A graph transform over ``mx.sym`` graphs that drives the int8 ops of
:mod:`mxnet_tpu_torch.ops.contrib_ops`: each quantizable node
(``Convolution``, ``FullyConnected``) becomes ``quantize_v2 ->
quantized_conv | quantized_fully_connected -> dequantize`` with its
calibrated range, and its weight and bias are quantized offline into
int8 parameters with their ranges. Calibration modes: ``none`` (each
batch's own min/max at run time), ``naive`` (the largest magnitude seen
over the calibration batches, reduced on the device) and ``entropy``
(the KL-divergence-optimal threshold over a 2,048-bin histogram, kept to
thresholds that clip at most 1% of the mass). The rewritten graph's
``-symbol.json`` is byte for byte the JAX package's for the same graph
and thresholds.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["quantize_model", "calibrate", "quantize_graph",
           "QUANTIZABLE_OPS"]

QUANTIZABLE_OPS = ("Convolution", "FullyConnected")


# ----------------------------------------------------------------------
# Calibration
# ----------------------------------------------------------------------

def _optimal_threshold_entropy(arr, num_bins=2048, num_quantized_bins=128):
    """The KL-divergence-optimal ``|threshold|`` of ``arr`` for int8."""
    a = np.abs(np.asarray(arr, np.float64)).ravel()
    amax = a.max() if a.size else 0.0
    if amax == 0.0:
        return 1e-8
    hist, edges = np.histogram(a, bins=num_bins, range=(0.0, amax))
    best_kl = np.inf
    best_t = amax
    total = hist.sum()
    if total == 0:
        return float(amax)
    # candidate thresholds keep at least 99% of the mass un-clipped: on a
    # small calibration set the histogram is sparse, and an unconstrained
    # scan can collapse onto a tiny threshold
    cum = np.cumsum(hist)
    start = int(np.searchsorted(cum, 0.99 * total)) + 1
    start = max(num_quantized_bins, start)
    for i in range(start, num_bins + 1,
                   max(1, num_bins // 128)):
        ref = hist[:i].astype(np.float64).copy()
        # everything beyond the threshold clips into the last bin
        ref[-1] += hist[i:].sum()
        if ref.sum() == 0:
            continue
        # quantize the i bins down to num_quantized_bins
        chunks = np.array_split(ref, num_quantized_bins)
        q = np.zeros(i, np.float64)
        pos = 0
        for ch in chunks:
            nz = ch > 0
            if nz.any():
                q[pos:pos + len(ch)][nz] = ch.sum() / nz.sum()
            pos += len(ch)
        p = ref / ref.sum()
        qn = q / q.sum() if q.sum() else q
        mask = p > 0
        # smoothed KL(P || Q)
        kl = float(np.sum(p[mask] * np.log(
            p[mask] / np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl = kl
            best_t = edges[i]
    return float(best_t)


def calibrate(sym, arg_params, aux_params, calib_data,
              data_names=("data",), calib_mode="entropy",
              num_calib_batches=None, quantizable_ops=QUANTIZABLE_OPS,
              excluded_sym_names=()):
    """Collect per-tensor thresholds for every quantizable node input.

    ``calib_data`` yields batches: arrays or NDArrays (one input) or
    dicts of them.  Returns ``{tensor_name: (min, max)}`` for the data
    input of each quantizable node.
    """
    from .. import ndarray as nd
    from ..symbol.symbol import Group, Symbol

    # tensors to observe: the data input of every quantizable node
    nodes = [n for n in sym._topo()
             if n.op in quantizable_ops and n.name not in excluded_sym_names]
    watch = []  # (tensor_name, Symbol) pairs
    seen = set()
    for node in nodes:
        src, idx = node.inputs[0]
        tname = src.name if idx == 0 else "%s_out%d" % (src.name, idx)
        if tname in seen:
            continue
        seen.add(tname)
        watch.append((tname, Symbol([(src, idx)])))
    if not watch:
        return {}
    group = Group([s for _, s in watch])

    stats = {name: [] for name, _ in watch}
    consts = dict(arg_params)
    consts.update(aux_params)
    n_done = 0
    for batch in calib_data:
        if num_calib_batches is not None and n_done >= num_calib_batches:
            break
        n_done += 1
        feeds = dict(consts)
        if isinstance(batch, dict):
            feeds.update({k: nd.array(np.asarray(v)) if not isinstance(
                v, nd.NDArray) else v for k, v in batch.items()})
        else:
            if not isinstance(batch, nd.NDArray):
                batch = nd.array(np.asarray(batch))
            feeds[data_names[0]] = batch
        outs = group.eval(**feeds)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for (name, _), val in zip(watch, outs):
            if calib_mode == "naive":
                # the largest magnitude is all ``naive`` keeps: reduced
                # on the tensor's device, read once at the end (exact,
                # as the maximum over the host copies would be)
                peak = val._data.detach().abs().max()
                stats[name] = [peak if not stats[name]
                               else torch.maximum(stats[name][0], peak)]
            else:
                stats[name].append(val.asnumpy())

    thresholds = {}
    for name, chunks in stats.items():
        if not chunks:
            raise MXNetError("calibrate: calib_data yielded no batches")
        if calib_mode == "naive":
            t = float(chunks[0]) or 1e-8
        elif calib_mode == "entropy":
            allv = np.concatenate([c.ravel() for c in chunks])
            t = _optimal_threshold_entropy(allv)
        else:
            raise MXNetError("calibrate: unknown calib_mode %r"
                             % calib_mode)
        thresholds[name] = (-t, t)
    return thresholds


# ----------------------------------------------------------------------
# Graph transform
# ----------------------------------------------------------------------

def _quantize_weight(arr):
    a = np.asarray(arr, np.float32)
    bound = float(np.max(np.abs(a))) or 1e-8
    q = np.clip(np.round(a * (127.0 / bound)), -127, 127).astype(np.int8)
    return q, bound


def quantize_graph(sym, arg_params, aux_params, thresholds=None,
                   excluded_sym_names=(), quantizable_ops=QUANTIZABLE_OPS):
    """Rewrite a fp32 Symbol into an int8-compute graph.

    Every quantizable node becomes ``quantize_v2(data) -> quantized_op ->
    dequantize``; weights/biases are quantized offline into the returned
    parameter dict (int8 payload + baked scales).  Non-quantized nodes
    are rebuilt unchanged.  Returns ``(qsym, qarg_params, aux_params)``.
    """
    from ..symbol.symbol import Group, Symbol, _make_node, var

    thresholds = thresholds or {}
    qargs = {k: v for k, v in arg_params.items()}
    env = {}  # id(old_node) -> list of Symbols per output index

    # params still referenced by nodes that STAY fp32 (excluded or
    # non-quantizable) must keep their fp32 entry even when a quantized
    # node shares them (weight tying)
    fp32_referenced = set()
    for n in sym._topo():
        if n.op is None:
            continue
        stays_fp32 = n.op not in quantizable_ops \
            or n.name in excluded_sym_names
        if stays_fp32:
            for src, _ in n.inputs:
                if src.op is None:
                    fp32_referenced.add(src.name)

    def entry_sym(src, idx):
        return env[id(src)][idx]

    for node in sym._topo():
        if node.op is None:
            env[id(node)] = [Symbol(
                [(type(node)(None, node.name, dict(node.attrs), []), 0)])]
            continue
        ins = [entry_sym(s, i) for s, i in node.inputs]
        if node.op in quantizable_ops \
                and node.name not in excluded_sym_names:
            src, idx = node.inputs[0]
            tname = src.name if idx == 0 else \
                "%s_out%d" % (src.name, idx)
            wname = node.inputs[1][0].name
            bname = node.inputs[2][0].name if len(node.inputs) > 2 else None

            # offline weight quantization (idempotent: a weight shared by
            # several quantized nodes is converted once; one also shared
            # with an fp32 node keeps its fp32 entry)
            if wname not in arg_params:
                raise MXNetError("quantize_graph: missing weight param %r"
                                 % wname)
            from .. import ndarray as nd
            if wname + "_quantized" not in qargs:
                qw, wbound = _quantize_weight(arg_params[wname].asnumpy())
                qargs[wname + "_quantized"] = nd.array(qw)
                qargs[wname + "_min"] = nd.array(
                    np.asarray(-wbound, np.float32))
                qargs[wname + "_max"] = nd.array(
                    np.asarray(wbound, np.float32))
                if wname not in fp32_referenced:
                    del qargs[wname]
            w_q = var(wname + "_quantized")
            w_min = var(wname + "_min")
            w_max = var(wname + "_max")

            qparams = {}
            if tname in thresholds:
                lo, hi = thresholds[tname]
                qparams = {"min_calib_range": float(lo),
                           "max_calib_range": float(hi)}
            q_data = _make_node("quantize_v2", [ins[0]], qparams,
                                name=node.name + "_quantize")
            d_q, d_min, d_max = q_data[0], q_data[1], q_data[2]

            op_params = {k: v for k, v in node.attrs.items()}
            no_bias = bname is None
            if no_bias:
                # quantized ops take a full arg list; feed zero-range bias
                b_q = var(node.name + "_nobias")
                b_min = var(node.name + "_nobias_min")
                b_max = var(node.name + "_nobias_max")
                qargs[node.name + "_nobias"] = nd.array(
                    np.zeros((1,), np.int8))
                qargs[node.name + "_nobias_min"] = nd.array(
                    np.asarray(0.0, np.float32))
                qargs[node.name + "_nobias_max"] = nd.array(
                    np.asarray(0.0, np.float32))
                op_params["no_bias"] = True
            else:
                if bname + "_quantized" not in qargs:
                    qb, bbound = _quantize_weight(
                        arg_params[bname].asnumpy())
                    qargs[bname + "_quantized"] = nd.array(qb)
                    qargs[bname + "_min"] = nd.array(
                        np.asarray(-bbound, np.float32))
                    qargs[bname + "_max"] = nd.array(
                        np.asarray(bbound, np.float32))
                    if bname not in fp32_referenced:
                        del qargs[bname]
                b_q = var(bname + "_quantized")
                b_min = var(bname + "_min")
                b_max = var(bname + "_max")
                op_params["no_bias"] = False

            qop = "quantized_conv" if node.op == "Convolution" \
                else "quantized_fully_connected"
            acc = _make_node(qop,
                             [d_q, w_q, b_q, d_min, d_max, w_min, w_max,
                              b_min, b_max],
                             op_params, name=node.name + "_quantized")
            out = _make_node("dequantize", [acc[0], acc[1], acc[2]], {},
                             name=node.name)
            env[id(node)] = [out]
            continue
        # pass through unchanged (rebuild on the new inputs)
        rebuilt = _make_node(node.op, ins, dict(node.attrs),
                             name=node.name)
        env[id(node)] = [rebuilt[i] for i in range(len(rebuilt))] \
            if len(rebuilt) > 1 else [rebuilt]

    outs = [entry_sym(n, i) for n, i in sym._outputs]
    qsym = outs[0] if len(outs) == 1 else Group(outs)
    return qsym, qargs, dict(aux_params)


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=(), calib_mode="entropy",
                   calib_data=None, num_calib_batches=None,
                   quantized_dtype="int8", logger=None, **kwargs):
    """Post-training quantization in one call.

    calib_mode ``none`` bakes no ranges (runtime min/max), ``naive`` and
    ``entropy`` calibrate thresholds from ``calib_data``.  Returns
    ``(qsym, qarg_params, aux_params)``.
    """
    if quantized_dtype != "int8":
        raise MXNetError("quantize_model: only int8 is supported")
    thresholds = {}
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError("quantize_model: calib_mode %r needs "
                             "calib_data" % calib_mode)
        thresholds = calibrate(
            sym, arg_params, aux_params, calib_data,
            data_names=data_names, calib_mode=calib_mode,
            num_calib_batches=num_calib_batches,
            excluded_sym_names=excluded_sym_names)
        if logger:
            logger.info("calibrated %d tensors", len(thresholds))
    return quantize_graph(sym, arg_params, aux_params, thresholds,
                          excluded_sym_names=excluded_sym_names)
