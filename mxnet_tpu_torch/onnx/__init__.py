"""ONNX interchange (counterpart of ``mxnet_tpu/onnx``; reference
``python/mxnet/contrib/onnx`` :: ``export_model`` / ``import_model``,
``mx2onnx/_op_translations.py``, ``onnx2mx/_import_helper.py``).

Serialization goes through the port's own protobuf wire-format module
(:mod:`.wire`): ONNX files are plain protobuf, and the subset the format
uses is stable.  Exported files follow IR version 8 / default opset 13,
byte for byte the JAX package's, and are readable by any standard ONNX
parser; ``import_model`` reads files of this exporter and of stock
exporters (raw_data and typed tensor payloads, packed and unpacked
repeated fields).  The converters and their errors are the JAX
package's: a graph node without one (``fused_batch_norm_relu``, which a
channels-last net's export holds) raises naming its op.  Imported
arrays come back on the host, as a restored checkpoint's do.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from . import wire

__all__ = ["export_model", "import_model", "MX2ONNX_OP", "ONNX2MX_OP",
           "get_model_metadata"]


def _attr(node, key, default=None):
    from ..symbol.symbol import _parse_attr_value
    if key not in node.attrs:
        return default
    return _parse_attr_value(node.attrs[key])


def _numpy(arr):
    """A parameter value (NDArray, tensor, array-like) as numpy."""
    import torch
    arr = getattr(arr, "_data", arr)
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            import ml_dtypes
            return arr.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return arr.numpy()
    return np.asarray(arr)


def _ints(v, n=None):
    if v is None:
        return None
    if isinstance(v, (int, np.integer)):
        v = (int(v),) * (n or 1)
    return [int(x) for x in v]


# ----------------------------------------------------------------------
# Export: Symbol graph -> ModelProto bytes
# ----------------------------------------------------------------------

# simple 1:1 renames (everything else has a converter function below)
MX2ONNX_OP = {
    "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh", "exp": "Exp",
    "log": "Log", "sqrt": "Sqrt", "abs": "Abs", "negative": "Neg",
    "erf": "Erf", "floor": "Floor", "ceil": "Ceil", "identity": "Identity",
    "elemwise_add": "Add", "elemwise_sub": "Sub", "elemwise_mul": "Mul",
    "elemwise_div": "Div", "broadcast_add": "Add", "broadcast_sub": "Sub",
    "broadcast_mul": "Mul", "broadcast_div": "Div",
    "broadcast_power": "Pow", "broadcast_maximum": "Max",
    "broadcast_minimum": "Min", "matmul": "MatMul",
    "add_n": "Sum", "Flatten": "Flatten",
}


class _Exporter:
    def __init__(self, sym, params, in_shapes, in_types):
        self.sym = sym
        self.params = params
        self.in_shapes = list(in_shapes or [])
        self.in_types = list(in_types or [])
        self.nodes = []          # NodeProto bytes, topo order
        self.initializers = []   # TensorProto bytes
        self.init_names = set()
        self.graph_inputs = []   # ValueInfo bytes
        self.entry_name = {}     # (id(node), out_idx) -> tensor name
        self.counter = 0
        self._ranks = None       # (id(node), out_idx) -> rank or None

    def _internal_ranks(self):
        """Best-effort rank map for every internal output, via partial
        shape inference seeded with the graph-input shapes and the
        (always-known) parameter shapes.  Unknowns map to None."""
        if self._ranks is not None:
            return self._ranks
        self._ranks = {}
        try:
            kwargs = {}
            in_idx = 0
            for n in self.sym._topo():
                if n.op is not None:
                    continue
                if n.name in self.params:
                    kwargs[n.name] = tuple(self.params[n.name].shape)
                else:
                    if in_idx < len(self.in_shapes):
                        kwargs[n.name] = tuple(self.in_shapes[in_idx])
                    in_idx += 1
            internals = self.sym.get_internals()
            _, out_shapes, _ = internals.infer_shape_partial(**kwargs)
            for (node, idx), shp in zip(internals._outputs, out_shapes):
                self._ranks[(id(node), idx)] = \
                    None if shp is None else len(shp)
        except Exception:
            pass
        return self._ranks

    def fresh(self, base):
        self.counter += 1
        return "%s__%d" % (base, self.counter)

    def in_name(self, node, i):
        src, idx = node.inputs[i]
        return self.entry_name[(id(src), idx)]

    def add_node(self, op_type, inputs, outputs, name, attrs=None):
        self.nodes.append(wire.make_node(op_type, inputs, outputs,
                                         name=name, attrs=attrs))

    def add_init(self, name, arr):
        if name not in self.init_names:
            self.initializers.append(wire.make_tensor(name, arr))
            self.init_names.add(name)

    # -- per-op converters --------------------------------------------

    def conv(self, node):
        layout = str(node.attrs.get("layout", "NCHW") or "NCHW")
        if layout and layout[-1] == "C":
            raise MXNetError("onnx export: channels-last Convolution is "
                             "not representable; use NCHW layout")
        kernel = _ints(_attr(node, "kernel", ()))
        nsp = len(kernel)
        attrs = {"kernel_shape": kernel,
                 "group": int(_attr(node, "num_group", 1) or 1)}
        stride = _ints(_attr(node, "stride", None), nsp)
        dilate = _ints(_attr(node, "dilate", None), nsp)
        pad = _ints(_attr(node, "pad", None), nsp)
        if stride:
            attrs["strides"] = stride
        if dilate:
            attrs["dilations"] = dilate
        if pad:
            attrs["pads"] = pad + pad
        op = "Conv" if node.op == "Convolution" else "ConvTranspose"
        if op == "ConvTranspose":
            adj = _ints(_attr(node, "adj", None), nsp)
            if adj and any(adj):
                attrs["output_padding"] = adj
        ins = [self.in_name(node, i) for i in range(len(node.inputs))]
        self.add_node(op, ins, [node.name], node.name, attrs)

    def fully_connected(self, node):
        flatten = _attr(node, "flatten", True)
        no_bias = bool(_attr(node, "no_bias", False))
        x = self.in_name(node, 0)
        if flatten:
            flat = self.fresh(node.name + "_flat")
            self.add_node("Flatten", [x], [flat], flat, {"axis": 1})
            x = flat
        ins = [x, self.in_name(node, 1)]
        if not no_bias and len(node.inputs) > 2:
            ins.append(self.in_name(node, 2))
        self.add_node("Gemm", ins, [node.name], node.name,
                      {"alpha": 1.0, "beta": 1.0, "transB": 1})

    def activation(self, node):
        act = str(node.attrs.get("act_type", "relu"))
        m = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
             "softrelu": "Softplus", "softsign": "Softsign"}
        if act not in m:
            raise MXNetError("onnx export: Activation %r unsupported" % act)
        self.add_node(m[act], [self.in_name(node, 0)], [node.name],
                      node.name)

    def leaky_relu(self, node):
        act = str(node.attrs.get("act_type", "leaky"))
        slope = float(_attr(node, "slope", 0.25))
        if act == "leaky":
            self.add_node("LeakyRelu", [self.in_name(node, 0)],
                          [node.name], node.name, {"alpha": slope})
        elif act == "elu":
            self.add_node("Elu", [self.in_name(node, 0)], [node.name],
                          node.name, {"alpha": slope})
        elif act == "selu":
            self.add_node("Selu", [self.in_name(node, 0)], [node.name],
                          node.name)
        else:
            raise MXNetError("onnx export: LeakyReLU %r unsupported" % act)

    def batch_norm(self, node):
        if int(_attr(node, "axis", 1)) != 1:
            raise MXNetError("onnx export: BatchNorm axis must be 1 "
                             "(channels-first)")
        attrs = {"epsilon": float(_attr(node, "eps", 1e-5)),
                 "momentum": float(_attr(node, "momentum", 0.9))}
        ins = [self.in_name(node, i) for i in range(5)]
        if _attr(node, "fix_gamma", True):
            # the op ignores gamma when fix_gamma: bake ones so ONNX
            # semantics match (reference mx2onnx does the same)
            gname = ins[1]
            if gname in self.params:
                shape = np.asarray(self.params[gname]).shape
                ones_name = self.fresh(gname + "_fixed")
                self.add_init(ones_name, np.ones(shape, np.float32))
                ins[1] = ones_name
        self.add_node("BatchNormalization", ins, [node.name], node.name,
                      attrs)

    def pooling(self, node):
        layout = str(node.attrs.get("layout", "NCHW") or "NCHW")
        if layout and layout[-1] == "C":
            raise MXNetError("onnx export: channels-last Pooling is not "
                             "representable; use NCHW layout")
        pool_type = str(node.attrs.get("pool_type", "max"))
        global_pool = bool(_attr(node, "global_pool", False))
        x = self.in_name(node, 0)
        if global_pool:
            op = {"max": "GlobalMaxPool", "avg": "GlobalAveragePool"}.get(
                pool_type)
            if op is None:
                raise MXNetError("onnx export: global %s pool unsupported"
                                 % pool_type)
            self.add_node(op, [x], [node.name], node.name)
            return
        kernel = _ints(_attr(node, "kernel", ()))
        nsp = len(kernel)
        attrs = {"kernel_shape": kernel}
        stride = _ints(_attr(node, "stride", None), nsp)
        pad = _ints(_attr(node, "pad", None), nsp)
        if stride:
            attrs["strides"] = stride
        if pad:
            attrs["pads"] = pad + pad
        if str(node.attrs.get("pooling_convention", "valid")) == "full":
            attrs["ceil_mode"] = 1
        if pool_type == "avg":
            attrs["count_include_pad"] = \
                1 if _attr(node, "count_include_pad", True) else 0
            op = "AveragePool"
        elif pool_type == "max":
            op = "MaxPool"
        else:
            raise MXNetError("onnx export: pool_type %r unsupported"
                             % pool_type)
        self.add_node(op, [x], [node.name], node.name, attrs)

    def reshape(self, node):
        shape = _ints(_attr(node, "shape", ()))
        if any(s in (-2, -3, -4) for s in shape):
            raise MXNetError("onnx export: Reshape codes -2/-3/-4 are not "
                             "representable in ONNX")
        sname = self.fresh(node.name + "_shape")
        self.add_init(sname, np.asarray(shape, np.int64))
        self.add_node("Reshape", [self.in_name(node, 0), sname],
                      [node.name], node.name)

    def scalar_op(self, node):
        scalar = float(_attr(node, "scalar", 0.0))
        cname = self.fresh(node.name + "_scalar")
        self.add_init(cname, np.asarray(scalar, np.float32))
        x = self.in_name(node, 0)
        op_map = {"_plus_scalar": ("Add", [x, cname]),
                  "_minus_scalar": ("Sub", [x, cname]),
                  "_rminus_scalar": ("Sub", [cname, x]),
                  "_mul_scalar": ("Mul", [x, cname]),
                  "_div_scalar": ("Div", [x, cname]),
                  "_rdiv_scalar": ("Div", [cname, x]),
                  "_power_scalar": ("Pow", [x, cname]),
                  "_rpower_scalar": ("Pow", [cname, x])}
        op, ins = op_map[node.op]
        self.add_node(op, ins, [node.name], node.name)

    def softmax(self, node):
        self.add_node("Softmax", [self.in_name(node, 0)], [node.name],
                      node.name, {"axis": int(_attr(node, "axis", -1))})

    def transpose(self, node):
        axes = _ints(_attr(node, "axes", ()))
        attrs = {"perm": axes} if axes else None
        self.add_node("Transpose", [self.in_name(node, 0)], [node.name],
                      node.name, attrs)

    def concat(self, node):
        ins = [self.in_name(node, i) for i in range(len(node.inputs))]
        axis = int(_attr(node, "dim", _attr(node, "axis", 1)))
        self.add_node("Concat", ins, [node.name], node.name,
                      {"axis": axis})

    def dropout(self, node):
        # inference export: Dropout is identity
        self.add_node("Identity", [self.in_name(node, 0)], [node.name],
                      node.name)

    def clip(self, node):
        lo = self.fresh(node.name + "_min")
        hi = self.fresh(node.name + "_max")
        self.add_init(lo, np.asarray(_attr(node, "a_min", 0.0), np.float32))
        self.add_init(hi, np.asarray(_attr(node, "a_max", 0.0), np.float32))
        self.add_node("Clip", [self.in_name(node, 0), lo, hi],
                      [node.name], node.name)

    def embedding(self, node):
        # Gather(weight, indices): note the operand order swap
        self.add_node("Gather", [self.in_name(node, 1),
                                 self.in_name(node, 0)],
                      [node.name], node.name, {"axis": 0})

    def expand_dims(self, node):
        ax = self.fresh(node.name + "_axes")
        self.add_init(ax, np.asarray([int(_attr(node, "axis", 0))],
                                     np.int64))
        self.add_node("Unsqueeze", [self.in_name(node, 0), ax],
                      [node.name], node.name)

    def dot(self, node):
        # ONNX MatMul has numpy semantics and no transpose attrs; only
        # the untransposed form maps losslessly (mx dot's ND behavior is
        # tensordot(axes=1), which MatMul matches for rank <= 2; rank is
        # unknown at export time, so transposes are rejected, not
        # silently dropped)
        if _attr(node, "transpose_a", False) or \
                _attr(node, "transpose_b", False):
            raise MXNetError("onnx export: %s with transpose_a/b is not "
                             "representable as MatMul" % node.op)
        if node.op == "dot":
            # mx dot is tensordot(axes=1); MatMul's numpy semantics agree
            # only while the RHS has rank <= 2 (a rank>2 RHS makes MatMul
            # broadcast batch dims instead of chaining them).  Verify via
            # shape inference; reject rather than export silently wrong.
            rb = self._internal_ranks().get(
                (id(node.inputs[1][0]), node.inputs[1][1]))
            if rb is None or rb > 2:
                raise MXNetError(
                    "onnx export: dot with a rank-%s second operand is "
                    "not representable as MatMul (mx dot chains trailing "
                    "dims, MatMul broadcasts batch dims); pass in_shapes "
                    "proving rank <= 2 or rewrite with batch_dot"
                    % ("unknown" if rb is None else rb))
        self.add_node("MatMul", [self.in_name(node, 0),
                                 self.in_name(node, 1)],
                      [node.name], node.name)

    def simple(self, node):
        op = MX2ONNX_OP[node.op]
        ins = [self.in_name(node, i) for i in range(len(node.inputs))]
        attrs = {"axis": 1} if op == "Flatten" else None
        self.add_node(op, ins, [node.name], node.name, attrs)

    CONVERTERS = {
        "Convolution": conv, "Deconvolution": conv,
        "FullyConnected": fully_connected, "Activation": activation,
        "LeakyReLU": leaky_relu, "BatchNorm": batch_norm,
        "Pooling": pooling, "Reshape": reshape, "softmax": softmax,
        "transpose": transpose, "Concat": concat, "Dropout": dropout,
        "clip": clip, "Embedding": embedding, "expand_dims": expand_dims,
        "dot": dot, "batch_dot": dot,
        "_plus_scalar": scalar_op, "_minus_scalar": scalar_op,
        "_rminus_scalar": scalar_op, "_mul_scalar": scalar_op,
        "_div_scalar": scalar_op, "_rdiv_scalar": scalar_op,
        "_power_scalar": scalar_op, "_rpower_scalar": scalar_op,
    }

    def run(self):
        sym = self.sym
        in_idx = 0
        for node in sym._topo():
            if node.op is None:
                name = node.name
                self.entry_name[(id(node), 0)] = name
                if name in self.params:
                    self.add_init(name, _numpy(self.params[name]))
                else:
                    shape = self.in_shapes[in_idx] \
                        if in_idx < len(self.in_shapes) else ()
                    dt = wire.DT_FLOAT
                    if in_idx < len(self.in_types):
                        dt = wire._NP2DT.get(
                            np.dtype(self.in_types[in_idx]), wire.DT_FLOAT)
                    in_idx += 1
                    self.graph_inputs.append(
                        wire.make_value_info(name, dt, shape))
                continue
            conv_fn = self.CONVERTERS.get(node.op)
            self.entry_name[(id(node), 0)] = node.name
            for i in range(1, node.num_outputs):
                self.entry_name[(id(node), i)] = "%s_out%d" % (node.name, i)
            if conv_fn is not None:
                conv_fn(self, node)
            elif node.op in MX2ONNX_OP:
                self.simple(node)
            else:
                raise MXNetError("onnx export: no converter for op %r"
                                 % node.op)
        outputs = []
        for onode, idx in sym._outputs:
            outputs.append(wire.make_value_info(
                self.entry_name[(id(onode), idx)], wire.DT_FLOAT, ()))
        graph = wire.make_graph(self.nodes, "mxnet_tpu_graph",
                                self.graph_inputs, outputs,
                                self.initializers)
        return wire.make_model(graph)


def export_model(sym, params, in_shapes=None, in_types=None,
                 onnx_file_path="model.onnx", **kwargs):
    """Export a Symbol graph (or saved model prefix) to an ONNX file.

    Reference: ``mx.onnx.export_model(sym, params, in_shapes, in_types,
    onnx_file_path)``.  ``sym`` is a Symbol or a ``*-symbol.json`` path;
    ``params`` a dict (``arg:``/``aux:`` prefixes accepted) or a
    ``.params`` path.  Returns ``onnx_file_path``.
    """
    from ..ndarray import ndarray as nd
    from ..symbol import symbol as sym_mod
    if isinstance(sym, str):
        sym = sym_mod.load(sym)
    if isinstance(params, str):
        params = nd.load_tensors(params)
    flat = {}
    for k, v in (params or {}).items():
        if ":" in k:
            k = k.split(":", 1)[1]
        flat[k] = v
    model = _Exporter(sym, flat, in_shapes, in_types).run()
    from ..checkpoint.core import atomic_write_bytes
    atomic_write_bytes(onnx_file_path, model)
    return onnx_file_path


def get_model_metadata(model_file):
    """Input/output names+shapes of an ONNX file (reference:
    ``mx.contrib.onnx.get_model_metadata``)."""
    with open(model_file, "rb") as f:
        model = wire.parse_model(f.read())
    g = model["graph"]
    inits = {n for n, _ in g["initializers"]}
    return {
        "input_tensor_data": [(n, tuple(s)) for n, _t, s in g["inputs"]
                              if n not in inits],
        "output_tensor_data": [(n, tuple(s)) for n, _t, s in g["outputs"]],
    }


# ----------------------------------------------------------------------
# Import: ModelProto -> (Symbol, arg_params, aux_params)
# ----------------------------------------------------------------------

ONNX2MX_OP = {
    "Relu": ("Activation", {"act_type": "relu"}),
    "Sigmoid": ("Activation", {"act_type": "sigmoid"}),
    "Tanh": ("Activation", {"act_type": "tanh"}),
    "Softplus": ("Activation", {"act_type": "softrelu"}),
    "Softsign": ("Activation", {"act_type": "softsign"}),
    "Exp": ("exp", {}), "Log": ("log", {}), "Sqrt": ("sqrt", {}),
    "Abs": ("abs", {}), "Neg": ("negative", {}), "Erf": ("erf", {}),
    "Floor": ("floor", {}), "Ceil": ("ceil", {}),
    "Add": ("broadcast_add", {}), "Sub": ("broadcast_sub", {}),
    "Mul": ("broadcast_mul", {}), "Div": ("broadcast_div", {}),
    "Pow": ("broadcast_power", {}), "MatMul": ("matmul", {}),
    "Sum": ("add_n", {}), "Identity": ("identity", {}),
}


def _onnx_pads(attrs, nsp, kernel=None, strides=None, dilations=None):
    """Symmetric per-axis pads from ``pads`` or ``auto_pad``.

    Third-party exporters (tf2onnx, some torch eras) emit ``auto_pad``
    instead of explicit ``pads``; SAME_* resolves without the input
    shape only when the padded total is even per axis, which holds for
    the ubiquitous odd-kernel/stride-1 convs -- anything else is
    rejected loudly rather than imported wrong.
    """
    auto = attrs.get("auto_pad", "NOTSET")
    if isinstance(auto, bytes):
        auto = auto.decode()
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        if attrs.get("pads"):
            raise MXNetError("onnx import: both pads and auto_pad set")
        kernel = list(kernel or [])
        strides = list(strides or [1] * nsp)
        dilations = list(dilations or [1] * nsp)
        out = []
        for k, s, d in zip(kernel, strides, dilations):
            if s != 1:
                raise MXNetError(
                    "onnx import: auto_pad=%s with stride %d needs the "
                    "input shape; re-export with explicit pads" % (auto, s))
            total = d * (k - 1)
            if total % 2:
                raise MXNetError(
                    "onnx import: auto_pad=%s is asymmetric for "
                    "even-kernel axis (kernel %d)" % (auto, k))
            out.append(total // 2)
        return out
    pads = attrs.get("pads")
    if not pads:
        return [0] * nsp
    begin, end = pads[:nsp], pads[nsp:]
    if list(begin) != list(end):
        raise MXNetError("onnx import: asymmetric pads %r unsupported"
                         % (pads,))
    return list(begin)


class _Importer:
    def __init__(self, model):
        self.graph = model["graph"]
        self.inits = {n: a for n, a in self.graph["initializers"]}
        self.env = {}          # tensor name -> Symbol
        self.used_params = set()
        self.unsupported_outputs = {}  # extra output name -> op_type

    def sym_of(self, name):
        from ..symbol import symbol as S
        if name in self.unsupported_outputs:
            raise MXNetError(
                "onnx import: output %r of a %s node is consumed, but "
                "only the primary output is supported"
                % (name, self.unsupported_outputs[name]))
        if name not in self.env:
            self.env[name] = S.var(name)
        if name in self.inits:
            self.used_params.add(name)
        return self.env[name]

    def const_of(self, name):
        """Initializer consumed as a structural constant (shapes, axes)."""
        if name not in self.inits:
            raise MXNetError("onnx import: %r must be an initializer"
                             % name)
        return self.inits[name]

    def run(self):
        from ..symbol.symbol import Group, _make_node
        g = self.graph
        for node in g["nodes"]:
            op = node["op_type"]
            a = node["attrs"]
            ins = node["input"]
            out = node["output"][0]
            nm = node["name"] or out

            if op in ("Conv", "ConvTranspose"):
                w = self.inits.get(ins[1])
                # kernel_shape is optional in the spec: third-party
                # graphs routinely rely on the weight's trailing dims
                kernel = a.get("kernel_shape") or list(w.shape[2:])
                nsp = len(kernel)
                stride = a.get("strides", [1] * nsp)
                dilate = a.get("dilations", [1] * nsp)
                params = {"kernel": tuple(kernel),
                          "stride": tuple(stride),
                          "dilate": tuple(dilate),
                          "pad": tuple(_onnx_pads(a, nsp, kernel=kernel,
                                                  strides=stride,
                                                  dilations=dilate)),
                          "num_group": int(a.get("group", 1)),
                          "no_bias": len(ins) < 3}
                if op == "Conv":
                    params["num_filter"] = int(w.shape[0]) \
                        if w is not None else 0
                    mxop = "Convolution"
                else:
                    grp = params["num_group"]
                    params["num_filter"] = int(w.shape[1]) * grp \
                        if w is not None else 0
                    params["adj"] = tuple(a.get("output_padding",
                                                [0] * nsp))
                    mxop = "Deconvolution"
                syms = [self.sym_of(i) for i in ins]
                res = _make_node(mxop, syms, params, name=nm)
            elif op == "Gemm":
                alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
                if (alpha, beta) != (1.0, 1.0):
                    raise MXNetError("onnx import: Gemm alpha/beta != 1")
                if a.get("transA", 0):
                    raise MXNetError("onnx import: Gemm transA unsupported")
                w_name = ins[1]
                if not a.get("transB", 0):
                    if w_name not in self.inits:
                        raise MXNetError("onnx import: Gemm transB=0 needs "
                                         "an initializer weight")
                    # keep the original untouched (it may feed other
                    # consumers); this Gemm binds a transposed copy
                    t_name = w_name + "_transposed"
                    if t_name not in self.inits:
                        self.inits[t_name] = \
                            np.ascontiguousarray(self.inits[w_name].T)
                    w_name = t_name
                    ins = [ins[0], t_name] + list(ins[2:])
                w = self.inits.get(w_name)
                params = {"num_hidden": int(w.shape[0]) if w is not None
                          else 0, "no_bias": len(ins) < 3,
                          "flatten": False}
                syms = [self.sym_of(i) for i in ins]
                res = _make_node("FullyConnected", syms, params, name=nm)
            elif op == "BatchNormalization":
                params = {"eps": float(a.get("epsilon", 1e-5)),
                          "momentum": float(a.get("momentum", 0.9)),
                          "fix_gamma": False}
                syms = [self.sym_of(i) for i in ins[:3]]
                # running stats are aux states in the mx graph
                from ..attribute import AttrScope
                with AttrScope(__aux__="1"):
                    syms += [self.sym_of(i) for i in ins[3:5]]
                res = _make_node("BatchNorm", syms, params, name=nm)
            elif op in ("MaxPool", "AveragePool"):
                kernel = a["kernel_shape"]
                nsp = len(kernel)
                stride = a.get("strides", [1] * nsp)
                params = {"kernel": tuple(kernel),
                          "stride": tuple(stride),
                          "pad": tuple(_onnx_pads(a, nsp, kernel=kernel,
                                                  strides=stride)),
                          "pool_type": "max" if op == "MaxPool" else "avg",
                          "pooling_convention":
                          "full" if a.get("ceil_mode") else "valid"}
                if op == "AveragePool":
                    # the ONNX spec default is 0 (exclude padding) --
                    # our exporter always writes the attr explicitly,
                    # so honoring the spec default only changes
                    # third-party graphs, where it is what they meant
                    params["count_include_pad"] = \
                        bool(a.get("count_include_pad", 0))
                res = _make_node("Pooling", [self.sym_of(ins[0])], params,
                                 name=nm)
            elif op in ("GlobalMaxPool", "GlobalAveragePool"):
                params = {"global_pool": True,
                          "pool_type":
                          "max" if op == "GlobalMaxPool" else "avg"}
                res = _make_node("Pooling", [self.sym_of(ins[0])], params,
                                 name=nm)
            elif op == "Flatten":
                if int(a.get("axis", 1)) != 1:
                    raise MXNetError("onnx import: Flatten axis != 1")
                res = _make_node("Flatten", [self.sym_of(ins[0])], {},
                                 name=nm)
            elif op == "Constant":
                # a Constant node IS an initializer wearing node syntax
                # (the dominant third-party idiom for Reshape shapes)
                val = a.get("value")
                if val is None and "value_float" in a:
                    val = np.asarray(a["value_float"], np.float32)
                if val is None and "value_int" in a:
                    val = np.asarray(a["value_int"], np.int64)
                if val is None and "value_ints" in a:
                    val = np.asarray(a["value_ints"], np.int64)
                if val is None:
                    raise MXNetError("onnx import: Constant node %r has "
                                     "no supported value attr" % nm)
                self.inits[out] = np.asarray(val)
                continue
            elif op == "Reshape":
                if len(ins) > 1:
                    shape = [int(x) for x in self.const_of(ins[1])]
                else:
                    # opset<5 idiom (still emitted by some exporters):
                    # the target shape rides as an attribute
                    shape = [int(x) for x in a.get("shape", ())]
                    if not shape:
                        raise MXNetError("onnx import: Reshape without "
                                         "shape input or attr")
                res = _make_node("Reshape", [self.sym_of(ins[0])],
                                 {"shape": tuple(shape)}, name=nm)
            elif op == "Transpose":
                params = {}
                if "perm" in a:
                    params["axes"] = tuple(a["perm"])
                res = _make_node("transpose", [self.sym_of(ins[0])],
                                 params, name=nm)
            elif op == "Concat":
                res = _make_node("Concat",
                                 [self.sym_of(i) for i in ins],
                                 {"dim": int(a.get("axis", 1)),
                                  "num_args": len(ins)}, name=nm)
            elif op == "Softmax":
                res = _make_node("softmax", [self.sym_of(ins[0])],
                                 {"axis": int(a.get("axis", -1))}, name=nm)
            elif op == "LeakyRelu":
                res = _make_node("LeakyReLU", [self.sym_of(ins[0])],
                                 {"act_type": "leaky",
                                  "slope": float(a.get("alpha", 0.01))},
                                 name=nm)
            elif op == "Elu":
                res = _make_node("LeakyReLU", [self.sym_of(ins[0])],
                                 {"act_type": "elu",
                                  "slope": float(a.get("alpha", 1.0))},
                                 name=nm)
            elif op == "Selu":
                res = _make_node("LeakyReLU", [self.sym_of(ins[0])],
                                 {"act_type": "selu"}, name=nm)
            elif op == "Clip":
                if len(ins) >= 3:
                    lo = float(self.const_of(ins[1]))
                    hi = float(self.const_of(ins[2]))
                else:
                    lo = float(a.get("min", -np.inf))
                    hi = float(a.get("max", np.inf))
                res = _make_node("clip", [self.sym_of(ins[0])],
                                 {"a_min": lo, "a_max": hi}, name=nm)
            elif op == "Gather":
                if int(a.get("axis", 0)) != 0:
                    raise MXNetError("onnx import: Gather axis != 0")
                res = _make_node("Embedding",
                                 [self.sym_of(ins[1]),
                                  self.sym_of(ins[0])], {}, name=nm)
            elif op == "Unsqueeze":
                axes = a.get("axes")
                if axes is None:
                    axes = [int(x) for x in self.const_of(ins[1])]
                if any(ax < 0 for ax in axes) and len(axes) > 1:
                    raise MXNetError("onnx import: negative multi-axis "
                                     "Unsqueeze")
                res = self.sym_of(ins[0])
                # multi-axis unsqueeze = chained expand_dims, ascending
                # so earlier insertions don't shift later axes
                for i, ax in enumerate(sorted(int(x) for x in axes)):
                    res = _make_node("expand_dims", [res],
                                     {"axis": ax},
                                     name=nm if i == len(axes) - 1
                                     else "%s_ax%d" % (nm, ax))
            elif op == "Squeeze":
                axes = a.get("axes")
                if axes is None and len(ins) > 1:
                    axes = [int(x) for x in self.const_of(ins[1])]
                params = {} if axes is None \
                    else {"axis": tuple(int(x) for x in axes)}
                res = _make_node("squeeze", [self.sym_of(ins[0])],
                                 params, name=nm)
            elif op == "ReduceMean":
                # ResNet-style third-party graphs spell global average
                # pooling as ReduceMean over the spatial axes
                axes = a.get("axes")
                if axes is None and len(ins) > 1:
                    axes = [int(x) for x in self.const_of(ins[1])]
                if list(axes or []) != [2, 3]:
                    raise MXNetError(
                        "onnx import: ReduceMean only supported over "
                        "spatial axes [2, 3] (got %r)" % (axes,))
                pooled = _make_node("Pooling", [self.sym_of(ins[0])],
                                    {"global_pool": True,
                                     "pool_type": "avg"},
                                    name=nm + "_gap"
                                    if not a.get("keepdims", 1) else nm)
                if a.get("keepdims", 1):
                    res = pooled
                else:
                    res = _make_node("Flatten", [pooled], {}, name=nm)
            elif op == "Dropout":
                res = self.sym_of(ins[0])
            elif op in ONNX2MX_OP:
                mxop, params = ONNX2MX_OP[op]
                res = _make_node(mxop, [self.sym_of(i) for i in ins],
                                 dict(params), name=nm)
            else:
                raise MXNetError("onnx import: no converter for op %r"
                                 % op)
            self.env[out] = res[0] if len(res) > 1 else res
            for extra in node["output"][1:]:
                # declared-but-unsupported secondary outputs (Dropout
                # mask, BN training stats): error on use, not silently
                # alias the primary output
                if extra:
                    self.unsupported_outputs[extra] = op

        outs = [self.sym_of(n) for n, _t, _s in self.graph["outputs"]]
        sym = outs[0] if len(outs) == 1 else Group(outs)

        from ..context import cpu
        from ..ndarray import ndarray as nd
        arg_params, aux_params = {}, {}
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        for name, arr in self.inits.items():
            if name not in self.used_params:
                continue  # structural constant (shape/axes), consumed
            t = nd.array(np.ascontiguousarray(arr), ctx=cpu())
            if name in aux_names:
                aux_params[name] = t
            elif name in arg_names:
                arg_params[name] = t
        return sym, arg_params, aux_params


def import_model(model_file):
    """Import an ONNX file -> ``(sym, arg_params, aux_params)``
    (reference: ``mx.contrib.onnx.import_model``)."""
    with open(model_file, "rb") as f:
        model = wire.parse_model(f.read())
    return _Importer(model).run()
