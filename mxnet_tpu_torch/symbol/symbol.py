"""Symbol: declarative graph composition (counterpart of
``mxnet_tpu/symbol/symbol.py``; reference ``python/mxnet/symbol/
symbol.py`` over nnvm's ``Graph``/``Node``).

A :class:`Symbol` is one or more output entries of a DAG of op nodes
over the port's op table (:mod:`mxnet_tpu_torch.ops.table`), the same
table as ``mx.nd``.  Running it is a topological walk calling each
entry's function on tensors (:func:`_eval_symbol`); the
:class:`~mxnet_tpu_torch.executor.Executor` captures that walk into CUDA
graphs on the card.  Shapes propagate through the same functions on
tensors of PyTorch's ``meta`` device, which hold no data.

Serialization keeps the reference's ``-symbol.json`` schema (``nodes`` /
``arg_nodes`` / ``heads``), byte for byte the JAX package's, so a graph
written by either package loads in the other.
"""
from __future__ import annotations

import ast
import inspect
import json

import numpy as np
import torch

from ..attribute import AttrScope
from ..base import MXNetError
from ..name import NameManager
from ..ops import table

__all__ = ["Group", "Symbol", "Variable", "load", "load_json", "var"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op, name, attrs, inputs, num_outputs=1):
        self.op = op            # op name, or None for a variable
        self.name = name
        self.attrs = attrs      # {str: value}
        self.inputs = inputs    # [(node, output index)]
        self.num_outputs = num_outputs


class Symbol:
    """One or more output entries of a graph."""

    def __init__(self, outputs):
        self._outputs = outputs  # [(node, output index)]

    # -- composition ---------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group[%d]" % len(self._outputs))

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %r not found" % index)
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    def _binop(self, other, opname, reverse=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _make_node(opname, [lhs, rhs], {})
        scalar_ops = {
            "elemwise_add": "_plus_scalar",
            "elemwise_sub": "_rminus_scalar" if reverse else "_minus_scalar",
            "elemwise_mul": "_mul_scalar",
            "elemwise_div": "_rdiv_scalar" if reverse else "_div_scalar",
            "broadcast_power": "_rpower_scalar" if reverse
            else "_power_scalar"}
        return _make_node(scalar_ops[opname], [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binop(o, "elemwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power")

    def __neg__(self):
        return _make_node("negative", [self], {})

    # -- graph queries -------------------------------------------------
    def _topo(self):
        """Nodes in topological order, by an iterative walk (a deep
        sequential graph would overflow Python's stack)."""
        order, seen = [], set()
        for root, _ in self._outputs:
            if id(root) in seen:
                continue
            stack = [(root, False)]
            while stack:
                node, expanded = stack.pop()
                if expanded:
                    order.append(node)
                    continue
                if id(node) in seen:
                    continue
                seen.add(id(node))
                stack.append((node, True))
                for inp, _ in reversed(node.inputs):
                    if id(inp) not in seen:
                        stack.append((inp, False))
        return order

    def list_arguments(self):
        """Variable names in topological order, aux states (``__aux__``,
        BatchNorm's running statistics) left out."""
        return [n.name for n in self._topo()
                if n.op is None and "__aux__" not in n.attrs]

    def list_outputs(self):
        return ["%s_output%d" % (node.name, idx) if node.num_outputs > 1
                else node.name + "_output" for node, idx in self._outputs]

    def list_auxiliary_states(self):
        """The aux-state variables: inputs an op updates and no gradient
        reaches (BatchNorm's ``moving_mean``/``moving_var``)."""
        return [n.name for n in self._topo()
                if n.op is None and "__aux__" in n.attrs]

    def get_internals(self):
        return Symbol([(n, i) for n in self._topo()
                       for i in range(n.num_outputs)])

    def attr(self, key):
        return self._outputs[0][0].attrs.get(key)

    # -- shape and type inference --------------------------------------
    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes given
        by name: each node runs on ``meta`` tensors, and a parameter
        variable with no shape is sized by its op's rule
        (:func:`_param_shape_rule`), so the data and label shapes are
        enough, as ``Module.bind`` needs."""
        return _infer_shapes_forward(self, kwargs, partial=False)

    def infer_shape_partial(self, **kwargs):
        """:meth:`infer_shape` with ``None`` for what cannot be deduced,
        in place of raising."""
        return _infer_shapes_forward(self, kwargs, partial=True)

    def infer_type(self, **kwargs):
        """float32 everywhere but an int8 op's weight and bias (int8)."""
        return ([np.dtype(d).type for d in _arg_dtypes(self)],
                [np.float32] * len(self._outputs), [])

    # -- execution -----------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """The outputs, as NDArrays, of one walk over the NDArrays given
        by name."""
        from ..ndarray import NDArray
        return [NDArray(t) for t in _eval_symbol(self, kwargs)]

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, check=None, **kwargs):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req,
                        aux_states=aux_states, group2ctx=group2ctx,
                        check=check)

    def simple_bind(self, ctx=None, grad_req="write", check=None, **shapes):
        """Allocate every argument (shapes not given are inferred) and
        bind.  ``check=True`` (or ``MXNET_TPU_GRAPH_CHECK=1``) runs the
        static graph check over the given shapes first, so a broken
        graph raises ``GraphCheckError`` before anything is
        allocated."""
        from .. import env as _env
        from ..executor import Executor
        from ..ndarray import zeros
        if check is None:
            check = _env.get("MXNET_TPU_GRAPH_CHECK")
        if check:
            from ..analysis.graph_check import assert_graph_ok
            assert_graph_ok(self, shapes=shapes or None)
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        args = {name: zeros(shape, ctx=ctx)
                for name, shape in zip(self.list_arguments(), arg_shapes)}
        args_grad = {k: zeros(v.shape, ctx=ctx) for k, v in args.items()} \
            if grad_req != "null" else None
        aux = {name: zeros(shape, ctx=ctx)
               for name, shape in zip(self.list_auxiliary_states(),
                                      aux_shapes)}
        # checked above, over the shapes the allocation follows
        return Executor(self, ctx, args, args_grad, grad_req,
                        aux_states=aux, check=False)

    # -- serialization (reference: nnvm saveload_json.cc) --------------
    def tojson(self):
        nodes = self._topo()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{"op": n.op if n.op is not None else "null",
                   "name": n.name,
                   "attrs": {k: str(v) for k, v in n.attrs.items()},
                   "inputs": [[node_ids[id(src)], oi, 0]
                              for src, oi in n.inputs]} for n in nodes]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.op is None],
            "heads": [[node_ids[id(n)], oi, 0] for n, oi in self._outputs],
            "attrs": {"mxnet_version": ["int", 10700],
                      "mxnet_tpu": ["str", "1"]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


def var(name, shape=None, dtype=None, **kwargs):
    """A variable symbol, with the attributes of the enclosing
    :class:`~mxnet_tpu_torch.attribute.AttrScope`."""
    attrs = AttrScope.current_attrs()
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(_Node(None, name, attrs, []), 0)])


Variable = var


def Group(symbols):
    return Symbol([o for s in symbols for o in s._outputs])


def _parse_attr_value(v):
    # attributes read from a -symbol.json are untrusted: literal_eval
    # takes the tuples, numbers and booleans they hold, and runs no code
    s = str(v)
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


# ops whose further outputs are states: a whole such symbol composed as
# an input means its first output
_PRIMARY_FIRST = {"BatchNorm", "RNN", "fused_batch_norm_relu"}

# aux-state arguments: the output index carrying each one's new value,
# which an executor writes back after a training forward
_AUX_ARGS = {"BatchNorm": {"moving_mean": 1, "moving_var": 2},
             "fused_batch_norm_relu": {"moving_mean": 1, "moving_var": 2}}


def _skip_auto_var(opname, params, arg_name):
    """Whether a missing tensor argument is absent by structure, and so
    gets no automatic variable."""
    if arg_name == "bias" and params.get("no_bias"):
        return True
    if opname == "LeakyReLU" and arg_name == "gamma":
        # the reference lists gamma only for prelu (the JAX op takes no
        # gamma, nor prelu)
        return params.get("act_type", "leaky") != "prelu"
    return opname == "RNN" and arg_name == "state_cell" \
        and params.get("mode", "lstm") != "lstm"


def _make_node(opname, input_syms, params, name=None):
    spec = table.lookup(opname)
    name = NameManager.current().get(name, opname.lower().lstrip("_"))
    inputs = []
    for s in input_syms:
        if not isinstance(s, Symbol):
            raise MXNetError("op %s: expected Symbol input, got %r"
                             % (opname, s))
        if len(s._outputs) != 1 \
                and s._outputs[0][0].op not in _PRIMARY_FIRST:
            raise MXNetError("op %s: cannot take group symbol" % opname)
        inputs.append(s._outputs[0])
    # the tensor arguments left out become variables "{name}_{arg}" (as
    # nnvm composition makes them): sym.FullyConnected(data, num_hidden=k)
    # takes fc_weight and fc_bias as arguments
    if not spec.variadic and len(inputs) < len(spec.args):
        aux_map = _AUX_ARGS.get(opname, {})
        scope_attrs = AttrScope.current_attrs()
        for arg_name in spec.args[len(inputs):]:
            if _skip_auto_var(opname, params, arg_name):
                continue
            attrs = dict(scope_attrs)
            if arg_name in aux_map:
                attrs["__aux__"] = "1"
            inputs.append((_Node(None, "%s_%s" % (name, arg_name), attrs,
                                 []), 0))
    attrs = AttrScope.current_attrs()
    attrs.update(params)
    node = _Node(opname, name, attrs, inputs)
    node.num_outputs = _num_outputs(spec, node)
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _num_outputs(spec, node):
    """How many outputs a node's op gives, from its attributes."""
    if spec.name == "split":
        return int(_parse_attr_value(node.attrs.get("num_outputs", 1)))
    if spec.name in ("BatchNorm", "fused_batch_norm_relu"):
        return 3
    if spec.name == "RNN":
        return 3 if node.attrs.get("mode", "lstm") == "lstm" else 2
    if spec.name == "topk":
        return 2 if node.attrs.get("ret_typ") == "both" else 1
    if spec.name in ("linalg_syevd", "linalg_slogdet", "moments"):
        return 2
    if spec.name == "linalg_svd":
        return 3
    if spec.name in _QUANTIZED_OPS:
        return 3
    return 1


# each gives (values, min, max)
_QUANTIZED_OPS = ("quantize", "quantize_v2", "requantize",
                  "quantized_fully_connected", "quantized_conv",
                  "quantized_pooling")


def _signature_defaults(spec):
    """The parameters of an op that have defaults, with them."""
    return {p.name: p.default
            for p in inspect.signature(spec.fn).parameters.values()
            if p.name in spec.params
            and p.default is not inspect.Parameter.empty}


def _node_params(node, spec, training):
    params = _signature_defaults(spec)
    for k, v in node.attrs.items():
        if not k.startswith("__") and k in spec.params:
            params[k] = _parse_attr_value(v)
    if "training" in spec.params and "training" not in node.attrs:
        params["training"] = training
    return params


def _call_node(node, args, training, device):
    """One node's op on its input tensors."""
    spec = table.lookup(node.op)
    params = _node_params(node, spec, training)
    if not spec.variadic and len(args) < len(spec.args):
        # trailing tensor inputs absent by structure (no_bias=True)
        args = list(args) + [None] * (len(spec.args) - len(args))
    if spec.creates:
        params["device"] = device
    return spec.fn(*args, **params)


def _store(values, node, out):
    if isinstance(out, (tuple, list)):
        for i, o in enumerate(out):
            values[(id(node), i)] = o
    else:
        values[(id(node), 0)] = out


def _eval_symbol(sym, feed, aux_updates=None, training=None, device=None):
    """Walk ``sym`` over ``feed`` (name -> tensor or NDArray); returns
    the output tensors.  ``training`` defaults to
    ``autograd.is_training()``; an op that makes a tensor from none
    makes it on ``device``, by default that of the first fed tensor.
    With ``aux_updates`` a dict, the new values of aux states
    (:data:`_AUX_ARGS`) are collected into it by variable name."""
    if training is None:
        from .. import autograd
        training = autograd.is_training()
    values = {}
    for node in sym._topo():
        if node.op is None:
            if node.name not in feed:
                raise MXNetError("missing input %r" % node.name)
            v = feed[node.name]
            values[(id(node), 0)] = getattr(v, "_data", v)
            if device is None:
                device = values[(id(node), 0)].device
            continue
        args = [values[(id(src), oi)] for src, oi in node.inputs]
        _store(values, node, _call_node(node, args, training, device))
        if aux_updates is not None and node.op in _AUX_ARGS:
            arg_names = table.lookup(node.op).args
            for arg_name, out_idx in _AUX_ARGS[node.op].items():
                pos = arg_names.index(arg_name)
                if pos < len(node.inputs):
                    src, _ = node.inputs[pos]
                    if src.op is None and (id(node), out_idx) in values:
                        aux_updates[src.name] = values[(id(node), out_idx)]
    return [values[(id(n), oi)] for n, oi in sym._outputs]


# ----------------------------------------------------------------------
# Forward shape inference (nnvm InferShape)
# ----------------------------------------------------------------------

def _as_tuple(v):
    return (v,) if isinstance(v, int) else tuple(v)


def _param_shape_rule(opname, params, arg_name, in_shapes):
    """The shape of parameter variable ``arg_name`` of op ``opname``
    from the data input's shape ``in_shapes[0]`` (each op's
    FInferShape, for the parameters); None where no rule applies."""
    data = in_shapes[0] if in_shapes and in_shapes[0] is not None else None
    if data is None:
        return None
    if opname == "FullyConnected":
        nh = int(params.get("num_hidden", 0))
        if arg_name == "weight":
            k = int(np.prod(data[1:])) if params.get("flatten", True) \
                else int(data[-1])
            return (nh, k)
        if arg_name == "bias":
            return (nh,)
    elif opname == "Convolution":
        nf = int(params.get("num_filter", 0))
        kernel = _as_tuple(params.get("kernel", ()))
        groups = int(params.get("num_group", 1))
        if arg_name == "weight":
            return (nf, int(data[1]) // groups) + kernel
        if arg_name == "bias":
            return (nf,)
    elif opname == "Deconvolution":
        nf = int(params.get("num_filter", 0))
        kernel = _as_tuple(params.get("kernel", ()))
        if arg_name == "weight":
            return (int(data[1]), nf) + kernel
        if arg_name == "bias":
            return (nf,)
    elif opname in ("BatchNorm", "InstanceNorm", "GroupNorm"):
        return (int(data[int(params.get("axis", 1))]),)
    elif opname == "LayerNorm":
        return (int(data[int(params.get("axis", -1))]),)
    elif opname == "Embedding":
        return (int(params.get("input_dim", 0)),
                int(params.get("output_dim", 0)))
    elif opname == "_prelu":
        return (int(data[1]),) if len(data) > 1 else (1,)
    elif opname in ("SoftmaxOutput", "LogisticRegressionOutput"):
        if arg_name == "label":
            return (int(data[0]),)
    elif opname in ("LinearRegressionOutput", "MAERegressionOutput",
                    "softmax_cross_entropy"):
        if arg_name == "label":
            return tuple(data)
    elif opname in ("quantized_conv", "quantized_fully_connected"):
        return _quantized_param_shape(opname, params, arg_name, in_shapes)
    return None


def _quantized_param_shape(opname, params, arg_name, in_shapes):
    """An int8 op's weight and bias as its float op's (a ``no_bias``
    node's bias the one-element zero ``quantize_graph`` feeds), each
    range a scalar."""
    if arg_name.startswith(("min_", "max_")):
        return ()
    if arg_name == "bias" and params.get("no_bias"):
        return (1,)
    if opname == "quantized_fully_connected":
        return _param_shape_rule("FullyConnected", params, arg_name,
                                 in_shapes)
    shape = _param_shape_rule("Convolution", params, arg_name, in_shapes)
    layout = params.get("layout") or ""
    if arg_name == "weight" and layout.endswith("C"):
        groups = int(params.get("num_group", 1))
        shape = shape[:1] + shape[2:] + (int(in_shapes[0][-1]) // groups,)
    return shape


# the arguments that are not float32: the int8 ops' weights and biases
_ARG_DTYPES = {("quantized_conv", "weight"): "int8",
               ("quantized_conv", "bias"): "int8",
               ("quantized_fully_connected", "weight"): "int8",
               ("quantized_fully_connected", "bias"): "int8"}


def _arg_dtypes(sym):
    """Each argument's dtype name by the ops it feeds: int8 for an int8
    op's weight or bias, else float32."""
    dtypes = {}
    for node in sym._topo():
        if node.op is None:
            continue
        names = table.lookup(node.op).args
        for i, (src, _) in enumerate(node.inputs):
            if src.op is None and i < len(names):
                dt = _ARG_DTYPES.get((node.op, names[i]))
                if dt is not None:
                    dtypes[src.name] = dt
    return [dtypes.get(n, "float32") for n in sym.list_arguments()]


def _meta(shape, dtype="float32"):
    from ..ops.table import torch_dtype
    return torch.empty(tuple(shape), dtype=torch_dtype(str(dtype)),
                       device="meta")


def _infer_shapes_forward(sym, known, partial=False):
    """Walk the graph forward on ``meta`` tensors, sizing unknown
    parameter variables by :func:`_param_shape_rule`.  Returns
    ``(arg_shapes, out_shapes, aux_shapes)`` in ``list_arguments()``,
    ``list_outputs()`` and ``list_auxiliary_states()`` order."""
    known = {k: tuple(v) for k, v in known.items()}
    var_shape = {}          # name -> tuple
    specs = {}              # (id(node), oi) -> meta tensor

    for node in sym._topo():
        if node.op is None:
            if node.name in known:
                shape = known[node.name]
            elif "__shape__" in node.attrs:
                shape = tuple(_parse_attr_value(node.attrs["__shape__"]))
            else:
                continue
            var_shape[node.name] = shape
            specs[(id(node), 0)] = _meta(shape, node.attrs.get("__dtype__",
                                                               "float32"))
            continue
        spec = table.lookup(node.op)
        params = _node_params(node, spec, False)
        in_shapes = [specs.get((id(src), oi)) for src, oi in node.inputs]
        in_shapes = [None if s is None else tuple(s.shape)
                     for s in in_shapes]
        args = []
        for i, (src, oi) in enumerate(node.inputs):
            s = specs.get((id(src), oi))
            if s is None and src.op is None:
                shape = _param_shape_rule(
                    node.op, params,
                    spec.args[i] if i < len(spec.args) else "", in_shapes)
                if shape is not None:
                    s = specs[(id(src), oi)] = _meta(
                        shape, _ARG_DTYPES.get((node.op, spec.args[i]),
                                               "float32"))
                    var_shape[src.name] = shape
            args.append(s)
        if any(a is None for a in args):
            if partial:
                continue
            missing = [src.name for (src, _), a in zip(node.inputs, args)
                       if a is None]
            raise MXNetError("infer_shape: cannot deduce shape(s) of %r "
                             "feeding op %s(%s); pass them explicitly"
                             % (missing, node.op, node.name))
        try:
            with torch.no_grad():
                out = _call_node(node, args, False, torch.device("meta"))
        except Exception as e:   # any op's failure, named at its node
            if partial:
                continue
            raise MXNetError("infer_shape failed at %s(%s): %s"
                             % (node.op, node.name, e)) from e
        _store(specs, node, out)

    arg_names = sym.list_arguments()
    arg_shapes = [var_shape.get(n) for n in arg_names]
    if not partial and any(s is None for s in arg_shapes):
        missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
        raise MXNetError("infer_shape: undetermined arguments %r" % missing)
    out_shapes = []
    for n, oi in sym._outputs:
        s = specs.get((id(n), oi))
        out_shapes.append(tuple(s.shape) if s is not None else None)
    aux_shapes = [var_shape.get(n) for n in sym.list_auxiliary_states()]
    return arg_shapes, out_shapes, aux_shapes


def load_json(json_str):
    """A graph from a ``-symbol.json`` text."""
    data = json.loads(json_str)
    jnodes = data["nodes"]
    nodes = []
    for jn in jnodes:
        attrs = jn.get("attrs", jn.get("param", {})) or {}
        if jn["op"] == "null":
            nodes.append(_Node(None, jn["name"], attrs, []))
            continue
        try:
            table.lookup(jn["op"])
        except MXNetError:
            raise MXNetError("symbol json references unknown op %r"
                             % jn["op"]) from None
        nodes.append(_Node(jn["op"], jn["name"], attrs, []))
    for jn, node in zip(jnodes, nodes):
        node.inputs = [(nodes[i], oi) for i, oi, *_ in jn["inputs"]]
        if node.op is not None:
            node.num_outputs = _num_outputs(table.lookup(node.op), node)
    heads = data.get("heads", [[len(nodes) - 1, 0, 0]])
    return Symbol([(nodes[i], oi) for i, oi, *_ in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
