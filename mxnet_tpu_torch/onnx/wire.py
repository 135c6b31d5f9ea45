"""Self-contained ONNX protobuf wire format, the port's own copy of
``mxnet_tpu/onnx/wire.py`` (no ``onnx``/``protobuf`` dependency).

The protobuf wire format (varint tags and length-delimited
submessages, the only parts ONNX uses) is written and read directly.
Field numbers follow onnx.proto3 (IR version 8 era); readers accept
both packed and unpacked repeated scalars, writers emit ONNX's own
conventions (packed numeric tensor payloads in ``raw_data``), so a
file is byte for byte the JAX package's.

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

# -- primitives --------------------------------------------------------


def _uvarint(n):
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_uvarint(buf, pos):
    shift = 0
    val = 0
    while True:
        if pos >= len(buf):
            raise MXNetError("onnx: truncated varint")
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 70:
            raise MXNetError("onnx: varint too long")


def _svarint(n):
    # int64 fields are encoded two's-complement as uint64
    return _uvarint(n & (1 << 64) - 1)


def _to_signed(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def field_varint(num, val):
    return _uvarint(num << 3 | 0) + _svarint(int(val))


def field_bytes(num, payload):
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return _uvarint(num << 3 | 2) + _uvarint(len(payload)) + payload


def field_float(num, val):
    return _uvarint(num << 3 | 5) + struct.pack("<f", float(val))


def parse_message(buf):
    """Parse one protobuf message into {field_number: [(wiretype, value)]}.
    Length-delimited values stay as bytes (caller recurses as needed)."""
    fields = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_uvarint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_uvarint(buf, pos)
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_uvarint(buf, pos)
            val = buf[pos:pos + ln]
            if len(val) != ln:
                raise MXNetError("onnx: truncated length-delimited field")
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise MXNetError("onnx: unsupported wire type %d" % wt)
        fields.setdefault(num, []).append((wt, val))
    return fields


def get_ints(fields, num):
    """Repeated int64: accepts unpacked varints and packed blobs."""
    out = []
    for wt, v in fields.get(num, []):
        if wt == 0:
            out.append(_to_signed(v))
        elif wt == 2:
            pos = 0
            while pos < len(v):
                x, pos = _read_uvarint(v, pos)
                out.append(_to_signed(x))
    return out


def get_int(fields, num, default=0):
    vals = get_ints(fields, num)
    return vals[-1] if vals else default


def get_floats(fields, num):
    out = []
    for wt, v in fields.get(num, []):
        if wt == 5:
            out.append(struct.unpack("<f", v)[0])
        elif wt == 2:
            out.extend(struct.unpack("<%df" % (len(v) // 4), v))
    return out


def get_bytes(fields, num, default=b""):
    vals = [v for wt, v in fields.get(num, []) if wt == 2]
    return vals[-1] if vals else default


def get_str(fields, num, default=""):
    b = get_bytes(fields, num, None)
    return b.decode("utf-8") if b is not None else default


def get_all_bytes(fields, num):
    return [v for wt, v in fields.get(num, []) if wt == 2]


# -- TensorProto -------------------------------------------------------

# onnx TensorProto.DataType
DT_FLOAT, DT_UINT8, DT_INT8, DT_UINT16, DT_INT16, DT_INT32, DT_INT64 = \
    1, 2, 3, 4, 5, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_UINT32, DT_UINT64, DT_BFLOAT16 = \
    9, 10, 11, 12, 13, 16

_NP2DT = {
    np.dtype(np.float32): DT_FLOAT, np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int8): DT_INT8, np.dtype(np.uint16): DT_UINT16,
    np.dtype(np.int16): DT_INT16, np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64, np.dtype(np.bool_): DT_BOOL,
    np.dtype(np.float16): DT_FLOAT16, np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.uint32): DT_UINT32, np.dtype(np.uint64): DT_UINT64,
}
_DT2NP = {v: k for k, v in _NP2DT.items()}


def make_tensor(name, arr):
    """TensorProto from a numpy array (payload in raw_data, little-endian,
    as onnx's own exporters emit)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        dt = DT_BFLOAT16
    elif arr.dtype in _NP2DT:
        dt = _NP2DT[arr.dtype]
    else:  # anything exotic: store as fp32
        arr = np.ascontiguousarray(arr.astype(np.float32))
        dt = DT_FLOAT
    raw = arr.tobytes()
    out = b""
    for d in arr.shape:
        out += field_varint(1, d)            # dims
    out += field_varint(2, dt)               # data_type
    out += field_bytes(8, name)              # name
    out += field_bytes(9, raw)               # raw_data
    return out


def parse_tensor(buf):
    """-> (name, numpy array)."""
    f = parse_message(buf)
    dims = get_ints(f, 1)
    dt = get_int(f, 2, DT_FLOAT)
    name = get_str(f, 8)
    raw = get_bytes(f, 9, None)
    if dt == DT_BFLOAT16:
        import ml_dtypes
        np_dt = np.dtype(ml_dtypes.bfloat16)
    elif dt in _DT2NP:
        np_dt = _DT2NP[dt]
    else:
        raise MXNetError("onnx: unsupported tensor data_type %d" % dt)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dt).reshape(dims).copy()
    else:
        # typed repeated fields (float_data=4, int32_data=5, int64_data=7)
        if dt == DT_FLOAT:
            arr = np.asarray(get_floats(f, 4), np.float32).reshape(dims)
        elif dt == DT_INT64:
            arr = np.asarray(get_ints(f, 7), np.int64).reshape(dims)
        elif dt in (DT_INT32, DT_INT16, DT_INT8, DT_UINT16, DT_UINT8,
                    DT_BOOL):
            arr = np.asarray(get_ints(f, 5), np_dt).reshape(dims)
        else:
            raise MXNetError("onnx: tensor %r has no payload" % name)
    return name, arr


# -- AttributeProto ----------------------------------------------------

AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_GRAPH = 1, 2, 3, 4, 5
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


def make_attr(name, value):
    out = field_bytes(1, name)
    if isinstance(value, bool):
        out += field_varint(3, int(value)) + field_varint(20, AT_INT)
    elif isinstance(value, (int, np.integer)):
        out += field_varint(3, int(value)) + field_varint(20, AT_INT)
    elif isinstance(value, (float, np.floating)):
        out += field_float(2, value) + field_varint(20, AT_FLOAT)
    elif isinstance(value, (str, bytes)):
        out += field_bytes(4, value) + field_varint(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        out += field_bytes(5, make_tensor("", value)) \
            + field_varint(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], (float, np.floating)):
            for v in value:
                out += field_float(7, v)
            out += field_varint(20, AT_FLOATS)
        elif value and isinstance(value[0], (str, bytes)):
            for v in value:
                out += field_bytes(9, v)
            out += field_varint(20, AT_STRINGS)
        else:
            for v in value:
                out += field_varint(8, int(v))
            out += field_varint(20, AT_INTS)
    else:
        raise MXNetError("onnx: unsupported attribute value %r" % (value,))
    return out


def parse_attr(buf):
    """-> (name, python value)."""
    f = parse_message(buf)
    name = get_str(f, 1)
    at = get_int(f, 20, 0)
    if at == AT_FLOAT:
        return name, get_floats(f, 2)[-1]
    if at == AT_INT:
        return name, get_int(f, 3)
    if at == AT_STRING:
        return name, get_bytes(f, 4).decode("utf-8")
    if at == AT_TENSOR:
        return name, parse_tensor(get_bytes(f, 5))[1]
    if at == AT_FLOATS:
        return name, get_floats(f, 7)
    if at == AT_INTS:
        return name, get_ints(f, 8)
    if at == AT_STRINGS:
        return name, [b.decode("utf-8") for b in get_all_bytes(f, 9)]
    # tolerate untyped attrs: guess by populated field
    if 3 in f:
        return name, get_int(f, 3)
    if 8 in f:
        return name, get_ints(f, 8)
    raise MXNetError("onnx: attribute %r has unsupported type %d"
                     % (name, at))


# -- Node / ValueInfo / Graph / Model ---------------------------------


def make_node(op_type, inputs, outputs, name="", attrs=None, domain=""):
    out = b""
    for i in inputs:
        out += field_bytes(1, i)
    for o in outputs:
        out += field_bytes(2, o)
    if name:
        out += field_bytes(3, name)
    out += field_bytes(4, op_type)
    for k, v in (attrs or {}).items():
        out += field_bytes(5, make_attr(k, v))
    if domain:
        out += field_bytes(7, domain)
    return out


def parse_node(buf):
    f = parse_message(buf)
    return {
        "input": [b.decode("utf-8") for b in get_all_bytes(f, 1)],
        "output": [b.decode("utf-8") for b in get_all_bytes(f, 2)],
        "name": get_str(f, 3),
        "op_type": get_str(f, 4),
        "attrs": dict(parse_attr(a) for a in get_all_bytes(f, 5)),
    }


def make_value_info(name, elem_type, shape):
    dims = b""
    for d in shape:
        if isinstance(d, (int, np.integer)) and d >= 0:
            dims += field_bytes(1, field_varint(1, d))     # dim_value
        else:
            dims += field_bytes(1, field_bytes(2, str(d)))  # dim_param
    tensor_type = field_varint(1, elem_type) + field_bytes(2, dims)
    type_proto = field_bytes(1, tensor_type)
    return field_bytes(1, name) + field_bytes(2, type_proto)


def parse_value_info(buf):
    f = parse_message(buf)
    name = get_str(f, 1)
    shape = []
    elem_type = DT_FLOAT
    tp = get_bytes(f, 2, None)
    if tp is not None:
        tpf = parse_message(tp)
        tt = get_bytes(tpf, 1, None)
        if tt is not None:
            ttf = parse_message(tt)
            elem_type = get_int(ttf, 1, DT_FLOAT)
            shp = get_bytes(ttf, 2, None)
            if shp is not None:
                for dim_buf in get_all_bytes(parse_message(shp), 1):
                    df = parse_message(dim_buf)
                    if 1 in df:
                        shape.append(get_int(df, 1))
                    else:
                        shape.append(get_str(df, 2) or 0)
    return name, elem_type, shape


def make_graph(nodes, name, inputs, outputs, initializers):
    out = b""
    for n in nodes:
        out += field_bytes(1, n)
    out += field_bytes(2, name)
    for t in initializers:
        out += field_bytes(5, t)
    for vi in inputs:
        out += field_bytes(11, vi)
    for vi in outputs:
        out += field_bytes(12, vi)
    return out


def parse_graph(buf):
    f = parse_message(buf)
    return {
        "nodes": [parse_node(b) for b in get_all_bytes(f, 1)],
        "name": get_str(f, 2),
        "initializers": [parse_tensor(b) for b in get_all_bytes(f, 5)],
        "inputs": [parse_value_info(b) for b in get_all_bytes(f, 11)],
        "outputs": [parse_value_info(b) for b in get_all_bytes(f, 12)],
    }


def make_model(graph, ir_version=8, opset=13, producer="mxnet_tpu",
               producer_version="1.0", domain=""):
    opset_id = field_bytes(1, domain) + field_varint(2, opset)
    out = field_varint(1, ir_version)
    out += field_bytes(8, opset_id)      # opset_import (field 8)
    out += field_bytes(2, producer)
    out += field_bytes(3, producer_version)
    out += field_bytes(7, graph)         # graph (field 7)
    return out


def parse_model(buf):
    f = parse_message(buf)
    graph_buf = get_bytes(f, 7, None)
    if graph_buf is None:
        raise MXNetError("onnx: ModelProto has no graph")
    opsets = {}
    for b in get_all_bytes(f, 8):
        of = parse_message(b)
        opsets[get_str(of, 1)] = get_int(of, 2)
    return {
        "ir_version": get_int(f, 1),
        "producer": get_str(f, 2),
        "opset": opsets,
        "graph": parse_graph(graph_buf),
    }
