"""Minimal ONNX reader: protobuf wire-format parsing in pure Python.

Parses just enough of onnx.ModelProto to recover:
- graph initializers (name, dims, dtype, ndarray data),
- graph nodes (op_type, inputs, outputs, name),
- graph input/output names.

It reads the weights of an .onnx file without onnx or onnxruntime. The
port keeps its own copy of ``image_enhancement_deglaring_tpu.modelio.
onnx_reader`` (numpy only) so that it imports nothing of the JAX package.
Field numbers follow onnx.proto3.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# onnx.TensorProto.DataType -> numpy dtype
_ONNX_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, i
        shift += 7


def _signed64(v: int) -> int:
    """Reinterpret an unsigned varint as two's-complement int64.

    Protobuf encodes negative int64 fields (ONNX int attributes like
    axis=-1, and int64_data entries like Reshape shapes with -1) as
    10-byte varints equal to v + 2^64; without this they'd decode as huge
    positives and crash/corrupt the import."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes, start: int, end: int):
    """Yield (field_number, wire_type, value) over a message's bytes.

    Length-delimited values are (start, end) spans into ``buf``.
    """
    i = start
    while i < end:
        tag, i = _read_varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
            yield fn, wt, v
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            yield fn, wt, (i, i + ln)
            i += ln
        elif wt == 5:  # fixed32
            yield fn, wt, struct.unpack_from("<I", buf, i)[0]
            i += 4
        elif wt == 1:  # fixed64
            yield fn, wt, struct.unpack_from("<Q", buf, i)[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt} at offset {i}")


def _span_str(buf: bytes, span: tuple[int, int]) -> str:
    return buf[span[0] : span[1]].decode("utf-8")


@dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    # attribute name -> int | float | list[int] | bytes (only what we need)
    attributes: dict = field(default_factory=dict)


@dataclass
class OnnxGraph:
    initializers: dict[str, np.ndarray]
    nodes: list[OnnxNode]
    inputs: list[str]
    outputs: list[str]
    name: str = ""


def _parse_tensor(buf: bytes, start: int, end: int) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw_span = None
    float_data: list[float] = []
    int64_data: list[int] = []
    int32_data: list[int] = []
    double_data: list[float] = []
    uint64_data: list[int] = []
    for fn, wt, v in _iter_fields(buf, start, end):
        if fn == 1 and wt == 0:  # dims (repeated varint)
            dims.append(v)
        elif fn == 1 and wt == 2:  # packed dims
            s, e = v
            i = s
            while i < e:
                d, i = _read_varint(buf, i)
                dims.append(d)
        elif fn == 2:  # data_type
            dtype_code = v
        elif fn == 4 and wt == 2:  # packed float_data
            s, e = v
            float_data.extend(struct.unpack(f"<{(e - s) // 4}f", buf[s:e]))
        elif fn == 4 and wt == 5:
            float_data.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif fn == 7 and wt == 2:  # packed int64_data
            s, e = v
            i = s
            while i < e:
                d, i = _read_varint(buf, i)
                int64_data.append(_signed64(d))
        elif fn == 7 and wt == 0:
            int64_data.append(_signed64(v))
        elif fn == 8:  # name
            name = _span_str(buf, v)
        elif fn == 9:  # raw_data
            raw_span = v
        elif fn == 5 and wt == 2:  # packed int32_data (also carries
            s, e = v               # INT8/16, UINT8/16, BOOL, FLOAT16 bits)
            i = s
            while i < e:
                d, i = _read_varint(buf, i)
                int32_data.append(_signed64(d))
        elif fn == 5 and wt == 0:
            int32_data.append(_signed64(v))
        elif fn == 10 and wt == 2:  # packed double_data
            s, e = v
            double_data.extend(struct.unpack(f"<{(e - s) // 8}d", buf[s:e]))
        elif fn == 10 and wt == 1:
            double_data.append(struct.unpack("<d", struct.pack("<Q", v))[0])
        elif fn == 11 and wt == 2:  # packed uint64_data (UINT32/UINT64)
            s, e = v
            i = s
            while i < e:
                d, i = _read_varint(buf, i)
                uint64_data.append(d)
        elif fn == 11 and wt == 0:
            uint64_data.append(v)
    np_dtype = _ONNX_DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"unsupported ONNX tensor dtype {dtype_code} for {name!r}")
    if raw_span is not None:
        arr = np.frombuffer(buf[raw_span[0] : raw_span[1]], dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np_dtype)
    elif int32_data:
        if np_dtype == np.float16:  # stored as uint16 bit patterns
            arr = (np.asarray(int32_data, np.int64) & 0xFFFF).astype(
                np.uint16).view(np.float16)
        else:
            arr = np.asarray(int32_data, np.int64).astype(np_dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=np_dtype)
    elif uint64_data:
        arr = np.asarray(uint64_data, np.uint64).astype(np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_attribute(buf: bytes, start: int, end: int) -> tuple[str, object]:
    name = ""
    val: object = None
    ints: list[int] = []
    for fn, wt, v in _iter_fields(buf, start, end):
        if fn == 1:  # name
            name = _span_str(buf, v)
        elif fn == 2:  # f (float, fixed32)
            val = struct.unpack("<f", struct.pack("<I", v))[0]
        elif fn == 3:  # i (int)
            val = _signed64(v)
        elif fn == 4:  # s (bytes)
            val = buf[v[0] : v[1]]
        elif fn == 8 and wt == 0:  # ints (repeated, onnx.proto3 field 8)
            ints.append(_signed64(v))
        elif fn == 8 and wt == 2:  # packed ints
            s, e = v
            i = s
            while i < e:
                d, i = _read_varint(buf, i)
                ints.append(_signed64(d))
        elif fn == 7 and wt == 0:  # legacy: our pre-fix exporter wrote ints
            ints.append(_signed64(v))  # under field 7 (spec: floats) unpacked
        elif fn == 5:  # t (tensor)
            val = _parse_tensor(buf, v[0], v[1])[1]
    if ints:
        val = ints
    return name, val


def _parse_node(buf: bytes, start: int, end: int) -> OnnxNode:
    node = OnnxNode(op_type="", inputs=[], outputs=[])
    for fn, wt, v in _iter_fields(buf, start, end):
        if fn == 1:
            node.inputs.append(_span_str(buf, v))
        elif fn == 2:
            node.outputs.append(_span_str(buf, v))
        elif fn == 3:
            node.name = _span_str(buf, v)
        elif fn == 4:
            node.op_type = _span_str(buf, v)
        elif fn == 5:
            k, val = _parse_attribute(buf, v[0], v[1])
            node.attributes[k] = val
    return node


def _value_info_name(buf: bytes, start: int, end: int) -> str:
    for fn, _wt, v in _iter_fields(buf, start, end):
        if fn == 1:
            return _span_str(buf, v)
    return ""


def load_onnx(path: str) -> OnnxGraph:
    """Parse an .onnx file into an :class:`OnnxGraph`."""
    with open(path, "rb") as f:
        buf = f.read()

    graph_span = None
    for fn, wt, v in _iter_fields(buf, 0, len(buf)):
        if fn == 7 and wt == 2:  # ModelProto.graph
            graph_span = v
            break
    if graph_span is None:
        raise ValueError(f"{path}: no GraphProto found")

    g = OnnxGraph(initializers={}, nodes=[], inputs=[], outputs=[])
    for fn, wt, v in _iter_fields(buf, graph_span[0], graph_span[1]):
        if fn == 1:  # node
            g.nodes.append(_parse_node(buf, v[0], v[1]))
        elif fn == 2:  # name
            g.name = _span_str(buf, v)
        elif fn == 5:  # initializer
            name, arr = _parse_tensor(buf, v[0], v[1])
            g.initializers[name] = arr
        elif fn == 11:  # input (ValueInfoProto)
            g.inputs.append(_value_info_name(buf, v[0], v[1]))
        elif fn == 12:  # output
            g.outputs.append(_value_info_name(buf, v[0], v[1]))
    return g
