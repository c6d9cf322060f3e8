"""The initializers of an ``.onnx`` file, read without onnx or the program.

A frozen, reduced copy of the port's ``modelio/onnx_reader.py``: it walks
the protobuf wire format of ``ModelProto.graph.initializer`` and returns
each tensor by name as a numpy array. Only what a weights file needs is
kept (dims, data type, ``raw_data`` and the packed float / int64 fields).
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 11: np.float64}


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes, start: int, end: int):
    """(field number, wire type, value) of one message; a length-delimited
    value is its (start, end) span."""
    i = start
    while i < end:
        tag, i = _varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 2:
            n, i = _varint(buf, i)
            v, i = (i, i + n), i + n
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fn, wt, v


def _packed_varints(buf: bytes, span: tuple[int, int]) -> list[int]:
    out, i = [], span[0]
    while i < span[1]:
        v, i = _varint(buf, i)
        out.append(v - (1 << 64) if v >= 1 << 63 else v)
    return out


def _tensor(buf: bytes, span: tuple[int, int]) -> tuple[str, np.ndarray]:
    dims, code, name, raw, floats, ints = [], 1, "", None, [], []
    for fn, wt, v in _fields(buf, *span):
        if fn == 1:
            dims.extend(_packed_varints(buf, v) if wt == 2 else [v])
        elif fn == 2:
            code = v
        elif fn == 4 and wt == 2:
            floats.extend(struct.unpack(f"<{(v[1] - v[0]) // 4}f", buf[v[0]:v[1]]))
        elif fn == 7:
            ints.extend(_packed_varints(buf, v) if wt == 2 else [v])
        elif fn == 8:
            name = buf[v[0]:v[1]].decode()
        elif fn == 9:
            raw = buf[v[0]:v[1]]
    if code not in _DTYPES:
        raise ValueError(f"initializer {name!r}: unsupported ONNX data type {code}")
    dtype = _DTYPES[code]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).copy()
    else:
        arr = np.asarray(floats if floats else ints, dtype=dtype)
    return name, arr.reshape(dims) if dims else arr


def read_initializers(path: str) -> dict[str, np.ndarray]:
    """Every initializer of the ``.onnx`` file at ``path``, by name."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = next((v for fn, wt, v in _fields(buf, 0, len(buf)) if fn == 7 and wt == 2), None)
    if graph is None:
        raise ValueError(f"{path}: no graph in the model")
    return dict(_tensor(buf, v) for fn, wt, v in _fields(buf, *graph) if fn == 5)
