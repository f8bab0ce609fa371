"""Minimal TF1 frozen-graph (GraphDef) constant reader and writer (an own
copy of the JAX package's ``hri/perception/tf_graph.py``, which imports no
JAX).

The reference's Deep-SORT re-ID encoder runs the frozen
`mars-small128.pb` through a TF1 session
(HRI/TFVT_HRI/perception/tracker/re_id.py:22-48). TensorFlow is not a
dependency, so this module hand-decodes the protobuf wire format of
`GraphDef` far enough to pull every `Const` node's tensor — which for a
frozen inference graph is exactly the weight set. `reid.import_tf_consts`
then maps those tensors onto the port's `MarsSmall128` by position, shape
and scope.

Wire-format subset implemented (proto3):
  GraphDef.node (1, msg) → NodeDef{name (1, str), op (2, str),
  attr (5, map<str, AttrValue>)}; AttrValue.tensor (8, msg) →
  TensorProto{dtype (1, varint), tensor_shape (2, msg → dim (2) →
  size (1)), tensor_content (4, bytes), float_val (5), int_val (7)}.
Everything else is skipped by wire type.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_DT_FLOAT = 1
_DT_INT32 = 3

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _skip(data: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(data, pos)
        return pos
    if wire == _WIRE_64BIT:
        return pos + 8
    if wire == _WIRE_LEN:
        n, pos = _read_varint(data, pos)
        return pos + n
    if wire == _WIRE_32BIT:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire}")


def _fields(data: bytes):
    """Iterate (field_number, wire_type, value_or_span) over a message."""
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_LEN:
            n, pos = _read_varint(data, pos)
            yield field, wire, data[pos:pos + n]
            pos += n
        elif wire == _WIRE_VARINT:
            v, pos = _read_varint(data, pos)
            yield field, wire, v
        else:
            start = pos
            pos = _skip(data, pos, wire)
            yield field, wire, data[start:pos]


def _parse_shape(data: bytes) -> List[int]:
    dims = []
    for field, wire, val in _fields(data):
        if field == 2 and wire == _WIRE_LEN:        # dim
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == _WIRE_VARINT:  # size
                    dims.append(int(v2))
    return dims


def _parse_tensor(data: bytes) -> np.ndarray:
    dtype = _DT_FLOAT
    shape: List[int] = []
    content = b""
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, val in _fields(data):
        if field == 1 and wire == _WIRE_VARINT:
            dtype = int(val)
        elif field == 2 and wire == _WIRE_LEN:
            shape = _parse_shape(val)
        elif field == 4 and wire == _WIRE_LEN:
            content = val
        elif field == 5:                             # float_val
            if wire == _WIRE_32BIT:
                floats.append(struct.unpack("<f", val)[0])
            elif wire == _WIRE_LEN:                  # packed
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 7:                             # int_val
            if wire == _WIRE_VARINT:
                ints.append(int(val))
            elif wire == _WIRE_LEN:                  # packed varints
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(v)

    if dtype == _DT_FLOAT:
        np_dtype = np.float32
        vals = floats
    elif dtype == _DT_INT32:
        np_dtype = np.int32
        vals = ints
    else:
        raise ValueError(f"unsupported tensor dtype {dtype}")

    n = int(np.prod(shape)) if shape else 1
    if content:
        arr = np.frombuffer(content, np_dtype).copy()
    elif vals:
        arr = np.asarray(vals, np_dtype)
        if arr.size == 1 and n > 1:                  # splat encoding
            arr = np.full(n, arr[0], np_dtype)
    else:
        arr = np.zeros(n, np_dtype)
    return arr.reshape(shape) if shape else arr.reshape(())


def parse_graph_consts(data: bytes) -> Dict[str, np.ndarray]:
    """frozen GraphDef bytes → {const_node_name: ndarray} in graph order
    (for a frozen inference graph this is creation = layer order)."""
    out: Dict[str, np.ndarray] = {}
    for field, wire, node in _fields(data):
        if field != 1 or wire != _WIRE_LEN:          # GraphDef.node
            continue
        name, op, tensor = "", "", None
        for f2, w2, v2 in _fields(node):
            if f2 == 1 and w2 == _WIRE_LEN:
                name = v2.decode("utf-8", "replace")
            elif f2 == 2 and w2 == _WIRE_LEN:
                op = v2.decode("utf-8", "replace")
            elif f2 == 5 and w2 == _WIRE_LEN:        # attr map entry
                key, av = "", None
                for f3, w3, v3 in _fields(v2):
                    if f3 == 1 and w3 == _WIRE_LEN:
                        key = v3.decode("utf-8", "replace")
                    elif f3 == 2 and w3 == _WIRE_LEN:
                        av = v3
                if key == "value" and av is not None:
                    for f4, w4, v4 in _fields(av):
                        if f4 == 8 and w4 == _WIRE_LEN:  # AttrValue.tensor
                            tensor = _parse_tensor(v4)
        if op == "Const" and tensor is not None:
            out[name] = tensor
    return out


# --- test-support encoder ----------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | _WIRE_LEN) + _varint(len(payload)) + payload


def encode_const_graph(named_arrays) -> bytes:
    """[(name, ndarray)] → GraphDef bytes with one Const node each
    (round-trip fixture for `parse_graph_consts`; uses the same subset
    of the wire format a real freeze_graph output uses)."""
    graph = bytearray()
    for name, arr in named_arrays:
        arr = np.asarray(arr)
        if arr.dtype == np.float32:
            dt = _DT_FLOAT
        elif arr.dtype == np.int32:
            dt = _DT_INT32
        else:
            raise ValueError(arr.dtype)
        shape = b"".join(
            _len_field(2, _varint(1 << 3) + _varint(d)) for d in arr.shape)
        tensor = (_varint((1 << 3) | _WIRE_VARINT) + _varint(dt) +
                  _len_field(2, shape) +
                  _len_field(4, arr.tobytes()))
        attr_value = _len_field(8, tensor)
        attr_entry = (_len_field(1, b"value") + _len_field(2, attr_value))
        node = (_len_field(1, name.encode()) +
                _len_field(2, b"Const") +
                _len_field(5, attr_entry))
        graph += _len_field(1, node)
    return bytes(graph)
