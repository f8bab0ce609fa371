"""Proto3 wire codec for the greeting/eval service messages (the port's own
copy of the JAX package's ``hri/pg_proto.py``, which imports no JAX; the
port imports nothing of that package).

The reference defines two gRPC services (jetson/proactive_greeting.proto:8-21,
jetson/eval_server.proto:7-21):

    service ProactiveGreeting { rpc infer (stream VideoRequest)
                                returns (stream InferResponse); }
    message VideoRequest  { int32 reqID = 1; int32 lag = 2;
                            string wakeup = 3; bytes curFrame = 4; }
    message InferResponse { string response = 1; }

    service EvalServer    { rpc infer (EvalRequest) returns (EvalResponse); }
    message EvalRequest   { int32 nframe = 1; bytes frames = 2; }
    message EvalResponse  { string response = 1; float response_score = 2;
                            float trigger_pred = 3; float nullact_score = 4;
                            int32 nullact_id = 5; }

The four messages are encoded and decoded by a small hand-written proto3
wire codec instead of generated _pb2 classes, so neither protoc nor its
codegen plugin is needed, and the codec itself needs no grpcio.
The bytes on the wire are REAL protobuf — interoperable with the
reference's C++/Java stubs — which `tests/test_grpc_transport.py`
proves by cross-checking every encoding against `google.protobuf`
dynamic messages built from the same field specs; the port's
`tests/test_torch_transport.py` holds this copy's bytes to it.

Wire rules implemented (the only ones these messages need):
  - varint tags: (field_number << 3) | wire_type
  - int32  -> wire type 0; negatives sign-extend to 10-byte varints
  - string/bytes -> wire type 2 (varint length + payload)
  - float  -> wire type 5 (4-byte LE IEEE-754)
  - proto3 implicit presence: default values (0, "", b"") are omitted
    on encode and assumed on decode; unknown fields are skipped.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, fields
from typing import Tuple

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _enc_int32(num: int, v: int) -> bytes:
    if not v:
        return b""
    if not -(2**31) <= v < 2**31:
        raise ValueError(f"int32 out of range: {v}")
    # negatives are encoded as 64-bit two's complement (proto3 int32)
    return _enc_varint(num << 3 | _WT_VARINT) + _enc_varint(v & (2**64 - 1))


def _enc_float(num: int, v: float) -> bytes:
    if v == 0.0:
        return b""
    return _enc_varint(num << 3 | _WT_I32) + struct.pack("<f", v)


def _enc_len(num: int, v: bytes) -> bytes:
    if not v:
        return b""
    return _enc_varint(num << 3 | _WT_LEN) + _enc_varint(len(v)) + v


class _Message:
    """Encode/decode via the dataclass fields' `proto` metadata:
    (field_number, kind) with kind in {'int32', 'float', 'string',
    'bytes'}."""

    def encode(self) -> bytes:
        out = []
        for f in fields(self):
            num, kind = f.metadata["proto"]
            v = getattr(self, f.name)
            if kind == "int32":
                out.append(_enc_int32(num, v))
            elif kind == "float":
                out.append(_enc_float(num, v))
            elif kind == "string":
                out.append(_enc_len(num, v.encode("utf-8")))
            else:
                out.append(_enc_len(num, v))
        return b"".join(out)

    @classmethod
    def decode(cls, buf: bytes) -> "_Message":
        spec = {f.metadata["proto"][0]: (f.name, f.metadata["proto"][1])
                for f in fields(cls)}
        msg = cls()
        i = 0
        while i < len(buf):
            tag, i = _dec_varint(buf, i)
            num, wt = tag >> 3, tag & 7
            if wt == _WT_VARINT:
                raw, i = _dec_varint(buf, i)
                val: object = raw - 2**64 if raw >= 2**63 else raw
            elif wt == _WT_I32:
                (val,) = struct.unpack_from("<f", buf, i)
                i += 4
            elif wt == _WT_LEN:
                ln, i = _dec_varint(buf, i)
                if i + ln > len(buf):
                    raise ValueError("truncated length-delimited field")
                val = buf[i:i + ln]
                i += ln
            elif wt == _WT_I64:
                i += 8
                continue                     # unknown fixed64 — skip
            else:
                raise ValueError(f"unsupported wire type {wt}")
            if num not in spec:
                continue                     # unknown field — skip
            name, kind = spec[num]
            if kind == "int32":
                val = int(val) & (2**32 - 1)
                setattr(msg, name, val - 2**32 if val >= 2**31 else val)
            elif kind == "float":
                setattr(msg, name, float(val))
            elif kind == "string":
                setattr(msg, name, bytes(val).decode("utf-8"))
            else:
                setattr(msg, name, bytes(val))
        return msg


def _f(num: int, kind: str, default):
    return field(default=default, metadata={"proto": (num, kind)})


@dataclass
class VideoRequest(_Message):
    req_id: int = _f(1, "int32", 0)       # reqID
    lag: int = _f(2, "int32", 0)          # ms behind realtime
    wakeup: str = _f(3, "string", "")     # "1" => robot wake word heard
    cur_frame: bytes = _f(4, "bytes", b"")


@dataclass
class InferResponse(_Message):
    response: str = _f(1, "string", "")   # JSON decision


@dataclass
class EvalRequest(_Message):
    nframe: int = _f(1, "int32", 0)
    frames: bytes = _f(2, "bytes", b"")   # nframe stacked frames


@dataclass
class EvalResponse(_Message):
    response: str = _f(1, "string", "")
    response_score: float = _f(2, "float", 0.0)
    trigger_pred: float = _f(3, "float", 0.0)
    nullact_score: float = _f(4, "float", 0.0)
    nullact_id: int = _f(5, "int32", 0)


# gRPC method paths, exactly as the reference protos declare them
# (package `grpc` / `evalserver`; see module docstring).
GREETING_INFER = "/grpc.ProactiveGreeting/infer"
EVAL_INFER = "/evalserver.EvalServer/infer"
