"""Python clients of the native streaming greeting service (an own copy of
the JAX package's ``hri/stream_client.py``, which imports no JAX; the wire
format is the same byte for byte).

Counterpart of the reference's gRPC clients (jetson/parallel_eval.py for
eval; the robot side of ProactiveGreeting.infer) over the
length-prefixed TCP protocol of runtime_cpp/stream_server.cpp — see
that header for the wire format and the proto field mapping.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Iterator, Optional

import numpy as np


class _FramedClient:
    """Shared socket plumbing for the length-prefixed protocol."""

    def __init__(self, host: str, port: int, timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def set_timeout(self, timeout: Optional[float]) -> None:
        """Adjust the blocking-read deadline (None = block forever).
        Used by drain loops that read until the stream goes quiet."""
        self.sock.settimeout(timeout)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        graced = False
        prev = self.sock.gettimeout()
        try:
            while len(buf) < n:
                try:
                    chunk = self.sock.recv(n - len(buf))
                except TimeoutError:
                    if buf and not graced:
                        # mid-frame timeout: the peer has started
                        # sending (short poll timeouts must not corrupt
                        # framing) — give the rest of the frame one
                        # long grace window
                        graced = True
                        self.sock.settimeout(30.0)
                        continue
                    if buf:
                        raise ConnectionError(
                            f"stream corrupt: timed out {len(buf)}/{n} "
                            "bytes into a frame") from None
                    raise
                if not chunk:
                    raise ConnectionError("stream closed")
                buf += chunk
            return buf
        finally:
            if graced:
                self.sock.settimeout(prev)

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class GreetingStreamClient(_FramedClient):
    """Streams VideoRequests to a running StreamServer and reads
    InferResponse JSONs."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9310,
                 timeout: float = 10.0):
        super().__init__(host, port, timeout)

    def send_frame(self, req_id: int, pixels: np.ndarray,
                   lag_ms: int = 0, wakeup: str = "") -> None:
        """pixels: float32 letterboxed RGB in [0,1], any shape (flattened
        on the wire — the server expects 416·416·3 in production)."""
        px = np.ascontiguousarray(pixels, np.float32).reshape(-1)
        wk = wakeup.encode("utf-8")
        body = (struct.pack("<Bii", 1, req_id, lag_ms) +
                struct.pack("<I", len(wk)) + wk +
                struct.pack("<I", px.size) + px.tobytes())
        self.sock.sendall(struct.pack("<I", len(body)) + body)


    def read_response(self) -> dict:
        """Blocking read of one InferResponse → parsed JSON dict."""
        (plen,) = struct.unpack("<I", self._read_exact(4))
        payload = self._read_exact(plen)
        if payload[0] != 2:
            raise ValueError(f"unexpected message type {payload[0]}")
        (jlen,) = struct.unpack("<I", payload[1:5])
        return json.loads(payload[5:5 + jlen].decode("utf-8"))

    def responses(self) -> Iterator[dict]:
        while True:
            yield self.read_response()


class EvalStreamClient(_FramedClient):
    """Unary client for the native offline EvalServer
    (runtime_cpp/eval_server.cpp): EvalRequest{nframe, frames} →
    EvalResponse{response, response_score, trigger_pred, nullact_score,
    nullact_id} over the length-prefixed framing (the socket stand-in
    for eval_server.proto's gRPC, jetson/parallel_eval.py's stub)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9311,
                 timeout: float = 30.0):
        super().__init__(host, port, timeout)

    def infer(self, frames) -> dict:
        """frames: sequence of float32 letterboxed RGB arrays in [0,1]
        (416·416·3 in production). Blocking unary call."""
        parts = [struct.pack("<Bi", 3, len(frames))]
        for f in frames:
            px = np.ascontiguousarray(f, np.float32).reshape(-1)
            parts.append(struct.pack("<I", px.size) + px.tobytes())
        body = b"".join(parts)
        self.sock.sendall(struct.pack("<I", len(body)) + body)

        (plen,) = struct.unpack("<I", self._read_exact(4))
        if plen < 21:
            raise ConnectionError(
                f"truncated EvalResponse: {plen} bytes (header is 21)")
        payload = self._read_exact(plen)
        if payload[0] != 4:
            raise ValueError(f"unexpected message type {payload[0]}")
        response_score, trigger_pred, nullact_score, nullact_id, jlen = \
            struct.unpack("<fffiI", payload[1:21])
        if 21 + jlen > plen:
            raise ConnectionError(
                f"truncated EvalResponse json: {jlen} bytes declared, "
                f"{plen - 21} present")
        return {
            "response": json.loads(payload[21:21 + jlen].decode("utf-8")),
            "response_score": response_score,
            "trigger_pred": trigger_pred,
            "nullact_score": nullact_score,
            "nullact_id": nullact_id,
        }


