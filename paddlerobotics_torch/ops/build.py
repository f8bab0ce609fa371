"""Build a hand-written CUDA kernel into a shared library and load it.

Each kernel source under ``ops/csrc/`` is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``. The build lands in ``build/torch_kernels/<key>/`` at
the repository root, where ``<key>`` hashes the source, any generated
headers written beside it and the flags, so a changed source builds anew
and an unchanged one is loaded as it is. ``-Xptxas -v`` is among the flags
of every build; its register and spill report is parsed per kernel.

Two kernels built in two threads compile in parallel: ``subprocess.run``
releases the GIL while ``nvcc`` runs.

``build_native_runtime`` builds the repository's C++ serving runtime
(``runtime_cpp/``) the same way, with ``g++``, into
``build/torch_kernels/<key>/libserving_capi.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Mapping

BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from ops/csrc/ with the CUDA toolkit")


def parse_ptxas(log: str) -> dict:
    """Registers and spill bytes per kernel instantiation from -Xptxas -v."""
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def build_library(name: str, source: pathlib.Path, flags: tuple = (),
                  generated: Mapping[str, str] | None = None
                  ) -> tuple[ctypes.CDLL, dict]:
    """Compile ``source`` (once per hash) into ``lib<name>.so`` and load it.

    ``flags`` come after ``BASE_FLAGS``; ``generated`` maps header file
    names to their text, written into the build directory, which is on the
    include path. Returns the library and a dict with the build's
    ``seconds``, ``path``, per-kernel ``ptxas`` report and raw ``log``."""
    generated = dict(generated or {})
    all_flags = BASE_FLAGS + tuple(flags)
    h = hashlib.sha256(source.read_bytes())
    for fname in sorted(generated):
        h.update(fname.encode() + generated[fname].encode())
    h.update(" ".join(all_flags).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    so = out_dir / f"lib{name}.so"
    log_path = out_dir / f"{name}.ptxas.log"
    t0 = time.perf_counter()
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for fname, text in generated.items():
            (out_dir / fname).write_text(text)
        tmp = out_dir / f"lib{name}.{os.getpid()}.so"
        cmd = [nvcc(), *all_flags, "-I", str(out_dir), "-o", str(tmp),
               str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n"
                               + res.stdout + res.stderr)
        log_path.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    log = log_path.read_text() if log_path.exists() else ""
    info = dict(seconds=time.perf_counter() - t0, path=str(so),
                ptxas=parse_ptxas(log), log=log)
    return lib, info


RUNTIME_DIR = pathlib.Path(__file__).resolve().parents[2] / "runtime_cpp"
RUNTIME_SOURCES = ("pipeline", "stream_server", "eval_server", "hpack",
                   "grpc_server", "capi")
RUNTIME_FLAGS = ("-std=c++17", "-O2", "-pthread", "-fPIC", "-shared")


def cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native serving runtime is "
                           "built from runtime_cpp/ with a C++17 compiler")
    return found


def build_native_runtime() -> tuple[str, dict]:
    """Compile ``runtime_cpp/src/*.cpp`` (once per hash of the sources, the
    headers and the flags) into ``libserving_capi.so``, the C ABI that
    ``hri/native_pipeline`` loads. Returns the library's path and a dict
    with the build's ``seconds``, ``compiler`` (its version line) and
    ``path``.

    The library is written under a temporary name and renamed into place,
    so processes that build at once each load a whole file."""
    sources = [RUNTIME_DIR / "src" / f"{n}.cpp" for n in RUNTIME_SOURCES]
    headers = sorted((RUNTIME_DIR / "include").rglob("*.hpp"))
    h = hashlib.sha256(" ".join(RUNTIME_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode() + f.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    so = out_dir / "libserving_capi.so"
    t0 = time.perf_counter()
    compiler = cxx()
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libserving_capi.{os.getpid()}.so"
        cmd = [compiler, *RUNTIME_FLAGS, "-I", str(RUNTIME_DIR / "include"),
               "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("g++ failed on runtime_cpp:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, so)
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    return str(so), dict(seconds=time.perf_counter() - t0,
                         compiler=version, path=str(so))
