"""Build and load the hand-written CUDA kernels (route (b): nvcc into a
shared library with a plain C interface, bound with ctypes).

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so``,
where the hash covers the source text, every shared header
``csrc/*.cuh`` and the nvcc flags, so an edited source or header
rebuilds and an unchanged one is reused. Beside each library,
``<name>-<hash>.log`` keeps nvcc's output, ptxas's per-kernel
registers, shared memory and spills included (``ptxas_report``).
Nothing is built at import: the first CUDA launch of a kernel builds
its library, and
``build_all()`` builds every source at once, one nvcc process per
source, all started together.

Each C entry point takes pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

__all__ = ["LaunchError", "SOURCES", "build_all", "build_hash", "check",
           "library", "nvcc_path", "ptxas_report"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build" / "kernels"
SOURCES = ("rms_norm", "paged_attention", "flash_attention", "fused_adam",
           "weight_only_linear", "llm_int8_linear", "philox_check")
# sm_90a, not sm_90: wgmma exists only for the "a" target
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built from csrc/*.cu at first CUDA use and need "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_hash(name: str) -> str:
    """The 16 hex digits that name ``csrc/<name>.cu``'s build: a hash of
    its source, every shared header and the nvcc flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD / f"{name}-{build_hash(name)}.so"


def _start(name: str):
    """Start one nvcc build into a temporary file; returns (proc, tmp,
    target) or None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    target.with_suffix(".log").write_text(out)
    # atomic publish: a concurrent build of the same hash loses nothing
    os.replace(tmp, target)


def build_all() -> None:
    """Build every source that is not built yet, all nvcc processes
    started together."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers, spill stores and spill loads (bytes) of every kernel of
    ``csrc/<name>.cu`` by mangled name, from the build's nvcc log (empty
    when the library was built before logs were kept)."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return {}
    report: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
    return report


class LaunchError(RuntimeError):
    """A C entry point returned a CUDA error code."""


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise LaunchError(f"{what}: CUDA launch failed with error {rc} "
                           "(cudaGetLastError after the launch)")
