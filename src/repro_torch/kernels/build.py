"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each source under `repro_torch/csrc/` has a plain C interface and includes no PyTorch
header, so `nvcc` compiles it in seconds into its own shared library under
`build/kernels/` at the repository root (listed in `.gitignore`).  The
library's name carries a hash of its source, the shared headers (`*.cuh`)
and the flags, so an edited source is never served from a stale build.  `build_all()` starts one `nvcc` per
source, all at once, and waits for them; `library(name)` builds on first use.

Nothing here runs at import time, and nothing falls back: a missing `nvcc`
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-O3", "-std=c++17", ARCH, "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

SOURCES = {"sorted_probe": "sorted_probe.cu",
           "segmented_scan": "segmented_scan.cu",
           "flash_attention": "flash_attention.cu",
           "span_compact": "span_compact.cu",
           "span_segment": "span_segment.cu",
           "rwkv6_scan": "rwkv6_scan.cu",
           "linear_scan": "linear_scan.cu"}

_lock = threading.Lock()
_libs: dict = {}
_ptxas: dict = {}


def nvcc() -> str:
    """Path of `nvcc`: `$CUDA_HOME/bin`, else the one on `PATH`."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> pathlib.Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        _ptxas.setdefault(name, "(cached build)")
        return
    log, _ = proc.communicate()
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    _ptxas[name] = log


def build_all() -> dict:
    """Compile every kernel source in parallel; returns {name: ptxas log}."""
    with _lock:
        procs = {name: _start(name) for name in SOURCES}
        for name, proc in procs.items():
            _finish(name, proc)
        return {name: _ptxas[name] for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _declare(name, lib)
            _libs[name] = lib
        return _libs[name]


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "sorted_probe":
        fn = lib.repro_sorted_probe
        fn.argtypes = [i, p, ll, p, ll, p, i, p, ll, p]
        fn.restype = i
    elif name == "segmented_scan":
        fn = lib.repro_segmented_scan
        fn.argtypes = [i, i, i, p, p, p, p, ll, ll, p, p, ll, p]
        fn.restype = i
        _declare_layout(lib.repro_segmented_scan_layout)
    elif name == "flash_attention":
        fn = lib.repro_flash_attention
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, ctypes.c_float,
                       i, i, p]
        fn.restype = i
    elif name == "span_compact":
        fn = lib.repro_span_compact
        fn.argtypes = [p, ll, i, p, ll, p, p, p, ll, p, p]
        fn.restype = i
        _declare_layout(lib.repro_span_compact_layout)
    elif name == "span_segment":
        fn = lib.repro_span_segment
        fn.argtypes = [i, p, p, ll, p, p, p, p, ll, p, p]
        fn.restype = i
        _declare_layout(lib.repro_span_segment_layout)
    elif name == "rwkv6_scan":
        fn = lib.repro_rwkv6_scan
        fn.argtypes = [i] * 4 + [p] * 8 + [i] * 4 + [p]
        fn.restype = i
    elif name == "linear_scan":
        fn = lib.repro_linear_scan
        fn.argtypes = [p, p, p, p, ll, ll, i, p]
        fn.restype = i
    else:  # pragma: no cover - SOURCES and this table move together
        raise KeyError(name)


def _declare_layout(fn) -> None:
    """A look-back kernel's layout call: fills three int64 words."""
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = None


def check(err: int, what: str) -> None:
    """Raise on a nonzero `cudaError_t` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
