"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` into its own plain-C
shared library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), at first use.  The file name carries a hash of the source
and flags, so an edited source rebuilds.  Flags:

- ``-gencode arch=compute_90a,code=sm_90a``: Hopper (H100) only;
- ``-fmad=false``: no FMA contraction — the epilogues and carries must
  round twice, exactly like the plain PyTorch versions;
- no ``--use_fast_math``: ``x / delta`` stays correctly rounded and
  denormals are kept (``ldexpf`` results below 2^-126 must match);
- ``-Xptxas -v``: registers / shared memory / spills go to the build log.

Nothing here runs at import time: the tests on a machine without a card
import this module but never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "kernels"
SOURCES = ("qmatmul", "int_attention", "pq_layernorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cu*")):     # sources and shared headers
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc process for ``name`` (None when already built)."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = open(BUILD_DIR / f"{name}.log", "w")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish(name: str, started) -> None:
    proc, log, tmp, out = started
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}):\n"
                           + build_log(name))
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every source in parallel (one nvcc each, all started at once);
    returns ``{name: nvcc/ptxas log}`` (empty log when already built)."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return {n: build_log(n) for n in names}


def build_log(name: str) -> str:
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
