"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, from the package's sources only, into ``<package>/_build/``
(gitignored); a library is named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and an
unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: this module imports on machines without
``nvcc`` or a GPU (the CPU tests import every module).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# C signatures of every exported function, by library.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "coattn": {
        "mpo_coattn_fwd_fused_k": [_P] * 11 + [_I] * 6 + [_F, _P],
        "mpo_coattn_fwd_fused_k_train": [_P] * 14 + [_I] * 6 + [_F, _U, _F, _P],
        "mpo_coattn_stats": [_P] * 6 + [_I] * 6 + [_F, _P],
        "mpo_coattn_weights": [_P] * 6 + [_I] * 6 + [_F, _P],
    },
    "coattn_bwd": {
        "mpo_coattn_bwd_fused_k": [_P] * 19 + [_I] * 6 + [_F, _U, _F, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOGS: Dict[str, str] = {}  # library name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:  # every source may include any header
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists; returns
    the process (output to ``<lib>.log``) or None."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    log = open(path + ".log", "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
        stdout=log, stderr=subprocess.STDOUT,
    )
    proc._mpo = (name, tmp, path, log)  # type: ignore[attr-defined]
    return proc


def _finish_build(proc: subprocess.Popen) -> None:
    name, tmp, path, log = proc._mpo  # type: ignore[attr-defined]
    rc = proc.wait()
    log.close()
    with open(path + ".log") as fh:
        BUILD_LOGS[name] = fh.read()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc={rc}):\n{BUILD_LOGS[name]}")
    os.replace(tmp, path)  # atomic: a concurrent reader never sees half a file


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every library (default: every source in SIGNATURES) with one
    nvcc process per source running in parallel. Returns name -> path."""
    names = list(names or SIGNATURES)
    procs = [p for p in (_start_build(n) for n in names) if p is not None]
    errors = []
    for p in procs:
        try:
            _finish_build(p)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _lib_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaGetLastError after launch)")
