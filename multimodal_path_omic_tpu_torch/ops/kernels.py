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

import torch

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
_L = ctypes.c_longlong
# C signatures of every exported function, by library.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "coattn": {
        "mpo_coattn_fwd_fused_k": [_P] * 14 + [_I] * 6 + [_F, _P],
        "mpo_coattn_fwd_fused_k_train": [_P] * 17 + [_I] * 6 + [_F, _U, _F, _P],
        "mpo_coattn_stats": [_P] * 9 + [_I] * 6 + [_F, _P],
        "mpo_coattn_weights": [_P] * 9 + [_I] * 7 + [_F, _P],
        "mpo_coattn_tiles": [_P] * 4 + [_I] * 3 + [_P],
        "mpo_coattn_plain_fwd": [_P] * 16 + [_I] * 7 + [_F, _U, _F, _P],
    },
    "coattn_bwd": {
        "mpo_coattn_bwd_fused_k": [_P] * 23 + [_I] * 7 + [_F, _U, _F, _P],
        "mpo_coattn_plain_bwd": [_P] * 18 + [_I] * 6 + [_F, _U, _F, _P],
    },
    "milpool": {
        "mpo_milpool": [_P] * 10 + [_I] * 5 + [_P],
    },
    "flash": {
        "mpo_flash_fwd": [_P] * 7 + [_I] * 4 + [_L] * 9 + [_F, _P],
    },
    "flash_bwd": {
        "mpo_flash_bwd": [_P] * 12 + [_I] * 4 + [_P, _F, _P],
    },
    "gather": {
        "mpo_gather_rows": [_P] * 3 + [_L] * 2 + [_I, _P],
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


# ---------------------------------------------------------------------------
# Argument checks shared by the kernel wrappers
# ---------------------------------------------------------------------------


def require(t: torch.Tensor, name: str, shape, dtype=torch.float32, *,
            strided: bool = False) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of the
    given shape and type (what every kernel's float4 loads assume). With
    ``strided`` a view the kernel reads in place also passes: unit stride on
    the last axis and every other stride a multiple of 4 elements."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if strided:
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit stride on its last axis and every other "
                             f"stride a multiple of 4, got strides {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be 16-byte aligned for float4 loads")


def mask_ptr(key_mask: Optional[torch.Tensor], b: int, m_len: int, device) -> Optional[int]:
    """The pointer of a [B, M] bool mask on ``device``, or None for no mask."""
    if key_mask is None:
        return None
    require(key_mask, "key_mask", (b, m_len), torch.bool)
    if key_mask.device != device:
        raise ValueError("key_mask is on another device")
    return key_mask.data_ptr()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SM_COUNTS: Dict[int, int] = {}


def sm_count(device) -> int:
    """The device's SM count, looked up once per device (every wrapper call
    asks for it)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    count = _SM_COUNTS.get(index)
    if count is None:
        count = _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return count


def tile_splits(n_tiles: int, per_bag: int, cap: int = 1024) -> int:
    """How many blocks share one bag's ``n_tiles`` tiles: at most ``per_bag``
    (the SMs over the bags) and ``cap`` (the merge kernel's partials), and no
    split without a tile."""
    splits = max(1, min(n_tiles, per_bag, cap))
    return -(-n_tiles // -(-n_tiles // splits))


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """A forward-only kernel cannot serve a call autograd would differentiate."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward kernel: call it under torch.no_grad() / "
            "inference_mode(), or on the CPU (the plain version is differentiable)")
