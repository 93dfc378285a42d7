"""Row gather for the device-resident bag cache
(``multimodal_path_omic_tpu/ops/gather.py``): ``pool[idx]`` for a pool
[N, M, D] and an index vector [B], the batch assembly of the cached train
step.

:func:`gather_rows` launches the CUDA kernel (``csrc/gather.cu``: rows
copied as bytes, 16 at a time) for a CUDA pool, or raises on what the kernel
does not take, and uses the plain version (:func:`gather_rows_plain`,
``torch.index_select``) only for a CPU pool; :data:`take_rows` is the same
function under the name the cached step calls. The pool is the dataset cache, a
constant: no gradient is defined. ``LAUNCH_COUNTS`` counts kernel launches.
"""

from __future__ import annotations

import torch

from multimodal_path_omic_tpu_torch.ops import kernels

POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
MAX_ROWS = 65535  # gathered rows per launch (the grid's second axis)

LAUNCH_COUNTS = {"gather_rows": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def gather_rows_plain(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(pool, 0, idx.to(torch.int64))


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]``: pool [N, M, D] (float32, bfloat16 or int8), idx [B]
    int32 or int64 on the pool's device, every index in [0, N) -> [B, M, D].
    Kernel: a contiguous pool whose rows are a multiple of 16 bytes, 1 to
    65535 indices."""
    if pool.dim() != 3 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes a pool [N, M, D] and idx [B], got "
                         f"{tuple(pool.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if idx.device != pool.device:
        raise ValueError(f"idx is on {idx.device}, the pool on {pool.device}")
    if pool.device.type == "cpu":
        return gather_rows_plain(pool, idx)
    if pool.dtype not in POOL_DTYPES:
        raise TypeError(f"pool must be one of {POOL_DTYPES}, got {pool.dtype}")
    n, m_len, d = pool.shape
    b = idx.shape[0]
    row_bytes = m_len * d * pool.element_size()
    if row_bytes % 16 != 0 or n < 1 or not 1 <= b <= MAX_ROWS:
        raise ValueError(f"gather kernel: rows of {row_bytes} bytes (must be a multiple of "
                         f"16), N={n}, B={b} (1..{MAX_ROWS})")
    kernels.require(pool, "pool", (n, m_len, d), pool.dtype)
    idx = idx.to(torch.int64).contiguous()
    out = torch.empty((b, m_len, d), dtype=pool.dtype, device=pool.device)
    err = kernels.library("gather").mpo_gather_rows(
        pool.data_ptr(), idx.data_ptr(), out.data_ptr(), row_bytes, n, b,
        kernels.stream(pool.device),
    )
    kernels.check(err, "gather_rows")
    LAUNCH_COUNTS["gather_rows"] += 1
    return out


take_rows = gather_rows  # the JAX package's name for the cached step's gather


def sharded_supported(pool: torch.Tensor, idx: torch.Tensor, mesh) -> bool:
    """Whether the kernel takes the gather of a mesh rank's cache slice
    (``data/device_cache.py``: [N, bucket / mesh size, D], the patch axis
    split over every rank): rows of a multiple of 16 bytes, 1 to
    ``MAX_ROWS`` indices."""
    if pool.dim() != 3 or idx.dim() != 1:
        return False
    row_bytes = pool.shape[1] * pool.shape[2] * pool.element_size()
    return (pool.dtype in POOL_DTYPES and row_bytes % 16 == 0 and pool.shape[0] >= 1
            and 1 <= idx.shape[0] <= MAX_ROWS)


def take_rows_sharded(pool: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """``pool[idx]`` over this rank's patch slice of every bag (JAX
    ``take_rows_sharded``): the same kernel on the local [N, bucket / mesh
    size, D] pool with the whole batch's indices, no collective; the
    batch's rows and patches then move to their ranks in one all-to-all
    (``parallel/mesh.py::reshard_cache_rows``)."""
    return gather_rows(pool, idx)
