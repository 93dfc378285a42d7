"""Device-resident dataset cache: upload the cohort once, gather on device
(``multimodal_path_omic_tpu/data/device_cache.py``; the port's own copy).

``DeviceBagCache`` stores, per bag-length bucket, one padded device tensor of
all that bucket's bags (and masks), plus the whole label / omics table; every
training batch is then assembled on the device from cached rows
(``train/loop.py::make_cached_train_step``), and a step transfers only the
index arrays of :func:`build_meta`.

The upload goes bucket by bucket in chunks of ``upload_chunk`` bags: each
chunk is padded into a pinned host buffer (when the cache lives on a CUDA
device) and copied straight into its rows of the preallocated bucket tensor,
so host staging stays at one chunk and no device-side concatenation doubles
the bucket's memory.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_path_omic_tpu_torch.data.bags import bucket_for
from multimodal_path_omic_tpu_torch.device import resolve_device

_PER_ELEMENT = {"int8": 1, "bfloat16": 2}


def _per_patch_bytes(dim: int, store_dtype: str) -> int:
    """int8 stores 1 byte per element plus a 4-byte float32 scale per patch."""
    return dim + 4 if store_dtype == "int8" else dim * _PER_ELEMENT.get(store_dtype, 4)


class DeviceBagCache:
    """Per-bucket padded device tensors of every bag + the label/omics table.

    ``caches[bucket]`` is a dict of device tensors consumed by the cached
    train step: wsi [n_b, bucket, D], mask [n_b, bucket] bool, label [n]
    int64, and (survival mode) omics_packed [n, S], censorship [n],
    survival_months [n]. ``position(rows)`` maps dataset rows to their
    bucket-local wsi index. ``device`` defaults to the GPU
    (``device.resolve_device``). Only ``store_dtype="float32"`` is ported;
    a mesh-sharded cache is not (ROADMAP queue 1).
    """

    def __init__(self, dataset, extras_fn, buckets: Sequence[int], *, device=None,
                 ge_mode: bool = False, lengths: Optional[np.ndarray] = None,
                 upload_chunk: int = 64, store_dtype: str = "float32", mesh=None,
                 only_buckets: Optional[Sequence[int]] = None):
        if store_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"store_dtype must be float32, bfloat16 or int8, got {store_dtype!r}")
        if store_dtype != "float32":
            raise NotImplementedError(
                f"store_dtype {store_dtype!r} is not ported yet (ROADMAP queue 1, item 8)")
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded device cache is not ported yet (ROADMAP queue 1, item 9)")
        self.device = resolve_device(device)
        self.store_dtype = store_dtype
        self.ge_mode = ge_mode
        dev = self.device

        n = len(dataset)
        if lengths is None:
            lengths = np.array([dataset.bag(i).shape[0] for i in range(n)])
        self.bucket_of = np.array([bucket_for(int(m), tuple(buckets)) for m in lengths])
        self._position = np.zeros(n, np.int32)
        self.caches: Dict[int, Dict[str, torch.Tensor]] = {}

        extras = extras_fn(dataset, np.arange(n))
        table = {"label": torch.from_numpy(np.asarray(extras["label"]).astype(np.int64)).to(dev)}
        if not ge_mode:
            packed = np.concatenate([np.asarray(o, np.float32) for o in extras["omics"]],
                                    axis=-1)
            self.omic_sizes = tuple(int(np.asarray(o).shape[-1]) for o in extras["omics"])
            table["omics_packed"] = torch.from_numpy(packed).to(dev)
            for key in ("censorship", "survival_months"):
                table[key] = torch.from_numpy(np.asarray(extras[key], np.float32)).to(dev)

        dim = int(dataset.bag(0).shape[1]) if n else 0
        all_buckets = sorted(set(self.bucket_of.tolist()))
        self.cached_buckets = (
            [b for b in all_buckets if b in set(only_buckets)]
            if only_buckets is not None else all_buckets
        )
        pin = dev.type == "cuda"
        for bucket in self.cached_buckets:
            rows = np.flatnonzero(self.bucket_of == bucket)
            self._position[rows] = np.arange(len(rows), dtype=np.int32)
            wsi = torch.empty((len(rows), bucket, dim), device=dev)
            mask = torch.empty((len(rows), bucket), dtype=torch.bool, device=dev)
            stage_w = torch.empty((min(upload_chunk, len(rows)), bucket, dim), pin_memory=pin)
            stage_m = torch.empty(stage_w.shape[:2], dtype=torch.bool, pin_memory=pin)
            for s in range(0, len(rows), upload_chunk):
                chunk_rows = rows[s:s + upload_chunk]
                stage_w.zero_()
                stage_m.zero_()
                for j, r in enumerate(chunk_rows):
                    bag = np.asarray(dataset.bag(int(r)), np.float32)
                    m = bag.shape[0]
                    if m > bucket:
                        # bucket_for guarantees m <= bucket when the lengths
                        # probe was right; clamping would train on cut bags
                        raise ValueError(
                            f"bag {int(r)} has {m} patches but was assigned bucket "
                            f"{bucket}: a stale bag-length probe?")
                    stage_w[j, :m] = torch.from_numpy(bag)
                    stage_m[j, :m] = True
                k = len(chunk_rows)
                # the staging buffers are reused: each copy ends before the next fill
                wsi[s:s + k].copy_(stage_w[:k])
                mask[s:s + k].copy_(stage_m[:k])
            self.caches[bucket] = dict(wsi=wsi, mask=mask, **table)

    @staticmethod
    def nbytes(lengths: np.ndarray, buckets: Sequence[int], dim: int,
               store_dtype: str = "float32",
               only_buckets: Optional[Sequence[int]] = None) -> int:
        """Total device bytes the wsi cache needs (bags padded to their
        buckets). ``only_buckets`` restricts to a bucket subset (partial
        caching)."""
        per_bucket = DeviceBagCache.bucket_bytes(lengths, buckets, dim, store_dtype)
        keep = None if only_buckets is None else set(only_buckets)
        return int(sum(v for b, v in per_bucket.items() if keep is None or b in keep))

    @staticmethod
    def bucket_bytes(lengths: np.ndarray, buckets: Sequence[int], dim: int,
                     store_dtype: str = "float32") -> Dict[int, int]:
        """Per-bucket wsi cache bytes (for the partial-caching budget fit)."""
        per_patch = _per_patch_bytes(dim, store_dtype)
        out: Dict[int, int] = {}
        for m in lengths:
            b = bucket_for(int(m), tuple(buckets))
            out[b] = out.get(b, 0) + b * per_patch
        return out

    def position(self, rows: np.ndarray) -> np.ndarray:
        return self._position[np.asarray(rows)]


def plan_cache_fit(per_bucket: Dict[int, int], counts: Dict[int, int], budget_total: int, *,
                   forced: bool = False, multi_host: bool = False,
                   ) -> Tuple[Optional[List[int]], int, bool]:
    """The budget-fit policy: given per-bucket cache bytes and bag counts,
    decide what gets cached.

    Returns ``(only_buckets, resident_bytes, engaged)``: ``only_buckets`` None
    = every bucket (full cache), a list = partial cache (greedy cheapest
    bytes-per-bag fit), and ``engaged`` False = host feeding (resident 0).
    Forced mode always caches everything (the budget is advisory there).
    Multi-host never partial-caches."""
    total = sum(per_bucket.values())
    if forced or total <= budget_total:
        return None, total, True
    if multi_host:
        return None, 0, False
    order = sorted(per_bucket, key=lambda b: per_bucket[b] / counts[b])
    chosen: List[int] = []
    used = 0
    for b in order:
        if used + per_bucket[b] <= budget_total:
            chosen.append(b)
            used += per_bucket[b]
    if not chosen:
        return None, 0, False
    return chosen, used, True


def build_meta(indices: List[int], batch_size: int, cache: DeviceBagCache,
               ) -> Tuple[Dict[str, np.ndarray], int]:
    """Per-batch gather meta (tiny host arrays) for the cached train step: a
    short batch is filled with zero-weight repeats of its last row."""
    real = len(indices)
    full = np.array(list(indices) + [indices[-1]] * (batch_size - real), np.int32)
    weight = np.zeros((batch_size,), np.float32)
    weight[:real] = 1.0
    return {"pos": cache.position(full), "row": full, "weight": weight}, real
