"""WSI patch-embedding bag stores + bucketed padding
(``multimodal_path_omic_tpu/data/bags.py``; the port's own copy).

The reference lazily loads one bag per item from per-slide ``.pt`` tensors
(reference: dataset/dataset.py:124-126) or a single HDF5 file keyed by slide
name (dataset.py:128-129). Here the same two backends exist, plus a
memory-mapped ``.npy`` backend (the fast path for the input pipeline), a
directory auto-detector, and the bucketing/padding machinery that turns ragged
bags into fixed shapes (one shape per bucket).
"""

from __future__ import annotations

import os
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 24576)


def slide_basename(slide_id: str) -> str:
    """slide_id '.svs' stem (reference maps '.svs' -> '.pt', dataset.py:44)."""
    return slide_id[:-4] if slide_id.endswith(".svs") else slide_id


class BagStore(Protocol):
    def exists(self, slide_id: str) -> bool: ...

    def get(self, slide_id: str) -> np.ndarray: ...


class PtBagStore:
    """Per-slide torch ``.pt`` tensors under a directory (dataset.py:43-47)."""

    def __init__(self, patches_dir: str):
        self.patches_dir = patches_dir or ""

    def _path(self, slide_id: str) -> str:
        return os.path.join(self.patches_dir, slide_basename(slide_id) + ".pt")

    def exists(self, slide_id: str) -> bool:
        return os.path.exists(self._path(slide_id))

    def get(self, slide_id: str) -> np.ndarray:
        return load_pt_bag(self._path(slide_id))


def load_pt_bag(path: str) -> np.ndarray:
    """One ``.pt`` bag as float32. It is loaded with ``weights_only=True``:
    a bag file is a plain tensor, and a file holding any other pickle is
    refused before it can run code."""
    t = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{path}: a bag file holds one tensor, not {type(t).__name__}")
    return np.asarray(t.detach().numpy(), dtype=np.float32)


class H5BagStore:
    """One HDF5 file of all slides, keyed by slide name (dataset.py:48-55)."""

    def __init__(self, h5_path: str):
        import h5py

        self.h5_path = h5_path
        self._file = h5py.File(h5_path, "r")

    def exists(self, slide_id: str) -> bool:
        return slide_basename(slide_id) in self._file

    def get(self, slide_id: str) -> np.ndarray:
        return np.asarray(self._file[slide_basename(slide_id)], dtype=np.float32)

    def close(self):
        self._file.close()

    def __del__(self):  # faithful to dataset.py:245-247
        try:
            self._file.close()
        except Exception:
            pass


class NpyBagStore:
    """Per-slide ``.npy`` arrays, memory-mapped (the fast path).

    No reference equivalent: zero-copy mmap reads feed the host->device
    pipeline without deserialization cost.
    """

    def __init__(self, patches_dir: str, mmap: bool = True):
        self.patches_dir = patches_dir or ""
        self.mmap = mmap

    def _path(self, slide_id: str) -> str:
        return os.path.join(self.patches_dir, slide_basename(slide_id) + ".npy")

    def exists(self, slide_id: str) -> bool:
        return os.path.exists(self._path(slide_id))

    def get(self, slide_id: str) -> np.ndarray:
        arr = np.load(self._path(slide_id), mmap_mode="r" if self.mmap else None)
        return np.asarray(arr, dtype=np.float32)


def open_bag_store(
    patches_dir: Optional[str] = None, h5_dataset: Optional[str] = None
) -> BagStore:
    """Pick a backend the way the reference config does (dataset.py:33-55):
    ``h5_dataset`` wins if set; otherwise a directory of per-slide files
    (``.npy`` preferred when present, else ``.pt``)."""
    if h5_dataset:
        return H5BagStore(h5_dataset)
    if patches_dir is None:
        patches_dir = ""
    if os.path.isdir(patches_dir):
        names = os.listdir(patches_dir)
        if any(n.endswith(".npy") for n in names):
            return NpyBagStore(patches_dir)
    return PtBagStore(patches_dir)


def convert_bags(
    src: str, dst: str, dtype: str = "float32", verbose: bool = True
) -> int:
    """Convert a reference-style bag store (a directory of per-slide ``.pt``
    tensors, dataset.py:43-47, or one ``.h5`` file keyed by slide name,
    dataset.py:48-55) into a directory of per-slide ``.npy`` arrays — the
    fast-path store the mmap pipeline consumes. Returns the number of bags
    written. ``dtype='float16'`` halves disk; training numerics are
    unaffected (bags are cast to float32 after load).
    """
    if dtype not in ("float32", "float16"):
        raise ValueError(f"dtype must be float32 or float16, got {dtype!r}")
    os.makedirs(dst, exist_ok=True)
    # enumerate raw store entries and read them DIRECTLY (keys/filenames may
    # themselves end in '.svs', which the stores' accessors would strip);
    # output stems get slide_basename so NpyBagStore finds them from CSV
    # slide_ids either way
    if os.path.isfile(src):  # one HDF5 file of all slides
        import h5py

        with h5py.File(src, "r") as f:
            keys = sorted(f.keys())
            n = _write_npy_bags(
                ((k, np.asarray(f[k], dtype=np.float32)) for k in keys),
                dst, dtype, verbose, total=len(keys),
            )
    elif os.path.isdir(src):
        names = sorted(n for n in os.listdir(src) if n.endswith(".pt"))
        n = _write_npy_bags(
            ((name[:-3], load_pt_bag(os.path.join(src, name))) for name in names),
            dst, dtype, verbose, total=len(names),
        )
    else:
        raise FileNotFoundError(src)
    if n == 0:
        raise ValueError(f"no bags found in {src!r} (.pt files or h5 keys)")
    if verbose:
        print(f"Converted {n} bags -> {dst} ({dtype})")
    return n


def _write_npy_bags(items, dst, dtype, verbose, total=None) -> int:
    n = 0
    for stem, bag in items:
        bag = np.ascontiguousarray(bag, dtype=dtype)
        if bag.ndim != 2:
            raise ValueError(f"bag {stem!r} has shape {bag.shape}; expected [M, D]")
        np.save(os.path.join(dst, slide_basename(stem) + ".npy"), bag)
        n += 1
        if verbose and n % 200 == 0:
            print(f"  converted {n}{f'/{total}' if total else ''} bags")
    return n


def bucket_for(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= length; beyond the largest bucket, round up to the
    next multiple of the largest (bounded shape count, no truncation)."""
    for b in buckets:
        if length <= b:
            return b
    largest = buckets[-1]
    return ((length + largest - 1) // largest) * largest


def pad_bag(bag: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad [M, D] -> ([bucket, D], mask [bucket]); zero-fill, boolean mask."""
    m, d = bag.shape
    if m > bucket:
        raise ValueError(f"bag of {m} patches exceeds bucket {bucket}")
    padded = np.zeros((bucket, d), dtype=np.float32)
    padded[:m] = bag
    mask = np.zeros((bucket,), dtype=bool)
    mask[:m] = True
    return padded, mask


def filter_existing(slide_ids: Sequence[str], store: BagStore, verbose: bool = True) -> np.ndarray:
    """Indices of slides whose bag file exists (reference drops missing rows
    at init, dataset.py:39-59)."""
    keep = np.array([store.exists(s) for s in slide_ids])
    rows = np.where(keep)[0]
    if verbose:
        print(f"Remaining samples after removing incomplete: {len(rows)}")
    return rows
