"""Bucketed padding of ragged WSI bags.

A copy of ``multimodal_path_omic_tpu/data/bags.py``'s ``bucket_for`` and
``pad_bag`` (numpy only): the port keeps its own copy rather than importing
the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 24576)


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
