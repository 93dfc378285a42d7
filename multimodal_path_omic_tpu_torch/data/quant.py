"""Int8 symmetric per-patch quantization of WSI patch embeddings
(``multimodal_path_omic_tpu/data/quant.py``; the port's own copy).

Patch embeddings are the dominant byte stream of a batch. Each embedding row
x is stored as ``q = rint(x / s)`` with ``s = max|x| / 127`` (one float32
scale a row), so the element-wise error is at most ``s / 2``. That cuts the
host-to-device bytes (``tpu.transfer_dtype: int8``) and the device cache's
footprint (``tpu.cache_dtype: int8``) about 4x. All-zero rows (padding) get
scale 1 and q 0, so their dequantization is exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def quantize_bag_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[..., M, D] float32 embeddings -> (q int8 of x's shape, float32 row
    scales of shape ``x.shape[:-1]``), bit for bit the JAX package's."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``q * scale`` row-wise, in ``dtype`` (default float32): both factors
    are cast first, as the JAX package's ``dequantize`` does (q in
    [-127, 127] is exact in bfloat16; the product rounds once)."""
    dtype = dtype or torch.float32
    return q.to(dtype) * scale[..., None].to(dtype)
