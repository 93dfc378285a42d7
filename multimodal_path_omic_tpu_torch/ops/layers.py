"""Layer utilities with the JAX package's semantics
(``multimodal_path_omic_tpu/ops/layers.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# Large-negative (finite) masking constant, as in the JAX package: -inf would
# turn fully-masked softmax rows into NaN; here they come out uniform.
NEG_INF = -1e9


class TorchLinear(nn.Linear):
    """``nn.Linear`` with torch's default init.

    The weight keeps torch's ``[out, in]`` layout; the JAX package's flax
    kernels are ``[in, out]``, so the weight bridge (``utils/weights.py``)
    transposes them. The int8 ``row_scale`` route of the JAX layer belongs
    to a later slice.
    """


class FastDropout(nn.Module):
    """Inverted dropout. Only its eval-time identity exists so far: the
    training semantics (uint16-threshold keep masks) come with the training
    slice, so a module in training mode with ``rate > 0`` raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError("training-mode dropout is not ported yet")
        return x


class AlphaDropout(FastDropout):
    """SELU-preserving alpha dropout; eval-time identity (see FastDropout)."""


def masked_softmax(
    scores: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1
) -> torch.Tensor:
    """Softmax with a boolean validity mask broadcast over ``scores``.

    mask True = valid. Fully-masked rows yield a uniform distribution over
    the masked entries (finite fill value), never NaN.
    """
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=dim)
