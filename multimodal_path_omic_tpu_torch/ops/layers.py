"""Layer utilities with the JAX package's semantics
(``multimodal_path_omic_tpu/ops/layers.py``).

Dropout draws its bits from a ``torch.Generator`` the caller passes in (the
trainer owns one); the bits cannot match JAX's generator, only the keep rule
and the formulas do."""

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


def fast_keep_mask(generator: torch.Generator, rate: float, shape, device):
    """Dropout keep mask by a uint16 threshold: (keep [bool], keep_prob).

    keep iff a 16-bit draw is >= thresh = round(rate * 65536), so
    keep_prob = 1 - thresh / 65536 exactly (the rate itself for multiples of
    1/65536, 0.25 included). A rate that rounds to 1 drops everything and
    returns keep_prob 1.0, so that 1 / keep_prob stays finite. Draws come
    from ``generator`` (on ``device``'s type), never from a global RNG.
    """
    thresh = int(round(float(rate) * 65536.0))
    if thresh >= 65536:
        return torch.zeros(shape, dtype=torch.bool, device=device), 1.0
    bits = torch.randint(0, 65536, tuple(shape), generator=require_generator(generator),
                         device=device, dtype=torch.int32)
    return bits >= thresh, 1.0 - thresh / 65536.0


def require_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The generator a dropout draw uses; None raises (no global RNG)."""
    if generator is None:
        raise ValueError("training-mode dropout draws from an explicit torch.Generator: "
                         "pass generator=")
    return generator


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the uint16-threshold keep mask:
    ``where(keep, x / keep_prob, 0)``; the identity at rate 0."""
    if rate == 0.0:
        return x
    keep, keep_prob = fast_keep_mask(generator, rate, x.shape, x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class FastDropout(nn.Module):
    """:func:`dropout` in training mode, the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, generator) if self.training else x


class AlphaDropout(FastDropout):
    """SELU-preserving alpha dropout with torch's formula: dropped units take
    alpha' = -1.7580993408473766, and the output is corrected affinely,
    ``a * where(keep, x, alpha') + b`` with
    a = ((1 - p)(1 + p alpha'^2))^-1/2, b = -a alpha' p, p the effective rate."""

    ALPHA_PRIME = -1.7580993408473766

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep, keep_prob = fast_keep_mask(generator, self.rate, x.shape, x.device)
        p = 1.0 - keep_prob
        a = ((1.0 - p) * (1.0 + p * self.ALPHA_PRIME ** 2)) ** -0.5
        b = -a * self.ALPHA_PRIME * p
        return a * torch.where(keep, x, torch.full_like(x, self.ALPHA_PRIME)) + b


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
