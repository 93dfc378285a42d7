"""Late-fusion heads (``multimodal_path_omic_tpu/ops/fusion.py``); inputs
are batched ``[B, dim_i]`` vectors."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops.layers import TorchLinear


class ConcatFusion(nn.Module):
    """Concat -> Linear-ReLU-Linear-ReLU."""

    def __init__(self, in_size: int, hidden_size: int = 256, output_size: int = 256):
        super().__init__()
        self.fc1 = TorchLinear(in_size, hidden_size)
        self.fc2 = TorchLinear(hidden_size, output_size)

    def forward(self, *x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(torch.cat(x, dim=-1)))
        return F.relu(self.fc2(h))


def make_fusion(kind: str, in_size: int, hidden: int, output: int) -> nn.Module:
    """Fusion factory. ``gated_concat`` and ``bilinear`` are not ported yet."""
    if kind == "concat":
        return ConcatFusion(in_size, hidden, output)
    if kind in ("gated_concat", "bilinear"):
        raise NotImplementedError(f"fusion {kind!r} is not ported yet")
    raise RuntimeError(f"Fusion mechanism {kind} not implemented")
