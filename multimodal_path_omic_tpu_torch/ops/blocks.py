"""Model blocks (``multimodal_path_omic_tpu/ops/blocks.py``): the MIL
scoring head, the masked MIL pooling, the fused SNN omic encoders and the
WSI patch encoder."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops.layers import (
    AlphaDropout,
    FastDropout,
    TorchLinear,
    masked_softmax,
)


class AttentionNetGated(nn.Module):
    """Gated-attention MIL scoring head: A = W_c(tanh(W_a x) * sigmoid(W_b x)).
    Input x: [..., L, input_dim]; returns (A [..., L, n_classes], x)."""

    def __init__(self, input_dim: int, hidden_dim: int, n_classes: int = 1,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.attention_a = TorchLinear(input_dim, hidden_dim)
        self.attention_b = TorchLinear(input_dim, hidden_dim)
        self.attention_c = TorchLinear(hidden_dim, n_classes)
        self.drop_a = FastDropout(dropout_rate)
        self.drop_b = FastDropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.drop_a(torch.tanh(self.attention_a(x)))
        b = self.drop_b(torch.sigmoid(self.attention_b(x)))
        return self.attention_c(a * b), x


class GatedMILPool(nn.Module):
    """Masked gated-attention MIL pooling + rho head (the eager branch of the
    JAX module; its fused kernel serves GE eval, a later slice).

    x: [B, L, D], mask: [B, L] or None -> (pooled [B, D], raw scores [B, 1, L]).
    """

    def __init__(self, dim: int, dropout_rate: float = 0.25):
        super().__init__()
        self.attention_head = AttentionNetGated(dim, dim, 1, dropout_rate)
        self.rho = TorchLinear(dim, dim)
        self.drop = FastDropout(dropout_rate)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        scores, h = self.attention_head(x)
        a = scores.transpose(-1, -2)  # [B, 1, L]
        weights = masked_softmax(a, None if mask is None else mask[:, None, :])
        pooled = torch.matmul(weights, h)[:, 0, :]  # [B, D]
        pooled = self.drop(F.relu(self.rho(pooled)))
        return pooled, a


class WSIEncoder(nn.Module):
    """Patch-embedding FC: Linear(F -> d) + ReLU + Dropout."""

    def __init__(self, in_dim: int, dim: int, dropout_rate: float = 0.25):
        super().__init__()
        self.fc = TorchLinear(in_dim, dim)
        self.drop = FastDropout(dropout_rate)

    def forward(self, wsi: torch.Tensor) -> torch.Tensor:
        return self.drop(F.relu(self.fc(wsi)))


class OmicEncoderStack(nn.Module):
    """All per-signature SNN encoders as two batched contractions over
    zero-padded stacked kernels (the JAX package's fused layout).

    Inputs are padded to the widest signature with zeros and the padded
    kernel rows are zeros, so the padded rows stay inert: the result equals
    the per-encoder computation. omics: sequence of [B, s_i] -> [B, N, dim2].
    """

    def __init__(self, sizes: Sequence[int], dim1: int, dim2: int,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.sizes = tuple(int(s) for s in sizes)
        n, max_s = len(self.sizes), max(self.sizes)
        self.fc1_kernel = nn.Parameter(torch.zeros(n, max_s, dim1))
        self.fc1_bias = nn.Parameter(torch.zeros(n, dim1))
        self.fc2_kernel = nn.Parameter(torch.zeros(n, dim1, dim2))
        self.fc2_bias = nn.Parameter(torch.zeros(n, dim2))
        self.drop1 = AlphaDropout(dropout_rate)
        self.drop2 = AlphaDropout(dropout_rate)

    def forward(self, omics: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(omics) != len(self.sizes):
            raise ValueError(f"expected {len(self.sizes)} signatures, got {len(omics)}")
        max_s = self.fc1_kernel.shape[1]
        x = torch.stack(
            [F.pad(o.float(), (0, max_s - o.shape[-1])) for o in omics], dim=1
        )  # [B, N, max_s]
        h = torch.einsum("bns,nsd->bnd", x, self.fc1_kernel) + self.fc1_bias
        h = self.drop1(F.elu(h))
        h = torch.einsum("bnd,nde->bne", h, self.fc2_kernel) + self.fc2_bias
        return self.drop2(F.elu(h))
