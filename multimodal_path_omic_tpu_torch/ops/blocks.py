"""Model blocks (``multimodal_path_omic_tpu/ops/blocks.py``): the MIL
scoring head, the masked MIL pooling, the fused SNN omic encoders and the
WSI patch encoder. Dropout sites are active in training mode and draw from
the ``generator`` passed to ``forward``."""

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
from multimodal_path_omic_tpu_torch.ops.milpool import fused_gated_mil_pool
from multimodal_path_omic_tpu_torch.ops.milpool import supports as milpool_supports


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

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.drop_a(torch.tanh(self.attention_a(x)), generator)
        b = self.drop_b(torch.sigmoid(self.attention_b(x)), generator)
        return self.attention_c(a * b), x


class GatedMILPool(nn.Module):
    """Masked gated-attention MIL pooling + rho head.

    x: [B, L, D], mask: [B, L] or None -> (pooled [B, D], raw scores [B, 1, L]).

    In eval, a pool over more than 32 positions (GE pools the patch axis)
    at widths the kernel takes (``milpool.supports``) goes through
    :func:`fused_gated_mil_pool`: on a CUDA tensor the streaming kernel, with
    no [B, L, D] branch activations in device memory; on a CPU tensor its
    plain version. Few-token pools (the 6-token branches), other widths (the
    JAX module's XLA fallback) and training (two dropout sites, no backward
    kernel) take the eager branch.
    """

    def __init__(self, dim: int, dropout_rate: float = 0.25):
        super().__init__()
        self.attention_head = AttentionNetGated(dim, dim, 1, dropout_rate)
        self.rho = TorchLinear(dim, dim)
        self.drop = FastDropout(dropout_rate)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        head = self.attention_head
        if (not self.training and x.shape[1] > 32
                and milpool_supports(x.shape[2], head.attention_a.weight.shape[0], x.shape[1])):
            pooled, s = fused_gated_mil_pool(
                x, mask, head.attention_a.weight.t(), head.attention_a.bias,
                head.attention_b.weight.t(), head.attention_b.bias,
                head.attention_c.weight.t(), head.attention_c.bias,
            )
            a = s[:, None, :]  # [B, 1, L] raw scores
        else:
            scores, h = self.attention_head(x, generator)
            a = scores.transpose(-1, -2)  # [B, 1, L]
            weights = masked_softmax(a, None if mask is None else mask[:, None, :])
            pooled = torch.matmul(weights, h)[:, 0, :]  # [B, D]
        pooled = self.drop(F.relu(self.rho(pooled)), generator)
        return pooled, a


class WSIEncoder(nn.Module):
    """Patch-embedding FC: Linear(F -> d) + ReLU + Dropout."""

    def __init__(self, in_dim: int, dim: int, dropout_rate: float = 0.25):
        super().__init__()
        self.fc = TorchLinear(in_dim, dim)
        self.drop = FastDropout(dropout_rate)

    def forward(self, wsi: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.drop(F.relu(self.fc(wsi)), generator)


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

    def forward(self, omics: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if len(omics) != len(self.sizes):
            raise ValueError(f"expected {len(self.sizes)} signatures, got {len(omics)}")
        max_s = self.fc1_kernel.shape[1]
        x = torch.stack(
            [F.pad(o.float(), (0, max_s - o.shape[-1])) for o in omics], dim=1
        )  # [B, N, max_s]
        h = torch.einsum("bns,nsd->bnd", x, self.fc1_kernel) + self.fc1_bias
        h = self.drop1(F.elu(h), generator)
        h = torch.einsum("bnd,nde->bne", h, self.fc2_kernel) + self.fc2_bias
        return self.drop2(F.elu(h), generator)
