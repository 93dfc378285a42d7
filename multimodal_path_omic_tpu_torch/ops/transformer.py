"""Post-LN transformer encoder with torch-default semantics
(``multimodal_path_omic_tpu/ops/transformer.py``): post-norm, LayerNorm eps
1e-5, ReLU feed-forward, dropout on the attention weights, the attention
output, inside the feed-forward and on its output (training mode, drawn from
the ``generator`` passed to ``forward``). Input [B, L, D] with an optional
mask [B, L]. LayerNorm computes its statistics in float32 under a
bfloat16 compute dtype (``ops/layers.py::LayerNorm``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops.attention import MultiheadAttention
from multimodal_path_omic_tpu_torch.ops.layers import FastDropout, LayerNorm, TorchLinear


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int = 8, dim_feedforward: int = 512,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dropout_rate=dropout_rate)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = TorchLinear(d_model, dim_feedforward)
        self.linear2 = TorchLinear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.drop_attn = FastDropout(dropout_rate)
        self.drop_ff = FastDropout(dropout_rate)
        self.drop_out = FastDropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn_out, _ = self.self_attn(x, x, x, mask, need_weights=False, generator=generator)
        x = self.norm1(x + self.drop_attn(attn_out, generator))
        ff = self.linear2(self.drop_ff(F.relu(self.linear1(x)), generator))
        return self.norm2(x + self.drop_out(ff, generator))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, num_layers: int = 2, nhead: int = 8,
                 dim_feedforward: int = 512, dropout_rate: float = 0.25):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout_rate)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask, generator)
        return x
