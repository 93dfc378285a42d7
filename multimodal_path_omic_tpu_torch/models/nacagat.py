"""NaCAGaT: Narrow Contextual Attention Gate Transformer
(``multimodal_path_omic_tpu/models/nacagat.py``), eval forward.

The MCAT skeleton with the pre-gated contextual co-attention. The JAX model
runs its two branch modules (slot 0 = path, slot 1 = omic) as one vmapped
module over stacked parameters; here they are two modules in a ModuleList,
and the weight bridge (``utils/weights.py``) splits the stacked axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from multimodal_path_omic_tpu_torch.models.common import (
    MODEL_SIZES,
    SurvivalOutput,
    survival_head,
)
from multimodal_path_omic_tpu_torch.ops.attention import PreGatingContextualAttention
from multimodal_path_omic_tpu_torch.ops.blocks import (
    GatedMILPool,
    OmicEncoderStack,
    WSIEncoder,
)
from multimodal_path_omic_tpu_torch.ops.fusion import make_fusion
from multimodal_path_omic_tpu_torch.ops.layers import TorchLinear
from multimodal_path_omic_tpu_torch.ops.transformer import TransformerEncoder


class NaCAGaT(nn.Module):
    def __init__(self, omic_sizes: Sequence[int], model_size: str = "medium",
                 n_classes: int = 4, dropout_rate: float = 0.25,
                 fusion: str = "concat", wsi_dim: int = 1024):
        super().__init__()
        d1, d2 = MODEL_SIZES[model_size]
        self.H = WSIEncoder(wsi_dim, d1, dropout_rate)
        self.G = OmicEncoderStack(omic_sizes, d1, d2, dropout_rate)
        self.co_attention = PreGatingContextualAttention(d2, 1)
        self.branch_transformer = nn.ModuleList(
            TransformerEncoder(d2, num_layers=2, dropout_rate=dropout_rate)
            for _ in range(2)
        )
        self.branch_pool = nn.ModuleList(
            GatedMILPool(d2, dropout_rate) for _ in range(2)
        )
        self.fusion_layer = make_fusion(fusion, 2 * d2, d2, d2)
        self.classifier = TorchLinear(d2, n_classes)

    def forward(self, wsi: torch.Tensor, omics: Sequence[torch.Tensor],
                mask: Optional[torch.Tensor] = None, *,
                need_attention: bool = True) -> SurvivalOutput:
        """wsi [B, M, wsi_dim], omics: list of [B, s_i], mask [B, M] bool.
        ``need_attention``: True returns the co-attention map [B, N, M] under
        ``attention['coattn']`` (export branch); False skips it (lean-V
        branch, fuse-K kernel)."""
        h_bag = self.H(wsi)
        g_bag = self.G(omics)
        h_coattn, a_coattn = self.co_attention(
            g_bag, h_bag, h_bag, mask, need_weights=need_attention
        )
        pooled, scores = [], []
        for slot, tokens in enumerate((h_coattn, g_bag)):
            p, s = self.branch_pool[slot](self.branch_transformer[slot](tokens))
            pooled.append(p)
            scores.append(s)
        h = self.fusion_layer(pooled[0], pooled[1])
        hazards, survs, y = survival_head(self.classifier(h))
        attention = {
            "path": scores[0],
            "omic": scores[1],
            "coattn": a_coattn if need_attention else None,
        }
        return SurvivalOutput(hazards=hazards, survs=survs, y=y, attention=attention)
