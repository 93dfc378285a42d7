"""Shared model plumbing: size table, survival head, output container
(``multimodal_path_omic_tpu/models/common.py``), and the skeleton MCAT and
NaCAGaT share."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_path_omic_tpu_torch.ops.blocks import (
    GatedMILPool,
    OmicEncoderStack,
    WSIEncoder,
)
from multimodal_path_omic_tpu_torch.ops.fusion import make_fusion
from multimodal_path_omic_tpu_torch.ops.layers import TorchLinear
from multimodal_path_omic_tpu_torch.ops.transformer import TransformerEncoder

MODEL_SIZES = {"small": (128, 128), "medium": (256, 256), "big": (512, 512)}


class SurvivalOutput(NamedTuple):
    """hazards / survs / y: [B, n_classes]; attention: dict of score maps
    ('coattn' is None when not requested)."""

    hazards: torch.Tensor
    survs: torch.Tensor
    y: torch.Tensor
    attention: Dict[str, Optional[torch.Tensor]]


def survival_head(
    logits: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits -> (hazards, survs, Y), always in float32:
    hazards = sigmoid(logits); survs = cumprod(1 - hazards); Y = softmax(logits)."""
    logits = logits.float()
    hazards = torch.sigmoid(logits)
    survs = torch.cumprod(1.0 - hazards, dim=-1)
    y = torch.softmax(logits, dim=-1)
    return hazards, survs, y


class CoAttentionSurvivalModel(nn.Module):
    """The skeleton of MCAT and NaCAGaT: WSI FC (``H``) and per-signature SNN
    omic encoders (``G``), a co-attention with omic queries over patch keys
    and values (the subclass's module), two 2-layer transformer
    encoders and gated-attention MIL pools (path and omic branch), fusion and
    the survival head.

    The JAX models run their two branch modules (slot 0 = path, slot 1 =
    omic) as one vmapped module over stacked parameters; here they are two
    modules in a ModuleList, and the weight bridge (``utils/weights.py``)
    splits the stacked axis. ``co_attention`` is any module called as
    ``(query, key, value, key_mask, need_weights=, generator=)`` that returns
    ``(out [B, N, d2], weights | ssq | None)``."""

    def __init__(self, co_attention: nn.Module, omic_sizes: Sequence[int],
                 model_size: str = "medium", n_classes: int = 4,
                 dropout_rate: float = 0.25, fusion: str = "concat",
                 wsi_dim: int = 1024):
        super().__init__()
        d1, d2 = MODEL_SIZES[model_size]
        self.H = WSIEncoder(wsi_dim, d1, dropout_rate)
        self.G = OmicEncoderStack(omic_sizes, d1, d2, dropout_rate)
        self.co_attention = co_attention
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
                need_attention=True,
                generator: Optional[torch.Generator] = None) -> SurvivalOutput:
        """wsi [B, M, wsi_dim], omics: list of [B, s_i], mask [B, M] bool.
        ``need_attention``: True returns the co-attention map [B, N, M] under
        ``attention['coattn']``; False skips it; "ssq" returns the per-query
        sum of squares of the final co-attention weights [B, N] under
        ``attention['coattn_ssq']`` (all the cesar loss needs). ``generator``
        feeds every dropout site in training mode."""
        want_ssq = need_attention == "ssq"
        h_bag = self.H(wsi, generator)
        g_bag = self.G(omics, generator)
        h_coattn, a_coattn = self.co_attention(
            g_bag, h_bag, h_bag, mask, need_weights="ssq" if want_ssq else bool(need_attention),
            generator=generator,
        )
        pooled, scores = [], []
        for slot, tokens in enumerate((h_coattn, g_bag)):
            p, s = self.branch_pool[slot](
                self.branch_transformer[slot](tokens, None, generator), None, generator)
            pooled.append(p)
            scores.append(s)
        h = self.fusion_layer(pooled[0], pooled[1])
        hazards, survs, y = survival_head(self.classifier(h))
        attention = {"path": scores[0], "omic": scores[1]}
        if want_ssq:
            attention["coattn"] = None
            attention["coattn_ssq"] = a_coattn
        else:
            attention["coattn"] = a_coattn if need_attention else None
        return SurvivalOutput(hazards=hazards, survs=survs, y=y, attention=attention)
