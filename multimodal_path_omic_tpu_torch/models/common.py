"""Shared model plumbing: size table, survival head, output container
(``multimodal_path_omic_tpu/models/common.py``)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

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
