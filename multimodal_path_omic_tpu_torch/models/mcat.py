"""MCAT: Multimodal Co-Attention Transformer
(``multimodal_path_omic_tpu/models/mcat.py``): the forward in eval and
training mode.

The skeleton is ``models/common.py::CoAttentionSurvivalModel``, shared with
``models/nacagat.py``; MCAT's co-attention is a plain one-head
``MultiheadAttention`` without attention dropout and without the pre-gate.
By default it takes the module's lean branch (no kernel: both patch-side
projections are reassociated onto the six queries) for every
``need_attention``; with ``lean=False`` it projects k and v over the patch
axis and runs the plain-K kernels (False, "ssq") or the export kernels
(True).
"""

from __future__ import annotations

from typing import Sequence

from multimodal_path_omic_tpu_torch.models.common import (
    MODEL_SIZES,
    CoAttentionSurvivalModel,
)
from multimodal_path_omic_tpu_torch.ops.attention import MultiheadAttention


class MCAT(CoAttentionSurvivalModel):
    def __init__(self, omic_sizes: Sequence[int], model_size: str = "medium",
                 n_classes: int = 4, dropout_rate: float = 0.25,
                 fusion: str = "concat", wsi_dim: int = 1024, lean: bool = True,
                 bug_compat: bool = False):
        d2 = MODEL_SIZES[model_size][1]
        super().__init__(MultiheadAttention(d2, 1, dropout_rate=0.0, lean=lean),
                         omic_sizes, model_size, n_classes, dropout_rate, fusion, wsi_dim,
                         bug_compat)
