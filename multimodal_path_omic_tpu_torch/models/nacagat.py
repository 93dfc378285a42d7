"""NaCAGaT: Narrow Contextual Attention Gate Transformer
(``multimodal_path_omic_tpu/models/nacagat.py``): the forward in eval and
training mode (dropout at every site, drawn from the ``generator`` passed to
``forward``).

The MCAT skeleton (``models/common.py::CoAttentionSurvivalModel``, shared
with ``models/mcat.py``) with the pre-gated contextual co-attention:
``need_attention`` True takes its export branch, False and "ssq" the lean-V
branch (fuse-K kernels), or with ``lean=False`` the plain-K kernels over
projected k and v.
"""

from __future__ import annotations

from typing import Sequence

from multimodal_path_omic_tpu_torch.models.common import (
    MODEL_SIZES,
    CoAttentionSurvivalModel,
)
from multimodal_path_omic_tpu_torch.ops.attention import PreGatingContextualAttention


class NaCAGaT(CoAttentionSurvivalModel):
    def __init__(self, omic_sizes: Sequence[int], model_size: str = "medium",
                 n_classes: int = 4, dropout_rate: float = 0.25,
                 fusion: str = "concat", wsi_dim: int = 1024, lean: bool = True,
                 bug_compat: bool = False):
        d2 = MODEL_SIZES[model_size][1]
        super().__init__(PreGatingContextualAttention(d2, 1, dropout_rate, lean=lean),
                         omic_sizes, model_size, n_classes, dropout_rate, fusion, wsi_dim,
                         bug_compat)
