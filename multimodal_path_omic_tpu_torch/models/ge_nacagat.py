"""GE-NaCAGaT: the WSI-only gene-expression-class model
(``multimodal_path_omic_tpu/models/ge_nacagat.py``).

Despite its name it holds no pre-gating or CAG block: plain one-head
self-attention over the patch bag (Q = K = V = the patch embeddings), a
2-layer path transformer, gated MIL pooling over the patch axis and a
3-class classifier with ``y = softmax(logits)``.

It is the worst case for memory: M x M self-attention over bags of up to
~24k patches, three times per forward. The bag mask reaches the
self-attention, the path transformer and the pool. The three
self-attentions take the flash branch of ``MultiheadAttention`` (scores
never materialized): always in eval; in training the model's own
self-attention (dropout 0) always, and the path transformer's layers from
4096 patches up, where their attention-probability dropout site is dropped
(below that they keep the materialized attention with dropout). The pool
takes the streaming MIL-pool kernel in eval and its eager branch, with its
two dropout sites, in training. The full M x M map is formed only when
``need_attention`` asks for it, which is usable at small M only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_path_omic_tpu_torch.models.common import MODEL_SIZES
from multimodal_path_omic_tpu_torch.ops.attention import MultiheadAttention
from multimodal_path_omic_tpu_torch.ops.blocks import GatedMILPool, WSIEncoder
from multimodal_path_omic_tpu_torch.ops.layers import TorchLinear, seq_sharded, set_mesh
from multimodal_path_omic_tpu_torch.ops.transformer import TransformerEncoder


class GENaCAGaT(nn.Module):
    def __init__(self, model_size: str = "medium", n_classes: int = 3,
                 dropout_rate: float = 0.25, wsi_dim: int = 1024):
        super().__init__()
        d1, d2 = MODEL_SIZES[model_size]
        self.H = WSIEncoder(wsi_dim, d1, dropout_rate)
        self.self_attention = MultiheadAttention(d2, 1, dropout_rate=0.0)
        self.path_transformer = TransformerEncoder(d2, num_layers=2, dropout_rate=dropout_rate)
        self.path_pool = GatedMILPool(d2, dropout_rate)
        self.classifier = TorchLinear(d2, n_classes)

    def carry_mesh(self, mesh) -> None:
        """Every module runs over the patch axis here: the WSI encoder, the
        self-attention, the path transformer and the pool (JAX
        ``ge_nacagat.py:40-88``); on a seq mesh the attentions take the ring
        and the pool merges its softmax over the seq group."""
        for module in (self.H, self.self_attention, self.path_transformer, self.path_pool):
            set_mesh(module, mesh)

    def forward(self, wsi: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                need_attention: bool = False,
                generator: Optional[torch.Generator] = None,
                wsi_scale: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
        """wsi [B, M, wsi_dim], mask [B, M] bool -> (y [B, n_classes],
        {"attn": the [B, M, M] self-attention map or None, "path": the raw
        MIL scores [B, 1, M]}). ``generator`` feeds every dropout site in
        training mode; ``wsi_scale`` as in the survival models. On a seq
        mesh (this rank's patches given) the maps are the whole bag's in
        eval: the pool's scores and the self-attention's rows all-gathered
        over the seq group."""
        h_bag = self.H(wsi, generator, wsi_scale)
        h_attn, a_attn = self.self_attention(h_bag, h_bag, h_bag, mask,
                                             need_weights=bool(need_attention),
                                             generator=generator)
        path_trans = self.path_transformer(h_attn, mask, generator)
        h_path, a_path = self.path_pool(path_trans, mask, generator)
        if seq_sharded(self.path_pool) and not self.training:
            # the whole bag's scores (JAX's attention['path'] over the sharded
            # bag): every seq rank's patches, gathered in order
            from multimodal_path_omic_tpu_torch.parallel import comm

            a_path = comm.all_gather(a_path, self.path_pool.mesh.seq_group, 2)
        # the class probabilities, in float32 whatever the compute type
        y = torch.softmax(self.classifier(h_path).float(), dim=-1)
        return y, {"attn": a_attn, "path": a_path}
