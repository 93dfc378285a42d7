"""Model blocks (``multimodal_path_omic_tpu/ops/blocks.py``): the MIL
scoring head, the masked MIL pooling, the fused SNN omic encoders and the
WSI patch encoder. Dropout sites are active in training mode and draw from
the ``generator`` passed to ``forward``. Each block computes in its
``compute_dtype`` (``ops/layers.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops.layers import (
    NEG_INF,
    AlphaDropout,
    FastDropout,
    TorchLinear,
    cast,
    masked_softmax,
    seq_sharded,
)
from multimodal_path_omic_tpu_torch.ops import remat
from multimodal_path_omic_tpu_torch.ops import milpool as _milpool  # noqa: F401 (registers the op)
from multimodal_path_omic_tpu_torch.ops.milpool import supports as milpool_supports


def fused_gated_mil_pool(x, mask, wa, ba, wb, bb, wc, bc):
    """``milpool.fused_gated_mil_pool`` through its custom op
    ``mpo_torch::milpool`` (``deploy.py`` exports it as one node)."""
    return torch.ops.mpo_torch.milpool(x, mask, wa, ba, wb, bb, wc, bc)


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
    JAX module's XLA fallback), training (two dropout sites, no backward
    kernel) and bfloat16 activations (a bfloat16 compute dtype; the kernel
    is float32-only, on the TPU too: one checkpoint scores alike in every
    bucket) take the eager branch.

    On a mesh (``layers.set_mesh``) the kernel is off, as in JAX
    (``blocks.py:99``). On a seq mesh the patch axis is split: the masked
    softmax over it merges across the seq group (in JAX GSPMD does it): the
    local maximum, its maximum over the group, then the sums of exp and of
    the weighted rows over the group; the raw scores stay local.
    """

    mesh = None  # this rank's parallel.mesh.Mesh, where the pool runs over the patch axis

    def __init__(self, dim: int, dropout_rate: float = 0.25):
        super().__init__()
        self.attention_head = AttentionNetGated(dim, dim, 1, dropout_rate)
        self.rho = TorchLinear(dim, dim)
        self.drop = FastDropout(dropout_rate, over_patches=False)  # on the pooled [B, D]

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        head = self.attention_head
        if seq_sharded(self):
            pooled, a = self._seq_pool(x, mask, generator)
        elif (self.mesh is None and not self.training and x.shape[1] > 32
                and x.dtype == torch.float32
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

    def _seq_pool(self, x, mask, generator):
        from multimodal_path_omic_tpu_torch.parallel import comm

        group = self.mesh.seq_group
        scores, h = self.attention_head(x, generator)
        a = scores.transpose(-1, -2)  # [B, 1, Ml]
        am = a if mask is None else torch.where(mask[:, None, :], a, torch.full_like(a, NEG_INF))
        m = comm.max_over(am.amax(dim=-1, keepdim=True), group)
        e = torch.exp(am - m)
        l_sum = comm.sum_over(e.sum(dim=-1, keepdim=True), group)
        pooled = comm.sum_over(torch.matmul(e, h), group) / l_sum
        return pooled[:, 0, :], a


class WSIEncoder(nn.Module):
    """Patch-embedding FC: Linear(F -> d) + ReLU + Dropout. With
    ``wsi_scale`` and an int8 ``wsi`` (``tpu.int8_matmul``) the projection
    takes the int8 route (``layers.w8a8_linear``). Under ``tpu.remat``
    (``ops/remat.py``) neither the fc output nor the post-dropout h is kept
    (JAX tags both, ``blocks.py:184-190``): the ReLU keeps the sign of its
    input (one byte an element), and the backward recomputes h from ``wsi``
    and the forward's keep mask, in place."""

    def __init__(self, in_dim: int, dim: int, dropout_rate: float = 0.25):
        super().__init__()
        self.fc = TorchLinear(in_dim, dim)
        self.drop = FastDropout(dropout_rate)

    def forward(self, wsi: torch.Tensor, generator: Optional[torch.Generator] = None,
                wsi_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not remat.active():
            return self.drop(F.relu(self.fc(wsi, wsi_scale)), generator)
        r = remat.ReluSavingSign.apply(self.fc(wsi, wsi_scale))  # saves fc > 0, not fc
        drawn = self.drop.keep_mask(r, generator)

        def recompute(wsi_, scale_):  # in place: one [B, M, d] tensor at a time
            h = self.fc(wsi_, scale_).relu_()
            if drawn is None:
                return h
            keep, keep_prob = drawn
            return h.div_(keep_prob).masked_fill_(~keep, 0.0)  # FastDropout.apply's values

        return remat.tag(self.drop.apply(r, drawn), recompute, wsi, wsi_scale)


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
        h = torch.einsum("bns,nsd->bnd", cast(x, self), cast(self.fc1_kernel, self)) \
            + cast(self.fc1_bias, self)
        h = self.drop1(F.elu(h), generator)
        h = torch.einsum("bnd,nde->bne", h, cast(self.fc2_kernel, self)) \
            + cast(self.fc2_bias, self)
        return self.drop2(F.elu(h), generator)
