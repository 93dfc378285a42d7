"""Attention primitives (``multimodal_path_omic_tpu/ops/attention.py``):
the branches of ``MultiheadAttention`` that NaCAGaT's eval takes, the
contextual attention gate and the pre-gated contextual co-attention.

Inputs are batched ``[B, seq, dim]`` with an optional boolean key-validity
mask ``[B, M]`` (True = valid). Eval only: every dropout is the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops.coattn import (
    attention_with_weights,
    fused_attention_leank,
)
from multimodal_path_omic_tpu_torch.ops.layers import TorchLinear, masked_softmax


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, E] -> [B, H, L, E/H]"""
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] -> [B, L, H*D]"""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def tiny_attention(q, k, v, key_mask, num_heads: int) -> torch.Tensor:
    """Few-token attention as broadcast-multiply-reduce (the 6-token branch
    transformers). q [B, N, E]; k, v [B, M, E] -> [B, N, E]. Same math as
    :func:`attention_core`: 1/sqrt(D) scale, masked softmax over keys."""
    b, n, e = q.shape
    m = k.shape[1]
    d = e // num_heads
    q4 = q.reshape(b, n, num_heads, d)
    k4 = k.reshape(b, m, num_heads, d)
    v4 = v.reshape(b, m, num_heads, d)
    # scores [B, N, M, H]
    scores = ((q4 * (1.0 / math.sqrt(d)))[:, :, None] * k4[:, None]).sum(-1)
    mask4 = None if key_mask is None else key_mask[:, None, :, None]
    weights = masked_softmax(scores, mask4, dim=2)
    out = (weights[..., None] * v4[:, None]).sum(2)  # [B, N, H, D]
    return out.reshape(b, n, e)


def attention_core(q, k, v, key_mask, *, pre_gate: bool, need_weights: bool = True):
    """Scaled-dot attention on projected heads.

    q [B, H, N, D]; k, v [B, H, M, D]; key_mask [B, M]. With ``pre_gate``,
    scores are multiplied by (tanh(q).tanh(k)^T + 1)/2 before the softmax.
    Returns (out [B, H, N, D], weights [B, H, N, M] or None)."""
    d = q.shape[-1]
    scores = torch.matmul(q / math.sqrt(d), k.transpose(-1, -2))
    if pre_gate:
        p = (torch.matmul(torch.tanh(q), torch.tanh(k).transpose(-1, -2)) + 1.0) / 2.0
        scores = scores * p
    mask4 = None if key_mask is None else key_mask[:, None, None, :]
    weights = masked_softmax(scores, mask4)
    out = torch.matmul(weights, v)
    return out, (weights if need_weights else None)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` parity: packed in-projection (torch layout
    ``in_proj_weight [3E, E]``, the transpose of the JAX ``[E, 3E]``
    kernel), optional pre-gating. Branches, in the JAX module's order:

    * lean-V (one head, pre-gated cross-attention, no weights): the K
      projection happens in the fuse-K kernel, the V projection is
      reassociated onto the pooled rows: out = (w.kv) @ wv + bv * sum(w);
    * tiny: few-token attention without weights (branch transformers);
    * export (weights requested, cross-attention): two-pass weights emission;
    * otherwise :func:`attention_core`.
    """

    def __init__(self, embed_dim: int, num_heads: int, pre_gate: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.pre_gate = pre_gate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = TorchLinear(embed_dim, embed_dim)
        bound = math.sqrt(6.0 / (4 * embed_dim))  # xavier over the packed matrix
        nn.init.uniform_(self.in_proj_weight, -bound, bound)

    def _proj(self, x, lo: int, hi: int):
        e = self.embed_dim
        return F.linear(x, self.in_proj_weight[lo * e:hi * e],
                        self.in_proj_bias[lo * e:hi * e])

    def forward(self, query, key, value, key_mask=None, *, need_weights=True,
                average_attn_weights: bool = True, return_projected_q: bool = False):
        if need_weights not in (True, False):
            raise NotImplementedError(f"need_weights={need_weights!r} (ssq) comes with training")
        e, heads = self.embed_dim, self.num_heads
        self_attn = query is key
        lean_v = (
            heads == 1 and not self_attn and key is value and self.pre_gate
            and need_weights is False
            and query.shape[1] <= 32 and key.shape[1] > 32
        )
        out_h = weights = None
        if lean_v:
            q = self._proj(query, 0, 1)
            wk = self.in_proj_weight[e:2 * e].t().contiguous()  # [F, E]
            out_raw, sumw = fused_attention_leank(
                q, key.contiguous(), wk, self.in_proj_bias[e:2 * e], key_mask,
                need_sumw=True,
            )
            # V projection after the patch-axis contraction, bias weighted by
            # the row's weight mass
            out_flat = (F.linear(out_raw, self.in_proj_weight[2 * e:])
                        + self.in_proj_bias[2 * e:] * sumw[:, :, None])
        else:
            if self_attn and key is value:
                q, k, v = self._proj(query, 0, 3).chunk(3, dim=-1)
            else:
                q = self._proj(query, 0, 1)
                k = self._proj(key, 1, 2)
                v = self._proj(value, 2, 3)
            if (need_weights is False and not self.pre_gate
                    and query.shape[1] <= 32 and key.shape[1] <= 32):
                out_flat = tiny_attention(q, k, v, key_mask, heads)
            else:
                qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
                if need_weights is True and not self_attn:
                    out_h, weights = attention_with_weights(
                        qh, kh, vh, key_mask, pre_gate=self.pre_gate
                    )
                else:
                    out_h, weights = attention_core(
                        qh, kh, vh, key_mask, pre_gate=self.pre_gate,
                        need_weights=bool(need_weights),
                    )
        out = self.out_proj(out_flat if out_h is None else _merge_heads(out_h))
        if weights is not None and average_attn_weights:
            weights = weights.mean(dim=1)  # [B, N, M]
        if return_projected_q:
            return out, weights, q
        return out, weights


class ContextualAttentionGate(nn.Module):
    """CAG: G = LN(ELU(ELU(fc1(Q)) + ELU(fc2(Q_hat)))); E = LN(ELU(ELU(fc3(Q_hat))));
    C = ELU(fc_c(G * E)). fc1/2/3 already end in ELU: the double ELU is
    faithful to the reference."""

    def __init__(self, dim: int = 256, hidden_dim: int = 128):
        super().__init__()
        self.fc1 = TorchLinear(dim, hidden_dim)
        self.fc2 = TorchLinear(dim, hidden_dim)
        self.fc3 = TorchLinear(dim, hidden_dim)
        self.fc_c = TorchLinear(hidden_dim, hidden_dim)
        self.ln_g = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.ln_e = nn.LayerNorm(hidden_dim, eps=1e-5)

    def forward(self, q: torch.Tensor, q_hat: torch.Tensor) -> torch.Tensor:
        fc1 = F.elu(self.fc1(q))
        fc2 = F.elu(self.fc2(q_hat))
        fc3 = F.elu(self.fc3(q_hat))
        g = self.ln_g(F.elu(fc1 + fc2))
        e = self.ln_e(F.elu(fc3))
        return F.elu(self.fc_c(g * e))


class PreGatingContextualAttention(nn.Module):
    """NaCAGaT co-attention: pre-gated MHA plus a CAG residual computed from
    the original and the projected query: out, A = PreGatedMHA(Q, K, V);
    return out + CAG(Q, W_q Q), A."""

    def __init__(self, embed_dim: int, num_heads: int = 1):
        super().__init__()
        self.mha = MultiheadAttention(embed_dim, num_heads, pre_gate=True)
        self.cag = ContextualAttentionGate(embed_dim, embed_dim)

    def forward(self, query, key, value, key_mask: Optional[torch.Tensor] = None, *,
                need_weights=True, average_attn_weights: bool = True):
        attn_out, weights, q_proj = self.mha(
            query, key, value, key_mask, need_weights=need_weights,
            average_attn_weights=average_attn_weights, return_projected_q=True,
        )
        return attn_out + self.cag(query, q_proj), weights
