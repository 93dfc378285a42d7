"""Attention primitives (``multimodal_path_omic_tpu/ops/attention.py``):
the branches of ``MultiheadAttention`` that MCAT, NaCAGaT and GE-NaCAGaT
take, the contextual attention gate and the pre-gated contextual
co-attention.

Inputs are batched ``[B, seq, dim]`` with an optional boolean key-validity
mask ``[B, M]`` (True = valid). Attention dropout (torch semantics: weights
normalized, then dropped and rescaled) is active in training mode and draws
from the ``generator`` the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops.coattn import (
    attention_with_weights,
    fused_attention,
    fused_attention_leank,
    fused_k_supports,
    leank_train_form,
    plain_k_supports,
)
from multimodal_path_omic_tpu_torch.ops.flash import flash_attention
from multimodal_path_omic_tpu_torch.ops.flash import supports as flash_supports
from multimodal_path_omic_tpu_torch.ops.layers import (
    TorchLinear,
    dropout,
    fast_keep_mask,
    masked_softmax,
    require_generator,
)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, E] -> [B, H, L, E/H]"""
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] -> [B, L, H*D]"""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def tiny_attention(q, k, v, key_mask, num_heads: int, *, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Few-token attention as broadcast-multiply-reduce (the 6-token branch
    transformers). q [B, N, E]; k, v [B, M, E] -> [B, N, E]. Same math as
    :func:`attention_core`: 1/sqrt(D) scale, masked softmax over keys,
    dropout on the weights at ``dropout_rate``."""
    b, n, e = q.shape
    m = k.shape[1]
    d = e // num_heads
    q4 = q.reshape(b, n, num_heads, d)
    k4 = k.reshape(b, m, num_heads, d)
    v4 = v.reshape(b, m, num_heads, d)
    # scores [B, N, M, H]
    scores = ((q4 * (1.0 / math.sqrt(d)))[:, :, None] * k4[:, None]).sum(-1)
    mask4 = None if key_mask is None else key_mask[:, None, :, None]
    weights = dropout(masked_softmax(scores, mask4, dim=2), dropout_rate, generator)
    out = (weights[..., None] * v4[:, None]).sum(2)  # [B, N, H, D]
    return out.reshape(b, n, e)


def lean_single_head_cross_attention(q, kv, wk, bk, wv, bv, key_mask, *,
                                     dropout_rate: float = 0.0,
                                     generator: Optional[torch.Generator] = None):
    """Few-query single-head cross-attention with the K and V projections
    reassociated off the patch axis:

        scores = (q/sqrt(d)) (kv wk + bk)^T = ((q/sqrt(d)) wk^T) kv^T + (q/sqrt(d)).bk
        out    = w (kv wv + bv)            = (w kv) wv + bv sum_m(w)

    so every patch-axis product contracts against the N queries and the
    [B, M, E] k and v never exist. q [B, N, E] (projected, unscaled), kv
    [B, M, F] raw patch-side input, wk, wv [F, E], bk, bv [E]. The dropout
    mask is drawn in :func:`attention_core`'s [B, 1, N, M] layout. Returns
    (out [B, N, E], weights [B, N, M], the dropped ones)."""
    b, n, e = q.shape
    qs = q * (1.0 / math.sqrt(e))
    qk = torch.matmul(qs, wk.t())  # [B, N, F]
    scores = torch.matmul(qk, kv.transpose(-1, -2)) + torch.matmul(qs, bk)[..., None]
    weights = masked_softmax(scores, None if key_mask is None else key_mask[:, None, :])
    if dropout_rate > 0.0:
        keep, keep_prob = fast_keep_mask(generator, dropout_rate,
                                         (b, 1, n, weights.shape[-1]), q.device)
        weights = torch.where(keep[:, 0], weights / keep_prob, torch.zeros_like(weights))
    pooled = torch.matmul(weights, kv)
    out = torch.matmul(pooled, wv) + bv * weights.sum(dim=-1, keepdim=True)
    return out, weights


def attention_core(q, k, v, key_mask, *, pre_gate: bool, need_weights: bool = True,
                   dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """Scaled-dot attention on projected heads.

    q [B, H, N, D]; k, v [B, H, M, D]; key_mask [B, M]. With ``pre_gate``,
    scores are multiplied by (tanh(q).tanh(k)^T + 1)/2 before the softmax.
    ``dropout_rate`` drops the normalized weights (the returned weights are
    the dropped ones). Returns (out [B, H, N, D], weights [B, H, N, M] or
    None)."""
    d = q.shape[-1]
    scores = torch.matmul(q / math.sqrt(d), k.transpose(-1, -2))
    if pre_gate:
        p = (torch.matmul(torch.tanh(q), torch.tanh(k).transpose(-1, -2)) + 1.0) / 2.0
        scores = scores * p
    mask4 = None if key_mask is None else key_mask[:, None, None, :]
    weights = dropout(masked_softmax(scores, mask4), dropout_rate, generator)
    out = torch.matmul(weights, v)
    return out, (weights if need_weights else None)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` parity: packed in-projection (torch layout
    ``in_proj_weight [3E, E]``, the transpose of the JAX ``[E, 3E]``
    kernel), optional pre-gating, attention dropout at ``dropout_rate`` in
    training mode. Branches, in the JAX module's order:

    * lean (one head, few-query cross-attention without the pre-gate, key is
      value: MCAT): :func:`lean_single_head_cross_attention`, plain PyTorch,
      no kernel; serves every ``need_weights``;
    * lean-V (one head, pre-gated cross-attention, weights not requested,
      a shape :func:`fused_k_supports` admits): the K projection happens in
      the fuse-K kernel, the V projection is reassociated onto the pooled
      rows: out = (w.kv) @ wv + bv * sum(w); in training the kernels'
      training form (dropout, ssq, backward);
    * tiny: few-token attention without weights (branch transformers);
    * fused (cross-attention over more than 32 keys of a shape
      :func:`plain_k_supports` admits, weights not requested, or "ssq" with
      one head): k and v are projected
      over the patch axis and :func:`fused_attention` runs the plain-K
      kernels with values, forward and backward, in eval and in training
      (dropout in-kernel). Reached when the lean routes do not apply
      (several heads, key is not value) or are switched off;
    * flash (self-attention over more than 32 positions, no pre-gate, weights
      not requested: GE's bag self-attention and path transformer), in eval
      and in training: :func:`flash_attention`, forward and backward, the
      L x L scores never in device memory; the heads are read in place from
      the packed projection. With attention dropout active the branch is
      taken from 4096 positions up, and the attention-probability dropout
      site is dropped there (a dropout mask over L x L weights cannot be
      materialized; every other dropout site of the layer remains), as in the
      JAX module; below that, active dropout keeps :func:`attention_core`.
      A head width ``flash.supports`` refuses takes :func:`attention_core`
      without dropout in this branch (JAX: ``_xla_fused``);
    * export (weights requested, cross-attention, no dropout): two-pass
      weights emission;
    * otherwise :func:`attention_core`, also for every shape a kernel's
      predicate refuses (the JAX dispatchers' ``_xla_fused`` /
      ``attention_core`` fallback): the route is decided by shape alone, on
      the CPU and on the card alike.

    ``need_weights``: True returns the [B, N, M] weights, False None, and
    "ssq" the per-query sum of squares of the final weights [B, N] (the
    cesar penalty's input, without the N x M map on the lean-V branch).

    ``lean=False`` switches the lean and lean-V routes off (the JAX
    package's ``MPO_NO_LEAN_ATTENTION=1``; here a constructor argument, no
    environment variable): the same numbers through the fused branch.
    """

    def __init__(self, embed_dim: int, num_heads: int, pre_gate: bool = False,
                 dropout_rate: float = 0.0, lean: bool = True):
        super().__init__()
        self.lean = bool(lean)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.pre_gate = pre_gate
        self.dropout_rate = float(dropout_rate)
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
                average_attn_weights: bool = True, return_projected_q: bool = False,
                generator: Optional[torch.Generator] = None):
        if need_weights not in (True, False, "ssq"):
            raise ValueError(f"need_weights must be True, False or 'ssq', got {need_weights!r}")
        want_ssq = need_weights == "ssq"
        e, heads = self.embed_dim, self.num_heads
        rate = self.dropout_rate if self.training else 0.0
        self_attn = query is key
        n, m_len = query.shape[1], key.shape[1]
        lean_shape = (self.lean and heads == 1 and not self_attn and key is value
                      and n <= 32 and m_len > 32)
        lean = lean_shape and not self.pre_gate
        # lean-V only where the fuse-K kernels take the shape, in the form the
        # call will run
        train_form = leank_train_form(rate, want_ssq, query, key, self.in_proj_weight,
                                      self.in_proj_bias)
        lean_v = (lean_shape and self.pre_gate and need_weights is not True
                  and fused_k_supports(n, e, key.shape[-1], m_len, train=train_form))
        out_h = weights = ssq = None
        if lean:
            q = self._proj(query, 0, 1)
            w = self.in_proj_weight
            out_flat, w_lean = lean_single_head_cross_attention(
                q, key, w[e:2 * e].t(), self.in_proj_bias[e:2 * e], w[2 * e:].t(),
                self.in_proj_bias[2 * e:], key_mask, dropout_rate=rate, generator=generator,
            )
            if need_weights is True:
                weights = w_lean[:, None]
            elif want_ssq:  # one head: the head-averaged weights are the weights
                ssq = (w_lean * w_lean).sum(dim=-1)
        elif lean_v:
            q = self._proj(query, 0, 1)
            wk = self.in_proj_weight[e:2 * e].t().contiguous()  # [F, E]
            seed = None
            if rate > 0.0:  # the kernel's dropout seed, drawn per call
                seed = torch.randint(0, 2**31 - 1, (1,), generator=require_generator(generator),
                                     device=query.device, dtype=torch.int32)
            res = fused_attention_leank(
                q, key.contiguous(), wk, self.in_proj_bias[e:2 * e], key_mask,
                dropout_rate=rate, dropout_seed=seed, need_ssq=want_ssq, need_sumw=True,
            )
            out_raw, sumw = res[0], res[-1]
            if want_ssq:
                ssq = res[1]
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
                    and n <= 32 and m_len <= 32):
                out_flat = tiny_attention(q, k, v, key_mask, heads, dropout_rate=rate,
                                          generator=generator)
            else:
                qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
                if (not self_attn and m_len > 32
                        and plain_k_supports(n, e // heads, m_len, values=True)
                        and (need_weights is False or (want_ssq and heads == 1))):
                    res = fused_attention(qh, kh, vh, key_mask, pre_gate=self.pre_gate,
                                          dropout_rate=rate, generator=generator,
                                          need_ssq=want_ssq)
                    out_h, ssq = (res[0], res[1][:, 0]) if want_ssq else (res, None)
                elif (need_weights is False and not self.pre_gate and self_attn
                        and key is value and n > 32 and (rate == 0.0 or n >= 4096)):
                    if flash_supports(*qh.shape):
                        out_h = flash_attention(qh, kh, vh, key_mask)
                    else:  # no kernel instance (JAX: _xla_fused); the site dropped alike
                        out_h, _ = attention_core(qh, kh, vh, key_mask, pre_gate=False,
                                                  need_weights=False)
                elif need_weights is True and not self_attn and rate == 0.0:
                    out_h, weights = attention_with_weights(
                        qh, kh, vh, key_mask, pre_gate=self.pre_gate
                    )
                else:
                    out_h, weights = attention_core(
                        qh, kh, vh, key_mask, pre_gate=self.pre_gate,
                        need_weights=need_weights is not False, dropout_rate=rate,
                        generator=generator,
                    )
                if want_ssq and ssq is None:  # of the head-averaged weights, as the map returned
                    w = weights.mean(dim=1)
                    ssq, weights = (w * w).sum(dim=-1), None
        out = self.out_proj(out_flat if out_h is None else _merge_heads(out_h))
        if weights is not None and average_attn_weights:
            weights = weights.mean(dim=1)  # [B, N, M]
        second = ssq if want_ssq else weights
        if return_projected_q:
            return out, second, q
        return out, second


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
    return out + CAG(Q, W_q Q), A. ``need_weights`` as in
    :class:`MultiheadAttention` (A is the ssq [B, N] for "ssq")."""

    def __init__(self, embed_dim: int, num_heads: int = 1, dropout_rate: float = 0.25,
                 lean: bool = True):
        super().__init__()
        self.mha = MultiheadAttention(embed_dim, num_heads, pre_gate=True,
                                      dropout_rate=dropout_rate, lean=lean)
        self.cag = ContextualAttentionGate(embed_dim, embed_dim)

    def forward(self, query, key, value, key_mask: Optional[torch.Tensor] = None, *,
                need_weights=True, average_attn_weights: bool = True,
                generator: Optional[torch.Generator] = None):
        attn_out, weights, q_proj = self.mha(
            query, key, value, key_mask, need_weights=need_weights,
            average_attn_weights=average_attn_weights, return_projected_q=True,
            generator=generator,
        )
        return attn_out + self.cag(query, q_proj), weights
