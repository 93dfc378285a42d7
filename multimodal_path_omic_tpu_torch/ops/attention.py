"""Attention primitives (``multimodal_path_omic_tpu/ops/attention.py``):
the branches of ``MultiheadAttention`` that MCAT, NaCAGaT and GE-NaCAGaT
take, the contextual attention gate and the pre-gated contextual
co-attention.

Inputs are batched ``[B, seq, dim]`` with an optional boolean key-validity
mask ``[B, M]`` (True = valid). Attention dropout (torch semantics: weights
normalized, then dropped and rescaled) is active in training mode and draws
from the ``generator`` the caller passes. Each module computes in its
``compute_dtype`` (``ops/layers.py``): inputs and parameters are cast where
they are used, as the JAX module casts them (``attention.py:267, 334-338,
393-425``), and the kernels' predicates are asked about that type.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops import remat
from multimodal_path_omic_tpu_torch.ops.coattn import (
    attention_with_weights,
    fused_attention,
    fused_attention_leank,
    fused_attention_leank_sharded,
    fused_attention_sharded,
    fused_k_supports,
    leank_train_form,
    plain_k_supports,
    sharded_eligible,
)
from multimodal_path_omic_tpu_torch.ops.flash import flash_attention
from multimodal_path_omic_tpu_torch.ops.flash import supports as flash_supports
from multimodal_path_omic_tpu_torch.ops.kernels import takes
from multimodal_path_omic_tpu_torch.ops.layers import (
    LayerNorm,
    TorchLinear,
    cast,
    compute_dtype_of,
    dropout,
    fast_keep_mask,
    masked_softmax,
    require_generator,
    seq_sharded,
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
      (several heads, key is not value, more than 32 queries, or pre-gated
      past the fuse-K kernels' 8: NaCAGaT at 9..256 signature groups) or
      are switched off;
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
      the CPU and on the card alike, except that a bfloat16 shape whose
      float32 form a kernel takes raises on the card (``kernels.takes``:
      that kernel has no bfloat16 instance yet).

    ``need_weights``: True returns the [B, N, M] weights, False None, and
    "ssq" the per-query sum of squares of the final weights [B, N] (the
    cesar penalty's input, without the N x M map on the lean-V branch).

    ``lean=False`` switches the lean and lean-V routes off (the JAX
    package's ``MPO_NO_LEAN_ATTENTION=1``; here a constructor argument, no
    environment variable): the same numbers through the fused branch.

    ``mesh`` (``layers.set_mesh``; JAX ``ring_mesh``): on a data-parallel
    mesh the kernel routes run on this rank's rows through the per-rank
    wrappers (``coattn.fused_attention_sharded``,
    ``fused_attention_leank_sharded``: the global row index in the dropout
    counter), and so does the export (maps are row-local; JAX turns its
    export passes off at mesh size > 1, ``attention.py:518-520``, for
    ``attention_core``'s same map). On a seq mesh the patch axis is split:
    the lean routes are off and :meth:`_seq_forward` takes the call (a map
    through the export kernels per rank on merged statistics).
    """

    mesh = None  # this rank's parallel.mesh.Mesh, where the module runs over the patch axis

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

    def _seq_forward(self, query, key, value, key_mask, need_weights, rate, generator,
                     n: int, m_len: int, philox: bool):
        """The routes of a seq mesh (JAX ``attention.py:428-470``), the patch
        axis split over the seq group; ``n``, ``m_len``: the global lengths.
        Self-attention without the pre-gate takes the ring
        (``parallel/ring.py``; at 4096 positions and up with dropout active
        its attention-probability dropout site is dropped, as on the flash
        route), or with dropout active below that the keys gathered from the
        seq group and the one-device route's masks (the ``attention_core``
        layout, or the ``tiny`` one at 32 positions and below), each rank
        keeping its query rows; cross-attention over at most 256 queries
        merges its softmax statistics (``philox``: the one-device route is a
        kernel's, so its dropout counter is drawn).

        Maps (``need_weights`` True, JAX: ``attention_core`` over the
        sharded inputs, ``attention.py:518-531``): cross-attention without
        dropout takes the export route, the export kernels per rank on
        merged statistics (``ring.sequence_parallel_export``; their plain
        versions on the CPU); with dropout the stat merge returns its
        dropped weights; self-attention gathers the keys and returns its
        query rows' weights, the rows all-gathered. Returns (out_h
        [B, H, N, D], the ssq [B, N], the weights [B, H, N, M] or None, the
        projected queries)."""
        from multimodal_path_omic_tpu_torch.parallel import comm
        from multimodal_path_omic_tpu_torch.parallel.ring import (
            ring_self_attention,
            sequence_parallel_cross_attention,
            sequence_parallel_export,
        )

        mesh, heads = self.mesh, self.num_heads
        want_ssq = need_weights == "ssq"
        want_map = need_weights is True
        if query is key and key is value:
            q, k, v = self._proj(query, 0, 3).chunk(3, dim=-1)
        else:
            q = self._proj(query, 0, 1)
            k = self._proj(key, 1, 2)
            v = self._proj(value, 2, 3)
        qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
        if query is key and not self.pre_gate and not want_ssq:
            if (rate == 0.0 or n >= 4096) and not want_map:
                return ring_self_attention(qh, kh, vh, key_mask, mesh), None, q
            group = mesh.seq_group
            kg, vg = comm.gather_over(kh, group, 2), comm.gather_over(vh, group, 2)
            mask = None if key_mask is None else comm.all_gather(key_mask, group, 1)
            scores = torch.matmul(qh / math.sqrt(qh.shape[-1]), kg.transpose(-1, -2))
            w = masked_softmax(scores, None if mask is None else mask[:, None, None, :])
            b, _, nl, mg = w.shape
            if rate > 0.0:
                if n <= 32 and m_len <= 32:  # tiny_attention's [B, N, M, H] layout
                    keep, kp = fast_keep_mask(generator, rate, (b, nl, mg, heads), w.device,
                                              seq_dim=1)
                    keep = keep.permute(0, 3, 1, 2)
                else:
                    keep, kp = fast_keep_mask(generator, rate, w.shape, w.device, seq_dim=2)
                w = torch.where(keep, w / kp, torch.zeros_like(w))
            return torch.matmul(w, vg), comm.all_gather(w, group, 2) if want_map else None, q
        if query is not key and want_map and rate == 0.0:
            out_h, w = sequence_parallel_export(qh, kh, vh, key_mask, mesh,
                                                pre_gate=self.pre_gate)
            return out_h, w, q
        if query is not key and query.shape[1] <= 256 and (not want_ssq or heads == 1):
            res = sequence_parallel_cross_attention(
                qh, kh, vh, key_mask, mesh, pre_gate=self.pre_gate, dropout_rate=rate,
                generator=generator, philox=philox, need_ssq=want_ssq, need_weights=want_map)
            if want_ssq:
                return res[0].to(q.dtype), res[1][:, 0], q
            if want_map:
                return res[0].to(q.dtype), res[1], q
            return res.to(q.dtype), None, q
        raise NotImplementedError(
            f"no seq-mesh route for this attention (self={query is key}, pre_gate="
            f"{self.pre_gate}, queries {query.shape[1]}, heads {heads}, need_weights="
            f"{need_weights!r})")

    def _proj(self, x, lo: int, hi: int):
        """The q / k / v projections (rows ``lo`` to ``hi`` of the packed
        weight), tagged for ``tpu.remat`` (JAX ``attention.py:251-268``)."""
        e = self.embed_dim
        out = F.linear(cast(x, self), cast(self.in_proj_weight[lo * e:hi * e], self),
                       cast(self.in_proj_bias[lo * e:hi * e], self))
        return remat.tag(out, self._proj, x, lo, hi)

    def forward(self, query, key, value, key_mask=None, *, need_weights=True,
                average_attn_weights: bool = True, return_projected_q: bool = False,
                generator: Optional[torch.Generator] = None):
        if need_weights not in (True, False, "ssq"):
            raise ValueError(f"need_weights must be True, False or 'ssq', got {need_weights!r}")
        want_ssq = need_weights == "ssq"
        e, heads = self.embed_dim, self.num_heads
        dt = compute_dtype_of(self)
        rate = self.dropout_rate if self.training else 0.0
        self_attn = query is key
        mesh = self.mesh
        on_seq = seq_sharded(self)
        # a seq mesh splits the patch axis: routes are chosen by the global
        # lengths, as the one-device call chooses them
        n, m_len = query.shape[1], key.shape[1] * (mesh.seq if on_seq else 1)
        if on_seq and self_attn:
            n = m_len
        lean_shape = (self.lean and heads == 1 and not self_attn and key is value
                      and n <= 32 and m_len > 32)
        lean = lean_shape and not self.pre_gate
        # lean-V only where the fuse-K kernels take the shape, in the form the
        # call will run
        train_form = leank_train_form(rate, want_ssq, query, key, self.in_proj_weight,
                                      self.in_proj_bias)
        lean_v = (lean_shape and self.pre_gate and need_weights is not True
                  and takes("fuse-K", fused_k_supports, query.device, n, e, key.shape[-1],
                            m_len, train=train_form, dtype=dt))
        fused = (not self_attn and m_len > 32
                 and (need_weights is False or (want_ssq and heads == 1))
                 and takes("plain-K", plain_k_supports, query.device, n, e // heads, m_len,
                           values=True, dtype=dt))
        if on_seq:
            out_h, second, q = self._seq_forward(query, key, value, key_mask, need_weights,
                                                 rate, generator, n, m_len,
                                                 philox=(lean_v or fused) and not lean)
            out = self.out_proj(_merge_heads(out_h))
            if need_weights is True and average_attn_weights:
                second = second.mean(dim=1)  # [B, N, M]
            return (out, second, q) if return_projected_q else (out, second)
        data_sharded = sharded_eligible(mesh, query.shape[0])
        out_h = weights = ssq = None
        if lean:
            q = self._proj(query, 0, 1)
            w = self.in_proj_weight
            b = self.in_proj_bias
            out_flat, w_lean = lean_single_head_cross_attention(
                q, cast(key, self), cast(w[e:2 * e].t(), self), cast(b[e:2 * e], self),
                cast(w[2 * e:].t(), self), cast(b[2 * e:], self), key_mask,
                dropout_rate=rate, generator=generator,
            )
            if need_weights is True:
                weights = w_lean[:, None]
            elif want_ssq:  # one head: the head-averaged weights are the weights
                ssq = (w_lean * w_lean).sum(dim=-1)
        elif lean_v:
            q = self._proj(query, 0, 1)
            wk = cast(self.in_proj_weight[e:2 * e].t(), self).contiguous()  # [F, E]
            seed = None
            if rate > 0.0:  # the kernel's dropout seed, drawn per call
                seed = torch.randint(0, 2**31 - 1, (1,), generator=require_generator(generator),
                                     device=query.device, dtype=torch.int32)
            leank = fused_attention_leank
            if data_sharded:  # this rank's rows: the global row index in the dropout counter
                leank = functools.partial(fused_attention_leank_sharded, mesh=mesh)
            res = leank(
                q, cast(key, self).contiguous(), wk, cast(self.in_proj_bias[e:2 * e], self),
                key_mask,
                dropout_rate=rate, dropout_seed=seed, need_ssq=want_ssq, need_sumw=True,
            )
            out_raw, sumw = res[0], res[-1]
            if want_ssq:
                ssq = res[1]
            # V projection after the patch-axis contraction, bias weighted by
            # the row's weight mass
            out_flat = (F.linear(cast(out_raw, self), cast(self.in_proj_weight[2 * e:], self))
                        + cast(self.in_proj_bias[2 * e:], self) * sumw[:, :, None].to(dt))
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
                if fused:
                    attend = fused_attention
                    if data_sharded:
                        attend = functools.partial(fused_attention_sharded, mesh=mesh)
                    res = attend(qh, kh, vh, key_mask, pre_gate=self.pre_gate,
                                 dropout_rate=rate, generator=generator, need_ssq=want_ssq)
                    out_h, ssq = (res[0], res[1][:, 0]) if want_ssq else (res, None)
                elif (need_weights is False and not self.pre_gate and self_attn
                        and key is value and n > 32 and (rate == 0.0 or n >= 4096)):
                    if takes("flash", flash_supports, qh.device, *qh.shape, dtype=dt):
                        out_h = flash_attention(qh, kh, vh, key_mask)
                    else:  # no kernel instance (JAX: _xla_fused); the site dropped alike
                        out_h, _ = attention_core(qh, kh, vh, key_mask, pre_gate=False,
                                                  need_weights=False)
                elif (need_weights is True and not self_attn and rate == 0.0
                        and (mesh is None or data_sharded)):
                    # the export passes; on a data-parallel mesh on this rank's rows
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
        self.ln_g = LayerNorm(hidden_dim, eps=1e-5)
        self.ln_e = LayerNorm(hidden_dim, eps=1e-5)

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


class PreGatedAttention(nn.Module):
    """Standalone pre-gated cross-attention (JAX ``attention.py:651-675``;
    reference: blocks.py:209-229), not used by any model. Faithful quirks:
    ``scores = QK^T / scale`` with ``scale = 1/sqrt(dk)``, i.e. the scores
    are multiplied by sqrt(dk) (blocks.py:213, 225), and the pre-gate P is
    computed but not applied (blocks.py:224-225), so it is left out.

    x1 [..., M, x1_dim] (keys and values), x2 [..., N, x2_dim] (queries),
    key_mask [..., M] -> (q [..., N, dk], q_hat [..., N, dk], weights
    [..., N, M])."""

    def __init__(self, x1_dim: int, x2_dim: int, dk: int = 256):
        super().__init__()
        self.dk = dk
        self.fc_q = TorchLinear(x2_dim, dk)
        self.fc_k = TorchLinear(x1_dim, dk)
        self.fc_v = TorchLinear(x1_dim, dk)

    def forward(self, x1, x2, key_mask=None):
        q = self.fc_q(cast(x2, self))
        k = self.fc_k(cast(x1, self))
        v = self.fc_v(cast(x1, self))
        scores = torch.matmul(q, k.transpose(-1, -2)) * math.sqrt(self.dk)
        weights = masked_softmax(scores, None if key_mask is None else key_mask[..., None, :])
        return q, torch.matmul(weights, v), weights


class PreGatingContextualAttentionGate(nn.Module):
    """The PCAG composite (JAX ``attention.py:678-698``; reference:
    blocks.py:256-285): PreGatedAttention, then the CAG, then final_fc(Q).
    The reference returns ``(relu(final_fc(Q)), attention weights)`` with the
    ``Q + C`` residual commented out (blocks.py:284-285), reproduced as it
    is: the CAG's output is computed and unused. Not used by any model."""

    def __init__(self, x1_dim: int, x2_dim: int, dk: int = 256, output_dim: int = 128):
        super().__init__()
        self.pg_coattn = PreGatedAttention(x1_dim, x2_dim, dk)
        self.cag = ContextualAttentionGate(dk, output_dim)
        self.final_fc = TorchLinear(dk, output_dim)

    def forward(self, x1, x2, key_mask=None):
        q, q_hat, weights = self.pg_coattn(x1, x2, key_mask)
        self.cag(q, q_hat)  # computed and discarded, as in the reference
        return F.relu(self.final_fc(q)), weights
