"""Sequence parallelism over the seq group of a mesh
(``multimodal_path_omic_tpu/parallel/ring.py``): the patch axis M of each
bag is split over the seq ranks (``parallel/mesh.py``), each holding M / seq
patches.

* :func:`ring_self_attention`: exact masked self-attention. K, V and the
  mask rotate around the seq group by point-to-point sends (``ppermute``,
  JAX ``ring.py:100-107``) while each rank attends its local queries, in
  chunks of at most 512 (:func:`_ring_chunk_size`) with the online (m, l, o)
  merge: no [Ml, Ml] score block ever exists. Its backward
  (:class:`RingSelfAttention`) recomputes each step's scores chunk by chunk
  (JAX wraps the update in ``jax.checkpoint``) and carries the dK / dV
  accumulators around the ring with their blocks, home after the last step.
* :func:`sequence_parallel_cross_attention`: the few-query co-attention of
  the survival models over a split M. Each rank attends its keys with the
  queries replicated; the statistics merge by one max and the sums of l, o
  (and ssq) over the seq group (JAX ``:196-217``). Attention dropout is drawn
  shard-locally at the global key and bag indices, so the split call drops
  the weights the one-device route drops. With ``need_weights`` it also
  returns the map, each rank's columns all-gathered along the key axis.
* :func:`sequence_parallel_export`: the attention-map export over a split
  M, on the export kernels: each rank runs export pass 1
  (``coattn.coattn_stats``) on its keys, the statistics merge over the seq
  group (m the maximum, l the sum of l_r exp(m_r - m)), and export pass 2
  (``coattn.coattn_weights``) writes the rank's columns of the map from the
  merged (l, m); a shape the kernels refuse takes the same merge over
  plain scores. The JAX package runs ``attention_core`` over the sharded
  inputs here (``attention.py:518-531``): the same map.

The ring and the stat merge run plain tensor operations, as the JAX package
runs XLA there; the flash kernel inside each ring step is later work
(ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from multimodal_path_omic_tpu_torch.ops import kernels
from multimodal_path_omic_tpu_torch.ops.coattn import (
    coattn_stats,
    coattn_weights,
    dropout_bits,
    dropout_threshold,
    plain_k_supports,
)
from multimodal_path_omic_tpu_torch.ops.layers import NEG_INF, fast_keep_mask, require_generator
from multimodal_path_omic_tpu_torch.parallel import comm


def _ring_chunk_size(ml: int, target: int = 512) -> int:
    """Largest power-of-two divisor of Ml that is <= target (JAX ``:31``)."""
    qc = 1
    while qc * 2 <= min(target, ml) and ml % (qc * 2) == 0:
        qc *= 2
    return qc


def _masked_scores(q_c, k, mask_f, scale):
    """[B, H, qc, Mk] scores of a query chunk against a key block, masked
    keys at ``NEG_INF`` (a fully masked row: uniform weights, never NaN)."""
    s = torch.matmul(q_c * scale, k.transpose(-1, -2))
    return torch.where(mask_f[:, None, None, :] > 0, s, torch.full_like(s, NEG_INF))


class RingSelfAttention(torch.autograd.Function):
    """q, k, v [B, H, Ml, D] float32 (this rank's patches), mask_f [B, Ml]
    -> o [B, H, Ml, D]. Saves q, k, v, the mask, o and each query row's
    maximum and sum (not their log-sum-exp: a row without a valid key has
    m = NEG_INF, where adding log l would be lost to rounding); the
    backward recomputes the scores a chunk at a time."""

    @staticmethod
    def forward(ctx, q, k, v, mask_f, group, q_chunk):
        b, h, ml, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qc = _ring_chunk_size(ml, q_chunk)
        m_stat = torch.full((b, h, ml, 1), NEG_INF, dtype=q.dtype, device=q.device)
        l_stat = torch.zeros((b, h, ml, 1), dtype=q.dtype, device=q.device)
        o_acc = torch.zeros_like(q)
        kb, vb, mb = k, v, mask_f
        for step in range(group.size):
            for c in range(0, ml, qc):
                sl = slice(c, c + qc)
                s = _masked_scores(q[:, :, sl], kb, mb, scale)
                m_new = torch.maximum(m_stat[:, :, sl], s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m_stat[:, :, sl] - m_new)
                p = torch.exp(s - m_new)
                l_stat[:, :, sl] = alpha * l_stat[:, :, sl] + p.sum(dim=-1, keepdim=True)
                o_acc[:, :, sl] = alpha * o_acc[:, :, sl] + torch.matmul(p, vb)
                m_stat[:, :, sl] = m_new
            if step < group.size - 1:
                kb, vb, mb = comm.ring_shift((kb, vb, mb), group)
        out = o_acc / l_stat
        ctx.save_for_backward(q, k, v, mask_f, out, m_stat, l_stat)
        ctx.group, ctx.qc, ctx.scale = group, qc, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask_f, out, m_stat, l_stat = ctx.saved_tensors
        group, qc, scale = ctx.group, ctx.qc, ctx.scale
        ml = q.shape[2]
        dout = dout.contiguous()
        delta = (dout * out).sum(dim=-1, keepdim=True)  # [B, H, Ml, 1]
        dq = torch.zeros_like(q)
        kb, vb, mb = k, v, mask_f
        dkb, dvb = torch.zeros_like(k), torch.zeros_like(v)
        for step in range(group.size):
            for c in range(0, ml, qc):
                sl = slice(c, c + qc)
                s = _masked_scores(q[:, :, sl], kb, mb, scale)
                p = torch.exp(s - m_stat[:, :, sl]) / l_stat[:, :, sl]  # [B, H, qc, Mk]
                dvb += torch.matmul(p.transpose(-1, -2), dout[:, :, sl])
                dp = torch.matmul(dout[:, :, sl], vb.transpose(-1, -2))
                ds = p * (dp - delta[:, :, sl])
                ds = torch.where(mb[:, None, None, :] > 0, ds, torch.zeros_like(ds))
                dq[:, :, sl] += torch.matmul(ds, kb) * scale
                dkb += torch.matmul(ds.transpose(-1, -2), q[:, :, sl]) * scale
            # the block and its accumulators move on together; after the last
            # step one more shift takes the accumulators home
            if step < group.size - 1:
                kb, vb, mb, dkb, dvb = comm.ring_shift((kb, vb, mb, dkb, dvb), group)
            else:
                dkb, dvb = comm.ring_shift((dkb, dvb), group)
        return dq, dkb, dvb, None, None, None


def ring_self_attention(q, k, v, key_mask, mesh, q_chunk: int = 512) -> torch.Tensor:
    """Exact masked self-attention with K / V rotating around ``mesh``'s seq
    group. q, k, v: [B, H, Ml, D], this rank's patches of each bag;
    key_mask: [B, Ml] bool or None. Returns [B, H, Ml, D] in q's type
    (float32 inside)."""
    b, h, ml, d = q.shape
    if key_mask is None:
        key_mask = torch.ones((b, ml), dtype=torch.bool, device=q.device)
    mask_f = key_mask.to(torch.float32)
    out = RingSelfAttention.apply(q.float(), k.float(), v.float(), mask_f, mesh.seq_group,
                                  q_chunk)
    return out.to(q.dtype)


def sequence_parallel_cross_attention(q, k, v, key_mask, mesh, *, pre_gate: bool = False,
                                      dropout_rate: float = 0.0, generator=None,
                                      philox: bool = True, need_ssq: bool = False,
                                      need_weights: bool = False):
    """Exact masked cross-attention with K / V split over ``mesh``'s seq
    group and the (few) queries replicated: q [B, H, N, D]; k, v
    [B, H, Ml, D]; key_mask [B, Ml] bool or None. Returns out [B, H, N, D]
    (the same on every seq rank), and with ``need_ssq`` (out, ssq [B, H, N],
    the per-query sum of squares of the final weights), or with
    ``need_weights`` (out, the final weights [B, H, N, M] over the global
    keys, every rank's columns all-gathered).

    ``pre_gate``: the NaCAGaT pre-gate, shard-local. ``dropout_rate`` > 0
    drops the normalized weights as torch does (l sums the undropped ones),
    the bits drawn at the global bag and key indices of each local element,
    so that the split call drops what the one-device route drops: with
    ``philox`` the co-attention kernels' counter (a seed drawn from
    ``generator``, ``ops/coattn.py::dropout_bits``; the lean-V and fused
    routes), else the generator's keep mask over [B, H, N, M] (the lean and
    ``attention_core`` routes; ``generator`` a ``layers.ShardedDraws``)."""
    b, h, n, d = q.shape
    ml = k.shape[2]
    group = mesh.seq_group
    q, k, v = q.float(), k.float(), v.float()
    s = torch.matmul(q * (1.0 / math.sqrt(d)), k.transpose(-1, -2))
    if pre_gate:
        s = s * ((torch.matmul(torch.tanh(q), torch.tanh(k).transpose(-1, -2)) + 1.0) / 2.0)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    # softmax is shift-invariant: the max carries no gradient
    m = comm.max_over(s.amax(dim=-1, keepdim=True), group)
    p = torch.exp(s - m)
    l_local = p.sum(dim=-1, keepdim=True)
    p_used = p
    if dropout_rate > 0.0:
        if philox:
            seed = torch.randint(0, 2**31 - 1, (1,), generator=require_generator(generator),
                                 device=q.device, dtype=torch.int32)
            # the folded heads' global bag index, as fused_attention folds them
            bits = dropout_bits(seed, (b * h, n, ml), q.device, bag0=mesh.d * b * h,
                                key0=mesh.s * ml)
            keep = (bits >= dropout_threshold(dropout_rate)).reshape(b, h, n, ml)
            scale = 1.0 / (1.0 - dropout_rate)
        else:
            keep, keep_prob = fast_keep_mask(generator, dropout_rate, (b, h, n, ml), q.device,
                                             seq_dim=3)
            scale = 1.0 / keep_prob
        p_used = torch.where(keep, p * scale, torch.zeros_like(p))
    l_glob = comm.sum_over(l_local, group)
    o_glob = comm.sum_over(torch.matmul(p_used, v), group)
    out = o_glob / l_glob
    if need_weights:
        return out, comm.gather_over(p_used / l_glob, group, 3)
    if not need_ssq:
        return out
    ssq = comm.sum_over((p_used * p_used).sum(dim=-1, keepdim=True), group) / (l_glob * l_glob)
    return out, ssq[..., 0]


def sequence_parallel_export(q, k, v, key_mask, mesh, *, pre_gate: bool = False):
    """The attention-map export (``coattn.attention_with_weights``) with K /
    V split over ``mesh``'s seq group and the queries replicated: q
    [B, H, N, D]; k, v [B, H, Ml, D]; key_mask [B, Ml] bool or None.
    Returns (out [B, H, N, D] in q's type, weights [B, H, N, M] float32
    over the global keys), the same on every seq rank.

    Where the export kernels take the shape (``coattn.plain_k_supports`` on
    the local keys) each rank runs export pass 1 on its keys, giving
    (l_r, m_r) a query; a rank whose keys of a bag are all masked is the
    kernels' lone unit (m_r = ``coattn.NEG``, l_r = Ml), which drops out of
    the merge m = max_r m_r, l = sum_r l_r exp(m_r - m) unless no rank has
    a valid key, where it leaves l = M and the row uniform over the global
    M. Export pass 2 then writes the rank's columns, exp(s - m) / l; out is
    the sum over the group of each rank's columns times its v. Elsewhere the
    same merge runs over the scores of ``attention_core``'s form."""
    b, h, n, d = q.shape
    ml = k.shape[2]
    group = mesh.seq_group
    if kernels.takes("export", plain_k_supports, q.device, n, d, ml, values=False,
                     dtype=q.dtype):
        qf = q.reshape(b * h, n, d).contiguous()
        kf = k.reshape(b * h, ml, d).contiguous()
        mf = None if key_mask is None else key_mask.contiguous()  # a rank's patch slice
        if mf is not None and h > 1:
            mf = mf.repeat_interleave(h, dim=0)
        l_r, m_r = coattn_stats(qf, kf, mf, pre_gate=pre_gate)
        m = comm.max_over(m_r, group)
        l = comm.all_reduce(l_r * torch.exp(m_r - m), group)
        w = coattn_weights(qf, kf, mf, l, m, pre_gate=pre_gate).reshape(b, h, n, ml)
        out = comm.all_reduce(torch.matmul(w, v.float()), group)
        return out.to(q.dtype), comm.all_gather(w, group, 3)
    out, w = sequence_parallel_cross_attention(q, k, v, key_mask, mesh, pre_gate=pre_gate,
                                               need_weights=True)
    return out.to(q.dtype), w
