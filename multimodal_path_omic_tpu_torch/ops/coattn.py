"""Few-query co-attention: CUDA kernel wrappers, their plain PyTorch
versions, and the dispatchers of ``multimodal_path_omic_tpu/ops/coattn.py``.

Seven kernels (``csrc/coattn.cu``, ``csrc/coattn_bwd.cu``) replace the TPU
kernels of the NaCAGaT and MCAT serving and training paths:

* :func:`coattn_fwd_fused_k` — the forward kernel in its fuse-K form: K is
  projected from the raw key-side input in-kernel (``k = kv @ wk + bk``, on
  the tensor cores as 3xTF32 at float32 accuracy, only for the 64-key tiles
  that hold a valid key), pre-gated, masked, online-softmaxed, and the raw
  values ``kv`` pooled; emits o, l, m and sumw (``coattention_fused_k``,
  eval: no dropout; E up to 512, NaCAGaT ``big``);
* :func:`coattn_fwd_fused_k_train` — the same forward in its training form:
  attention dropout in-kernel, the ssq and sumw side outputs of the dropped
  weights, l and m saved for the backward ((E, F) in ``FUSED_K_TRAIN_EF``:
  NaCAGaT ``medium`` and ``big``);
* :func:`coattn_bwd_fused_k` — the recompute backward of the fuse-K form:
  dq, dkv, dwk, dbk (``_coattn_fk_bwd``), with its partial-sum reduce;
* :func:`coattn_stats` — the forward kernel's plain-K form, statistics only
  (pass 1 of the attention-map export, ``coattention_weights``);
* :func:`coattn_weights` — the weights-emission kernel (export pass 2); the
  two passes skip the 64-key tiles without a valid key and read no k of a
  bag without one, and ``coattention_weights`` builds their tile list once;
* :func:`coattn_fwd_plain_k` — the forward kernel's plain-K form with values
  (``coattention``: attention over projected k and v, with or without the
  pre-gate; eval form, and training form with dropout, ssq and sumw), counted
  as ``coattn_plain``;
* :func:`coattn_bwd_plain_k` — its recompute backward: dq, dk, dv
  (``_coattn_bwd``), counted as ``coattn_plain_bwd``.

Each wrapper launches its kernel for a CUDA tensor (or raises on what the
kernel does not take) and uses the plain version only for a CPU tensor. What
the kernels take is stated once, in :func:`fused_k_supports` and
:func:`plain_k_supports`: the wrappers raise on a CUDA shape outside them, and
the dispatchers (``ops/attention.py``, :func:`attention_with_weights`) send
such a shape to ``attention_core`` before any launch.
``LAUNCH_COUNTS`` counts kernel launches, one per wrapper call on CUDA.

Scores are ``s = (q.k)/sqrt(d) * (tanh(q).tanh(k) + 1)/2`` with the finite
mask value ``NEG``: a fully-masked row has uniform weights over its M keys,
never NaN. (The TPU kernel pads M to its tile and spreads such a row over
the padded length; the port, like the JAX package's plain attention_core,
spreads it over exactly M.)

Attention dropout (training form) follows torch: weights are normalized
first, then dropped and rescaled by ``1 / (1 - rate)``. The TPU kernel draws
its bits from the TPU's own generator per (seed, tile); the port uses a
counter-based Philox4x32-10 per element (:func:`dropout_bits`), which the
kernels and the plain versions compute identically, so the backward
regenerates the forward's mask exactly. The keep rule is the TPU kernel's:
keep iff bits >= :func:`dropout_threshold` (uint32).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from multimodal_path_omic_tpu_torch.ops import kernels

NEG = -0.7 * 3.4e38  # finite mask value of the TPU kernel
MAX_QUERIES = 8  # one warp per query in the kernels
FK_TILE = 64  # keys per fuse-K tile (csrc/coattn_common.cuh FK_BM)
VALUES_D = (128, 256)  # D the plain-K kernels with values take
# (E, F) the fuse-K training forward and backward take: their template
# instances (csrc/coattn.cu launch_fused_k, csrc/coattn_bwd.cu MPO_BWD)
FUSED_K_TRAIN_EF = frozenset({(e, f) for e in (128, 256) for f in (128, 256)} | {(512, 512)})
EVAL_E = (128, 256, 512)  # E the eval fuse-K kernel takes (F % 16 == 0, F <= 1024)
PLAIN_BLOCKS_PER_SM = 2  # the plain-K kernels (and the export passes): most main-pass blocks an SM
TILE_LONE = 2  # flag of a bag without a valid key in the export passes' tile list

LAUNCH_COUNTS = {
    "coattn_fwd_fused_k": 0, "coattn_stats": 0, "coattn_weights": 0,
    "coattn_fwd_fused_k_train": 0, "coattn_bwd_fused_k": 0,
    "coattn_plain": 0, "coattn_plain_bwd": 0, "coattn_tiles": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# =============================================================================
# Plain PyTorch versions (the CPU path; on the card, the kernels' yardstick)
# =============================================================================


def _scores(q, k, key_mask, pre_gate):
    """[B, N, M] masked (pre-gated) scores, as the TPU kernel computes them."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if pre_gate:
        gate = torch.matmul(torch.tanh(q), torch.tanh(k).transpose(-1, -2))
        s = s * (gate + 1.0) * 0.5
    if key_mask is not None:
        s = torch.where(key_mask[:, None, :], s, torch.full_like(s, NEG))
    return s


def _inv(l):
    return torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)


def coattn_stats_plain(q, k, key_mask=None, *, pre_gate=True):
    s = _scores(q, k, key_mask, pre_gate)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return l, m


def coattn_weights_plain(q, k, key_mask, l, m, *, pre_gate=True):
    s = _scores(q, k, key_mask, pre_gate)
    return torch.exp(s - m[..., None]) * _inv(l)[..., None]


def coattn_tiles_plain(key_mask, *, lone: bool):
    """The kernels' key-tile list for a [B, M] bool mask: flags
    [B, T] uint8 (T = ceil(M / 64)), 1 for a 64-key tile that is computed,
    0 for one that is skipped (no valid key in a bag with one); a bag without
    a valid key computes every tile or, ``lone`` (the export passes), is one
    unit of flag ``TILE_LONE`` at tile 0. Then the computed units
    u = bag * T + tile in order [count] int32 and each bag's first position
    in them [B + 1] int32 (the last entry: the count)."""
    b, m_len = key_mask.shape
    t = -(-m_len // FK_TILE)
    padded = torch.zeros((b, t * FK_TILE), dtype=torch.bool, device=key_mask.device)
    padded[:, :m_len] = key_mask
    flags = padded.view(b, t, FK_TILE).any(-1).to(torch.uint8)
    empty = ~key_mask.any(-1)
    flags[empty] = 0 if lone else 1
    if lone:
        flags[empty, 0] = TILE_LONE
    units = torch.nonzero(flags.reshape(-1)).reshape(-1).to(torch.int32)
    off = torch.zeros((b + 1,), dtype=torch.int32, device=key_mask.device)
    off[1:] = torch.cumsum((flags != 0).sum(-1), 0)
    return flags, units, off


def coattn_fwd_fused_k_plain(q, kv, wk, bk, key_mask=None):
    """The eval form: the training form without dropout, no ssq."""
    o, l, m, _, sumw = coattn_fwd_fused_k_train_plain(q, kv, wk, bk, key_mask, None, 0.0)
    return o, l, m, sumw


_U32 = 0xFFFFFFFF


def _mulhilo(a: int, c: torch.Tensor):
    """(a * c) >> 32 and (a * c) mod 2^32 for a uint32 constant ``a`` and
    uint32 values ``c`` held in int64, in 16-bit halves so that no
    intermediate leaves int64."""
    lo_part = c * (a & 0xFFFF)
    hi_part = c * (a >> 16)
    t = ((hi_part & 0xFFFF) << 16) + lo_part
    return (hi_part >> 16) + (t >> 32), t & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) in torch integer ops: four
    uint32 counter words and two key words (int64 tensors or ints, broadcast
    together) -> the four uint32 output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _U32
            k1 = (k1 + 0xBB67AE85) & _U32
        hi0, lo0 = _mulhilo(0xD2511F53, torch.as_tensor(c0))
        hi1, lo1 = _mulhilo(0xCD9E8D57, torch.as_tensor(c2))
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, shape, device) -> torch.Tensor:
    """[B, N, M] int64 attention-dropout bits of element (b, n, key): word 0
    of Philox4x32-10 at counter (key, n, b, 0) under key (seed, 0), as
    ``dropout_bits`` in csrc/coattn_common.cuh computes it. ``seed``: one
    int32 (a [1] tensor)."""
    b, n, m = shape
    ar = [torch.arange(x, device=device, dtype=torch.int64) for x in (b, n, m)]
    k0 = seed.to(device=device, dtype=torch.int64).reshape(()) & _U32
    return philox4x32_10(
        (ar[2][None, None, :], ar[1][None, :, None], ar[0][:, None, None], 0), (k0, 0)
    )[0]


def dropout_threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) = rate (coattn.py _dropout_threshold)."""
    return min(int(rate * 4294967296.0), 4294967295)


def coattn_fwd_plain_k_plain(q, k, v, key_mask, seed, rate: float, *, pre_gate: bool):
    """The plain-K form with values, training form: (o, l, m, ssq, sumw) with
    attention dropout at ``rate`` from :func:`dropout_bits` (``seed`` is read
    only when rate > 0); l sums the undropped weights, o, ssq and sumw use
    the dropped ones. Differentiable (m is a constant shift)."""
    s = _scores(q, k, key_mask, pre_gate)
    m = s.amax(dim=-1).detach()
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    w = p * _inv(l)[..., None]
    if rate > 0.0:
        keep = dropout_bits(seed, w.shape, w.device) >= dropout_threshold(rate)
        w = torch.where(keep, w * (1.0 / (1.0 - rate)), torch.zeros_like(w))
    return torch.matmul(w, v), l, m, (w * w).sum(dim=-1), w.sum(dim=-1)


def coattn_bwd_plain_k_plain(q, k, v, key_mask, seed, rate, dout, dssq, dsumw, *,
                             pre_gate: bool):
    """(dq, dk, dv): autograd through the plain training form, with the
    cotangents of o, ssq and sumw."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o, _, _, ssq, sumw = coattn_fwd_plain_k_plain(*ins, key_mask, seed, rate,
                                                      pre_gate=pre_gate)
        return torch.autograd.grad((o, ssq, sumw), ins, (dout, dssq, dsumw))


def coattn_fwd_fused_k_train_plain(q, kv, wk, bk, key_mask, seed, rate: float):
    """The fuse-K training form: the pre-gated plain-K form on
    k = kv wk + bk with the raw kv as values."""
    return coattn_fwd_plain_k_plain(q, torch.matmul(kv, wk) + bk, kv, key_mask, seed, rate,
                                    pre_gate=True)


def coattn_bwd_fused_k_plain(q, kv, wk, bk, key_mask, seed, rate, dout, dssq, dsumw):
    """(dq, dkv, dwk, dbk): autograd through the plain training form, with
    the cotangents of o, ssq and sumw."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, kv, wk, bk)]
        o, _, _, ssq, sumw = coattn_fwd_fused_k_train_plain(*ins, key_mask, seed, rate)
        return torch.autograd.grad((o, ssq, sumw), ins, (dout, dssq, dsumw))


# =============================================================================
# Kernel wrappers
# =============================================================================


def fused_k_supports(n: int, e: int, f: int, m_len: int, *, train: bool) -> bool:
    """The shapes the fuse-K kernels take: 1..``MAX_QUERIES`` queries (one
    warp each), M >= 1 keys, and E in ``EVAL_E`` with F % 16 == 0, F <= 1024
    (eval form) or (E, F) in ``FUSED_K_TRAIN_EF`` (training form and
    backward). The wrappers raise on a CUDA shape outside it;
    ``MultiheadAttention`` routes such a shape off the lean-V branch (the JAX
    package's ``leank_eligible``)."""
    dims = (e, f) in FUSED_K_TRAIN_EF if train else (
        e in EVAL_E and f % 16 == 0 and f <= 1024)
    return 1 <= n <= MAX_QUERIES and m_len >= 1 and dims


def leank_train_form(dropout_rate: float, need_ssq: bool, *tensors: torch.Tensor) -> bool:
    """Whether :func:`fused_attention_leank` runs the fuse-K training form:
    dropout, ssq, or a gradient to take through any of ``tensors``. The
    lean-V gate reads it to ask :func:`fused_k_supports` about that form."""
    return dropout_rate > 0.0 or need_ssq or (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def plain_k_supports(n: int, d: int, m_len: int, *, values: bool) -> bool:
    """The shapes the plain-K kernels take: 1..``MAX_QUERIES`` queries, M >= 1
    keys, D in {128, 256, 512} (statistics and weights, the export passes) or,
    ``values``, D in ``VALUES_D`` (the forward with values and its
    backward). Shapes outside it take ``attention_core`` in the dispatchers
    (the JAX package's ``kernel_eligible``)."""
    dims = VALUES_D if values else (128, 256, 512)
    return 1 <= n <= MAX_QUERIES and m_len >= 1 and d in dims


def _refuse(what: str, n: int, d: str) -> None:
    raise ValueError(f"{what}: unsupported shape ({n} queries, the kernels take "
                     f"1..{MAX_QUERIES}; {d})")


def _fused_k_checks(q, kv, wk, bk, key_mask, *, train: bool):
    """Shapes and the mask pointer of the fuse-K kernels."""
    b, n, e = q.shape
    m_len, f = kv.shape[1], kv.shape[2]
    if not fused_k_supports(n, e, f, m_len, train=train):
        _refuse(f"fuse-K kernel{' (training)' if train else ''}", n, f"E={e}, F={f}, M={m_len}")
    kernels.require(q, "q", (b, n, e))
    kernels.require(kv, "kv", (b, m_len, f))
    kernels.require(wk, "wk", (f, e))
    kernels.require(bk, "bk", (e,))
    return b, n, e, m_len, f, kernels.mask_ptr(key_mask, b, m_len, q.device)


def _tile_list(b: int, m_len: int, dev):
    """Scratch of the fuse-K kernels' key-tile passes (csrc/fused_k_common.cuh):
    (flags [B * T] uint8, the list of computed tiles [B * T] and the bags'
    offsets into it [B + 1], int32), T = ceil(M / 64) tiles a bag."""
    n_units = b * -(-m_len // FK_TILE)
    units = torch.empty((n_units + b + 1,), dtype=torch.int32, device=dev)
    return torch.empty((n_units,), dtype=torch.uint8, device=dev), units, units[n_units:]


def coattn_fwd_fused_k(
    q: torch.Tensor, kv: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, N, E], kv [B, M, F], wk [F, E], bk [E], key_mask [B, M] bool ->
    (o [B, N, F], l [B, N], m [B, N], sumw [B, N]). Kernel: E in
    {128, 256, 512}, F % 16 == 0 and F <= 1024, N <= 8, float32."""
    if q.device.type == "cpu":
        return coattn_fwd_fused_k_plain(q, kv, wk, bk, key_mask)
    b, n, e, m_len, f, mask_ptr = _fused_k_checks(q, kv, wk, bk, key_mask, train=False)
    dev = q.device
    # one block an SM over the 64-key tiles that hold a valid key (or every
    # tile of a bag without one), each writing a partial per bag it visits
    blocks = kernels.sm_count(dev)
    o = torch.empty((b, n, f), device=dev)
    l, m, sumw = (torch.empty((b, n), device=dev) for _ in range(3))
    o_part = torch.empty((blocks + b, n, f), device=dev)
    ml_part = torch.empty((blocks + b, n, 2), device=dev)
    flags, units, offsets = _tile_list(b, m_len, dev)
    err = kernels.library("coattn").mpo_coattn_fwd_fused_k(
        q.data_ptr(), kv.data_ptr(), wk.data_ptr(), bk.data_ptr(), mask_ptr,
        o.data_ptr(), l.data_ptr(), m.data_ptr(), sumw.data_ptr(),
        o_part.data_ptr(), ml_part.data_ptr(), flags.data_ptr(), units.data_ptr(),
        offsets.data_ptr(), b, n, m_len, f, e, blocks, 1.0 / math.sqrt(e), kernels.stream(dev),
    )
    kernels.check(err, "coattn_fwd_fused_k")
    LAUNCH_COUNTS["coattn_fwd_fused_k"] += 1
    return o, l, m, sumw


def _dropout_args(seed, rate, device):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must lie in [0, 1), got {rate}")
    kernels.require(seed, "seed", (1,), torch.int32)
    if seed.device != device:
        raise ValueError("seed is on another device")
    thresh = dropout_threshold(rate) if rate > 0.0 else 0
    return thresh, (1.0 / (1.0 - rate) if rate > 0.0 else 1.0)


def coattn_fwd_fused_k_train(
    q: torch.Tensor, kv: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    key_mask: Optional[torch.Tensor], seed: torch.Tensor, rate: float,
) -> Tuple[torch.Tensor, ...]:
    """The training form of the fuse-K forward: shapes as
    :func:`coattn_fwd_fused_k`, plus ``seed`` (a [1] int32 tensor on the
    same device) and the attention-dropout ``rate`` -> (o [B, N, F], l, m,
    ssq, sumw [B, N]). Kernel: (E, F) in ``FUSED_K_TRAIN_EF``, N <= 8,
    float32."""
    if q.device.type == "cpu":
        return coattn_fwd_fused_k_train_plain(q, kv, wk, bk, key_mask, seed, rate)
    b, n, e, m_len, f, mask_ptr = _fused_k_checks(q, kv, wk, bk, key_mask, train=True)
    dev = q.device
    thresh, keep_scale = _dropout_args(seed, rate, dev)
    blocks = kernels.sm_count(dev)  # the eval form's grid
    o = torch.empty((b, n, f), device=dev)
    l, m, ssq, sumw = (torch.empty((b, n), device=dev) for _ in range(4))
    o_part = torch.empty((blocks + b, n, f), device=dev)
    ml_part, sq_part = (torch.empty((blocks + b, n, 2), device=dev) for _ in range(2))
    flags, units, offsets = _tile_list(b, m_len, dev)
    err = kernels.library("coattn").mpo_coattn_fwd_fused_k_train(
        q.data_ptr(), kv.data_ptr(), wk.data_ptr(), bk.data_ptr(), mask_ptr, seed.data_ptr(),
        o.data_ptr(), l.data_ptr(), m.data_ptr(), ssq.data_ptr(), sumw.data_ptr(),
        o_part.data_ptr(), ml_part.data_ptr(), sq_part.data_ptr(), flags.data_ptr(),
        units.data_ptr(), offsets.data_ptr(), b, n, m_len, f, e, blocks, 1.0 / math.sqrt(e),
        thresh, keep_scale, kernels.stream(dev),
    )
    kernels.check(err, "coattn_fwd_fused_k_train")
    LAUNCH_COUNTS["coattn_fwd_fused_k_train"] += 1
    return o, l, m, ssq, sumw


def coattn_bwd_fused_k(
    q: torch.Tensor, kv: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    key_mask: Optional[torch.Tensor], seed: torch.Tensor, rate: float,
    dout: torch.Tensor, l: torch.Tensor, m: torch.Tensor, di: torch.Tensor,
    dssq: torch.Tensor, dsumw: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`coattn_fwd_fused_k_train` -> (dq [B, N, E],
    dkv [B, M, F], dwk [F, E], dbk [E]), given the cotangents dout [B, N, F],
    dssq, dsumw [B, N], the forward's l, m and
    di = rowsum(o * dout) + 2 dssq ssq + dsumw sumw [B, N] (the plain
    version recomputes what it needs and takes no l, m, di). Kernel: (E, F)
    in ``FUSED_K_TRAIN_EF``, N <= 8, float32."""
    if q.device.type == "cpu":
        return coattn_bwd_fused_k_plain(q, kv, wk, bk, key_mask, seed, rate, dout, dssq, dsumw)
    b, n, e, m_len, f, mask_ptr = _fused_k_checks(q, kv, wk, bk, key_mask, train=True)
    dev = q.device
    thresh, keep_scale = _dropout_args(seed, rate, dev)
    kernels.require(dout, "dout", (b, n, f))
    for t, name in ((l, "l"), (m, "m"), (di, "di"), (dssq, "dssq"), (dsumw, "dsumw")):
        kernels.require(t, name, (b, n))
    # One block an SM shares out the 64-key tiles that hold a valid key (or
    # every tile of a bag without one) evenly, across bags; dwk = kv^T dk in
    # a second kernel, blocks of (a 128 x 128 tile of dwk, a share of those
    # tiles), each writing one partial.
    sms = kernels.sm_count(dev)
    wsplits = max(1, sms // ((f // 128) * (e // 128)))
    dq = torch.empty((b, n, e), device=dev)
    dkv = torch.empty((b, m_len, f), device=dev)
    dwk = torch.empty((f, e), device=dev)
    dbk = torch.empty((e,), device=dev)
    dq_part = torch.empty((sms + b, n, e), device=dev)
    dwk_part = torch.empty((wsplits, f, e), device=dev)
    dbk_part = torch.empty((sms, e), device=dev)
    dk_scratch = torch.empty((b, m_len, e), device=dev)
    flags, units, offsets = _tile_list(b, m_len, dev)
    err = kernels.library("coattn_bwd").mpo_coattn_bwd_fused_k(
        q.data_ptr(), kv.data_ptr(), wk.data_ptr(), bk.data_ptr(), mask_ptr, seed.data_ptr(),
        dout.data_ptr(), l.data_ptr(), m.data_ptr(), di.data_ptr(), dssq.data_ptr(),
        dsumw.data_ptr(), dq.data_ptr(), dkv.data_ptr(), dwk.data_ptr(), dbk.data_ptr(),
        dq_part.data_ptr(), dwk_part.data_ptr(), dbk_part.data_ptr(), dk_scratch.data_ptr(),
        flags.data_ptr(), units.data_ptr(), offsets.data_ptr(), b, n, m_len, f, e,
        sms, wsplits, 1.0 / math.sqrt(e), thresh, keep_scale, kernels.stream(dev),
    )
    kernels.check(err, "coattn_bwd_fused_k")
    LAUNCH_COUNTS["coattn_bwd_fused_k"] += 1
    return dq, dkv, dwk, dbk


class FusedKTrain(torch.autograd.Function):
    """The training form of the fuse-K co-attention with its backward kernel
    (JAX: the custom VJP ``_coattn_fk``): (q, kv, wk, bk) -> (o, ssq, sumw).
    di is computed here in plain torch, as ``_coattn_fk_bwd`` does."""

    @staticmethod
    def forward(ctx, q, kv, wk, bk, key_mask, seed, rate):
        o, l, m, ssq, sumw = coattn_fwd_fused_k_train(q, kv, wk, bk, key_mask, seed, rate)
        ctx.save_for_backward(q, kv, wk, bk, key_mask, seed, o, l, m, ssq, sumw)
        ctx.rate = rate
        return o, ssq, sumw

    @staticmethod
    def backward(ctx, dout, dssq, dsumw):
        q, kv, wk, bk, key_mask, seed, o, l, m, ssq, sumw = ctx.saved_tensors
        dout, dssq, dsumw = (t.contiguous() for t in (dout, dssq, dsumw))
        di = (o * dout).sum(dim=-1) + 2.0 * dssq * ssq + dsumw * sumw
        grads = coattn_bwd_fused_k(q, kv, wk, bk, key_mask, seed, ctx.rate, dout, l, m,
                                   di, dssq, dsumw)
        return (*grads, None, None, None)


def _plain_k_checks(q, k, *, values: bool = False):
    b, n, d = q.shape
    m_len = k.shape[1]
    if not plain_k_supports(n, d, m_len, values=values):
        _refuse(f"plain-K kernels{' with values' if values else ''}", n, f"D={d}, M={m_len}")
    kernels.require(q, "q", (b, n, d))
    kernels.require(k, "k", (b, m_len, d))
    return b, n, d, m_len


def coattn_tiles(key_mask: torch.Tensor, *, lone: bool):
    """The key-tile flag and list passes alone, as the kernels run them (the
    card's yardstick is :func:`coattn_tiles_plain`): key_mask [B, M] bool ->
    (flags [B, T] uint8, the computed units [count] int32, the bags' offsets
    [B + 1] int32)."""
    if key_mask.device.type == "cpu":
        return coattn_tiles_plain(key_mask, lone=lone)
    (b, m_len), dev = key_mask.shape, key_mask.device
    flags, units, offsets = _tile_list(b, m_len, dev)
    err = kernels.library("coattn").mpo_coattn_tiles(
        kernels.mask_ptr(key_mask, b, m_len, dev), flags.data_ptr(), units.data_ptr(),
        offsets.data_ptr(), b, m_len, int(lone), kernels.stream(dev),
    )
    kernels.check(err, "coattn_tiles")
    LAUNCH_COUNTS["coattn_tiles"] += 1
    return flags.view(b, -1), units[:int(offsets[-1])], offsets


def _export_checks(q, k, key_mask):
    """Shapes, the mask pointer and the most main-pass blocks of the export
    passes: they run over the 64-key tiles that hold a valid key (a bag
    without one is a lone unit that reads no k), shared evenly by the blocks
    resident at once, at most ``PLAIN_BLOCKS_PER_SM`` an SM."""
    b, n, d, m_len = _plain_k_checks(q, k)
    blocks = PLAIN_BLOCKS_PER_SM * kernels.sm_count(q.device)
    return b, n, d, m_len, blocks, kernels.mask_ptr(key_mask, b, m_len, q.device)


def _stats_on_card(q, k, key_mask, pre_gate):
    """Export pass 1 on the card -> (l, m, the tile list it built)."""
    b, n, d, m_len, blocks, mask_ptr = _export_checks(q, k, key_mask)
    dev = q.device
    l, m = (torch.empty((b, n), device=dev) for _ in range(2))
    ml_part = torch.empty((blocks + b, n, 2), device=dev)
    tiles = _tile_list(b, m_len, dev)
    err = kernels.library("coattn").mpo_coattn_stats(
        q.data_ptr(), k.data_ptr(), mask_ptr, l.data_ptr(), m.data_ptr(), ml_part.data_ptr(),
        *(t.data_ptr() for t in tiles), b, n, m_len, d, int(pre_gate), blocks,
        1.0 / math.sqrt(d), kernels.stream(dev),
    )
    kernels.check(err, "coattn_stats")
    LAUNCH_COUNTS["coattn_stats"] += 1
    return l, m, tiles


def _weights_on_card(q, k, key_mask, l, m, pre_gate, tiles=None):
    """Export pass 2 on the card, on the tile list of a pass-1 call with the
    same mask (``tiles``) or on its own."""
    b, n, d, m_len, blocks, mask_ptr = _export_checks(q, k, key_mask)
    kernels.require(l, "l", (b, n))
    kernels.require(m, "m", (b, n))
    dev = q.device
    w = torch.empty((b, n, m_len), device=dev)
    ready = tiles is not None
    tiles = tiles if ready else _tile_list(b, m_len, dev)
    err = kernels.library("coattn").mpo_coattn_weights(
        q.data_ptr(), k.data_ptr(), mask_ptr, l.data_ptr(), m.data_ptr(), w.data_ptr(),
        *(t.data_ptr() for t in tiles), b, n, m_len, d, int(pre_gate), blocks, int(ready),
        1.0 / math.sqrt(d), kernels.stream(dev),
    )
    kernels.check(err, "coattn_weights")
    LAUNCH_COUNTS["coattn_weights"] += 1
    return w


def coattn_stats(
    q: torch.Tensor, k: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
    *, pre_gate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Export pass 1: q [B, N, D], k [B, M, D] -> (l [B, N], m [B, N]), the
    softmax normalizer and row max of the masked (pre-gated) scores. Kernel:
    D in {128, 256, 512}, N <= 8, float32."""
    if q.device.type == "cpu":
        return coattn_stats_plain(q, k, key_mask, pre_gate=pre_gate)
    return _stats_on_card(q, k, key_mask, pre_gate)[:2]


def coattn_weights(
    q: torch.Tensor, k: torch.Tensor, key_mask: Optional[torch.Tensor],
    l: torch.Tensor, m: torch.Tensor, *, pre_gate: bool = True,
) -> torch.Tensor:
    """Export pass 2: normalized weights w [B, N, M] = exp(s - m) / l."""
    if q.device.type == "cpu":
        return coattn_weights_plain(q, k, key_mask, l, m, pre_gate=pre_gate)
    return _weights_on_card(q, k, key_mask, l, m, pre_gate)


def _plain_kv_checks(q, k, v, key_mask):
    """Shapes, the mask pointer and the most main-pass blocks of the plain-K
    kernels with values (D in ``VALUES_D``): they run over the 64-key tiles
    that hold a valid key (every tile of a bag without one), shared evenly by
    the blocks resident at once, at most ``PLAIN_BLOCKS_PER_SM`` an SM."""
    b, n, d, m_len = _plain_k_checks(q, k, values=True)
    kernels.require(v, "v", (b, m_len, d))
    blocks = PLAIN_BLOCKS_PER_SM * kernels.sm_count(q.device)
    return b, n, d, m_len, blocks, kernels.mask_ptr(key_mask, b, m_len, q.device)


def coattn_fwd_plain_k(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor],
    seed: Optional[torch.Tensor] = None, rate: float = 0.0, *, pre_gate: bool,
    train: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """The plain-K forward with values: q [B, N, D], k, v [B, M, D], key_mask
    [B, M] bool -> (o [B, N, D], l, m, ssq, sumw [B, N]). ``train`` selects
    the kernel's training form (dropout at ``rate`` keyed by ``seed``, a [1]
    int32 tensor on the same device; ssq and sumw of the dropped weights);
    the eval form takes no dropout and returns None for ssq and sumw.
    Kernel: D in {128, 256}, N <= 8, float32."""
    if not train and rate > 0.0:
        raise ValueError("the eval form takes no dropout")
    if q.device.type == "cpu":
        out = coattn_fwd_plain_k_plain(q, k, v, key_mask, seed, rate, pre_gate=pre_gate)
        return out if train else (*out[:3], None, None)
    b, n, d, m_len, blocks, mask_ptr = _plain_kv_checks(q, k, v, key_mask)
    dev = q.device
    thresh, keep_scale, seed_ptr = 0, 1.0, None
    ssq = sumw = sq_part = None
    if train:
        if seed is None:
            seed = torch.zeros((1,), dtype=torch.int32, device=dev)
        thresh, keep_scale = _dropout_args(seed, rate, dev)
        seed_ptr = seed.data_ptr()
        ssq, sumw = (torch.empty((b, n), device=dev) for _ in range(2))
        sq_part = torch.empty((blocks + b, n, 2), device=dev)
    o = torch.empty((b, n, d), device=dev)
    l, m = (torch.empty((b, n), device=dev) for _ in range(2))
    o_part = torch.empty((blocks + b, n, d), device=dev)
    ml_part = torch.empty((blocks + b, n, 2), device=dev)
    flags, units, offsets = _tile_list(b, m_len, dev)
    side_ptrs = [None if t is None else t.data_ptr() for t in (ssq, sumw, sq_part)]
    err = kernels.library("coattn").mpo_coattn_plain_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, seed_ptr,
        o.data_ptr(), l.data_ptr(), m.data_ptr(), side_ptrs[0], side_ptrs[1],
        o_part.data_ptr(), ml_part.data_ptr(), side_ptrs[2], flags.data_ptr(),
        units.data_ptr(), offsets.data_ptr(), b, n, m_len, d, int(pre_gate), blocks,
        int(train), 1.0 / math.sqrt(d), thresh, keep_scale, kernels.stream(dev),
    )
    kernels.check(err, "coattn_fwd_plain_k")
    LAUNCH_COUNTS["coattn_plain"] += 1
    return o, l, m, ssq, sumw


def coattn_bwd_plain_k(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: Optional[torch.Tensor],
    seed: torch.Tensor, rate: float, dout: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
    di: torch.Tensor, dssq: torch.Tensor, dsumw: torch.Tensor, *, pre_gate: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`coattn_fwd_plain_k` -> (dq [B, N, D], dk, dv
    [B, M, D]), given the cotangents dout [B, N, D], dssq, dsumw [B, N], the
    forward's l, m and di = rowsum(o * dout) + 2 dssq ssq + dsumw sumw
    [B, N] (the plain version recomputes what it needs and takes no l, m,
    di)."""
    if q.device.type == "cpu":
        return coattn_bwd_plain_k_plain(q, k, v, key_mask, seed, rate, dout, dssq, dsumw,
                                        pre_gate=pre_gate)
    b, n, d, m_len, blocks, mask_ptr = _plain_kv_checks(q, k, v, key_mask)
    dev = q.device
    thresh, keep_scale = _dropout_args(seed, rate, dev)
    kernels.require(dout, "dout", (b, n, d))
    for t, name in ((l, "l"), (m, "m"), (di, "di"), (dssq, "dssq"), (dsumw, "dsumw")):
        kernels.require(t, name, (b, n))
    dq = torch.empty((b, n, d), device=dev)
    # the tile pass writes the skipped tiles' dk and dv rows, the main pass the rest
    dk, dv = (torch.empty((b, m_len, d), device=dev) for _ in range(2))
    dq_part = torch.empty((blocks + b, n, d), device=dev)
    flags, units, offsets = _tile_list(b, m_len, dev)
    err = kernels.library("coattn_bwd").mpo_coattn_plain_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, seed.data_ptr(),
        dout.data_ptr(), l.data_ptr(), m.data_ptr(), di.data_ptr(), dssq.data_ptr(),
        dsumw.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_part.data_ptr(),
        flags.data_ptr(), units.data_ptr(), offsets.data_ptr(), b, n, m_len, d,
        int(pre_gate), blocks, 1.0 / math.sqrt(d), thresh, keep_scale, kernels.stream(dev),
    )
    kernels.check(err, "coattn_bwd_plain_k")
    LAUNCH_COUNTS["coattn_plain_bwd"] += 1
    return dq, dk, dv


class PlainKAttention(torch.autograd.Function):
    """The training form of the plain-K co-attention with its backward kernel
    (JAX: the custom VJP ``_coattn``): (q, k, v) -> (o, ssq, sumw). di is
    computed here in plain torch, as ``_coattn_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed, rate, pre_gate):
        o, l, m, ssq, sumw = coattn_fwd_plain_k(q, k, v, key_mask, seed, rate,
                                                pre_gate=pre_gate)
        ctx.save_for_backward(q, k, v, key_mask, seed, o, l, m, ssq, sumw)
        ctx.rate, ctx.pre_gate = rate, pre_gate
        return o, ssq, sumw

    @staticmethod
    def backward(ctx, dout, dssq, dsumw):
        q, k, v, key_mask, seed, o, l, m, ssq, sumw = ctx.saved_tensors
        dout, dssq, dsumw = (t.contiguous() for t in (dout, dssq, dsumw))
        di = (o * dout).sum(dim=-1) + 2.0 * dssq * ssq + dsumw * sumw
        grads = coattn_bwd_plain_k(q, k, v, key_mask, seed, ctx.rate, dout, l, m, di,
                                   dssq, dsumw, pre_gate=ctx.pre_gate)
        return (*grads, None, None, None, None)


# =============================================================================
# Dispatchers (same signatures and layouts as the JAX package's)
# =============================================================================


def fused_attention_leank(
    q: torch.Tensor, kv: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None, *,
    dropout_rate: float = 0.0, dropout_seed: Optional[torch.Tensor] = None,
    need_ssq: bool = False, need_sumw: bool = False,
):
    """Pre-gated attention from the raw key-side input, K projected
    in-kernel and the raw ``kv`` as values (the caller applies the V
    projection to the [B, N, F] result: ops/attention.py lean-V).

    q [B, N, E], kv [B, M, F], wk [F, E], bk [E] -> o [B, N, F], extended to
    a tuple by ``need_ssq`` (ssq [B, N]) then ``need_sumw`` (sumw [B, N]).
    ``dropout_rate`` > 0 drops attention weights with bits keyed by
    ``dropout_seed`` (a [1] int32 tensor on q's device). With dropout, ssq,
    or a gradient to take, the training form runs (:class:`FusedKTrain`:
    training forward + backward kernels); otherwise the eval kernel. On
    CUDA the kernels run at every shape they support (the TPU-tuned M
    cut-overs are not carried over).
    """
    if leank_train_form(dropout_rate, need_ssq, q, kv, wk, bk):
        if dropout_seed is None:
            if dropout_rate > 0.0:
                raise ValueError("dropout_rate > 0 requires a dropout_seed")
            dropout_seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
        o, ssq, sumw = FusedKTrain.apply(q, kv, wk, bk, key_mask, dropout_seed,
                                         float(dropout_rate))
    else:
        o, _, _, sumw = coattn_fwd_fused_k(q, kv, wk, bk, key_mask)
        ssq = None
    extras = ([ssq] if need_ssq else []) + ([sumw] if need_sumw else [])
    return tuple([o] + extras) if extras else o


def coattention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None, *, pre_gate: bool = False,
    dropout_rate: float = 0.0, dropout_seed: Optional[torch.Tensor] = None,
    need_ssq: bool = False, need_sumw: bool = False,
):
    """Few-query attention over projected keys and values: q [B, N, D], k, v
    [B, M, D], key_mask [B, M] bool -> o [B, N, D], extended to a tuple by
    ``need_ssq`` (ssq [B, N], the per-row sum of squares of the final
    weights) then ``need_sumw`` (sumw [B, N], their per-row sum).
    ``dropout_rate`` > 0 drops attention weights with bits keyed by
    ``dropout_seed`` (a [1] int32 tensor on q's device). With dropout, a side
    output, or a gradient to take, the training form runs
    (:class:`PlainKAttention`: forward + backward kernels); otherwise the
    eval form."""
    wants_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if dropout_rate > 0.0 or need_ssq or need_sumw or wants_grad:
        if dropout_seed is None:
            if dropout_rate > 0.0:
                raise ValueError("dropout_rate > 0 requires a dropout_seed")
            dropout_seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
        o, ssq, sumw = PlainKAttention.apply(q, k, v, key_mask, dropout_seed,
                                             float(dropout_rate), bool(pre_gate))
    else:
        o = coattn_fwd_plain_k(q, k, v, key_mask, pre_gate=pre_gate, train=False)[0]
        ssq = sumw = None
    extras = ([ssq] if need_ssq else []) + ([sumw] if need_sumw else [])
    return tuple([o] + extras) if extras else o


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None, *, pre_gate: bool = False,
    dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
    need_ssq: bool = False, need_sumw: bool = False,
):
    """Masked (pre-gated) few-query attention on projected heads without the
    scores in device memory: q [B, H, N, D], k, v [B, H, M, D], key_mask
    [B, M] -> [B, H, N, D], extended to a tuple by ``need_ssq`` then
    ``need_sumw`` ([B, H, N] each). Heads fold into the batch, the mask is
    repeated per head, and the kernel's dropout seed is drawn per call from
    ``generator``. On CUDA the kernel runs at every shape it supports (the
    TPU-tuned M cut-overs are not carried over)."""
    b, h, n, d = q.shape
    m_len = k.shape[2]
    qf, kf, vf = (t.reshape(b * h, t.shape[2], d).contiguous() for t in (q, k, v))
    mf = key_mask
    if key_mask is not None and h > 1:
        mf = key_mask.repeat_interleave(h, dim=0)
    seed = None
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout draws its seed from an explicit "
                             "torch.Generator: pass generator=")
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=q.device,
                             dtype=torch.int32)
    out = coattention(qf, kf, vf, mf, pre_gate=pre_gate, dropout_rate=dropout_rate,
                      dropout_seed=seed, need_ssq=need_ssq, need_sumw=need_sumw)
    if need_ssq or need_sumw:
        return tuple([out[0].reshape(b, h, n, d)] + [e.reshape(b, h, n) for e in out[1:]])
    return out.reshape(b, h, n, d)


def coattention_weights(
    q: torch.Tensor, k: torch.Tensor, key_mask: Optional[torch.Tensor], *,
    pre_gate: bool = False,
) -> torch.Tensor:
    """Normalized weights [B, N, M] by the two passes: (l, m) statistics,
    then the weight tiles recomputed from them; on the card both passes run
    on one tile list, built by the first."""
    if q.device.type == "cpu":
        l, m = coattn_stats_plain(q, k, key_mask, pre_gate=pre_gate)
        return coattn_weights_plain(q, k, key_mask, l, m, pre_gate=pre_gate)
    l, m, tiles = _stats_on_card(q, k, key_mask, pre_gate)
    return _weights_on_card(q, k, key_mask, l, m, pre_gate, tiles)


def attention_with_weights(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None, *, pre_gate: bool = False,
):
    """(out [B, H, N, D], weights [B, H, N, M]) for need_weights=True:
    weights from the two-pass emission, out as one matmul over them (out and
    weights exactly consistent); ``attention_core`` on a shape the kernels do
    not take (:func:`plain_k_supports`)."""
    b, h, n, d = q.shape
    m_len = k.shape[2]
    if not plain_k_supports(n, d, m_len, values=False):  # JAX: not kernel_eligible
        from multimodal_path_omic_tpu_torch.ops.attention import attention_core

        return attention_core(q, k, v, key_mask, pre_gate=pre_gate, need_weights=True)
    qf = q.reshape(b * h, n, d).contiguous()
    kf = k.reshape(b * h, m_len, d).contiguous()
    mf = key_mask
    if key_mask is not None and h > 1:
        mf = key_mask.repeat_interleave(h, dim=0)
    w = coattention_weights(qf, kf, mf, pre_gate=pre_gate).reshape(b, h, n, m_len)
    return torch.matmul(w, v), w
