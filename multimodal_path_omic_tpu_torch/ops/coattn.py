"""Pre-gated few-query co-attention: CUDA kernel wrappers, their plain
PyTorch versions, and the dispatchers of ``multimodal_path_omic_tpu/ops/coattn.py``.

Three kernels (``csrc/coattn.cu``) replace the TPU kernels of the NaCAGaT
serving path:

* :func:`coattn_fwd_fused_k` — the forward kernel in its fuse-K form: K is
  projected from the raw key-side input in-kernel (``k = kv @ wk + bk``),
  pre-gated, masked, online-softmaxed, and the raw values ``kv`` pooled;
  emits o, l, m and sumw (``coattention_fused_k``, eval: no dropout);
* :func:`coattn_stats` — the forward kernel's plain-K form, statistics only
  (pass 1 of the attention-map export, ``coattention_weights``);
* :func:`coattn_weights` — the weights-emission kernel (export pass 2).

Each wrapper launches its kernel for a CUDA tensor (or raises on what the
kernel does not take) and uses the plain version only for a CPU tensor.
``LAUNCH_COUNTS`` counts kernel launches, one per wrapper call on CUDA.

Scores are ``s = (q.k)/sqrt(d) * (tanh(q).tanh(k) + 1)/2`` with the finite
mask value ``NEG``: a fully-masked row has uniform weights over its M keys,
never NaN. (The TPU kernel pads M to its tile and spreads such a row over
the padded length; the port, like the JAX package's plain attention_core,
spreads it over exactly M.)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from multimodal_path_omic_tpu_torch.ops import kernels

NEG = -0.7 * 3.4e38  # finite mask value of the TPU kernel
MAX_QUERIES = 8  # one warp per query in the kernels
FK_TILE = 64  # keys per fuse-K tile (csrc/coattn.cu FK_BM)
STATS_MIN_KEYS_PER_WARP = 32

LAUNCH_COUNTS = {"coattn_fwd_fused_k": 0, "coattn_stats": 0, "coattn_weights": 0}


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


def coattn_fwd_fused_k_plain(q, kv, wk, bk, key_mask=None):
    k = torch.matmul(kv, wk) + bk
    s = _scores(q, k, key_mask, True)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l_inv = _inv(l)
    o = torch.matmul(p, kv) * l_inv[..., None]
    return o, l, m, l * l_inv


# =============================================================================
# Kernel wrappers
# =============================================================================


def _require(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be 16-byte aligned for float4 loads")


def _mask_ptr(key_mask, b, m_len, device):
    if key_mask is None:
        return None
    _require(key_mask, "key_mask", (b, m_len), torch.bool)
    if key_mask.device != device:
        raise ValueError("key_mask is on another device")
    return key_mask.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_queries(n):
    if not 1 <= n <= MAX_QUERIES:
        raise ValueError(f"the co-attention kernels take 1..{MAX_QUERIES} queries, got {n}")


def coattn_fwd_fused_k(
    q: torch.Tensor, kv: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, N, E], kv [B, M, F], wk [F, E], bk [E], key_mask [B, M] bool ->
    (o [B, N, F], l [B, N], m [B, N], sumw [B, N]). Kernel: E in {128, 256},
    F % 16 == 0 and F <= 1024, N <= 8, float32."""
    if q.device.type == "cpu":
        return coattn_fwd_fused_k_plain(q, kv, wk, bk, key_mask)
    b, n, e = q.shape
    m_len, f = kv.shape[1], kv.shape[2]
    _check_queries(n)
    if e not in (128, 256) or f % 16 != 0 or f > 1024 or m_len < 1:
        raise ValueError(f"fuse-K kernel: unsupported E={e}, F={f}, M={m_len}")
    _require(q, "q", (b, n, e))
    _require(kv, "kv", (b, m_len, f))
    _require(wk, "wk", (f, e))
    _require(bk, "bk", (e,))
    dev = q.device
    mask_ptr = _mask_ptr(key_mask, b, m_len, dev)
    n_tiles = -(-m_len // FK_TILE)
    splits = max(1, min(n_tiles, _sm_count(dev) // b, 1024))
    o = torch.empty((b, n, f), device=dev)
    l, m, sumw = (torch.empty((b, n), device=dev) for _ in range(3))
    o_part = torch.empty((b, splits, n, f), device=dev)
    ml_part = torch.empty((b, splits, n, 2), device=dev)
    err = kernels.library("coattn").mpo_coattn_fwd_fused_k(
        q.data_ptr(), kv.data_ptr(), wk.data_ptr(), bk.data_ptr(), mask_ptr,
        o.data_ptr(), l.data_ptr(), m.data_ptr(), sumw.data_ptr(),
        o_part.data_ptr(), ml_part.data_ptr(),
        b, n, m_len, f, e, splits, 1.0 / math.sqrt(e), _stream(dev),
    )
    kernels.check(err, "coattn_fwd_fused_k")
    LAUNCH_COUNTS["coattn_fwd_fused_k"] += 1
    return o, l, m, sumw


def _plain_k_checks(q, k):
    b, n, d = q.shape
    m_len = k.shape[1]
    _check_queries(n)
    if d not in (128, 256, 512) or m_len < 1:
        raise ValueError(f"plain-K kernels: unsupported D={d}, M={m_len}")
    _require(q, "q", (b, n, d))
    _require(k, "k", (b, m_len, d))
    # enough warps per bag to keep loads in flight, >= 32 keys per warp
    splits = max(1, min(-(-m_len // (8 * STATS_MIN_KEYS_PER_WARP)),
                        -(-4 * _sm_count(q.device) // b), 128))
    return b, n, d, m_len, splits


def coattn_stats(
    q: torch.Tensor, k: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
    *, pre_gate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Export pass 1: q [B, N, D], k [B, M, D] -> (l [B, N], m [B, N]), the
    softmax normalizer and row max of the masked (pre-gated) scores."""
    if q.device.type == "cpu":
        return coattn_stats_plain(q, k, key_mask, pre_gate=pre_gate)
    b, n, d, m_len, splits = _plain_k_checks(q, k)
    dev = q.device
    mask_ptr = _mask_ptr(key_mask, b, m_len, dev)
    l, m = (torch.empty((b, n), device=dev) for _ in range(2))
    ml_part = torch.empty((b, splits * 8, n, 2), device=dev)
    err = kernels.library("coattn").mpo_coattn_stats(
        q.data_ptr(), k.data_ptr(), mask_ptr, l.data_ptr(), m.data_ptr(),
        ml_part.data_ptr(), b, n, m_len, d, int(pre_gate), splits,
        1.0 / math.sqrt(d), _stream(dev),
    )
    kernels.check(err, "coattn_stats")
    LAUNCH_COUNTS["coattn_stats"] += 1
    return l, m


def coattn_weights(
    q: torch.Tensor, k: torch.Tensor, key_mask: Optional[torch.Tensor],
    l: torch.Tensor, m: torch.Tensor, *, pre_gate: bool = True,
) -> torch.Tensor:
    """Export pass 2: normalized weights w [B, N, M] = exp(s - m) / l."""
    if q.device.type == "cpu":
        return coattn_weights_plain(q, k, key_mask, l, m, pre_gate=pre_gate)
    b, n, d, m_len, splits = _plain_k_checks(q, k)
    _require(l, "l", (b, n))
    _require(m, "m", (b, n))
    dev = q.device
    mask_ptr = _mask_ptr(key_mask, b, m_len, dev)
    w = torch.empty((b, n, m_len), device=dev)
    err = kernels.library("coattn").mpo_coattn_weights(
        q.data_ptr(), k.data_ptr(), mask_ptr, l.data_ptr(), m.data_ptr(),
        w.data_ptr(), b, n, m_len, d, int(pre_gate), splits,
        1.0 / math.sqrt(d), _stream(dev),
    )
    kernels.check(err, "coattn_weights")
    LAUNCH_COUNTS["coattn_weights"] += 1
    return w


# =============================================================================
# Dispatchers (same signatures and layouts as the JAX package's)
# =============================================================================


def fused_attention_leank(
    q: torch.Tensor, kv: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None, *,
    need_ssq: bool = False, need_sumw: bool = False,
):
    """Pre-gated attention from the raw key-side input, K projected
    in-kernel and the raw ``kv`` as values (the caller applies the V
    projection to the [B, N, F] result: ops/attention.py lean-V).

    q [B, N, E], kv [B, M, F], wk [F, E], bk [E] -> o [B, N, F], extended to
    a tuple by ``need_sumw`` (sumw [B, N]). On CUDA the kernel runs at every
    shape it supports (the TPU-tuned M cut-over is not carried over).
    ``need_ssq`` (the training-time cesar side output) comes with training.
    """
    if need_ssq:
        raise NotImplementedError("need_ssq belongs to the training slice")
    o, _, _, sumw = coattn_fwd_fused_k(q, kv, wk, bk, key_mask)
    return (o, sumw) if need_sumw else o


def coattention_weights(
    q: torch.Tensor, k: torch.Tensor, key_mask: Optional[torch.Tensor], *,
    pre_gate: bool = False,
) -> torch.Tensor:
    """Normalized weights [B, N, M] by the two passes: (l, m) statistics,
    then the weight tiles recomputed from them."""
    l, m = coattn_stats(q, k, key_mask, pre_gate=pre_gate)
    return coattn_weights(q, k, key_mask, l, m, pre_gate=pre_gate)


def attention_with_weights(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None, *, pre_gate: bool = False,
):
    """(out [B, H, N, D], weights [B, H, N, M]) for need_weights=True:
    weights from the two-pass emission, out as one matmul over them (out and
    weights exactly consistent)."""
    b, h, n, d = q.shape
    m_len = k.shape[2]
    qf = q.reshape(b * h, n, d).contiguous()
    kf = k.reshape(b * h, m_len, d).contiguous()
    mf = key_mask
    if key_mask is not None and h > 1:
        mf = key_mask.repeat_interleave(h, dim=0)
    w = coattention_weights(qf, kf, mf, pre_gate=pre_gate).reshape(b, h, n, m_len)
    return torch.matmul(w, v), w
