"""Masked self-attention over long bags without the L x L score matrix
(``multimodal_path_omic_tpu/ops/flash.py``): the flash forward and backward
kernels' wrappers, their plain PyTorch versions and the
``torch.autograd.Function`` that joins them.

    out = softmax(where(key_mask, q k^T * sm_scale, -1e9)) v

Key-mask semantics, those of the port's ``masked_softmax``: scores of masked
keys are filled with the finite -1e9, every query row is computed (a pad
query attends to the valid keys), and a bag with no valid key gives the
uniform mean of ``v``. (On the TPU the JAX package passes the mask as
segment ids, under which a pad query attends to the pad keys instead; valid
rows agree, and pad rows are masked by every later attention and pool.)

:func:`flash_attention` is what the modules call. Where autograd would
differentiate the call it goes through :class:`FlashAttention`, whose forward
also returns each row's softmax statistics (m, l) and whose backward
recomputes the weights from them (the JAX package gets this from its library
kernel's custom VJP). On CUDA tensors the wrappers :func:`flash_fwd` and
:func:`flash_bwd` launch ``csrc/flash.cu`` and ``csrc/flash_bwd.cu`` (or
raise on what the kernels do not take); :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain` serve CPU tensors only. The backward keeps
m and l apart: in a bag without a valid key every score is -1e9, and in
float32 ``-1e9 + log(L)`` rounds back to -1e9, so a single log-sum-exp would
give the weight 1 where the forward gave 1/L. ``LAUNCH_COUNTS`` counts kernel
launches, one per wrapper call on CUDA, by the kernel's instance (head width,
and ``_bf16`` for the bfloat16 instances).

bfloat16 (GE under the compute dtype ``bfloat16``; the JAX package hands its
library TPU kernel bfloat16 q, k, v): every width has a bfloat16 instance of
both kernels, and the plain versions take bfloat16 inputs. Both compute in
float32 from the bfloat16 values and round where the TPU kernel does
(``jax/experimental/pallas/ops/tpu/flash_attention.py``): the scale
multiplies the float32 sum q k^T (the float32 form scales q first), p is
rounded to bfloat16 before P V while m and l come from the unrounded p, out
is bfloat16; the backward recomputes p in float32, rounds it for dv = p^T
dout, and rounds ds = p (dp - delta) * scale for dq = ds k and dk = ds^T q;
dq, dk, dv are bfloat16, m, l and delta float32. The plain versions pass
the gradient straight through their roundings (``layers.round_bf16``). On
the card the bfloat16 instances run on Hopper's warpgroup MMA
(``csrc/flash_sm90.cuh``; the backward's dkv pass at width 512 on
``mma.sync``), their exponentials on the exp unit (``ex2.approx``, the
backward's 1 / l as ``-log2 l`` in the exponent): within a few units in the
last place of float32's, which the card's bars absorb.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_path_omic_tpu_torch.ops import kernels
from multimodal_path_omic_tpu_torch.ops.coattn import register_op
from multimodal_path_omic_tpu_torch.ops.layers import NEG_INF, round_bf16

# The kernels' instances: GE small (one head of 128, eight of 16), medium
# (256, 32) and big (512, 64).
HEAD_DIMS = (16, 32, 64, 128, 256, 512)

# The bfloat16 forward kernel's keys a tile by head width (csrc/flash.cu,
# ``mpo_flash_fwd_bf16``): it rounds p against the running maximum over the
# tiles seen so far, as the TPU kernel does over its key blocks, and the plain
# version follows the same tiles.
KEY_TILE = {16: 64, 32: 64, 64: 128, 128: 128, 256: 64, 512: 32}

# one count per template instance of each kernel
LAUNCH_COUNTS = {f"flash_{way}_d{d}{sfx}": 0 for way in ("fwd", "bwd") for d in HEAD_DIMS
                 for sfx in ("", "_bf16")}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, key_mask=None, sm_scale: Optional[float] = None, *,
                          chunk: int = 1024, return_stats: bool = False,
                          key_tile: Optional[int] = None):
    """q, k, v [B, H, L, D]; key_mask [B, L] bool (True = valid) ->
    [B, H, L, D]. The scores are formed ``chunk`` query rows at a time (a
    whole [L, L] map per bag and head does not fit at GE lengths); chunking
    changes no value. With ``return_stats`` also each row's maximum score m
    and the sum l of exp(s - m) over its keys, [B, H, L] each, with
    ``out = (exp(s - m) / l) v``: what the backward recomputes p from.

    bfloat16 q, k, v: float32 math on their values, s = (q k^T) * scale,
    and p rounded to bfloat16 against the running maximum over key tiles of
    ``key_tile`` keys (default the kernel's, ``KEY_TILE``; the TPU kernel's
    is its key block): with m_t that maximum after tile t and m its last
    value, ``out = sum_t (round(exp(s_t - m_t)) v_t) exp(m_t - m) / l``,
    returned in bfloat16; l from the unrounded p; m and l in float32."""
    n, d = q.shape[2], q.shape[3]
    scale = _scale(d, sm_scale)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = q.float(), k.float(), v.float()
        tile = key_tile or KEY_TILE.get(d, n)
        n_tiles = -(-n // tile)
    mask4 = None if key_mask is None else key_mask[:, None, None, :]
    kt = k.transpose(-1, -2)
    out, ms, ls = [], [], []
    for i0 in range(0, n, chunk):
        if bf16:
            scores = torch.matmul(q[:, :, i0:i0 + chunk], kt) * scale
        else:
            scores = torch.matmul(q[:, :, i0:i0 + chunk] * scale, kt)
        if mask4 is not None:
            scores = torch.where(mask4, scores, torch.full_like(scores, NEG_INF))
        if bf16:  # keys past L: weight exactly 0
            st = F.pad(scores, (0, n_tiles * tile - n), value=-math.inf)
            st = st.unflatten(-1, (n_tiles, tile))
            m_t = st.amax(dim=-1).cummax(dim=-1).values  # [.., rows, tiles]
            m = m_t[..., -1]
            e = torch.exp(st - m_t[..., None])
            rescale = torch.exp(m_t - m[..., None])[..., None]
            s = (e.sum(dim=-1) * rescale[..., 0]).sum(dim=-1)
            w = (round_bf16(e) * rescale).flatten(-2)[..., :n]
            out.append(torch.matmul(w, v) / s[..., None])
        else:
            m = scores.amax(dim=-1)
            e = torch.exp(scores - m[..., None])
            s = e.sum(dim=-1)
            out.append(torch.matmul(e / s[..., None], v))
        ms.append(m)
        ls.append(s)
    o = torch.cat(out, dim=2)
    if bf16:
        o = o.to(torch.bfloat16)
    if return_stats:
        return o, torch.cat(ms, dim=2), torch.cat(ls, dim=2)
    return o


def flash_attention_bwd_plain(q, k, v, key_mask, out, m, l, dout,
                              sm_scale: Optional[float] = None, *, chunk: int = 1024
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) [B, H, L, D] of :func:`flash_attention_plain` from its
    inputs, its result ``out``, the statistics (m, l) and the cotangent
    ``dout``, ``chunk`` query rows at a time:

        p = exp(s - m) / l;  dv = p^T dout;  dp = dout v^T
        ds = p * (dp - rowsum(dout * out)), 0 at every masked key
        dq = scale * ds k;   dk = scale * ds^T q

    The mask is a ``where``: a masked key passes no gradient to q or k even
    where its weight is not 0 (the bag without a valid key, p = 1/L), but
    its weight still feeds dv. bfloat16 inputs: float32 math on their
    values, p = exp(s - m) * (1 / l) rounded to bfloat16 for dv, ds * scale
    rounded to bfloat16 for dq and dk, which are returned in bfloat16 with
    dv (the module docstring)."""
    n, d = q.shape[2], q.shape[3]
    scale = _scale(d, sm_scale)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v, out, dout = (t.float() for t in (q, k, v, out, dout))
    mask4 = None if key_mask is None else key_mask[:, None, None, :]
    delta = (dout * out).sum(dim=-1)
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    for i0 in range(0, n, chunk):
        rows = slice(i0, i0 + chunk)
        if bf16:
            s = torch.matmul(q[:, :, rows], kt) * scale
        else:
            s = torch.matmul(q[:, :, rows] * scale, kt)
        if mask4 is not None:
            s = torch.where(mask4, s, torch.full_like(s, NEG_INF))
        if bf16:
            p = torch.exp(s - m[:, :, rows, None]) * (1.0 / l[:, :, rows, None])
            dv += torch.matmul(round_bf16(p).transpose(-1, -2), dout[:, :, rows])
        else:
            p = torch.exp(s - m[:, :, rows, None]) / l[:, :, rows, None]
            dv += torch.matmul(p.transpose(-1, -2), dout[:, :, rows])
        ds = p * (torch.matmul(dout[:, :, rows], vt) - delta[:, :, rows, None])
        if mask4 is not None:
            ds = torch.where(mask4, ds, torch.zeros_like(ds))
        if bf16:
            ds = round_bf16(ds * scale)
            dq[:, :, rows] = torch.matmul(ds, k)
            dk += torch.matmul(ds.transpose(-1, -2), q[:, :, rows])
        else:
            dq[:, :, rows] = scale * torch.matmul(ds, k)
            dk += scale * torch.matmul(ds.transpose(-1, -2), q[:, :, rows])
    if bf16:
        return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The kernels' wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def supports(b: int, h: int, l: int, d: int, *, dtype: torch.dtype = torch.float32) -> bool:
    """The shapes the kernels take, [B, H, L, D] for q, k and v alike: a head
    width with an instance, L >= 1, B * H <= 65535 (the grid's y), float32
    or bfloat16 (every width has both instances). The modules take
    :func:`flash_attention` only where this holds and ``attention_core``
    elsewhere, as the JAX dispatcher takes ``_xla_fused`` where
    ``flash.supported`` says no."""
    return (dtype in (torch.float32, torch.bfloat16) and d in HEAD_DIMS and l >= 1
            and 1 <= b * h <= 65535)


def _check_qkv(q, k, v, key_mask):
    """Raise on what the kernels do not take; (b, h, l, d, device, mask pointer)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, L, D], got {tuple(q.shape)}")
    b, h, l, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not supports(b, h, l, d, dtype=q.dtype):
        raise ValueError(f"flash kernel: unsupported head width D={d} (takes {HEAD_DIMS}), "
                         f"L={l}, B*H={b * h}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):  # read in place: strided views pass
        kernels.require(t, name, (b, h, l, d), q.dtype, strided=True)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v are on different devices")
    return b, h, l, d, dev, kernels.mask_ptr(key_mask, b, l, dev)


def flash_fwd(q, k, v, key_mask=None, sm_scale: Optional[float] = None, *,
              need_stats: bool = False):
    """The forward kernel: (out, m, l). float32 or bfloat16 (q, k, v and out
    alike; m and l float32), D in ``HEAD_DIMS``, any L >= 1; q, k, v may be
    strided views (the heads of a packed [B, L, 3E] projection are read in
    place). ``out`` is a [B, H, L, D] view of a [B, L, H, D] buffer, so
    merging the heads afterwards copies nothing; m, l are [B, H, L] with
    ``need_stats``, else None."""
    b, h, l, d, dev, mask_ptr = _check_qkv(q, k, v, key_mask)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=dev)
    m, s = (torch.empty((b, h, l), device=dev) for _ in range(2)) if need_stats else (None, None)
    sfx = kernels.suffix(q.dtype)
    err = getattr(kernels.library("flash"), "mpo_flash_fwd" + sfx)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        None if m is None else m.data_ptr(), None if s is None else s.data_ptr(),
        b, h, l, d, *strides, _scale(d, sm_scale), kernels.stream(dev),
    )
    kernels.check(err, "flash_attention")
    LAUNCH_COUNTS[f"flash_fwd_d{d}{sfx}"] += 1
    return out.permute(0, 2, 1, 3), m, s


def flash_bwd(q, k, v, key_mask, out, m, l, dout, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: (dq, dk, dv) in q's type, three [B, H, L, D]
    views of one packed [B, L, 3, H, D] buffer (beside a packed
    in-projection its gradient needs no gather). ``out``, m, l as
    :func:`flash_fwd` returned them; ``dout`` [B, H, L, D] in q's type is
    read with its strides (copied only where its last axis is not
    unit-stride or a stride is not a multiple of 16 bytes)."""
    b, h, n, d, dev, mask_ptr = _check_qkv(q, k, v, key_mask)
    out = out.permute(0, 2, 1, 3)  # the [B, L, H, D] buffer underneath
    kernels.require(out, "out", (b, n, h, d), q.dtype)
    for t, name in ((m, "m"), (l, "l")):
        kernels.require(t, name, (b, h, n))
    step = 16 // dout.element_size()
    if dout.stride(-1) != 1 or any(s % step for s in dout.stride()[:-1]) or dout.data_ptr() % 16:
        dout = dout.contiguous()
    kernels.require(dout, "dout", (b, h, n, d), q.dtype, strided=True)
    dqkv = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=dev)
    dq, dk, dv = (dqkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    delta = torch.empty((b, h, n), device=dev)
    strides = (ctypes.c_longlong * 21)(
        *[s for t in (q, k, v, dout, dq, dk, dv) for s in t.stride()[:3]])
    sfx = kernels.suffix(q.dtype)
    err = getattr(kernels.library("flash_bwd"), "mpo_flash_bwd" + sfx)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), m.data_ptr(),
        l.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, n, d, ctypes.addressof(strides), _scale(d, sm_scale),
        kernels.stream(dev),
    )
    kernels.check(err, "flash_attention backward")
    LAUNCH_COUNTS[f"flash_bwd_d{d}{sfx}"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Autograd and the entry point
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, key_mask, sm_scale)``: the forward
    saves q, k, v, out and the row statistics (m, l), never a weight; the
    backward recomputes the weights tile by tile. Kernels on CUDA tensors,
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sm_scale):
        if q.device.type == "cpu":
            out, m, l = flash_attention_plain(q, k, v, key_mask, sm_scale, return_stats=True)
        else:
            out, m, l = flash_fwd(q, k, v, key_mask, sm_scale, need_stats=True)
        ctx.save_for_backward(q, k, v, key_mask, out, m, l)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, key_mask, out, m, l = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_bwd
        dq, dk, dv = bwd(q, k, v, key_mask, out, m, l, dout, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v [B, H, L, D]; key_mask [B, L] bool or None -> [B, H, L, D].
    Differentiable (through :class:`FlashAttention`); on CUDA tensors the
    limits of :func:`flash_fwd` apply."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, key_mask, sm_scale)
    # the forward through its custom op (deploy.py exports it as one node);
    # the op returns the [B, L, H, D] buffer
    return torch.ops.mpo_torch.flash_fwd(q, k, v, key_mask, sm_scale).permute(0, 2, 1, 3)


def _flash_fwd_op(q, k, v, key_mask, sm_scale):
    """The forward as the [B, L, H, D] buffer: the kernel on CUDA, the plain
    version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, sm_scale).permute(0, 2, 1, 3).contiguous()
    return flash_fwd(q, k, v, key_mask, sm_scale)[0].permute(0, 2, 1, 3)


register_op("flash_fwd", "(Tensor q, Tensor k, Tensor v, Tensor? key_mask, float? sm_scale) "
            "-> Tensor", lambda *a: _flash_fwd_op(*a),
            lambda q, k, v, key_mask, sm_scale: q.new_empty(
                (q.shape[0], q.shape[2], q.shape[1], q.shape[3])))

