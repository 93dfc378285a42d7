"""Masked gated-MIL pooling over the patch axis
(``multimodal_path_omic_tpu/ops/milpool.py``): the streaming CUDA kernel's
wrapper and its plain PyTorch version.

    a = tanh(x @ Wa + ba);  g = sigmoid(x @ Wb + bb)
    s = (a * g) @ Wc + bc                      # [M] raw scores (returned)
    w = softmax(where(mask, s, -1e9))          # masked_softmax semantics
    pooled = w @ x                             # [D]

:func:`fused_gated_mil_pool` launches ``csrc/milpool.cu`` for a CUDA tensor
(or raises on what the kernel does not take) and uses
:func:`gated_mil_pool_plain` only for a CPU tensor. Inference only: the
kernel has no backward (training pools through the eager branch of
``ops/blocks.py::GatedMILPool``, with its two dropout sites).
``LAUNCH_COUNTS`` counts kernel launches, one per wrapper call on CUDA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_path_omic_tpu_torch.ops import kernels
from multimodal_path_omic_tpu_torch.ops.layers import masked_softmax

TILE = 64  # patches per tile (csrc/coattn_common.cuh FK_BM)
PACK = 128  # hidden units per weight pack (csrc/milpool.cu HC)
MAX_DIM = 1024  # widest x row the kernel takes

LAUNCH_COUNTS = {"milpool": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def supports(d: int, h: int, m_len: int) -> bool:
    """The shapes the kernel takes: D % 16 == 0, D <= ``MAX_DIM``, H % 128
    == 0 (whole weight packs), M >= 1. The wrapper raises on a CUDA shape
    outside it; ``ops/blocks.py::GatedMILPool`` sends such a pool to its
    eager branch (the JAX module's ``milpool_eligible`` / XLA fallback)."""
    return d % 16 == 0 and 16 <= d <= MAX_DIM and h % PACK == 0 and h >= PACK and m_len >= 1


def gated_mil_pool_plain(x, mask, wa, ba, wb, bb, wc, bc):
    """The math the kernel must match. x [B, M, D]; mask [B, M] bool or
    None; wa, wb [D, H]; ba, bb [H]; wc [H, 1]; bc [1] ->
    (pooled [B, D], raw scores [B, M])."""
    a = torch.tanh(x @ wa + ba)
    g = torch.sigmoid(x @ wb + bb)
    s = ((a * g) @ wc + bc)[..., 0]
    weights = masked_softmax(s[:, None, :], None if mask is None else mask[:, None, :])
    return torch.matmul(weights, x)[:, 0], s


def pack_gate_weights(wa, ba, wb, bb) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weight layout: both gating products share an x tile, so
    pack c holds the columns [Wa[:, 128c:128c+128] | Wb[:, 128c:128c+128]].
    wa, wb [D, H], ba, bb [H] -> (w [H/128, D, 256], bias [H/128, 256])."""
    d, h = wa.shape
    c = h // PACK
    w = torch.cat([wa.reshape(d, c, PACK), wb.reshape(d, c, PACK)], dim=2)
    bias = torch.cat([ba.reshape(c, PACK), bb.reshape(c, PACK)], dim=1)
    return w.permute(1, 0, 2).contiguous(), bias.contiguous()


def fused_gated_mil_pool(
    x: torch.Tensor, mask: Optional[torch.Tensor], wa: torch.Tensor, ba: torch.Tensor,
    wb: torch.Tensor, bb: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, M, D]; mask [B, M] bool or None; wa, wb [D, H]; ba, bb [H];
    wc [H, 1]; bc [1] -> (pooled [B, D], raw scores [B, M], pad positions
    included). Kernel: float32, the shapes of :func:`supports`; the weights
    may be strided views (they are repacked)."""
    if x.device.type == "cpu":
        return gated_mil_pool_plain(x, mask, wa, ba, wb, bb, wc, bc)
    kernels.refuse_grad("fused_gated_mil_pool", x, wa, ba, wb, bb, wc, bc)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, M, D], got {tuple(x.shape)}")
    b, m_len, d = x.shape
    h = wa.shape[-1]
    if not supports(d, h, m_len) or b < 1:
        raise ValueError(f"MIL pool kernel: unsupported D={d}, H={h}, M={m_len}, B={b}")
    kernels.require(x, "x", (b, m_len, d))
    dev = x.device
    for t, name, shape in ((wa, "wa", (d, h)), (wb, "wb", (d, h)), (ba, "ba", (h,)),
                           (bb, "bb", (h,)), (wc, "wc", (h, 1)), (bc, "bc", (1,))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    mask_ptr = kernels.mask_ptr(mask, b, m_len, dev)
    w, bias = pack_gate_weights(wa, ba, wb, bb)
    wc_flat, bc_c = wc.reshape(h).contiguous(), bc.contiguous()
    n_tiles = -(-m_len // TILE)
    splits = kernels.tile_splits(n_tiles, kernels.sm_count(dev) // b)
    pooled = torch.empty((b, d), device=dev)
    scores = torch.empty((b, m_len), device=dev)
    o_part = torch.empty((b, splits, d), device=dev)
    ml_part = torch.empty((b, splits, 2), device=dev)
    err = kernels.library("milpool").mpo_milpool(
        x.data_ptr(), mask_ptr, w.data_ptr(), bias.data_ptr(), wc_flat.data_ptr(),
        bc_c.data_ptr(), pooled.data_ptr(), scores.data_ptr(), o_part.data_ptr(),
        ml_part.data_ptr(), b, m_len, d, h, splits, kernels.stream(dev),
    )
    kernels.check(err, "fused_gated_mil_pool")
    LAUNCH_COUNTS["milpool"] += 1
    return pooled, scores
