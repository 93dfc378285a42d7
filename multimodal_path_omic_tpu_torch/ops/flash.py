"""Masked self-attention over long bags without the L x L score matrix
(``multimodal_path_omic_tpu/ops/flash.py``): the flash forward kernel's
wrapper and its plain PyTorch version.

    out = softmax(where(key_mask, q k^T * sm_scale, -1e9)) v

Key-mask semantics, those of the port's ``masked_softmax``: scores of masked
keys are filled with the finite -1e9, every query row is computed (a pad
query attends to the valid keys), and a bag with no valid key gives the
uniform mean of ``v``. (On the TPU the JAX package passes the mask as
segment ids, under which a pad query attends to the pad keys instead; valid
rows agree, and pad rows are masked by every later attention and pool.)

:func:`flash_attention` launches ``csrc/flash.cu`` for CUDA tensors (or
raises on what the kernel does not take) and uses
:func:`flash_attention_plain` only for CPU tensors. Forward only: the
backward kernel belongs to GE training. ``LAUNCH_COUNTS`` counts kernel
launches, one per wrapper call on CUDA, by the kernel's instance (head width).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from multimodal_path_omic_tpu_torch.ops import kernels
from multimodal_path_omic_tpu_torch.ops.layers import masked_softmax

HEAD_DIMS = (256, 32)  # the kernel's instances: GE medium's one head and its 8-head layers

# one count per template instance of the kernel
LAUNCH_COUNTS = {f"flash_fwd_d{d}": 0 for d in HEAD_DIMS}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def flash_attention_plain(q, k, v, key_mask=None, sm_scale: Optional[float] = None, *,
                          chunk: int = 1024) -> torch.Tensor:
    """q, k, v [B, H, L, D]; key_mask [B, L] bool (True = valid) ->
    [B, H, L, D]. The scores are formed ``chunk`` query rows at a time (a
    whole [L, L] map per bag and head does not fit at GE lengths); chunking
    changes no value."""
    b, h, l, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    mask4 = None if key_mask is None else key_mask[:, None, None, :]
    kt = k.transpose(-1, -2)
    out = []
    for i0 in range(0, l, chunk):
        scores = torch.matmul(q[:, :, i0:i0 + chunk] * scale, kt)
        out.append(torch.matmul(masked_softmax(scores, mask4), v))
    return torch.cat(out, dim=2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v [B, H, L, D]; key_mask [B, L] bool or None -> [B, H, L, D].
    Kernel: float32, D in {256, 32}, any L >= 1; q, k, v may be strided views
    (the heads of a packed [B, L, 3E] projection are read in place). The
    result is a [B, H, L, D] view of a [B, L, H, D] buffer, so merging the
    heads afterwards copies nothing."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, sm_scale)
    kernels.refuse_grad("flash_attention", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, L, D], got {tuple(q.shape)}")
    b, h, l, d = q.shape
    if d not in HEAD_DIMS or l < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f"flash kernel: unsupported head width D={d} (takes {HEAD_DIMS}), "
                         f"L={l}, B*H={b * h}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):  # read in place: strided views pass
        kernels.require(t, name, (b, h, l, d), strided=True)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v are on different devices")
    mask_ptr = kernels.mask_ptr(key_mask, b, l, dev)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    out = torch.empty((b, l, h, d), device=dev)
    err = kernels.library("flash").mpo_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        b, h, l, d, *strides, scale, kernels.stream(dev),
    )
    kernels.check(err, "flash_attention")
    LAUNCH_COUNTS[f"flash_fwd_d{d}"] += 1
    return out.permute(0, 2, 1, 3)
