"""Survival losses of the serving slice (``multimodal_path_omic_tpu/ops/losses.py``
and the loss dispatch of ``train/loop.py``): ``ces`` and ``cesar``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted mean over the batch axis; plain mean when w is None."""
    if w is None:
        return x.mean()
    w = w.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def _gather1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K], idx [B] -> [B]"""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def cross_entropy_survival(hazards, survs, y, c, alpha: float = 0.75,
                           eps: float = 1e-7,
                           sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"ces": discrete-hazard survival loss. hazards, survs [B, n_bins];
    y [B] int bin; c [B] censorship. S is padded with a leading ones column;
    S is clamped before the (1 - S), as in the reference."""
    y = y.long()
    c = c.to(hazards.dtype)
    s_padded = torch.cat([torch.ones_like(c)[:, None], survs], dim=1)
    s_at_y = _gather1(s_padded, y)
    h_at_y = _gather1(hazards, y)
    reg = -(1.0 - c) * (torch.log(s_at_y.clamp(min=eps)) + torch.log(h_at_y.clamp(min=eps)))
    surv_at_y = _gather1(survs, y).clamp(min=eps)
    ce_l = -(c * torch.log(surv_at_y) + (1.0 - c) * torch.log(1.0 - surv_at_y))
    return _wmean((1.0 - alpha) * ce_l + alpha * reg, sample_weight)


def survival_loss(loss_name: str, out, label, censorship, alpha: float,
                  weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, attn_loss) as the JAX eval step computes them. ``cesar`` adds
    0.01 x the weighted mean over samples of each sample's L2 norm of its
    co-attention map."""
    attn_loss = torch.zeros((), dtype=out.hazards.dtype, device=out.hazards.device)
    ces = cross_entropy_survival(out.hazards, out.survs, label, censorship,
                                 alpha=alpha, sample_weight=weight)
    if loss_name == "ces":
        return ces, attn_loss
    if loss_name == "cesar":
        attn = out.attention["coattn"]
        per = torch.sqrt((attn.reshape(attn.shape[0], -1) ** 2).sum(dim=1) + 1e-12)
        attn_loss = 0.01 * (per * weight).sum() / torch.clamp(weight.sum(), min=1.0)
        return ces + attn_loss, attn_loss
    raise NotImplementedError(f'loss "{loss_name}" is not ported yet')
