"""Survival losses (``multimodal_path_omic_tpu/ops/losses.py``) and the
string-keyed loss dispatch of ``train/loop.py::_survival_loss``.

* ``cross_entropy_survival``            ("ces")
* ``negative_log_likelihood_survival``  ("nll")
* ``cox_survival``                      ("cox")
* ``survival_classification_tobit``     ("sct")
* ``cross_entropy_survival_attn_reg``   (the standalone "cesar" form)
* ``cross_entropy_on_probs``            ("ce": cross-entropy over the softmax
  output Y, i.e. the reference's double softmax, kept faithfully)
* ``l1_reg``

Batched over ``[B, ...]``; ``sample_weight`` lets zero-weight filler rows of
a bucketed batch contribute nothing.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted mean over the batch axis; plain mean when w is None."""
    if w is None:
        return x.mean()
    w = w.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def _gather1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K], idx [B] -> [B]"""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def _s_padded(survs: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """S with a leading ones column."""
    return torch.cat([torch.ones_like(c)[:, None], survs], dim=1)


def cross_entropy_survival(hazards, survs, y, c, alpha: float = 0.75,
                           eps: float = 1e-7,
                           sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"ces": discrete-hazard survival loss. hazards, survs [B, n_bins];
    y [B] int bin; c [B] censorship. S is padded with a leading ones column;
    S is clamped before the (1 - S), as in the reference."""
    c = c.to(hazards.dtype)
    s_at_y = _gather1(_s_padded(survs, c), y)
    h_at_y = _gather1(hazards, y)
    reg = -(1.0 - c) * (torch.log(s_at_y.clamp(min=eps)) + torch.log(h_at_y.clamp(min=eps)))
    surv_at_y = _gather1(survs, y).clamp(min=eps)
    ce_l = -(c * torch.log(surv_at_y) + (1.0 - c) * torch.log(1.0 - surv_at_y))
    return _wmean((1.0 - alpha) * ce_l + alpha * reg, sample_weight)


def negative_log_likelihood_survival(hazards, survs, y, c, alpha: float = 0.15,
                                     eps: float = 1e-7,
                                     sample_weight: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """"nll": the classic discrete NLL survival loss."""
    c = c.to(hazards.dtype)
    s_padded = _s_padded(survs, c)
    uncensored = -(1.0 - c) * (torch.log(_gather1(s_padded, y).clamp(min=eps))
                               + torch.log(_gather1(hazards, y).clamp(min=eps)))
    censored = -c * torch.log(_gather1(s_padded, y.long() + 1).clamp(min=eps))
    loss = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    return _wmean(loss, sample_weight)


def cox_survival(hazards, survs, c,
                 sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cox partial likelihood over the batch. hazards (theta), survs, c [B];
    risk sets R[i, j] = S[j] >= S[i]. Weight-0 rows are kept out of every
    risk set, and an empty risk set is clamped (no log 0)."""
    theta = hazards.reshape(-1)
    s = survs.reshape(-1)
    r_mat = (s[None, :] >= s[:, None]).to(theta.dtype)
    if sample_weight is not None:
        r_mat = r_mat * sample_weight.to(theta.dtype)[None, :]
    risk_sum = torch.clamp((torch.exp(theta)[None, :] * r_mat).sum(dim=1), min=1e-30)
    per = (theta - torch.log(risk_sum)) * (1.0 - c.to(theta.dtype))
    return -_wmean(per, sample_weight)


def survival_classification_tobit(predictions, y, c, eps: float = 1e-7,
                                  sample_weight: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """"sct": uncensored -> -log p[y]; censored -> -log sum_{j >= y} p[j]."""
    c = c.to(predictions.dtype)
    p_at_y = _gather1(predictions, y)
    tail = _gather1(torch.flip(torch.cumsum(torch.flip(predictions, [1]), dim=1), [1]), y)
    loss = torch.where(c == 0, -torch.log(p_at_y + eps), -torch.log(tail + eps))
    return _wmean(loss, sample_weight)


def cross_entropy_survival_attn_reg(hazards, survs, y, c, attention, alpha: float = 0.75,
                                    eps: float = 1e-7, lambda_reg: float = 0.01,
                                    sample_weight: Optional[torch.Tensor] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """"cesar" standalone: ces + lambda * ||A||_2 over the whole map (with
    ``sample_weight``, the square root of the weighted sum of per-sample
    squares). Returns (loss, attn_loss). The training dispatch
    (:func:`survival_loss`) instead takes the weighted mean of per-sample
    norms, as the JAX train step does."""
    loss = cross_entropy_survival(hazards, survs, y, c, alpha=alpha, eps=eps,
                                  sample_weight=sample_weight)
    sq = (attention.reshape(attention.shape[0], -1) ** 2).sum(dim=1)
    if sample_weight is not None:
        sq = sq * sample_weight
    attn_loss = lambda_reg * torch.sqrt(sq.sum())
    return loss + attn_loss, attn_loss


def cross_entropy_on_probs(y_probs, labels,
                           sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"ce": cross-entropy with the softmax output Y taken as logits."""
    logp = y_probs - torch.log(torch.exp(y_probs).sum(dim=1, keepdim=True))
    return _wmean(-_gather1(logp, labels), sample_weight)


def l1_reg(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of |w| over parameters."""
    return sum(p.abs().sum() for p in params)


def survival_loss(loss_name: str, out, label, censorship, alpha: float,
                  weight: torch.Tensor, months: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, attn_loss) as the JAX train and eval steps compute them.
    ``cesar`` adds 0.01 x the weighted mean over samples of each sample's L2
    norm of its co-attention map: from ``attention['coattn_ssq']`` (the
    per-query sums of squares) when the model returned it, else from the
    map ``attention['coattn']``. ``cox`` takes its risk sets from ``months``
    with theta = risk = -sum(survs)."""
    attn_loss = torch.zeros((), dtype=out.hazards.dtype, device=out.hazards.device)
    if loss_name == "ce":
        return cross_entropy_on_probs(out.y, label, sample_weight=weight), attn_loss
    if loss_name == "ces":
        return cross_entropy_survival(out.hazards, out.survs, label, censorship,
                                      alpha=alpha, sample_weight=weight), attn_loss
    if loss_name == "sct":
        return survival_classification_tobit(out.y, label, censorship,
                                             sample_weight=weight), attn_loss
    if loss_name == "cesar":
        ssq = out.attention.get("coattn_ssq")
        if ssq is None:
            attn = out.attention["coattn"]
            ssq = attn.reshape(attn.shape[0], -1) ** 2
        per = torch.sqrt(ssq.sum(dim=1) + 1e-12)
        attn_loss = 0.01 * (per * weight).sum() / torch.clamp(weight.sum(), min=1.0)
        ces = cross_entropy_survival(out.hazards, out.survs, label, censorship,
                                     alpha=alpha, sample_weight=weight)
        return ces + attn_loss, attn_loss
    if loss_name == "nll":
        return negative_log_likelihood_survival(out.hazards, out.survs, label, censorship,
                                                sample_weight=weight), attn_loss
    if loss_name == "cox":
        if months is None:
            raise ValueError("the cox loss needs the survival months")
        risk = -out.survs.sum(dim=1)
        return cox_survival(risk, months, censorship, sample_weight=weight), attn_loss
    raise RuntimeError(f'Loss "{loss_name}" not implemented')
