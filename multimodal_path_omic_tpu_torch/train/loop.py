"""Train and eval steps (``multimodal_path_omic_tpu/train/loop.py``): one
optimizer update per batched, bucketed step on a single device, host-fed
(:func:`make_train_step`) or assembled on the device from a resident bag
cache (:func:`make_cached_train_step`); the no-grad eval step of validation
and serving (:func:`make_eval_step`), host-fed or cached; the MC-dropout
step of serving (:func:`make_mc_eval_step`).

A full effective batch is processed in one step. When B * M exceeds
``patch_budget`` the step runs the batch in gradient-accumulation chunks
(the largest divisor of B whose chunk fits), each chunk's loss scaled by its
weight mass, and divides the summed gradients by the batch's total weight
mass before the one optimizer update: the same gradient as the one-chunk
step. ``cox`` always takes the whole batch (its risk sets span it).

Unlike the JAX step, which is pure, this one updates the model's parameters
and the optimizer state in place (``TrainState`` carries the objects and a
step count). Dropout draws from the state's ``torch.Generator`` on the
model's device, seeded once: every dropout mask of a step, and the
co-attention kernel's int32 seed (one per chunk), come from it, as do the
``patch_dropout`` draws. Those differ from the JAX step's draw for draw
(another generator), as every dropout mask does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_path_omic_tpu_torch.ops.gather import take_rows
from multimodal_path_omic_tpu_torch.ops.losses import (
    cross_entropy_on_probs,
    l1_reg,
    survival_loss,
)
from multimodal_path_omic_tpu_torch.train.optim import OptimizerSpec


class TrainState(NamedTuple):
    optimizer: torch.optim.Optimizer  # holds the optimizer state
    generator: torch.Generator  # dropout bits
    step: int


class StepMetrics(NamedTuple):
    loss: torch.Tensor  # scalar weighted-mean loss (incl. the L1 term)
    attn_loss: torch.Tensor  # scalar (cesar only, else 0)
    risk: torch.Tensor  # [B] per-sample risk = -sum(survs)
    n_real: torch.Tensor  # scalar total weight


def init_train_state(model: nn.Module, optimizer: OptimizerSpec, seed: int) -> TrainState:
    """Optimizer state over the model's parameters and a dropout generator
    on the model's device, seeded with ``seed``."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(int(seed))
    return TrainState(optimizer.init(model.parameters()), generator, 0)


def accumulation_chunks(batch: int, m_len: int, patch_budget: Optional[int],
                        loss_name: str) -> int:
    """Number of accumulation chunks: B over the largest divisor d of B with
    d * M <= patch_budget (1 for cox or no budget)."""
    if patch_budget is None or loss_name == "cox":
        return 1
    max_chunk = max(1, patch_budget // max(m_len, 1))
    chunk = max(d for d in range(1, batch + 1) if batch % d == 0 and d <= max_chunk)
    return batch // chunk


def _unpack_omics(batch: Dict[str, Any], omic_sizes: Optional[Sequence[int]]):
    """The batch's 'omics' list, or the columns of its packed
    [B, sum(sizes)] 'omics_packed' tensor."""
    if "omics" in batch:
        return batch["omics"]
    if omic_sizes is None:
        raise ValueError("a batch with omics_packed needs omic_sizes")
    return list(torch.split(batch["omics_packed"], [int(s) for s in omic_sizes], dim=1))


def make_train_step(
    model: nn.Module, loss_name: str, optimizer: OptimizerSpec, *,
    alpha: float = 0.75, l1_lambda: float = 0.0, patch_budget: Optional[int] = 262_144,
    ge_mode: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    patch_dropout: float = 0.0,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, StepMetrics]]:
    """``step(state, batch) -> (state, metrics)``. Batch fields (tensors on
    the model's device): wsi [B, M, D], mask [B, M] bool, omics (list of
    [B, s_i]; or omics_packed [B, sum(s_i)], split by ``omic_sizes``), label
    [B], censorship [B], weight [B] (0 for filler rows), survival_months [B]
    (cox only).

    ``ge_mode`` trains the WSI-only GE-NaCAGaT: the batch holds wsi, mask,
    label and weight only, the model is called without omics, the loss is
    ``ce`` on its class probabilities (other names raise), and the metrics'
    ``attn_loss`` is 0 and ``risk`` zeros.

    ``l1_lambda`` > 0 adds the L1 penalty as the JAX step does: its
    gradient scaled by the batch's weight mass (the reference backwards it
    once per sample), the reported loss plus lambda * reg once. The L1
    gradient at a zero weight is +lambda, as JAX differentiates |w|.

    ``patch_dropout`` > 0 hides that share of each bag's real patches from
    the chunk's forward (a fresh draw per chunk from the state's generator);
    a bag whose real patches were all hidden keeps its full mask."""
    # cesar needs only the penalty, not the map: "ssq" keeps the model on the
    # fused kernels
    need_attention = "ssq" if loss_name == "cesar" else False
    if ge_mode and loss_name != "ce":
        raise NotImplementedError(f"GE-NaCAGaT trains with the ce loss, not {loss_name!r}")

    def step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, StepMetrics]:
        model.train()
        wsi = batch["wsi"]
        b, m_len = wsi.shape[0], wsi.shape[1]
        accum = accumulation_chunks(b, m_len, patch_budget, loss_name)
        chunk = b // accum
        params = list(model.parameters())
        for p in params:
            p.grad = None
        months = batch.get("survival_months")
        omics = None if ge_mode else _unpack_omics(batch, omic_sizes)
        zero = torch.zeros((), device=wsi.device)
        loss_sum, attn_sum, w_sum, risks = zero, zero, zero, []
        for i in range(accum):
            sl = slice(i * chunk, (i + 1) * chunk)
            weight = batch["weight"][sl]
            mask = batch["mask"][sl]
            if patch_dropout:
                mask = drop_patches(mask, patch_dropout, state.generator)
            if ge_mode:
                y, _ = model(wsi[sl], mask, generator=state.generator)
                loss = cross_entropy_on_probs(y, batch["label"][sl], sample_weight=weight)
                attn_loss, risk = zero, torch.zeros(chunk, device=wsi.device)
            else:
                out = model(wsi[sl], [o[sl] for o in omics], mask,
                            need_attention=need_attention, generator=state.generator)
                loss, attn_loss = survival_loss(
                    loss_name, out, batch["label"][sl], batch["censorship"][sl], alpha, weight,
                    None if months is None else months[sl],
                )
                risk = -out.survs.detach().sum(dim=1)
            w_i = weight.sum()
            (loss * w_i).backward()  # scaled by the chunk's weight mass
            loss_sum = loss_sum + (loss * w_i).detach()
            attn_sum = attn_sum + (attn_loss * w_i).detach()
            w_sum = w_sum + w_i
            risks.append(risk)
        w_sum = torch.clamp(w_sum, min=1.0)
        loss, attn_loss = loss_sum / w_sum, attn_sum / w_sum
        with torch.no_grad():
            for p in params:
                if p.grad is None:  # unused by this batch: a zero gradient, as in JAX
                    p.grad = torch.zeros_like(p)
            torch._foreach_div_([p.grad for p in params], w_sum)
            if l1_lambda > 0.0:
                reg = sum(p.abs().sum() for p in params)
                for p in params:
                    p.grad.add_(torch.where(p >= 0, 1.0, -1.0) * (l1_lambda * w_sum))
                loss = loss + l1_lambda * reg
        optimizer.update(state.optimizer)
        metrics = StepMetrics(loss=loss, attn_loss=attn_loss, risk=torch.cat(risks),
                              n_real=batch["weight"].sum())
        return TrainState(state.optimizer, state.generator, state.step + 1), metrics

    return step


def drop_patches(mask: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """``mask`` [B, M] bool with a ``rate`` share of its True entries drawn
    to False (uniform bits from ``generator``); a row left without a True
    entry keeps its full mask (an all-masked bag would empty its softmax)."""
    keep = torch.rand(mask.shape, generator=generator, device=mask.device) >= rate
    dropped = mask & keep
    return torch.where(dropped.any(dim=1, keepdim=True), dropped, mask)


def _gather_batch(cache: Dict[str, torch.Tensor], meta: Dict[str, Any],
                  ge_mode: bool) -> Dict[str, Any]:
    """Assemble a batch on the cache's device from gathers over its rows:
    wsi by the row-gather kernel (``ops/gather.py``) at ``meta['pos']``
    (bucket-local), the mask at the same positions and the label / omics
    columns at ``meta['row']`` (dataset rows) by ``index_select``. Only the
    meta arrays (numpy or tensors) cross from the host."""
    dev = cache["wsi"].device
    pos, row = (torch.as_tensor(meta[k]).to(device=dev, dtype=torch.int64)
                for k in ("pos", "row"))
    batch = {
        "wsi": take_rows(cache["wsi"], pos),
        "mask": cache["mask"].index_select(0, pos),
        "weight": torch.as_tensor(meta["weight"], dtype=torch.float32).to(dev),
        "label": cache["label"].index_select(0, row),
    }
    if not ge_mode:
        for key in ("omics_packed", "censorship", "survival_months"):
            batch[key] = cache[key].index_select(0, row)
    return batch


def make_cached_train_step(
    model: nn.Module, loss_name: str, optimizer: OptimizerSpec, *,
    alpha: float = 0.75, l1_lambda: float = 0.0, patch_budget: Optional[int] = 262_144,
    ge_mode: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    patch_dropout: float = 0.0, multi: bool = False, mesh=None, int8_matmul: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor], Dict[str, Any]],
              Tuple[TrainState, StepMetrics]]:
    """Train step over a device-resident dataset cache
    (``data/device_cache.py``): ``step(state, cache, meta)`` with ``cache``
    one bucket's tensors (``DeviceBagCache.caches[bucket]``) and ``meta``
    the index arrays of ``build_meta``. The batch is assembled on the device
    (:func:`_gather_batch`); the step itself is :func:`make_train_step`'s,
    so a cached and a host-fed step on the same rows are the same
    computation. Survival models need ``omic_sizes`` (the packed table's
    column widths). ``multi``, ``mesh`` and ``int8_matmul`` are not ported."""
    for name, on in (("multi", multi), ("mesh", mesh is not None),
                     ("int8_matmul", int8_matmul)):
        if on:
            raise NotImplementedError(
                f"make_cached_train_step({name}=...) is not ported yet (ROADMAP queue 1)")
    if not ge_mode and omic_sizes is None:
        raise ValueError("the cached step of a survival model needs omic_sizes")
    inner = make_train_step(model, loss_name, optimizer, alpha=alpha, l1_lambda=l1_lambda,
                            patch_budget=patch_budget, ge_mode=ge_mode, omic_sizes=omic_sizes,
                            patch_dropout=patch_dropout)

    def step(state: TrainState, cache: Dict[str, torch.Tensor],
             meta: Dict[str, Any]) -> Tuple[TrainState, StepMetrics]:
        return inner(state, _gather_batch(cache, meta, ge_mode))

    return step


def make_eval_step(
    model: nn.Module, loss_name: str, *, alpha: float = 0.75, ge_mode: bool = False,
    need_attention: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    l1_lambda: float = 0.0, cached: bool = False,
) -> Callable[..., Dict[str, Any]]:
    """The no-grad eval step of validation and serving: a deterministic
    forward (the model in eval mode) and the loss, under
    ``torch.inference_mode()`` (the MIL-pool kernel of GE's eval forward
    refuses a call autograd would differentiate).

    ``step(batch)`` takes a host-fed batch of device tensors (the fields of
    :func:`make_train_step`); with ``cached=True``, ``step(cache, meta)``
    assembles it on the device from a bucket of a ``DeviceBagCache``.
    Survival models return loss, attn_loss, risk = -sum(survs), hazards,
    survs, y, the attention dict (requested for ``cesar``, whose loss reads
    the map, or with ``need_attention``; else None) and n_real; GE-NaCAGaT
    (``ce`` only) returns loss, y, its attention dict (the raw MIL scores
    under 'path') and n_real. ``l1_lambda`` > 0 adds lambda * sum |w| to the
    loss, as the reference adds it to every validation sample's loss."""
    want_attn = bool(need_attention) or loss_name == "cesar"
    if ge_mode and loss_name != "ce":
        raise NotImplementedError(f"GE-NaCAGaT evaluates with the ce loss, not {loss_name!r}")
    if cached and not ge_mode and omic_sizes is None:
        raise ValueError("the cached step of a survival model needs omic_sizes")

    @torch.inference_mode()
    def step(batch: Dict[str, Any], meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if cached:
            batch = _gather_batch(batch, meta, ge_mode)
        model.eval()
        weight = batch["weight"]
        reg = l1_lambda * l1_reg(model.parameters()) if l1_lambda > 0.0 else 0.0
        if ge_mode:
            y, attn = model(batch["wsi"], batch["mask"])
            return {
                "loss": cross_entropy_on_probs(y, batch["label"], sample_weight=weight) + reg,
                "y": y,
                "attention": attn,
                "n_real": weight.sum(),
            }
        out = model(batch["wsi"], _unpack_omics(batch, omic_sizes), batch["mask"],
                    need_attention=want_attn)
        loss, attn_loss = survival_loss(loss_name, out, batch["label"], batch["censorship"],
                                        alpha, weight, batch.get("survival_months"))
        return {
            "loss": loss + reg,
            "attn_loss": attn_loss,
            "risk": -out.survs.sum(dim=1),
            "hazards": out.hazards,
            "survs": out.survs,
            "y": out.y,
            "attention": out.attention if want_attn else None,
            "n_real": weight.sum(),
        }

    return step


def mc_generator(device, mc_seed: int, fold: int = 0) -> torch.Generator:
    """The dropout generator of one MC-dropout call: on ``device``, seeded
    from ``(mc_seed, fold)`` through numpy's ``SeedSequence`` (``fold`` is a
    batch's index within a dataset scan, so batches draw independent masks;
    both must be >= 0)."""
    seed = np.random.SeedSequence([int(mc_seed), int(fold)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def make_mc_eval_step(
    model: nn.Module, n_samples: int, *, ge_mode: bool = False,
    omic_sizes: Optional[Sequence[int]] = None,
) -> Callable[[Dict[str, Any], torch.Generator], Dict[str, torch.Tensor]]:
    """Monte-Carlo-dropout predictive uncertainty (Gal & Ghahramani 2016):
    ``mc_step(batch, generator)`` runs ``n_samples`` training-mode forwards
    (every dropout site live, ``need_attention=False``) under
    ``torch.inference_mode()``, each drawing its dropout from ``generator``
    (see :func:`mc_generator`), one after another, so memory stays at one
    batch's forward. Returns the predictive mean and population standard
    deviation (``jnp.std``'s): ``y_mean`` / ``y_std`` and, for survival
    models, ``risk_mean`` / ``risk_std`` (risk = -sum(survs)),
    ``hazards_mean``, ``survs_mean`` / ``survs_std``. The batch is that of
    :func:`make_eval_step`. On the GPU a survival forward runs the fuse-K
    training form (its dropout seed drawn from ``generator``); GE's forwards
    take the MIL pool's eager branch (the pool kernel is eval-only) and the
    flash forward. The model is left in eval mode."""
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")

    @torch.inference_mode()
    def mc_step(batch: Dict[str, Any], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        cols = {"y": [], "hazards": [], "survs": [], "risk": []}
        model.train()
        try:
            for _ in range(n_samples):
                if ge_mode:
                    y, _ = model(batch["wsi"], batch["mask"], generator=generator)
                    cols["y"].append(y)
                    continue
                out = model(batch["wsi"], _unpack_omics(batch, omic_sizes), batch["mask"],
                            need_attention=False, generator=generator)
                cols["y"].append(out.y)
                cols["hazards"].append(out.hazards)
                cols["survs"].append(out.survs)
                cols["risk"].append(-out.survs.sum(dim=1))
        finally:
            model.eval()
        stacked = {k: torch.stack(v) for k, v in cols.items() if v}
        res = {"y_mean": stacked["y"].mean(dim=0), "y_std": stacked["y"].std(dim=0, correction=0)}
        if not ge_mode:
            res.update(
                risk_mean=stacked["risk"].mean(dim=0),
                risk_std=stacked["risk"].std(dim=0, correction=0),
                hazards_mean=stacked["hazards"].mean(dim=0),
                survs_mean=stacked["survs"].mean(dim=0),
                survs_std=stacked["survs"].std(dim=0, correction=0),
            )
        return res

    return mc_step
