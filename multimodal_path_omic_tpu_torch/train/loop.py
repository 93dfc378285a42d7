"""Train steps (``multimodal_path_omic_tpu/train/loop.py``): one optimizer
update per batched, bucketed step on a single device, host-fed
(:func:`make_train_step`) or assembled on the device from a resident bag
cache (:func:`make_cached_train_step`).

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
co-attention kernel's int32 seed (one per chunk), come from it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_path_omic_tpu_torch.ops.gather import take_rows
from multimodal_path_omic_tpu_torch.ops.losses import cross_entropy_on_probs, survival_loss
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
    gradient at a zero weight is +lambda, as JAX differentiates |w|."""
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
            if ge_mode:
                y, _ = model(wsi[sl], batch["mask"][sl], generator=state.generator)
                loss = cross_entropy_on_probs(y, batch["label"][sl], sample_weight=weight)
                attn_loss, risk = zero, torch.zeros(chunk, device=wsi.device)
            else:
                out = model(wsi[sl], [o[sl] for o in omics], batch["mask"][sl],
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
    multi: bool = False, mesh=None, int8_matmul: bool = False,
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
                            patch_budget=patch_budget, ge_mode=ge_mode, omic_sizes=omic_sizes)

    def step(state: TrainState, cache: Dict[str, torch.Tensor],
             meta: Dict[str, Any]) -> Tuple[TrainState, StepMetrics]:
        return inner(state, _gather_batch(cache, meta, ge_mode))

    return step
