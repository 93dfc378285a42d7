"""Train and eval steps (``multimodal_path_omic_tpu/train/loop.py``): one
optimizer update per batched, bucketed step on a single device, host-fed
(:func:`make_train_step`) or assembled on the device from a resident bag
cache (:func:`make_cached_train_step`); the no-grad eval step of validation
and serving (:func:`make_eval_step`), host-fed or cached; the MC-dropout
step of serving (:func:`make_mc_eval_step`); the multi-step forms of the
JAX package (:func:`make_multi_train_step`, ``make_cached_train_step(
multi=True)``, :func:`make_multi_eval_step`, :func:`stack_batches`): K steps
over inputs with a leading [K, ...] axis, exactly K single steps.

On the card every step runs through ``train/graphs.py``: the first call at a
batch shape runs eagerly and captures a CUDA graph, later calls replay it
(``graphs=True``, the default: the step's own :class:`StepGraphs`; a
:class:`StepGraphs` to share one pool between steps; ``graphs=False``: the
eager step). A multi-step replays the single step's graph K times, each
replay fed by a device-to-device copy from the stacked inputs. On the CPU
every step is eager and a multi-step loops over the eager step.

A full effective batch is processed in one step. When B * M exceeds
``patch_budget`` the step runs the batch in gradient-accumulation chunks
(the largest divisor of B whose chunk fits), each chunk's loss scaled by its
weight mass, and divides the summed gradients by the batch's total weight
mass before the one optimizer update: the same gradient as the one-chunk
step. ``cox`` always takes the whole batch (its risk sets span it; on a
mesh the global batch: each rank's risks, months and weights all-gathered
over the data group inside the loss, ``ops/losses.py::cox_survival``).

Unlike the JAX step, which is pure, this one updates the model's parameters
and the optimizer state in place (``TrainState`` carries the objects and a
step count). Dropout draws from the state's ``torch.Generator`` on the
model's device, seeded once: every dropout mask of a step, and the
co-attention kernel's int32 seed (one per chunk), come from it, as do the
``patch_dropout`` draws. Those differ from the JAX step's draw for draw
(another generator), as every dropout mask does.

Reduced precision: a batch whose wsi is int8 carries its row scales
(``wsi_scale``, ``data/quant.py``) and is dequantized inside the step,
straight to the model's compute dtype (:func:`dequant_wsi`); with
``int8_matmul`` a training step keeps the int8 wsi into the WSI encoder's
first layer (``ops/layers.py::w8a8_linear``). Eval always dequantizes. A
bfloat16 wsi goes to the model as it is (its first layer casts it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from multimodal_path_omic_tpu_torch.data.quant import dequantize
from multimodal_path_omic_tpu_torch.ops.gather import take_rows, take_rows_sharded
from multimodal_path_omic_tpu_torch.ops.layers import ShardedDraws, compute_dtype_of, draw
from multimodal_path_omic_tpu_torch.ops.remat import scope as remat_scope
from multimodal_path_omic_tpu_torch.ops.losses import (
    cross_entropy_on_probs,
    l1_reg,
    survival_loss,
)
from multimodal_path_omic_tpu_torch.train.graphs import StepGraphs
from multimodal_path_omic_tpu_torch.train.graphs import resolve as resolve_graphs
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


def dequant_wsi(batch: Dict[str, Any], dtype: Optional[torch.dtype] = None
                ) -> Dict[str, Any]:
    """The batch with an int8 wsi dequantized by its ``wsi_scale``, straight
    to ``dtype`` (the model's compute dtype: q in [-127, 127] is exact in
    bfloat16, and the product rounds once), ``wsi_scale`` dropped; a float
    batch as it is (JAX ``_dequant_wsi``)."""
    if "wsi_scale" not in batch:
        return batch
    batch = dict(batch)
    batch["wsi"] = dequantize(batch["wsi"], batch.pop("wsi_scale"), dtype)
    return batch


def _graphs_for(graphs: Union[bool, StepGraphs], mesh=None) -> Callable[[torch.device], Any]:
    """The step's :class:`StepGraphs` on a device (None: eager), resolved
    once per device on first use. A mesh over gloo runs eagerly (a gloo
    collective cannot be captured; the Trainer says so once); under NCCL the
    step's collectives are captured with it."""
    by_device: Dict[torch.device, Any] = {}
    if mesh is not None and mesh.backend == "gloo":
        graphs = False

    def get(device: torch.device):
        if device not in by_device:
            by_device[device] = resolve_graphs(graphs, device)
        return by_device[device]

    return get


def _check_mesh(mesh) -> None:
    """``mesh`` is None or a ``parallel.mesh.Mesh``."""
    if mesh is None:
        return
    from multimodal_path_omic_tpu_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")


def _rows_group(mesh):
    """The group the batch rows split over (the cox loss's risk sets span
    it): the mesh's data group, or None."""
    return None if mesh is None else mesh.data_group


def _gathered(x: torch.Tensor, mesh) -> torch.Tensor:
    """A per-row output of this rank's rows as the global batch's (the data
    group's rows in order; identical on every rank)."""
    from multimodal_path_omic_tpu_torch.parallel import comm

    return x if mesh is None else comm.all_gather(x.contiguous(), mesh.data_group, 0)


def _summed(x: torch.Tensor, mesh) -> torch.Tensor:
    from multimodal_path_omic_tpu_torch.parallel import comm

    return x if mesh is None else comm.all_reduce(x, mesh.data_group)


def make_train_step(
    model: nn.Module, loss_name: str, optimizer: OptimizerSpec, *,
    alpha: float = 0.75, l1_lambda: float = 0.0, patch_budget: Optional[int] = 262_144,
    ge_mode: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    patch_dropout: float = 0.0, int8_matmul: bool = False,
    graphs: Union[bool, StepGraphs] = True, mesh=None, remat: bool = False,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, StepMetrics]]:
    """``step(state, batch) -> (state, metrics)``, graphed on the card
    (``graphs``, see the module doc). Batch fields (tensors on
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
    a bag whose real patches were all hidden keeps its full mask.

    An int8 wsi with its ``wsi_scale`` [B, M] is dequantized in the step
    (:func:`dequant_wsi`); ``int8_matmul`` keeps it int8 into the first
    layer instead (``tpu.int8_matmul``).

    ``remat`` (``tpu.remat``): the backward recomputes the tagged patch-axis
    activations instead of keeping them (``ops/remat.py``); the gradients
    and the generator's state are those of the step without it, bit for
    bit.

    ``mesh`` (``parallel/mesh.py``): the batch holds this rank's rows and
    patches, and the step gives every rank the one-device step's
    per-parameter gradients (:func:`_train_fn`: the gradient rule); its
    metrics are the global batch's (risk all-gathered over the data
    group). ``cox`` builds each row's risk set over the global batch
    (``losses.cox_survival`` with the data group): each rank
    back-propagates its own rows' terms, so the gradient sum over the world
    counts every term once."""
    _check_mesh(mesh)
    eager = _train_fn(model, loss_name, optimizer, alpha=alpha, l1_lambda=l1_lambda,
                      patch_budget=patch_budget, ge_mode=ge_mode, omic_sizes=omic_sizes,
                      patch_dropout=patch_dropout, int8_matmul=int8_matmul, mesh=mesh,
                      remat=remat)
    get_graphs = _graphs_for(graphs, mesh)

    def step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, StepMetrics]:
        g = get_graphs(batch["wsi"].device)
        if g is None:
            return eager(state, batch)
        metrics = g.run("train", lambda b: eager(state, b)[1], batch,
                        generators=(state.generator,), keep=(eager, state.optimizer))
        return state._replace(step=state.step + 1), metrics

    return step


def _train_fn(model: nn.Module, loss_name: str, optimizer: OptimizerSpec, *, alpha: float,
              l1_lambda: float, patch_budget: Optional[int], ge_mode: bool,
              omic_sizes: Optional[Sequence[int]], patch_dropout: float,
              int8_matmul: bool = False, mesh=None, remat: bool = False):
    """The eager train step of :func:`make_train_step`.

    On a mesh the gradient rule is the JAX step's. Every dropout draw is
    the global batch's, sliced (``layers.ShardedDraws``), and the kernels'
    dropout counters take global bag and key indices, so a rank drops what
    the one-device step drops for its rows (where that step runs its batch
    in one chunk). Each chunk back-propagates its weighted loss over the
    seq axis' size: every seq rank holds the same loss after the merges,
    and a merge's backward sums its incoming gradients over the seq group
    (``parallel/comm.py``), so the parameters before a merge (the WSI
    encoder, the k / v projections) get partial gradients and those after
    it replicated shares. The gradients then sum over the whole world (one
    all-reduce of one flat buffer; captured in the step's graph under
    NCCL) and divide by the global weight mass, the data group's sum; the
    L1 term is added once, after the sum; clipping and decay act on the
    synchronized gradient (the optimizer)."""
    seq = mesh.seq if mesh is not None else 1
    # cesar needs only the penalty, not the map: "ssq" keeps the model on the
    # fused kernels
    need_attention = "ssq" if loss_name == "cesar" else False
    if ge_mode and loss_name != "ce":
        raise NotImplementedError(f"GE-NaCAGaT trains with the ce loss, not {loss_name!r}")

    def step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, StepMetrics]:
        model.train()
        gen = state.generator if mesh is None else ShardedDraws(state.generator, mesh)
        if not int8_matmul:
            batch = dequant_wsi(batch, compute_dtype_of(model))
        wsi, wsi_scale = batch["wsi"], batch.get("wsi_scale")
        b, m_len = wsi.shape[0], wsi.shape[1]
        accum = accumulation_chunks(b, m_len, patch_budget, loss_name)
        chunk = b // accum
        params = list(model.parameters())
        # zeroed in place, not dropped: a graph's gradients then stay in the
        # tensors the first (eager) step made, outside the graphs' pool
        grads = [p.grad for p in params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)
        months = batch.get("survival_months")
        omics = None if ge_mode else _unpack_omics(batch, omic_sizes)
        zero = torch.zeros((), device=wsi.device)
        loss_sum, attn_sum, w_sum, risks = zero, zero, zero, []
        for i in range(accum):
            sl = slice(i * chunk, (i + 1) * chunk)
            weight = batch["weight"][sl]
            mask = batch["mask"][sl]
            if patch_dropout:
                mask = drop_patches(mask, patch_dropout, gen, mesh)
            scale = None if wsi_scale is None else wsi_scale[sl]
            with remat_scope(remat):  # the tagged activations: recomputed, not saved
                if ge_mode:
                    y, _ = model(wsi[sl], mask, generator=gen, wsi_scale=scale)
                    loss = cross_entropy_on_probs(y, batch["label"][sl], sample_weight=weight)
                    attn_loss, risk = zero, torch.zeros(chunk, device=wsi.device)
                else:
                    out = model(wsi[sl], [o[sl] for o in omics], mask,
                                need_attention=need_attention, generator=gen,
                                wsi_scale=scale)
                    loss, attn_loss = survival_loss(
                        loss_name, out, batch["label"][sl], batch["censorship"][sl], alpha,
                        weight, None if months is None else months[sl], _rows_group(mesh),
                    )
                    risk = -out.survs.detach().sum(dim=1)
            w_i = weight.sum()
            (loss * w_i / seq).backward()  # scaled by the chunk's weight mass
            loss_sum = loss_sum + (loss * w_i).detach()
            attn_sum = attn_sum + (attn_loss * w_i).detach()
            w_sum = w_sum + w_i
            risks.append(risk)
        with torch.no_grad():
            for p in params:
                if p.grad is None:  # unused by this batch: a zero gradient, as in JAX
                    p.grad = torch.zeros_like(p)
            if mesh is not None:
                _sync_grads(params, mesh)
                loss_sum, attn_sum, w_sum = _summed(torch.stack([loss_sum, attn_sum, w_sum]),
                                                    mesh).unbind(0)
            w_sum = torch.clamp(w_sum, min=1.0)
            loss, attn_loss = loss_sum / w_sum, attn_sum / w_sum
            torch._foreach_div_([p.grad for p in params], w_sum)
            if l1_lambda > 0.0:
                reg = sum(p.abs().sum() for p in params)
                for p in params:
                    p.grad.add_(torch.where(p >= 0, 1.0, -1.0) * (l1_lambda * w_sum))
                loss = loss + l1_lambda * reg
        optimizer.update(state.optimizer)
        metrics = StepMetrics(loss=loss, attn_loss=attn_loss,
                              risk=_gathered(torch.cat(risks), mesh),
                              n_real=_summed(batch["weight"].sum(), mesh))
        return TrainState(state.optimizer, state.generator, state.step + 1), metrics

    return step


def drop_patches(mask: torch.Tensor, rate: float, generator: torch.Generator,
                 mesh=None) -> torch.Tensor:
    """``mask`` [B, M] bool with a ``rate`` share of its True entries drawn
    to False (uniform bits from ``generator``); a row left without a True
    entry keeps its full mask (an all-masked bag would empty its softmax).
    On a mesh (``generator`` a ``layers.ShardedDraws``) the draw is the
    global batch's, sliced, and "a row left without a True entry" asks the
    whole row, over the seq group."""
    on_seq = mesh is not None and mesh.seq > 1
    keep = draw(generator, lambda s, g: torch.rand(s, generator=g, device=mask.device),
                mask.shape, 1 if on_seq else None) >= rate
    dropped = mask & keep
    left = dropped.any(dim=1, keepdim=True)
    if on_seq:
        from multimodal_path_omic_tpu_torch.parallel import comm

        left = comm.all_reduce(left.to(torch.int32), mesh.seq_group, "max") > 0
    return torch.where(left, dropped, mask)


def _sync_grads(params: Sequence[torch.Tensor], mesh) -> None:
    """Sum every parameter's gradient over the world: one all-reduce of one
    flat buffer, copied back in place."""
    from multimodal_path_omic_tpu_torch.parallel import comm

    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    comm.all_reduce_(flat, mesh.world)
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def _gather_batch(cache: Dict[str, torch.Tensor], meta: Dict[str, torch.Tensor],
                  ge_mode: bool, mesh=None) -> Dict[str, Any]:
    """Assemble a batch on the cache's device from gathers over its rows:
    wsi by the row-gather kernel (``ops/gather.py``) at ``meta['pos']``
    (bucket-local), the mask at the same positions and the label / omics
    columns at ``meta['row']`` (dataset rows) by ``index_select``. ``meta``
    holds device tensors (:func:`meta_on`): nothing crosses from the host
    inside the step. An int8 cache's ``wsi_scale`` rows come along at
    ``pos``.

    On a mesh the cache holds this rank's patch chunk of every bag
    (``parallel/mesh.py::cache_patches``) and ``meta`` the global batch's
    indices: the gather kernel runs on the local chunk for the whole batch
    (``gather.take_rows_sharded``), then one all-to-all per field moves
    each rank's rows and patches to it (``mesh.reshard_cache_rows``; JAX:
    the sharding constraint of ``loop.py:229-280``); the per-sample
    columns are this rank's rows."""
    if mesh is not None and mesh.size > 1:
        return _gather_sharded(cache, meta, ge_mode, mesh)
    pos, row = meta["pos"], meta["row"]
    batch = {
        "wsi": take_rows(cache["wsi"], pos),
        "mask": cache["mask"].index_select(0, pos),
        "weight": meta["weight"],
        "label": cache["label"].index_select(0, row),
    }
    if "wsi_scale" in cache:
        batch["wsi_scale"] = cache["wsi_scale"].index_select(0, pos)
    if not ge_mode:
        for key in ("omics_packed", "censorship", "survival_months"):
            batch[key] = cache[key].index_select(0, row)
    return batch


def _gather_sharded(cache, meta, ge_mode: bool, mesh) -> Dict[str, Any]:
    from multimodal_path_omic_tpu_torch.parallel.mesh import reshard_cache_rows

    pos = meta["pos"]
    rows = mesh.rows(pos.shape[0])
    row = meta["row"][rows]
    batch = {
        "wsi": reshard_cache_rows(take_rows_sharded(cache["wsi"], pos, mesh), mesh),
        "mask": reshard_cache_rows(cache["mask"].index_select(0, pos), mesh),
        "weight": meta["weight"][rows],
        "label": cache["label"].index_select(0, row),
    }
    if "wsi_scale" in cache:
        batch["wsi_scale"] = reshard_cache_rows(cache["wsi_scale"].index_select(0, pos), mesh)
    if not ge_mode:
        for key in ("omics_packed", "censorship", "survival_months"):
            batch[key] = cache[key].index_select(0, row)
    return batch


_META_TYPES = {"pos": torch.int64, "row": torch.int64, "weight": torch.float32}


def meta_on(meta: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """``build_meta``'s index arrays (numpy or tensors, [B] or stacked
    [K, B]) as device tensors: pos and row int64, weight float32. Host
    arrays cross through pinned memory, without blocking the host."""
    device = torch.device(device)
    out = {}
    for key, dtype in _META_TYPES.items():
        v = meta[key]
        if isinstance(v, torch.Tensor):
            out[key] = v.to(device=device, dtype=dtype)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
        out[key] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                    else t.to(device))
    return out


def make_cached_train_step(
    model: nn.Module, loss_name: str, optimizer: OptimizerSpec, *,
    alpha: float = 0.75, l1_lambda: float = 0.0, patch_budget: Optional[int] = 262_144,
    ge_mode: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    patch_dropout: float = 0.0, multi: bool = False, mesh=None, int8_matmul: bool = False,
    graphs: Union[bool, StepGraphs] = True, remat: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor], Dict[str, Any]],
              Tuple[TrainState, StepMetrics]]:
    """Train step over a device-resident dataset cache
    (``data/device_cache.py``): ``step(state, cache, meta)`` with ``cache``
    one bucket's tensors (``DeviceBagCache.caches[bucket]``) and ``meta``
    the index arrays of ``build_meta`` (host or device, :func:`meta_on`).
    The batch is assembled on the device (:func:`_gather_batch`); the step
    itself is :func:`make_train_step`'s, so a cached and a host-fed step on
    the same rows are the same computation. With ``multi`` the meta arrays
    carry a leading [K, ...] axis and one call runs K steps over the one
    cache, returning metrics with a leading K axis. Graphed on the card as
    :func:`make_train_step` (one graph per bucket's cache), the dequant of
    an int8 cache inside it (or, with ``int8_matmul``, the int8 first
    layer). Survival models need ``omic_sizes`` (the packed table's column
    widths). ``mesh``: the cache is this rank's slice of a sharded
    ``DeviceBagCache`` and ``meta`` the global batch's
    (:func:`_gather_batch`); the step is :func:`make_train_step`'s on a
    mesh."""
    _check_mesh(mesh)
    if not ge_mode and omic_sizes is None:
        raise ValueError("the cached step of a survival model needs omic_sizes")
    eager = _train_fn(model, loss_name, optimizer, alpha=alpha, l1_lambda=l1_lambda,
                      patch_budget=patch_budget, ge_mode=ge_mode, omic_sizes=omic_sizes,
                      patch_dropout=patch_dropout, int8_matmul=int8_matmul, mesh=mesh,
                      remat=remat)
    get_graphs = _graphs_for(graphs, mesh)

    def step(state: TrainState, cache: Dict[str, torch.Tensor],
             meta: Dict[str, Any]) -> Tuple[TrainState, StepMetrics]:
        meta = meta_on(meta, cache["wsi"].device)
        g = get_graphs(cache["wsi"].device)
        if g is None:
            return eager(state, _gather_batch(cache, meta, ge_mode, mesh))
        metrics = g.run("cached_train",
                        lambda m: eager(state, _gather_batch(cache, m, ge_mode, mesh))[1], meta,
                        generators=(state.generator,), keep=(eager, state.optimizer, cache))
        return state._replace(step=state.step + 1), metrics

    if not multi:
        return step
    repeated = multi_step_of(step)
    return lambda state, cache, stacked: repeated(state, cache,
                                                  meta_on(stacked, cache["wsi"].device))


def make_multi_train_step(
    model: nn.Module, loss_name: str, optimizer: OptimizerSpec, *,
    alpha: float = 0.75, l1_lambda: float = 0.0, patch_budget: Optional[int] = 262_144,
    ge_mode: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    patch_dropout: float = 0.0, int8_matmul: bool = False,
    graphs: Union[bool, StepGraphs] = True, mesh=None, remat: bool = False,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, StepMetrics]]:
    """``step(state, stacked) -> (state, metrics)``: K optimizer steps over
    a batch whose tensors (on the model's device) carry a leading [K, ...]
    axis (:func:`stack_batches`, then ``pipeline.to_device``); exactly K
    calls of :func:`make_train_step`'s step, the same generator chain.
    Metrics carry a leading K axis. ``mesh``: as :func:`make_train_step`."""
    return multi_step_of(make_train_step(
        model, loss_name, optimizer, alpha=alpha, l1_lambda=l1_lambda,
        patch_budget=patch_budget, ge_mode=ge_mode, omic_sizes=omic_sizes,
        patch_dropout=patch_dropout, int8_matmul=int8_matmul, graphs=graphs, mesh=mesh,
        remat=remat))


def multi_step_of(step: Callable) -> Callable:
    """K calls of ``step`` over the leading axis of its last argument:
    ``multi(*args)`` where ``args[-1]`` is a tree of [K, ...] tensors; a
    train step (first argument a :class:`TrainState`) threads the state and
    returns ``(state, stacked metrics)``, an eval step returns its stacked
    results. Every other argument passes through unchanged."""

    def multi(*args):
        *head, stacked = args
        k = int(pytree.tree_leaves(stacked)[0].shape[0])
        outs: List[Any] = []
        for i in range(k):
            one = pytree.tree_map(lambda t: t[i], stacked)
            if head and isinstance(head[0], TrainState):
                state, metrics = step(*head, one)
                head[0] = state
                outs.append(metrics)
            else:
                outs.append(step(*head, one))
        stacked_out = stack_results(outs)
        return (head[0], stacked_out) if head and isinstance(head[0], TrainState) else stacked_out

    return multi


def stack_results(outs: Sequence[Any]) -> Any:
    """Stack same-structured result trees (metrics, eval dicts; None leaves
    stay None) along a new leading axis."""
    flat = [pytree.tree_flatten(o) for o in outs]
    spec = flat[0][1]
    return pytree.tree_unflatten([None if col[0] is None else torch.stack(col)
                                  for col in zip(*(f[0] for f in flat))], spec)


def stack_batches(batches: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack same-shaped host batches into one [K, ...] batch dict (numpy):
    the fields of one batch with a leading K axis (omics element-wise),
    without 'bucket', 'n_real' and 'aliased'."""
    out: Dict[str, Any] = {}
    for k in batches[0]:
        if k in ("bucket", "n_real", "aliased"):
            continue
        if k == "omics":
            out[k] = [np.stack([np.asarray(b[k][i]) for b in batches])
                      for i in range(len(batches[0][k]))]
        else:
            out[k] = np.stack([np.asarray(b[k]) for b in batches])
    return out


def make_eval_step(
    model: nn.Module, loss_name: str, *, alpha: float = 0.75, ge_mode: bool = False,
    need_attention: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    l1_lambda: float = 0.0, cached: bool = False, graphs: Union[bool, StepGraphs] = True,
    mesh=None,
) -> Callable[..., Dict[str, Any]]:
    """The no-grad eval step of validation and serving: a deterministic
    forward (the model in eval mode) and the loss, under
    ``torch.inference_mode()`` (the MIL-pool kernel of GE's eval forward
    refuses a call autograd would differentiate). Graphed on the card as
    :func:`make_train_step` (one graph per batch shape, and per cache).

    ``step(batch)`` takes a host-fed batch of device tensors (the fields of
    :func:`make_train_step`); with ``cached=True``, ``step(cache, meta)``
    assembles it on the device from a bucket of a ``DeviceBagCache``
    (``meta`` host or device arrays, :func:`meta_on`).
    Survival models return loss, attn_loss, risk = -sum(survs), hazards,
    survs, y, the attention dict (requested for ``cesar``, whose loss reads
    the map, or with ``need_attention``; else None) and n_real; GE-NaCAGaT
    (``ce`` only) returns loss, y, its attention dict (the raw MIL scores
    under 'path') and n_real. ``l1_lambda`` > 0 adds lambda * sum |w| to the
    loss, as the reference adds it to every validation sample's loss.

    ``mesh``: the batch (or the cache and its global meta) is this rank's,
    as in the train steps; the results are the global batch's on every
    rank: the loss over the data group's weight mass (``cox``: each row
    against its risk set in the global batch), per-row outputs all-gathered
    in row order. Attention, where the one-device step returns it (GE
    always, its raw MIL scores; the survival models with ``need_attention``):
    the maps of the global batch, their rows all-gathered over the data
    group and, on a seq axis, their patch columns over the seq group inside
    the model (the co-attention's export passes run per rank on merged
    statistics, ``parallel/ring.py::sequence_parallel_export``; GE gathers
    its pool's scores); ``cesar`` without ``need_attention`` reads the
    merged ssq, and its attention is None."""
    _check_mesh(mesh)
    want_attn = bool(need_attention) or loss_name == "cesar"
    model_attn = ("ssq" if mesh is not None and want_attn and not need_attention
                  else want_attn)
    attn_out = need_attention if mesh is not None else want_attn
    if ge_mode and loss_name != "ce":
        raise NotImplementedError(f"GE-NaCAGaT evaluates with the ce loss, not {loss_name!r}")
    if cached and not ge_mode and omic_sizes is None:
        raise ValueError("the cached step of a survival model needs omic_sizes")

    get_graphs = _graphs_for(graphs, mesh)

    def step(batch: Dict[str, Any], meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        dev = batch["wsi"].device
        g = get_graphs(dev)
        if cached:
            meta = meta_on(meta, dev)
            if g is None:
                return eager(_gather_batch(batch, meta, ge_mode, mesh))
            return g.run("cached_eval", lambda m: eager(_gather_batch(batch, m, ge_mode, mesh)),
                         meta,
                         keep=(eager, batch))
        if g is None:
            return eager(batch)
        return g.run("eval", eager, batch, keep=(eager,))

    @torch.inference_mode()
    def eager(batch: Dict[str, Any]) -> Dict[str, Any]:
        model.eval()
        batch = dequant_wsi(batch, compute_dtype_of(model))
        weight = batch["weight"]
        reg = l1_lambda * l1_reg(model.parameters()) if l1_lambda > 0.0 else 0.0
        if ge_mode:
            y, attn = model(batch["wsi"], batch["mask"])
            loss = cross_entropy_on_probs(y, batch["label"], sample_weight=weight)
            if mesh is not None:
                (loss,), y = _global_means([loss], weight, mesh), _gathered(y, mesh)
                attn = _gathered_maps(attn, mesh)
            return {"loss": loss + reg, "y": y, "attention": attn,
                    "n_real": _summed(weight.sum(), mesh)}
        out = model(batch["wsi"], _unpack_omics(batch, omic_sizes), batch["mask"],
                    need_attention=model_attn)
        loss, attn_loss = survival_loss(loss_name, out, batch["label"], batch["censorship"],
                                        alpha, weight, batch.get("survival_months"),
                                        _rows_group(mesh))
        if mesh is not None:
            loss, attn_loss = _global_means([loss, attn_loss], weight, mesh)
        return {
            "loss": loss + reg,
            "attn_loss": attn_loss,
            "risk": _gathered(-out.survs.sum(dim=1), mesh),
            "hazards": _gathered(out.hazards, mesh),
            "survs": _gathered(out.survs, mesh),
            "y": _gathered(out.y, mesh),
            "attention": _gathered_maps(out.attention, mesh) if attn_out else None,
            "n_real": _summed(weight.sum(), mesh),
        }

    return step


def _gathered_maps(attention: Dict[str, Any], mesh) -> Dict[str, Any]:
    """An attention dict with every map's rows all-gathered over the data
    group (None entries kept)."""
    if mesh is None:
        return attention
    return {k: None if v is None else _gathered(v, mesh) for k, v in attention.items()}


def _global_means(means: Sequence[torch.Tensor], weight: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Weighted means over this rank's rows (``losses._wmean``: the weighted
    sum over max(mass, 1)) as the global batch's: the sums and the masses
    summed over the data group."""
    w = weight.sum()
    tot = _summed(torch.stack([m * w for m in means] + [w]), mesh)
    return list((tot[:-1] / torch.clamp(tot[-1], min=1.0)).unbind(0))


def make_multi_eval_step(
    model: nn.Module, loss_name: str, *, alpha: float = 0.75, ge_mode: bool = False,
    need_attention: bool = False, omic_sizes: Optional[Sequence[int]] = None,
    l1_lambda: float = 0.0, cached: bool = False, graphs: Union[bool, StepGraphs] = True,
    mesh=None,
) -> Callable[..., Dict[str, Any]]:
    """K eval batches in one call: ``multi(stacked)`` over a batch whose
    tensors carry a leading [K, ...] axis, or with ``cached=True``
    ``multi(cache, stacked_meta)``; exactly K calls of
    :func:`make_eval_step`'s step (eval carries no state). Result leaves
    carry the leading K axis."""
    repeated = multi_step_of(make_eval_step(
        model, loss_name, alpha=alpha, ge_mode=ge_mode, need_attention=need_attention,
        omic_sizes=omic_sizes, l1_lambda=l1_lambda, cached=cached, graphs=graphs, mesh=mesh))
    if not cached:
        return repeated
    return lambda cache, stacked: repeated(cache, meta_on(stacked, cache["wsi"].device))


def mc_generator(device, mc_seed: int, fold: int = 0) -> torch.Generator:
    """The dropout generator of one MC-dropout call: on ``device``, seeded
    from ``(mc_seed, fold)`` through numpy's ``SeedSequence`` (``fold`` is a
    batch's index within a dataset scan, so batches draw independent masks;
    both must be >= 0)."""
    seed = np.random.SeedSequence([int(mc_seed), int(fold)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def make_mc_eval_step(
    model: nn.Module, n_samples: int, *, ge_mode: bool = False,
    omic_sizes: Optional[Sequence[int]] = None, mesh=None,
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
    flash forward. The model is left in eval mode. On a ``mesh`` the
    batch is this rank's, the draws the global batch's sliced
    (``layers.ShardedDraws``) and the results the global batch's
    (all-gathered over the data group)."""
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")

    @torch.inference_mode()
    def mc_step(batch: Dict[str, Any], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        cols = {"y": [], "hazards": [], "survs": [], "risk": []}
        if mesh is not None:
            generator = ShardedDraws(generator, mesh)
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
        stacked = {k: torch.stack([_gathered(t, mesh) for t in v]) for k, v in cols.items() if v}
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
