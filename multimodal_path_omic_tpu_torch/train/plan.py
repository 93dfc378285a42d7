"""Memory-fit planner: will a configuration fit the device before a long
run? (``multimodal_path_omic_tpu/train/plan.py``).

The reference answers it by running out of memory mid-epoch. The plan adds
up parameters, optimizer state and the device cache (per bucket, resident,
partial, against its budget: the Trainer's own ``plan_cache_fit``), and
each bucket's training step. JAX reads a step program's peak from an
ahead-of-time compile, which torch has no counterpart for; here, on the
card, each bucket's step runs once on a zero batch (twice: the first call
builds the kernels and the lazy optimizer state) between
``torch.cuda.reset_peak_memory_stats`` and ``max_memory_allocated``, eagerly
(no graph capture). A ``torch.OutOfMemoryError`` there is the plan's answer:
it does not fit. ``hbm_bytes`` is the card's ``total_memory``. On the CPU
the step peaks are None (``cpu_backend_note``).

The estimate is the resident cache (per device) plus the worst bucket's
step peak, which holds the parameters, the optimizer state and one batch.
The steps run on the Trainer's model; its parameters and optimizer state
are put back afterwards.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_H100_HBM = 80 * (1 << 30)  # assumed where the device reports none (the CPU)
# optimizer state tensors a parameter (train/optim.py's torch optimizers)
_OPT_SLOTS = {"sgd": 0, "rms": 1, "adadelta": 2, "adamax": 2, "adam": 2}


def _tensor_bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _zero_batch(trainer, bucket: int, dim: int) -> Dict[str, torch.Tensor]:
    """A host-fed step's batch of zeros on the device (``pipeline.device_arrays``'
    padded layout, in ``tpu.transfer_dtype``)."""
    dev, b = trainer.device, trainer.batch_size
    if trainer.mesh is not None:
        b, bucket = b // trainer.mesh.data, bucket // trainer.mesh.seq
    wsi_dtype = {"bfloat16": torch.bfloat16, "int8": torch.int8}.get(trainer.transfer_dtype,
                                                                    torch.float32)
    batch = {"wsi": torch.zeros((b, bucket, dim), dtype=wsi_dtype, device=dev),
             "mask": torch.ones((b, bucket), dtype=torch.bool, device=dev),
             "label": torch.zeros((b,), dtype=torch.int64, device=dev),
             "weight": torch.zeros((b,), device=dev)}
    if trainer.transfer_dtype == "int8":
        batch["wsi_scale"] = torch.ones((b, bucket), device=dev)
    if not trainer.ge_mode:
        batch["omics_packed"] = torch.zeros((b, int(sum(trainer.omic_sizes))), device=dev)
        batch["censorship"] = torch.zeros((b,), device=dev)
        batch["survival_months"] = torch.ones((b,), device=dev)
    return batch


def _step_peak(trainer, step, bucket: int, dim: int) -> Dict[str, Any]:
    """One bucket's step peak on the card: bytes allocated before the step
    (parameters, optimizer state, the batch: 'argument'), its peak, the
    peak's excess over the arguments ('temp') and what the step leaves
    allocated ('output')."""
    dev = trainer.device
    row: Dict[str, Any] = {"bucket": int(bucket)}
    try:
        batch = _zero_batch(trainer, bucket, dim)
        state = trainer.state
        state, _ = step(state, batch)  # kernel builds, lazy optimizer state
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        state, _ = step(state, batch)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        row.update(argument=int(before), output=int(torch.cuda.memory_allocated(dev) - before),
                   temp=int(peak - before), peak=int(peak))
        del batch
    except torch.OutOfMemoryError as e:
        row["error"] = f"OutOfMemoryError: {str(e).splitlines()[0]}"
    return row


def memory_plan(config, trainer=None) -> Dict[str, Any]:
    """The memory-fit report of ``config`` (a dict with the JAX plan's
    keys). Builds a Trainer (no epoch, no cache upload) unless one is
    passed."""
    from multimodal_path_omic_tpu_torch.data.bags import bucket_for
    from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache, plan_cache_fit
    from multimodal_path_omic_tpu_torch.train.loop import make_train_step

    if trainer is None:
        from multimodal_path_omic_tpu_torch.train.trainer import Trainer

        trainer = Trainer(config, verbose=False)
    c = trainer.config
    dev = trainer.device
    on_card = dev.type == "cuda"
    if on_card:
        hbm, hbm_assumed = int(torch.cuda.get_device_properties(dev).total_memory), False
        kind = torch.cuda.get_device_name(dev)
    else:
        hbm, hbm_assumed, kind = _H100_HBM, True, "cpu"

    params = list(trainer.model.parameters())
    params_b = _tensor_bytes(params)
    opt_b = _OPT_SLOTS.get(c.training.optimizer.lower() if c.training.optimizer else "adam",
                           2) * params_b

    # the device cache, by the Trainer's own budget fit (forced "on" and
    # partial caches included)
    lengths = trainer.train_batcher._bag_lengths()
    val_lengths = trainer.val_batcher._bag_lengths() if len(trainer.val_ds) else np.zeros(0)
    all_lengths = np.concatenate([lengths, val_lengths])
    dim = trainer.wsi_dim
    per_bucket = DeviceBagCache.bucket_bytes(all_lengths, trainer.buckets, dim,
                                             store_dtype=trainer.cache_dtype)
    cache_total = sum(per_bucket.values())
    n_mesh = 1 if trainer.mesh is None else int(trainer.mesh.size)
    budget = c.tpu.device_cache_budget_bytes  # a device's budget
    counts: Dict[int, int] = {}
    for m in all_lengths:
        b = bucket_for(int(m), trainer.buckets)
        counts[b] = counts.get(b, 0) + 1
    cache_wanted = trainer._want_device_cache
    cache_only, cache_resident, cache_engaged = (
        plan_cache_fit(per_bucket, counts, budget * n_mesh, forced=trainer._device_cache_forced)
        if cache_wanted else (None, 0, False))
    cache_per_device = cache_resident // n_mesh

    buckets_used = sorted(per_bucket) or list(trainer.buckets[:1])
    rows = []
    if on_card:
        step = make_train_step(trainer.model, c.training.loss, trainer.optimizer,
                               patch_dropout=c.training.patch_dropout,
                               int8_matmul=c.tpu.int8_matmul,
                               **{**trainer._step_kw, "graphs": False})
        saved_model = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        saved_opt = trainer.state.optimizer.state_dict()
        saved_gen = trainer.state.generator.get_state()
        try:
            for bucket in buckets_used:
                rows.append(_step_peak(trainer, step, bucket, dim))
                torch.cuda.empty_cache()
        finally:
            from multimodal_path_omic_tpu_torch.train.optim import load_state

            trainer.model.load_state_dict(saved_model)
            load_state(trainer.state.optimizer, saved_opt)
            trainer.state.generator.set_state(saved_gen)
            for p in trainer.model.parameters():
                p.grad = None
            if trainer.graphs is not None:
                trainer.graphs.reset()
    else:
        rows = [{"bucket": int(b), "argument": None, "output": None, "temp": None,
                 "peak": None} for b in buckets_used]

    oom = any("error" in r for r in rows)
    peak_step = max((r.get("peak") or 0 for r in rows), default=0)
    est_peak = cache_per_device + peak_step
    return {
        "backend": dev.type,
        "device_kind": kind,
        "hbm_bytes": hbm,
        "hbm_assumed": hbm_assumed,
        "params_bytes": params_b,
        "opt_state_bytes": int(opt_b),
        "n_bags": int(all_lengths.size),
        "cache_dtype": trainer.cache_dtype,
        "cache_bytes_per_bucket": {int(k): int(v) for k, v in per_bucket.items()},
        "cache_bytes_total": int(cache_total),
        "cache_resident_bytes": int(cache_resident),
        "cache_bytes_per_device": int(cache_per_device),
        "cache_wanted": bool(cache_wanted),
        "cache_engaged": bool(cache_engaged),
        "cache_partial_buckets": None if cache_only is None else [int(b) for b in cache_only],
        "cache_budget_bytes": int(budget),
        "cache_fits_budget": bool(cache_total <= budget * n_mesh),
        "n_mesh_devices": n_mesh,
        "batch_size": int(trainer.batch_size),
        "transfer_dtype": trainer.transfer_dtype,
        "step_programs": rows,
        "estimated_peak_bytes": int(est_peak),
        "fits": bool(est_peak <= hbm and not oom),
        "cpu_backend_note": not on_card,
    }


def _mib(n: Optional[int]) -> str:
    return "n/a" if n is None else f"{n / (1 << 20):,.1f} MiB"


def format_plan(plan: Dict[str, Any]) -> str:
    lines = []
    src = "assumed: an H100's" if plan["hbm_assumed"] else "the device's total_memory"
    lines.append(f"device: {plan['device_kind']} ({plan['backend']}), memory "
                 f"{_mib(plan['hbm_bytes'])} ({src})")
    lines.append(f"params {_mib(plan['params_bytes'])} + optimizer state "
                 f"{_mib(plan['opt_state_bytes'])}")
    mesh_note = (f" (/{plan['n_mesh_devices']} mesh devices = "
                 f"{_mib(plan['cache_bytes_per_device'])}/device)"
                 if plan["n_mesh_devices"] > 1 else "")
    fit = "fits" if plan["cache_fits_budget"] else "OVER"
    if not plan["cache_wanted"]:
        mode = "disabled in config: host feeding"
    elif not plan["cache_engaged"]:
        mode = "would NOT engage: host feeding"
    elif plan["cache_partial_buckets"] is not None:
        mode = (f"PARTIAL: buckets {plan['cache_partial_buckets']} resident "
                f"({_mib(plan['cache_resident_bytes'])}), overflow host-feeds")
    else:
        mode = "full cache resident"
    lines.append(f"device cache ({plan['cache_dtype']}, {plan['n_bags']} bags): "
                 f"{_mib(plan['cache_bytes_total'])}{mesh_note}; {fit} the "
                 f"{_mib(plan['cache_budget_bytes'])} budget; {mode}")
    lines.append(f"training steps (measured on the device, batch {plan['batch_size']}, "
                 f"{plan['transfer_dtype']} feed):")
    for r in plan["step_programs"]:
        if "error" in r:
            lines.append(f"  bucket {r['bucket']:>6}: {r['error']}")
        elif r["peak"] is None:
            lines.append(f"  bucket {r['bucket']:>6}: not measured (no GPU)")
        else:
            lines.append(f"  bucket {r['bucket']:>6}: peak {_mib(r['peak'])} (arguments "
                         f"{_mib(r['argument'])}, temp {_mib(r['temp'])}, output "
                         f"{_mib(r['output'])})")
    verdict = "FITS" if plan["fits"] else "DOES NOT FIT"
    lines.append(f"estimated peak (cache resident + worst step): "
                 f"{_mib(plan['estimated_peak_bytes'])} of {_mib(plan['hbm_bytes'])}: {verdict}")
    if plan["cpu_backend_note"]:
        lines.append("note: CPU run: the steps' peaks are measured only on a GPU")
    return "\n".join(lines)
