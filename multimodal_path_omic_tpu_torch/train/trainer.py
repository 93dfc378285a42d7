"""Trainer: the training entry point for every model family
(``multimodal_path_omic_tpu/train/trainer.py``).

The reference duplicates its epoch / train / validate / test / checkpoint
code across models/mcat/main.py, models/nacagat/main.py and
models/ge_nacagat/main.py. One Trainer drives them all:

* dataset build + seeded patient split (+ leave-one-out): mcat/main.py:239-252
* model build with ``omic_sizes = dataset.signature_sizes``: mcat/main.py:254-259
* loss / optimizer / scheduler: mcat/main.py:270-307
* epoch loop: train -> validate -> optional leave-one-out test with periodic
  attention export -> final validation: mcat/main.py:320-337
* checkpoints with the full state (weights, optimizer, dropout generator,
  epoch): mcat/main.py:88-100, 261-266, 309-312
* the censored c-index over per-sample risks: mcat/main.py:76-81

Batches are whole optimizer steps (bucketed, padded, masked). An epoch runs
in dispatch groups: up to ``tpu.steps_per_dispatch`` consecutive batches of
one bucket (0 = auto: 64, the JAX Trainer's), with leftovers down a (k, 8, 1)
ladder (:func:`_grouped`) and host-fed groups capped at 1 GiB of stacked bags
(:meth:`Trainer._host_k_cap`); a group is one multi-step call
(``train/loop.py::multi_step_of``), exactly its steps one by one. On the
card every step is a CUDA graph replay (``train/graphs.py``; one pool for
all of the Trainer's graphs). A host-fed group is read, padded and copied to
the device through pinned buffers on a copy stream (``pipeline.Stager``) in
a prefetch thread ``tpu.prefetch`` groups ahead, so the copies overlap the
steps; with ``tpu.device_cache`` engaged the cohort is uploaded once and
batches are gathered on the device (``data/device_cache.py``); a cohort that
fits ``tpu.device_cache_budget_bytes`` only in part caches the buckets that
fit and host-feeds the rest. An epoch's metrics stay on the device until one
fetch at its end (the per-50-steps print is the only sync inside an epoch);
``validated_epoch`` enqueues the training steps, then the validation steps,
then fetches both at once.

``Trainer(config, device=None, graphs=True)`` runs on the GPU;
``config.device == "cpu"`` or ``device="cpu"`` selects the CPU (the kernels'
plain versions, eager steps). "tpu", "cuda" and "gpu" all mean the GPU, and
without one the Trainer raises (``device.resolve_device``): it never drops
to the CPU on its own. ``graphs=False`` runs the eager steps on the card;
so does ``training.debug_nans`` (anomaly mode cannot be captured), saying so.

Reduced precision, as the JAX Trainer wires it: ``tpu.compute_dtype``
bfloat16 builds the model with that compute dtype (parameters and the
survival head stay float32; "auto" is float32 off a TPU,
``config.resolve_dtype``); ``tpu.transfer_dtype`` bfloat16 or int8 stages
the host-fed bags in that type (int8 with float32 row scales,
``pipeline.device_arrays``), ``tpu.cache_dtype`` stores the device cache in
it (and its budget fit counts that type's bytes), and the steps dequantize on
the device, or with ``tpu.int8_matmul`` keep an int8 batch int8 into the
first layer of a training step. Under bfloat16 NaCAGaT and MCAT run the
co-attention kernels' bfloat16 instances (``lean=False`` too: the plain-K
pair with values) and GE-NaCAGaT the flash kernels' at every size; a shape
whose float32 kernel has no bfloat16 instance (the eval fuse-K form at
E != F, which no shipped configuration reaches) raises on the card before
any launch (``kernels.takes``). ``wandb.enabled`` logs each
epoch's metrics to wandb as well (``train/logging.py``).

Multi-GPU, the JAX Trainer's mesh (``trainer.py:284-382``): with
``tpu.data_axis`` x ``tpu.seq_axis`` > 1 every rank (one process a GPU,
launched by torchrun; the world size must equal the mesh's) builds its
place in the mesh (``parallel/mesh.py``), the model with the mesh on its
patch-axis modules, the parameters broadcast from rank 0 and checked equal,
batchers that read only its slice of every batch (``host_slice``), the
sharded device cache (its budget per device) and the mesh steps, whose
metrics are the global batch's: the epoch's numbers are the same on every
rank. Rank 0 alone prints, logs and writes checkpoints; every rank restores
them. A mesh over gloo (CPU ranks, or several ranks on one card) runs the
steps eagerly, saying so once. Every loss runs on a mesh (``cox`` with its
risk sets over the global batch). The leave-one-out export
(``training.leave_one_out``, :meth:`Trainer.test`) runs on a seq axis, the
export passes per rank on merged statistics, and raises on a data axis > 1
where the JAX Trainer raises: its batch of one bag does not split over the
data axis. Several ranks without a mesh and a batch that does not split
over the data axis raise as well.

Settings the port cannot honour yet raise ``NotImplementedError``
(``config.require_supported``). A reference ``.pt`` checkpoint loads
through ``Trainer.load_torch_checkpoint`` (``utils/transplant.py``);
``Trainer.restore`` reads the port's own checkpoints only.
``tpu.use_native_pipeline`` reads a directory of ``.npy`` bags with the C++
loader (``data/native.py``) on a host with at least 2 CPUs, as the JAX
Trainer engages it: its pipeline fills pinned slots with each host-fed
batch's rows, the stager copies a slot to the device as it is, and the slot
returns to the ring once that copy has finished; the numbers are the Python
reader's, bit for bit. ``Trainer.bag_reader`` ("native" or "python") says
which reader runs, and the verbose log says why the Python one does (the
setting off, a store that is not ``.npy``, fewer than 2 CPUs, a header the
loader cannot parse); a loader that does not build raises. ``tpu.remat``
recomputes the large patch-axis activations in the backward instead of
saving them (``ops/remat.py``). These settings
only shape how the JAX package compiles and leave the numbers as they
are; they are read and have no effect here: ``matmul_precision`` (the port's float32 products are full float32,
``device.configure_precision``), ``prng_impl``, ``compilation_cache_dir``
and ``use_pallas`` (the port's kernel routes are chosen by their shape
predicates; on the CPU the plain versions run anyway).
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_path_omic_tpu_torch.config import (
    Config,
    load_config,
    require_supported,
    resolve_dtype,
)
from multimodal_path_omic_tpu_torch.data.bags import DEFAULT_BUCKETS, bucket_for
from multimodal_path_omic_tpu_torch.data.dataset import GeneExprDataset, MultimodalDataset
from multimodal_path_omic_tpu_torch.data.device_cache import (
    DeviceBagCache,
    build_meta,
    plan_cache_fit,
)
from multimodal_path_omic_tpu_torch.data.pipeline import (
    BucketBatcher,
    Stager,
    pad_plan_indices,
    gene_expr_extras,
    prefetch,
    survival_extras,
    to_device,
)
from multimodal_path_omic_tpu_torch.device import resolve_device
from multimodal_path_omic_tpu_torch.models import build_model, is_ge_model
from multimodal_path_omic_tpu_torch.parallel import comm
from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh, replicate
from multimodal_path_omic_tpu_torch.train import checkpoint as ckpt
from multimodal_path_omic_tpu_torch.train.graphs import StepGraphs
from multimodal_path_omic_tpu_torch.train.logging import MetricLogger, StepTimer
from multimodal_path_omic_tpu_torch.train.loop import (
    init_train_state,
    make_cached_train_step,
    make_eval_step,
    make_train_step,
    multi_step_of,
)
from multimodal_path_omic_tpu_torch.train.metrics import concordance_index_censored
from multimodal_path_omic_tpu_torch.train.optim import (
    current_lr,
    load_state,
    make_optimizer,
    schedule_lr,
    set_lr,
    step_exponential,
)
from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_


# auto steps_per_dispatch (the JAX Trainer's), and the cap on a host-fed
# group's stacked bags
_SPD_AUTO = 64
_SPD_STACK_BYTES = 1 << 30


def _c_index(censorship: np.ndarray, months: np.ndarray, risk: np.ndarray) -> float:
    try:
        return concordance_index_censored((1 - censorship).astype(bool), months, risk)[0]
    except ValueError:  # fewer than two samples, or no comparable pair
        return float("nan")


def _grouped(items, key_fn, K, k_fn=None):
    """Group consecutive items sharing ``key_fn(item)`` into runs of exactly
    k (k = ``k_fn(first)`` or K); leftovers flush down a fixed size ladder
    (k, 8, 1), so at most three group sizes exist per key (the JAX
    Trainer's, ``trainer.py:102-131``)."""

    def _flush(pend, k):
        for size in (8, 1):
            if size >= k:
                continue
            while len(pend) >= size:
                yield pend[:size]
                pend = pend[size:]
        for p in pend:
            yield [p]

    pend = []
    k_cur = K
    for it in items:
        if pend and key_fn(it) != key_fn(pend[0]):
            yield from _flush(pend, k_cur)
            pend = []
        if not pend:
            k_cur = k_fn(it) if k_fn is not None else K
        pend.append(it)
        if len(pend) >= k_cur:
            yield pend
            pend = []
    yield from _flush(pend, k_cur)


def _meta_arrays(meta) -> Dict[str, np.ndarray]:
    """``build_meta``'s arrays in the types the cached steps read."""
    return {"pos": np.asarray(meta["pos"], np.int64), "row": np.asarray(meta["row"], np.int64),
            "weight": np.asarray(meta["weight"], np.float32)}


def _fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """One device-to-host copy for a list of float32 tensors, split back
    into their shapes."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


class Trainer:
    mesh = None  # this rank's parallel.mesh.Mesh when tpu.data_axis x tpu.seq_axis > 1

    def __init__(self, config: Config, verbose: bool = True, device=None, graphs: bool = True,
                 split_rows=None):
        """``device``: None follows ``config.device`` (the GPU unless it is
        "cpu"). ``graphs``: on the GPU, run the steps as CUDA graphs
        (``train/graphs.py``); False runs them eagerly. ``split_rows``: a
        (train rows, validation rows) pair of row-index arrays in place of
        the config's seeded split (the folds of ``train/cv.py``); not with
        ``training.leave_one_out``, which defines its own split."""
        require_supported(config)
        c = self.config = config
        self.device = resolve_device(
            device if device is not None else ("cpu" if c.device == "cpu" else "cuda"))
        self.batch_size = c.tpu.batch_size or c.training.grad_acc_step
        self.mesh = self._make_mesh(verbose)
        if self.mesh is not None:
            self.device = self.mesh.device
        # rank 0 alone prints, logs and writes
        self.verbose = verbose and (self.mesh is None or self.mesh.rank == 0)
        verbose = self.verbose
        # CUDA graphs over every step, in one pool; anomaly mode (debug_nans)
        # and gloo collectives cannot be captured, so they take the eager
        # steps, openly
        self.graphs: Optional[StepGraphs] = None
        if self.device.type == "cuda" and graphs:
            if c.training.debug_nans:
                warnings.warn("training.debug_nans: anomaly mode cannot be captured in a CUDA "
                              "graph; the steps run eagerly")
            elif self.mesh is not None and self.mesh.backend == "gloo":
                warnings.warn("a mesh over gloo: its collectives cannot be captured in a CUDA "
                              "graph; the steps run eagerly")
            else:
                self.graphs = StepGraphs(self.device)
        self.ge_mode = is_ge_model(c.model.name)
        self.compute_dtype = resolve_dtype(c.tpu.compute_dtype)
        self.transfer_dtype = resolve_dtype(c.tpu.transfer_dtype)
        self.cache_dtype = resolve_dtype(c.tpu.cache_dtype)
        dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else None
        if self.ge_mode and c.training.loss != "ce":
            # the GE script's restriction (ge_nacagat/main.py:32-35)
            raise RuntimeError(f'Loss "{c.training.loss}" not implemented')
        self.leave_one_out = c.training.leave_one_out is not None

        # ----- dataset + splits (mcat/main.py:239-252) ---------------------
        if self.ge_mode:
            self.dataset = GeneExprDataset(c.dataset.file, c, gene=c.model.gene, verbose=verbose)
            self.extras_fn = gene_expr_extras
            self.omic_sizes: List[int] = []
        else:
            self.dataset = MultimodalDataset(c.dataset.file, c, use_signatures=True,
                                             verbose=verbose)
            self.extras_fn = survival_extras
            self.omic_sizes = list(self.dataset.signature_sizes)
        if split_rows is not None:
            if self.leave_one_out:
                raise ValueError("split_rows and training.leave_one_out are mutually exclusive: "
                                 "leave-one-out defines its own split")
            tr_rows, va_rows = (np.asarray(r) for r in split_rows)
            # --bug-compat reaches the subsets as it reaches table.split
            subset_kw = {("misalign_labels" if self.ge_mode else "misalign_signatures"):
                         c.training.bug_compat}
            table = self.dataset.table
            self.train_ds = self.dataset._with_table(table.subset(tr_rows, **subset_kw))
            self.val_ds = self.dataset._with_table(table.subset(va_rows, **subset_kw))
            self.test_ds = None
            if verbose:
                print(f"Using caller-provided split: {len(tr_rows)} train rows, "
                      f"{len(va_rows)} validation rows")
        else:
            if verbose:
                ts = int(c.training.train_size * 100)
                print(f"Using {ts}% train, {100 - ts}% validation")
            self.train_ds, self.val_ds, self.test_ds = self.dataset.split(
                c.training.train_size, test=self.leave_one_out,
                patient=c.training.leave_one_out or "", seed=c.training.seed,
                bug_compat=c.training.bug_compat)
        if verbose:
            print(f"Samples in train: {len(self.train_ds)}, "
                  f"Samples in validation: {len(self.val_ds)}")
            if self.test_ds is not None:
                print(f"Testing patient {c.training.leave_one_out}")

        self.buckets = tuple(c.tpu.bag_buckets) or DEFAULT_BUCKETS
        self.train_batcher = BucketBatcher(self.train_ds, self.extras_fn, self.batch_size,
                                           self.buckets, shuffle=True, seed=c.training.seed,
                                           host_slice=self.mesh)
        self.val_batcher = BucketBatcher(self.val_ds, self.extras_fn, self.batch_size,
                                         self.buckets, shuffle=False, host_slice=self.mesh)
        # the C++ bag reader (data/native.py) where the JAX Trainer engages its
        # pipeline (trainer.py:275-282): the setting, and at least 2 CPUs for
        # the workers to overlap the consumer
        native = bool(c.tpu.use_native_pipeline) and (os.cpu_count() or 1) >= 2
        self.train_batcher.use_native_pipeline = native
        self.val_batcher.use_native_pipeline = native
        self.bag_reader = self.train_batcher.reader if len(self.train_ds) else "python"
        if verbose:
            why = ("" if self.bag_reader == "native" else
                   " (tpu.use_native_pipeline is off)" if not c.tpu.use_native_pipeline else
                   " (fewer than 2 CPUs)" if not native else
                   f" ({self.train_batcher.reader_note})")
            print(f"Bag reader: {self.bag_reader}{why}")

        # ----- model, optimizer, steps (mcat/main.py:254-307) --------------
        self.wsi_dim = int(self.dataset.bag(0).shape[1]) if len(self.dataset) else 1024
        model = build_model(
            c.model.name, omic_sizes=self.omic_sizes, model_size=c.model.model_size,
            fusion=c.model.fusion, n_classes=3 if self.ge_mode else c.model.n_classes,
            dropout=c.model.dropout, wsi_dim=self.wsi_dim, bug_compat=c.training.bug_compat,
            dtype=dtype, mesh=self.mesh)
        self.model = seeded_init_(model, c.training.seed).to(self.device)
        if self.mesh is not None:  # every rank starts from rank 0's parameters
            replicate(list(self.model.parameters()) + list(self.model.buffers()), self.mesh)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self.optimizer = make_optimizer(c.training.optimizer, c.training.lr,
                                        c.training.weight_decay, grad_clip=c.training.grad_clip)
        if verbose:
            print(f"Trainable parameters of {c.model.name}: {self.n_params}")
            print(f"Using optimizer: {c.training.optimizer}")
            print(f'Using loss "{c.training.loss}" during training')
            print(f"Device: {self.device}"
                  + (f" ({torch.cuda.get_device_name(self.device)})"
                     if self.device.type == "cuda" else ""))
        self.state = init_train_state(self.model, self.optimizer, c.training.seed)
        self.starting_epoch = 0
        if c.model.load_from_checkpoint:
            self.restore(c.model.load_from_checkpoint)

        spd = c.tpu.steps_per_dispatch
        self._spd_auto = spd <= 0
        self.steps_per_dispatch = _SPD_AUTO if spd <= 0 else int(spd)
        self._step_kw = dict(alpha=c.training.alpha, l1_lambda=c.training.lambda_,
                             ge_mode=self.ge_mode,
                             omic_sizes=None if self.ge_mode else tuple(self.omic_sizes),
                             graphs=self.graphs if self.graphs is not None else False,
                             mesh=self.mesh)
        self.train_step = make_train_step(self.model, c.training.loss, self.optimizer,
                                          patch_dropout=c.training.patch_dropout,
                                          int8_matmul=c.tpu.int8_matmul, remat=c.tpu.remat,
                                          **self._step_kw)
        self.eval_step = make_eval_step(self.model, c.training.loss, **self._step_kw)
        # a dispatch group: its steps one by one, each a replay of its bucket's graph
        self.multi_step = multi_step_of(self.train_step)
        self.multi_eval = multi_step_of(self.eval_step)
        self.stager = Stager(self.device)

        # device-resident cohort: engaged on first use (_ensure_device_cache);
        # a partial cache holds the buckets that fit the budget
        self.device_cache = None
        self.device_cache_val = None
        self._cache_partial = False
        self._want_device_cache = c.tpu.device_cache in ("auto", "on")
        self._device_cache_forced = c.tpu.device_cache == "on"

        writer = self.mesh is None or self.mesh.rank == 0
        self.logger = MetricLogger(
            wandb_enabled=c.wandb.enabled and writer, wandb_project=c.wandb.project,
            wandb_config=self._wandb_config(),
            jsonl_path=os.path.join(c.training.test_output_dir, "run_log.jsonl")
            if c.training.test_output_dir and writer else None)
        self.timer = StepTimer()
        self.val_risks = np.zeros(0)  # the last validation's risks, real rows in batch order

    # ------------------------------------------------------------------ util
    def _make_mesh(self, verbose: bool):
        """This rank's mesh (``parallel/mesh.py``) when ``tpu.data_axis`` x
        ``tpu.seq_axis`` > 1, joining torchrun's process group; the JAX
        Trainer's refusals at its places: a batch that does not split over
        the data axis, several ranks without a mesh (each would train a
        replica of its own, never synchronized)."""
        c = self.config
        data, seq = c.tpu.data_axis, c.tpu.seq_axis
        if data * seq == 1:
            world = comm.world_size()
            if world > 1:
                raise ValueError(
                    f"{world} ranks but tpu.data_axis={data} x tpu.seq_axis={seq} defines no "
                    f"mesh: set the axes to span every rank (e.g. data_axis={world}) so that "
                    "the gradients synchronize")
            return None
        mesh = make_mesh(data, seq, device=self.device)
        if self.batch_size % data != 0:
            # batch rows split over the data axis (parallel/mesh.py::batch_spec)
            raise ValueError(
                f"tpu.batch_size={self.batch_size} must be divisible by tpu.data_axis={data} "
                "(batch rows shard over the data axis)")
        if verbose and mesh.rank == 0:
            print(f"Mesh: data={data} x seq={seq} over {mesh.size} ranks ({mesh.backend})")
        return mesh

    def _wandb_config(self) -> Dict[str, Any]:
        """The run's flattened hyperparameters for ``wandb.init`` (the JAX
        Trainer's, after the reference's wandb_init, mcat/main.py:186-215)."""
        c = self.config
        return {
            "model": c.model.name,
            "dataset": c.dataset.name,
            "normalization": c.dataset.normalize,
            "standardization": c.dataset.standardize,
            "decider_only": c.dataset.decider_only,
            "tcga_only": c.dataset.tcga_only,
            "diagnostic_only": c.dataset.diagnostic_only,
            "optimizer": c.training.optimizer,
            "learning_rate": c.training.lr,
            "weight_decay": c.training.weight_decay,
            "gradient_acceleration_step": c.training.grad_acc_step,
            "epochs": c.training.epochs,
            "architecture": c.model.name,
            "fusion": c.model.fusion,
            "loss": c.training.loss,
            "scheduler": c.training.scheduler,
            "alpha": c.training.alpha,
            "lambda": c.training.lambda_,
            "gamma": c.training.gamma,
            "model_size": c.model.model_size,
            "leave_one_out": c.training.leave_one_out,
        }

    def _ensure_device_cache(self) -> bool:
        """Upload the cohort (train and validation bags) once, if
        ``tpu.device_cache`` asks for it: the whole cohort if it fits
        ``tpu.device_cache_budget_bytes`` ("on" ignores the budget), else
        the buckets that fit (``plan_cache_fit``: cheapest bytes a bag
        first), the others host-fed. Returns whether the cache is engaged."""
        if not self._want_device_cache:
            return False
        if self.device_cache is not None:
            return True
        if len(self.train_ds) == 0:
            self._want_device_cache = False
            return False
        c = self.config
        lengths = self.train_batcher._bag_lengths()
        val_lengths = self.val_batcher._bag_lengths() if len(self.val_ds) else np.zeros(0)
        all_lengths = np.concatenate([lengths, val_lengths])
        per_bucket = DeviceBagCache.bucket_bytes(all_lengths, self.buckets, self.wsi_dim,
                                                 store_dtype=self.cache_dtype)
        counts: Dict[int, int] = {}
        for m in all_lengths:
            b = bucket_for(int(m), self.buckets)
            counts[b] = counts.get(b, 0) + 1
        # on a mesh the budget is each device's: the cache splits over every rank
        budget = c.tpu.device_cache_budget_bytes * (1 if self.mesh is None else self.mesh.size)
        only_buckets, nbytes, engaged = plan_cache_fit(
            per_bucket, counts, budget, forced=self._device_cache_forced)
        if not engaged:
            if self.verbose:
                print(f"Device dataset cache: cohort ({sum(per_bucket.values()) / (1 << 20):.0f}"
                      f" MiB) exceeds the budget ({budget / (1 << 20):.0f} MiB) and no bucket "
                      "fits; host feeding")
            self._want_device_cache = False
            return False
        self._cache_partial = only_buckets is not None
        if self.verbose:
            scope = (f"buckets {sorted(only_buckets)} (partial; others host-feed)"
                     if self._cache_partial
                     else f"{len(self.train_ds)} train + {len(self.val_ds)} val bags")
            print(f"Device dataset cache: {nbytes / (1 << 20):.0f} MiB of padded bags "
                  f"({self.cache_dtype}) uploaded once ({scope})")
        kw = dict(device=self.device, ge_mode=self.ge_mode, only_buckets=only_buckets,
                  store_dtype=self.cache_dtype, mesh=self.mesh)
        self.device_cache = DeviceBagCache(self.train_ds, self.extras_fn, self.buckets,
                                           lengths=lengths, **kw)
        self.device_cache_val = (
            DeviceBagCache(self.val_ds, self.extras_fn, self.buckets, lengths=val_lengths, **kw)
            if len(self.val_ds) else None)
        self._cached_step = make_cached_train_step(
            self.model, c.training.loss, self.optimizer,
            patch_dropout=c.training.patch_dropout, int8_matmul=c.tpu.int8_matmul,
            remat=c.tpu.remat, **self._step_kw)
        self._cached_eval = make_eval_step(self.model, c.training.loss, cached=True,
                                           **self._step_kw)
        self._cached_multi = multi_step_of(self._cached_step)
        self._cached_eval_multi = multi_step_of(self._cached_eval)
        return True

    def _device_batch(self, batch) -> Dict[str, Any]:
        """A host batch's tensors on the device (``pipeline.to_device``), the
        wsi in ``tpu.transfer_dtype``."""
        return to_device(batch, self.device, self.ge_mode, self.transfer_dtype)

    def _batch_info(self, meta, real: int, table) -> Dict[str, Any]:
        """The host columns the epoch's metrics read, for a cached batch."""
        rows = meta["row"]
        info = {"n_real": real, "weight": meta["weight"]}
        if self.ge_mode:
            info["label"] = table.gene_expr_class[rows]
        else:
            info["censorship"] = table.censorship[rows]
            info["survival_months"] = table.survival_months[rows]
        return info

    def _plan_info(self, indices, table) -> Dict[str, Any]:
        """:meth:`_batch_info` of a host-fed batch of the plan: the global
        batch's columns (a mesh rank reads only its slice of the bags, and
        the steps return the global batch's metrics)."""
        full, weight = pad_plan_indices(indices, self.batch_size)
        return self._batch_info({"row": np.asarray(full), "weight": weight}, len(indices),
                                table)

    def _host_k_cap(self, K):
        """``k_fn`` for :func:`_grouped` over host-fed items of a bucket:
        auto mode caps a group at 1 GiB of stacked float32 bags (K = 1 at a
        bucket whose one batch is that big); an explicit
        ``steps_per_dispatch`` is honoured as configured."""

        def k_cap(bucket: int) -> int:
            if not self._spd_auto:
                return K
            data, seq = (1, 1) if self.mesh is None else (self.mesh.data, self.mesh.seq)
            per = (self.batch_size // data) * (int(bucket) // seq) * self.wsi_dim * 4
            return max(1, min(K, _SPD_STACK_BYTES // max(per, 1)))

        return k_cap

    def _cached_call(self, cache, metas, single, multi):
        """A cached group's call; its metas go to the device through the
        stager now (one [B] set, or a [K, B] stack)."""
        staged = self.stager.stage([_meta_arrays(m) for m in metas], stacked=len(metas) > 1)
        fn = single if len(metas) == 1 else multi
        return lambda *st: fn(*st, cache, staged.take())

    def _host_call(self, batches, single, multi):
        if len(batches) == 1:
            staged = self.stager.stage_batch(batches[0], self.ge_mode, self.transfer_dtype)
            fn = single
        else:
            staged = self.stager.stage_group(batches, self.ge_mode, self.transfer_dtype)
            fn = multi
        return lambda *st: fn(*st, staged.take())

    def _items(self, plan, cache, ds):
        """(key, payload, bucket) per batch of ``plan`` (an epoch's
        (indices, bucket) list): key (cached, bucket); a cached batch's
        payload is (meta, info), a host batch's its indices."""
        cached = set(cache.caches) if cache is not None else set()
        table = ds.table
        for indices, bucket in plan:
            if bucket in cached:
                meta, real = build_meta(indices, self.batch_size, cache)
                yield (True, bucket), (meta, self._batch_info(meta, real, table)), bucket
            else:
                yield (False, bucket), indices, bucket

    def _staged_feed(self, batcher, cache, ds, K, steps):
        """(infos, call) per dispatch group of ``batcher``'s next epoch, the
        groups staged on the device as they are built (run it in the
        prefetch thread). ``steps``: (host single, host multi, cached single,
        cached multi). Cached buckets gather from ``cache``; the others (all
        of them without a cache) are host-fed: their bags read, and only
        their own patches copied through the stager (padded on the card)."""
        host_k = self._host_k_cap(K)
        plan = batcher._epoch_plan()
        pipe = None
        if batcher.native_store() is not None:
            cached = set(cache.caches) if cache is not None else set()
            host_plan = [p for p in plan if p[1] not in cached]
            if host_plan:
                pipe = batcher.native_pipeline(host_plan, pinned=self.device.type == "cuda")
        # the native reader feeds one batch a call (a group is its steps one
        # by one, so the numbers are the same), each from its pinned slot
        k_host = (lambda b: 1) if pipe is not None else host_k
        try:
            for group in _grouped(self._items(plan, cache, ds), key_fn=lambda x: x[0], K=K,
                                  k_fn=lambda x: K if x[0][0] else k_host(x[2])):
                is_cached, bucket = group[0][0]
                if is_cached:
                    metas, infos = zip(*(g[1] for g in group))
                    yield list(infos), self._cached_call(cache.caches[bucket], list(metas),
                                                         steps[2], steps[3])
                elif pipe is not None:
                    indices = group[0][1]
                    b, rows = pipe.next()
                    staged = self.stager.stage_batch(batcher.native_rows(indices, bucket, rows),
                                                     self.ge_mode, self.transfer_dtype)
                    pipe.release(b, staged.event)  # the slot returns once its copy is done
                    yield ([self._plan_info(indices, ds.table)],
                           lambda *st, staged=staged: steps[0](*st, staged.take()))
                else:  # only the bags' own patches cross; the card pads them
                    batches = [batcher._make_rows(g[1], bucket) for g in group]
                    yield ([self._plan_info(g[1], ds.table) for g in group],
                           self._host_call(batches, steps[0], steps[1]))
        finally:
            if pipe is not None:
                pipe.close()

    # --------------------------------------------------------------- training
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        return self._train_reduce(epoch, self._train_dispatch(epoch))

    def _train_dispatch(self, epoch: int) -> Dict[str, Any]:
        """Enqueue every training step of the epoch; the metrics stay on the
        device (:meth:`_train_reduce` fetches them)."""
        c = self.config
        # epoch-indexed schedules set the lr at the epoch's start, so a
        # resumed run lands on the lr of a straight-through run; the
        # reference's exp scheduler steps at the epoch's end (_train_reduce)
        if c.training.scheduler in ("cosine", "step") or c.training.warmup_epochs:
            set_lr(self.state.optimizer, schedule_lr(
                c.training.scheduler, c.training.lr, epoch, gamma=c.training.gamma,
                total_epochs=c.training.epochs, warmup_epochs=c.training.warmup_epochs,
                min_lr=c.training.min_lr, step_size=c.training.step_size))
        self.timer.reset()
        epoch_t0 = time.time()
        cache = self.device_cache if self._ensure_device_cache() else None
        steps = (self.train_step, self.multi_step,
                 *((self._cached_step, self._cached_multi) if cache is not None else (None,) * 2))
        feed = prefetch(self._staged_feed(self.train_batcher, cache, self.train_ds,
                                          self.steps_per_dispatch, steps),
                        depth=c.tpu.prefetch)
        anomaly = (torch.autograd.detect_anomaly(check_nan=True) if c.training.debug_nans
                   else contextlib.nullcontext())
        groups, infos = [], []
        with anomaly:
            for group_infos, call in feed:
                self.state, m = call(self.state)
                k = len(group_infos)
                groups.append((m, k))
                infos.extend(group_infos)
                for info in group_infos:
                    self.timer.tick(int(info["n_real"]))
                n = len(infos)
                if self.verbose and n // 50 > (n - k) // 50:
                    # the reference's per-50-batch print (mcat/main.py:63-68):
                    # the epoch's only sync
                    last = m.loss if k == 1 else m.loss[-1]
                    print(f"\tstep: {n}, loss: {float(last):.4f}, "
                          f"bags/s: {self.timer.rates()[1]:.2f}")
        return {"groups": groups, "infos": infos, "epoch_t0": epoch_t0}

    def _train_tensors(self, ctx) -> List[torch.Tensor]:
        """The epoch's on-device metrics, in :meth:`_train_reduce`'s order."""
        out = [torch.cat([m.loss.reshape(-1) for m, _ in ctx["groups"]])] if ctx["groups"] else []
        if out and not self.ge_mode:
            out.append(torch.cat([m.attn_loss.reshape(-1) for m, _ in ctx["groups"]]))
            out.append(torch.cat([m.risk.reshape(-1) for m, _ in ctx["groups"]]))
        return out

    def _train_reduce(self, epoch: int, ctx: Dict[str, Any],
                      fetched: Optional[List[np.ndarray]] = None) -> Dict[str, float]:
        """Fetch the epoch's metrics (unless ``fetched`` holds them) and
        reduce them: per-sample means, the c-index, the exp scheduler, the
        log and the periodic checkpoint."""
        c = self.config
        if fetched is None:
            fetched = _fetch(self._train_tensors(ctx))
        infos = ctx["infos"]
        loss_vals = fetched[0].astype(np.float64) if fetched else np.zeros(1)
        if not np.all(np.isfinite(loss_vals)):
            bad = int(np.argmax(~np.isfinite(loss_vals)))
            raise FloatingPointError(
                f"non-finite loss {loss_vals[bad]} at epoch {epoch + 1} step {bad + 1}")
        w = np.array([float(i["n_real"]) for i in infos]) if infos else np.ones(1)
        self.last_epoch_steps = len(infos)
        self.train_bags_per_s = self.timer.rates()[1]
        out: Dict[str, float] = {
            "train_loss": float((loss_vals * w).sum() / max(w.sum(), 1.0)),
            "epoch_seconds": time.time() - ctx["epoch_t0"],
        }
        if self.ge_mode:
            out["train_mse"] = out["train_loss"]  # ge_nacagat/main.py:82
            msg = f"Epoch: {epoch + 1}, train_loss: {out['train_loss']:.4f}"
        else:
            sel, cens, months = self._real_columns(infos)
            risk_all = fetched[2][sel] if fetched else np.zeros(0)
            out["train_c_index"] = _c_index(cens, months, risk_all)
            attn = fetched[1].astype(np.float64) if fetched else np.zeros(1)
            out["train_attn_loss"] = float((attn * w).sum() / max(w.sum(), 1.0))
            msg = (f"Epoch: {epoch + 1}, train_loss: {out['train_loss']:.4f}, "
                   f"train_c_index: {out['train_c_index']:.4f}")
        if c.training.scheduler == "exp" and not c.training.warmup_epochs:
            msg = f"{msg}, lr: {current_lr(self.state.optimizer):.8f}"
            step_exponential(self.state.optimizer, c.training.gamma)
        elif c.training.scheduler in ("cosine", "step") or c.training.warmup_epochs:
            msg = f"{msg}, lr: {current_lr(self.state.optimizer):.8f}"
        if self.verbose:
            print(msg)
        # periodic checkpoint (mcat/main.py:88-100)
        every = c.model.checkpoint_epoch
        if every and every > 0 and (epoch + 1) % every == 0 and epoch != 0:
            path = self.save(epoch, out["train_loss"])
            if self.verbose:
                print(f"Saving model into {path}")
        self.logger.log({k: v for k, v in out.items() if not math.isnan(v)}, step=epoch)
        return out

    @staticmethod
    def _real_columns(infos) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(real-row selector, censorship, months) over the epoch's batches."""
        if not infos:
            return np.zeros(0, bool), np.zeros(0), np.zeros(0)
        sel = np.concatenate([np.asarray(i["weight"]) for i in infos]) > 0
        cens = np.concatenate([np.asarray(i["censorship"]) for i in infos])[sel]
        months = np.concatenate([np.asarray(i["survival_months"]) for i in infos])[sel]
        return sel, cens, months

    def _val_results(self):
        """Yield (infos, result) per validation dispatch group: the eval
        results' loss and risk (GE: y), with a leading [k] axis for a group
        of k > 1 batches. Gathered from the validation cache where a bucket
        is cached, else host-fed through the stager."""
        cache = self.device_cache_val if self._ensure_device_cache() else None
        steps = (self.eval_step, self.multi_eval,
                 *((self._cached_eval, self._cached_eval_multi) if cache is not None
                   else (None,) * 2))
        keep = ("loss", "y" if self.ge_mode else "risk")
        feed = prefetch(self._staged_feed(self.val_batcher, cache, self.val_ds,
                                          self.steps_per_dispatch, steps),
                        depth=self.config.tpu.prefetch)
        for infos, call in feed:
            res = call()
            yield infos, {k: res[k] for k in keep}

    def validate(self, epoch) -> Dict[str, float]:
        """Eval steps over the validation split; the per-sample mean loss and
        the c-index (GE: the weighted top-1 accuracy)."""
        return self._validate_reduce(epoch, list(self._val_results()))

    def _val_tensors(self, results) -> List[torch.Tensor]:
        if not results:
            return []
        key = "y" if self.ge_mode else "risk"
        return [torch.cat([r["loss"].reshape(-1) for _, r in results]),
                torch.cat([r[key].reshape(-1) for _, r in results])]

    def _validate_reduce(self, epoch, results,
                         fetched: Optional[List[np.ndarray]] = None) -> Dict[str, float]:
        if fetched is None:
            fetched = _fetch(self._val_tensors(results))
        infos = [info for group, _ in results for info in group]
        lv = fetched[0].astype(np.float64) if fetched else np.zeros(1)
        wv = np.array([float(i["n_real"]) for i in infos]) if infos else np.ones(1)
        out = {"val_loss": float((lv * wv).sum() / max(wv.sum(), 1.0))}
        label = epoch if isinstance(epoch, str) else epoch + 1
        if self.ge_mode:
            out["val_mse"] = out["val_loss"]  # ge_nacagat/main.py:119
            if infos:
                y_all = fetched[1].reshape(len(infos) * self.batch_size, -1)
                l_all = np.concatenate([np.asarray(i["label"]) for i in infos])
                w_all = np.concatenate([np.asarray(i["weight"]) for i in infos])
                hit = (np.argmax(y_all, axis=1) == l_all).astype(float)
                out["val_accuracy"] = float((hit * w_all).sum() / max(w_all.sum(), 1.0))
            msg = f"Epoch: {label}, val_loss: {out['val_loss']:.4f}"
        else:
            sel, cens, months = self._real_columns(infos)
            self.val_risks = fetched[1][sel] if infos else np.zeros(0)
            out["val_c_index"] = _c_index(cens, months, self.val_risks)
            msg = (f"Epoch: {label}, val_loss: {out['val_loss']:.4f}, "
                   f"val_c_index: {out['val_c_index']:.4f}")
        if self.verbose:
            print(msg)
        self.logger.log({k: v for k, v in out.items() if not math.isnan(v)},
                        step=epoch if isinstance(epoch, int) else None)
        return out

    def validated_epoch(self, epoch: int) -> Tuple[Dict[str, float], Dict[str, float]]:
        """One training epoch and its validation as one chain: enqueue every
        training step, then every eval step (the weights are final once the
        last training step is enqueued), then one fetch for both, then the
        two reductions; the same numbers as ``train_epoch`` followed by
        ``validate``. A Trainer whose ``train_epoch`` or ``validate`` was
        replaced (a subclass, a wrapper) runs the two calls instead."""
        if (type(self).train_epoch is not Trainer.train_epoch
                or type(self).validate is not Trainer.validate
                or "train_epoch" in self.__dict__ or "validate" in self.__dict__):
            return self.train_epoch(epoch), self.validate(epoch)
        ctx = self._train_dispatch(epoch)
        val = list(self._val_results())
        train_t = self._train_tensors(ctx)
        fetched = _fetch(train_t + self._val_tensors(val))
        return (self._train_reduce(epoch, ctx, fetched[:len(train_t)]),
                self._validate_reduce(epoch, val, fetched[len(train_t):]))

    # -------------------------------------------------------------- test/export
    def test(self, epoch: int, save: bool = False, png: bool = False) -> None:
        """Leave-one-out inference + attention-map export (reference:
        mcat/main.py:158-183): survival models export the co-attention map
        [N, M], GE the MIL scores [1, M], each cut to the bag's patches, as
        ``ATTN_<model>_<patient>_<time>_E<epoch>_<batch>.npy`` (GE: without
        the model) or ``.pt`` under ``training.attn_export_format``; with
        ``png`` each saved map is also rendered beside it
        (``utils/visualize.py``, rows labelled by signature).

        On a seq mesh every rank reads its patches of each bag and runs the
        export step (the co-attention's export passes per rank on merged
        statistics, GE's scores gathered), and rank 0 alone prints and
        writes the files. A data axis > 1 raises ``ValueError``, as the JAX
        Trainer does (``shard_batch`` cannot split a batch of one bag over
        it)."""
        if self.test_ds is None or len(self.test_ds) == 0:
            return
        c = self.config
        mesh = self.mesh
        if mesh is not None and mesh.data > 1:
            # JAX: shard_batch's device_put of the one-bag batch over the data axis
            raise ValueError(
                f"the leave-one-out export feeds batches of 1 bag, which do not split over "
                f"tpu.data_axis={mesh.data} (batch rows shard over the data axis)")
        now = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
        if mesh is not None:  # one time stamp in every rank's names
            now = comm.broadcast_object(now, mesh.world)
        out_dir = c.training.test_output_dir
        writer = mesh is None or mesh.rank == 0
        if writer:
            os.makedirs(out_dir, exist_ok=True)
        batcher = BucketBatcher(self.test_ds, self.extras_fn, 1, self.buckets, shuffle=False,
                                host_slice=mesh)
        if not hasattr(self, "_test_eval_step"):
            self._test_eval_step = make_eval_step(
                self.model, c.training.loss, need_attention=not self.ge_mode, **self._step_kw)
        for bi, batch in enumerate(batcher.batches()):
            res = self._test_eval_step(self._device_batch(batch))
            n_patches = int(batch["mask"][0].sum())
            if mesh is not None:  # the bag's patches over every seq rank
                n_patches = int(comm.all_reduce(torch.tensor(n_patches, device=self.device),
                                                mesh.seq_group))
            attn = res["attention"]["path" if self.ge_mode else "coattn"]
            attn_map = attn.reshape(attn.shape[0], -1, attn.shape[-1])[0, :, :n_patches]
            attn_map = attn_map.cpu().numpy()
            if self.verbose:
                if self.ge_mode:
                    print(f"[{bi}] Gene Expression Class: {batch['label'][0]}")
                    print(f"Prediction: {res['y'][0].cpu().numpy()}")
                else:
                    print(f"[{bi}] Survival months: {batch['survival_months'][0]}, "
                          f"Survival class: {batch['label'][0]}, "
                          f"Censorship: {batch['censorship'][0]}")
                    print(f"Hazards: {res['hazards'][0].cpu().numpy()}, "
                          f"Survs: {res['survs'][0].cpu().numpy()}, "
                          f"Risk: {float(res['risk'][0]):.4f}")
                print(f"Attn min: {attn_map.min():.6f}, Attn max: {attn_map.max():.6f}, "
                      f"Attn mean: {attn_map.mean():.6f}")
            if save and writer:
                patient = c.training.leave_one_out
                ext = c.training.attn_export_format
                model = "" if self.ge_mode else f"{c.model.name}_"  # ge_nacagat/main.py:140
                path = os.path.join(out_dir, f"ATTN_{model}{patient}_{now}_E{epoch}_{bi}.{ext}")
                if self.verbose:
                    print(f"Saving attention in {path}")
                if ext == "pt":  # the reference's torch.save export (mcat/main.py:180-183)
                    torch.save(torch.from_numpy(np.ascontiguousarray(attn_map)), path)
                else:
                    np.save(path, attn_map)
                if png:
                    from multimodal_path_omic_tpu_torch.utils.visualize import save_attention_png

                    png_path = save_attention_png(
                        attn_map, path,
                        row_labels=None if self.ge_mode else list(
                            self.dataset.table.signature_names),
                        title=f"{c.model.name} · patient {patient} · epoch {epoch}")
                    if self.verbose:
                        print(f"Rendered attention heatmap {png_path}")

    # ------------------------------------------------------------- checkpoint
    def save(self, epoch: int, loss: float, tag: Optional[str] = None) -> str:
        """Checkpoint after 0-based ``epoch``: the model's and optimizer's
        state dicts, the dropout generator's state, the step count, the
        split seed and the epoch to resume at."""
        c = self.config
        if self.mesh is not None and self.mesh.rank != 0:  # rank 0 writes, the others wait
            comm.barrier(self.mesh.world)
            return comm.broadcast_object(None, self.mesh.world)
        payload = {
            "epoch": epoch + 1,  # a resumed run starts at the next epoch
            "model": self.model.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
            "generator": self.state.generator.get_state(),
            "step": self.state.step,
            "loss": float(loss),
            "seed": c.training.seed,
        }
        path = ckpt.save_checkpoint(c.model.checkpoint_dir, payload, model_name=c.model.name,
                                    dataset_name=c.dataset.name, epoch=epoch, tag=tag)
        if self.mesh is not None:
            comm.barrier(self.mesh.world)
            comm.broadcast_object(path, self.mesh.world)
        return path

    def restore(self, path: str) -> None:
        if self.verbose:
            print(f"Loading model checkpoint from {path}")
        payload = ckpt.restore_checkpoint(path)
        if "model_state_dict" in payload:
            raise ValueError(f"{path} is a reference PyTorch checkpoint: load it with "
                             "Trainer.load_torch_checkpoint (--torch-checkpoint)")
        self.model.load_state_dict(payload["model"])
        load_state(self.state.optimizer, payload["optimizer"])
        if self.graphs is not None:  # the optimizer's state tensors were replaced
            self.graphs.reset()
        state = payload["generator"]
        if state.numel() == self.state.generator.get_state().numel():
            self.state.generator.set_state(state)
        else:  # written on the other device type: CPU and CUDA generator states differ in kind
            warnings.warn(f"{path}: the dropout generator's state is another device type's; "
                          f"the run keeps its generator seeded from training.seed")
        self.state = self.state._replace(step=int(payload["step"]))
        self.starting_epoch = int(payload["epoch"])
        if self.config.training.bug_compat:
            # the reference resumes at the epoch it saved (mcat/main.py:96,
            # 309-312, 323), so it trains that epoch again
            self.starting_epoch = max(0, self.starting_epoch - 1)
        # the shuffle of an uninterrupted run at this epoch (seed + epoch)
        self.train_batcher._epoch = self.starting_epoch

    def load_torch_checkpoint(self, path: str) -> None:
        """Load a reference ``.pt`` checkpoint's model weights
        (``utils/transplant.py``). A reference checkpoint's 'epoch' is the
        0-based epoch it finished (mcat/main.py:96): training resumes at the
        next one, or under ``bug_compat`` at that one again, as the reference
        does (main.py:309-312, 323); a payload without 'epoch' starts at 0."""
        from multimodal_path_omic_tpu_torch.utils import transplant

        if self.verbose:
            print(f"Loading reference checkpoint from {path}")
        payload = transplant.load_torch_checkpoint(path)
        state = transplant.from_torch_state_dict(
            self.config.model.name, payload["model_state_dict"], self.model.state_dict(),
            n_signatures=len(self.omic_sizes), fusion=self.config.model.fusion)
        self.model.load_state_dict(state)
        saved = int(payload.get("epoch", -1))
        self.starting_epoch = max(0, saved + (0 if self.config.training.bug_compat else 1))
        self.train_batcher._epoch = self.starting_epoch

    def _monitor_key(self) -> str:
        """training.monitor; "auto" is val_c_index (survival) or val_accuracy (GE)."""
        m = self.config.training.monitor
        if m != "auto":
            return m
        return "val_accuracy" if self.ge_mode else "val_c_index"

    # -------------------------------------------------------------------- fit
    def fit(self) -> Dict[str, float]:
        """Train from ``starting_epoch`` to ``training.epochs``, validating
        every epoch; ``keep_best`` checkpoints each improvement of the
        monitored metric (tag "best"), ``early_stopping`` stops after that
        many validated epochs without one; then a final validation."""
        c = self.config
        if self.verbose:
            print("Training started...")
        last: Dict[str, float] = {}
        monitor = self._monitor_key()
        sign = -1.0 if monitor == "val_loss" else 1.0
        best_score, best_epoch, stale = -math.inf, -1, 0
        for epoch in range(self.starting_epoch, c.training.epochs):
            if self.verbose:
                print(f"Epoch: {epoch + 1}")
            t0 = time.time()
            train_out, val = self.validated_epoch(epoch)
            last.update(train_out)
            last.update(val)
            # a missing or NaN monitored metric counts as no improvement
            value = val.get(monitor, math.nan)
            score = sign * value if math.isfinite(value) else -math.inf
            if score > best_score:
                best_score, best_epoch, stale = score, epoch, 0
                if c.training.keep_best:
                    path = self.save(epoch, val.get("val_loss", 0.0), tag="best")
                    if self.verbose:
                        print(f"New best {monitor}: {value:.4f} (epoch {epoch + 1}) -> {path}")
            else:
                stale += 1
            if self.leave_one_out:
                self.test(epoch + 1, save=(epoch + 1) % c.training.output_attn_epoch == 0)
            if self.verbose:
                print(f"Time elapsed for epoch {epoch + 1}: {time.time() - t0:.0f}s")
            if c.training.early_stopping and stale >= c.training.early_stopping:
                if self.verbose:
                    print(f"Early stopping at epoch {epoch + 1}: no {monitor} improvement in "
                          f"{stale} validated epochs (best {sign * best_score:.4f} at epoch "
                          f"{best_epoch + 1})")
                break
        if best_epoch >= 0 and math.isfinite(best_score):
            last[f"best_{monitor}"] = sign * best_score
            last["best_epoch"] = float(best_epoch + 1)
        last.update(self.validate("final validation"))
        self.logger.finish()
        return last


def main(config_path: str, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """Train from a reference-schema YAML config (the reference's
    main(config_path), mcat/main.py:218-340), for every model family;
    ``overrides`` maps dotted keys to values (``{"training.lr": 1e-3}``)."""
    return Trainer(load_config(config_path, overrides)).fit()
