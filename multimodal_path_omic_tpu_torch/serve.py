"""Batch inference / serving API (``multimodal_path_omic_tpu/serve.py``): a
``Predictor`` that scores single bags, lists of bags in bucketed,
fixed-shape batches, or whole datasets (to a CSV), from a checkpoint, a
checkpoint ensemble or a reference ``.pt`` checkpoint, with optional
MC-dropout uncertainty.

The eval step is ``train/loop.py::make_eval_step``, the one validation runs.
Survival models (MCAT and NaCAGaT, every survival loss of ``LOSSES``): a
deterministic forward (the co-attention map is requested for ``cesar``,
whose loss consumes it, or with ``need_attention=True``), then the loss,
risk = -sum(survs), hazards, survs and y. GE-NaCAGaT (WSI
only, loss ``ce``): the class probabilities y and the raw MIL scores; bags
come without omics.

Bags reach the device through pinned host buffers and a copy stream
(``pipeline.Stager``); ``predict_bags`` and ``predict_dataset`` pad and copy
the next batch in a prefetch thread while the device scores the current one.
On the card the eval step is a CUDA graph replay (``train/graphs.py``), one
graph per batch shape.

On a mesh (``Predictor(..., mesh=)``, or a Trainer's) every rank calls with
the same bags, stages only its slice of each batch (its rows, of each bag
its patches) and gets the global batch's outputs (the mesh eval step
all-gathers them), so every call returns the one-device result on every
rank, under every loss (``cox``'s risk sets span the global batch) and with
``need_attention`` (the maps of the global batch; on a seq axis the
export passes run per rank on merged statistics). A batch has at least
``data_axis`` rows (``min_rows``): a single bag is padded with zero-weight
rows (JAX ``serve.py:51-55``). ``server.py`` serves a mesh over HTTP: rank
0 answers and hands each request to the other ranks.

CLI: ``python -m multimodal_path_omic_tpu_torch.cli predict --config cfg.yaml
--checkpoint ck --out predictions.csv`` writes one row per slide.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from multimodal_path_omic_tpu_torch.data.bags import DEFAULT_BUCKETS, bucket_for
from multimodal_path_omic_tpu_torch.data.pipeline import (
    BucketBatcher,
    Stager,
    bag_rows,
    gene_expr_extras,
    prefetch,
    survival_extras,
)
from multimodal_path_omic_tpu_torch.device import resolve_device
from multimodal_path_omic_tpu_torch.models import build_model, is_ge_model
from multimodal_path_omic_tpu_torch.train.loop import (
    make_eval_step,
    make_mc_eval_step,
    mc_generator,
)
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params, seeded_init_

LOSSES = ("ce", "ces", "sct", "cesar", "nll", "cox")
# the columns an MC-dropout call adds, by model family
MC_KEYS = {True: ("y_mean", "y_std"),
           False: ("risk_mean", "risk_std", "survs_mean", "survs_std", "hazards_mean",
                   "y_mean", "y_std")}


def _paths(arg) -> List[str]:
    return [arg] if isinstance(arg, str) else list(arg or [])


class Predictor:
    """Inference-only wrapper around a model.

    The keyword constructor builds its own model: ``params``, a JAX-package
    parameter tree (nested dicts of numpy arrays) to load; None draws random
    weights from ``seed``. ``device`` defaults to the GPU (see
    ``device.resolve_device``). A GE model name (``GE-NaCAGaT``,
    ``GeneExpr-NaCAGaT``) selects GE mode: no ``omic_sizes``, 3 classes and
    the ``ce`` loss by default. ``need_attention=True`` makes ``eval_step``
    return the survival models' co-attention map [B, N, M] under
    ``attention['coattn']`` for every loss. ``lean=False`` switches the
    co-attention off its lean routes (``ops/attention.py``): k and v are
    projected over the patch axis and the plain-K kernels run. ``dtype``
    (None: float32; ``torch.bfloat16``) is the model's compute dtype
    (``models.build_model``), as ``tpu.compute_dtype`` sets it for a
    Trainer.

    :meth:`from_trainer` shares a ``Trainer``'s model and eval step;
    :meth:`from_config` builds that Trainer from a config and loads
    checkpoints into it (two or more make an ensemble).
    """

    def __init__(self, model_name: str = "NaCAGaT", *, omic_sizes: Sequence[int] = (),
                 model_size: str = "medium", fusion: str = "concat",
                 n_classes: Optional[int] = None, wsi_dim: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, batch_size: int = 32,
                 loss: Optional[str] = None, alpha: float = 0.75,
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0,
                 device=None, lean: bool = True, need_attention: bool = False,
                 dtype: Optional[torch.dtype] = None, mesh=None):
        ge_mode = is_ge_model(model_name)
        allowed = ("ce",) if ge_mode else LOSSES
        loss = loss or ("ce" if ge_mode else "ces")
        if loss not in allowed:
            raise NotImplementedError(
                f"loss {loss!r} is not ported for {model_name} (takes {allowed})")
        device = resolve_device(device if mesh is None else mesh.device)
        omic_sizes = tuple(int(s) for s in omic_sizes)
        if not ge_mode and not omic_sizes:
            raise ValueError("survival models need omic_sizes (one width per signature)")
        model = build_model(model_name, omic_sizes=omic_sizes,
                            model_size=model_size, fusion=fusion,
                            n_classes=n_classes, wsi_dim=wsi_dim,  # None: the model's own
                            lean=lean, dtype=dtype, mesh=mesh)
        if params is not None:
            load_jax_params(model, params)
        else:
            seeded_init_(model, seed)
        model = model.to(device).eval()
        eval_step = make_eval_step(model, loss, alpha=alpha, ge_mode=ge_mode,
                                   need_attention=need_attention, omic_sizes=omic_sizes,
                                   mesh=mesh)
        self._attach(model, eval_step, model_name=model_name, ge_mode=ge_mode, device=device,
                     omic_sizes=omic_sizes, buckets=buckets, batch_size=batch_size, mesh=mesh)
        self.loss_name, self.alpha, self.need_attention = loss, alpha, bool(need_attention)

    def _attach(self, model, eval_step, *, model_name, ge_mode, device, omic_sizes, buckets,
                batch_size, trainer=None, param_sets=None, mesh=None) -> None:
        if mesh is not None and batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} does not split over the data axis "
                             f"{mesh.data}")
        self.mesh = mesh
        self.model_name = model_name
        self.ge_mode = ge_mode
        self.device = device
        self.omic_sizes = tuple(int(s) for s in omic_sizes)
        self.buckets = tuple(sorted(buckets))
        self.batch_size = int(batch_size)
        self.min_rows = 1 if mesh is None else mesh.data  # smallest servable batch
        self.model = model
        self._eval_step = eval_step
        self._t = trainer
        self.n_params = sum(p.numel() for p in model.parameters())
        self.wsi_dim = int(model.H.fc.in_features)
        self._mc_steps: Dict[int, Any] = {}  # n_samples -> MC step
        self.stager = Stager(device)
        # checkpoint ensemble: >= 2 state dicts on the device, loaded into
        # the one model in turn (members share the model and its eval step)
        self._param_sets = list(param_sets) if param_sets else None

    @classmethod
    def from_trainer(cls, trainer, param_sets=None) -> "Predictor":
        """A Predictor over ``trainer``'s model and eval step (its loss and
        ``l1_lambda`` included), buckets and batch size. ``param_sets``: two
        or more model state dicts make an ensemble."""
        self = cls.__new__(cls)
        c = trainer.config
        self._attach(trainer.model, trainer.eval_step, model_name=c.model.name,
                     ge_mode=trainer.ge_mode, device=trainer.device,
                     omic_sizes=trainer.omic_sizes, buckets=trainer.buckets,
                     batch_size=trainer.batch_size, trainer=trainer, param_sets=param_sets,
                     mesh=trainer.mesh)
        self.loss_name, self.alpha, self.need_attention = c.training.loss, c.training.alpha, False
        return self

    @classmethod
    def from_config(cls, config, checkpoint=None, torch_checkpoint=None,
                    verbose: bool = False) -> "Predictor":
        """Build a ``Trainer`` from ``config`` (on the device it names: the
        GPU unless ``device: cpu``) and load ``checkpoint`` (the port's) and
        ``torch_checkpoint`` (the reference's ``.pt``) into it; each is a
        path or a list of paths, and two or more in all build a checkpoint
        ensemble (one model, outputs averaged over the members)."""
        from multimodal_path_omic_tpu_torch.train.trainer import Trainer

        trainer = Trainer(config, verbose=verbose)
        param_sets = []

        def snapshot():
            return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}

        for path in _paths(checkpoint):
            trainer.restore(path)
            param_sets.append(snapshot())
        for path in _paths(torch_checkpoint):
            trainer.load_torch_checkpoint(path)
            param_sets.append(snapshot())
        return cls.from_trainer(trainer, param_sets if len(param_sets) >= 2 else None)

    @property
    def n_members(self) -> int:
        return len(self._param_sets) if self._param_sets else 1

    # ------------------------------------------------------------------- step
    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One deterministic forward + loss on a batch of device tensors:
        wsi [B, M, D], mask [B, M], label [B], weight [B] (0 for filler
        rows) and, for survival models, omics (list of [B, s_i]) or
        omics_packed, censorship [B] and, for ``cox``, survival_months [B]."""
        return self._eval_step(batch)

    def _eval(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One eval step, or one per ensemble member, merged: the mean of
        the members' hazards, survs and y (GE: y, the class probabilities),
        risk re-derived from the mean curve (risk = -sum survs), and the
        members' spread as ``risk_ens_std`` / ``y_ens_std`` (population
        standard deviation)."""
        if not self._param_sets:
            return self.eval_step(batch)
        outs = []
        for state in self._param_sets:
            self.model.load_state_dict(state)
            outs.append(self.eval_step(batch))

        def stack(key):
            return torch.stack([o[key] for o in outs])

        merged: Dict[str, Any] = {
            "loss": stack("loss").mean(), "n_real": outs[0]["n_real"], "attention": None,
            "y": stack("y").mean(dim=0),
        }
        if self.ge_mode:
            merged["y_ens_std"] = stack("y").std(dim=0, correction=0)
            return merged
        merged["survs"] = stack("survs").mean(dim=0)
        merged["hazards"] = stack("hazards").mean(dim=0)
        merged["risk"] = -merged["survs"].sum(dim=1)
        merged["risk_ens_std"] = stack("risk").std(dim=0, correction=0)
        if "attn_loss" in outs[0]:
            merged["attn_loss"] = stack("attn_loss").mean()
        return merged

    def _mc_step(self, n_samples: int):
        """The MC-dropout step of ``n_samples`` (``make_mc_eval_step``),
        built once per sample count."""
        if n_samples not in self._mc_steps:
            self._mc_steps[n_samples] = make_mc_eval_step(
                self.model, n_samples, ge_mode=self.ge_mode, omic_sizes=self.omic_sizes,
                mesh=self.mesh)
        return self._mc_steps[n_samples]

    def _mc_augment(self, out, batch, real: int, mc_samples: int, mc_seed: int,
                    fold: int = 0) -> Dict[str, np.ndarray]:
        """Add the MC-dropout columns of a staged batch to ``out``; ``fold``
        (a batch's index in a dataset scan) gives each batch its own
        generator, so batches draw independent masks."""
        if self._param_sets:
            raise ValueError(
                "mc_samples with a checkpoint ensemble is not supported — "
                "the ensemble spread (risk_ens_std / y_ens_std) is already "
                "the uncertainty estimate")
        res = self._mc_step(mc_samples)(batch, mc_generator(self.device, mc_seed, fold))
        for k in MC_KEYS[self.ge_mode]:
            out[k] = res[k][:real].cpu().numpy()
        return out

    def _batch(self, wsi, mask, omics_rows, n_real: int) -> Dict[str, Any]:
        """Device batch of ``len(wsi)`` rows; rows past ``n_real`` are
        zero-weight filler (with zero omics for survival models)."""
        omics = None if self.ge_mode else [
            torch.from_numpy(col).to(self.device)
            for col in self._omic_columns(omics_rows, wsi.shape[0])]
        return self._assemble(wsi, mask, omics, n_real)

    def _omic_columns(self, omics_rows, n: int) -> List[np.ndarray]:
        """One [n, s_j] float32 column per signature; rows past the given
        ones are zero."""
        cols = []
        for j, s in enumerate(self.omic_sizes):
            col = np.zeros((n, s), np.float32)
            for row, sig in enumerate(omics_rows):
                col[row] = np.asarray(sig[j], np.float32)
            cols.append(col)
        return cols

    def _assemble(self, wsi, mask, omics, n_real: int) -> Dict[str, Any]:
        """A device batch of ``wsi``'s rows (on a mesh, this rank's rows of the
        global batch, which has ``n_real`` real rows)."""
        dev, n = self.device, wsi.shape[0]
        row0 = 0 if self.mesh is None else self.mesh.d * n
        batch = {
            "wsi": wsi,
            "mask": mask,
            "label": torch.zeros((n,), dtype=torch.long, device=dev),
            "weight": (torch.arange(row0, row0 + n, device=dev) < n_real).float(),
        }
        if self.ge_mode:
            return batch
        batch["omics"] = omics
        batch["censorship"] = torch.zeros((n,), device=dev)
        batch["survival_months"] = torch.zeros((n,), device=dev)
        return batch

    def _stage(self, bags: Sequence[np.ndarray], bucket: int, n: int, omics_rows):
        """Copy ``bags`` (one a row, each at most ``bucket`` patches) toward
        an ``n``-row batch through the stager (pinned buffers, the copy
        stream): only the bags' own patches cross, with their positions in
        the padded batch, its mask and the omics columns."""
        for bag in bags:
            if np.ndim(bag) != 2 or np.shape(bag)[1] != self.wsi_dim:
                raise ValueError(f"a bag must be [patches, {self.wsi_dim}], got {np.shape(bag)}")
        if self.mesh is not None:  # this rank's rows, of each bag its patches
            rows, window = self.mesh.rows(n), self.mesh.patches(bucket)
            bags = [np.asarray(b)[window] for b in bags[rows]]
            omics_rows = omics_rows[rows]
            n, bucket = n // self.mesh.data, window.stop - window.start
        arrays = bag_rows(bags, bucket, n)
        if not bags:  # a batch of filler rows only
            arrays.update(rows=[np.zeros((0, self.wsi_dim), np.float32)],
                          pos=[np.zeros(0, np.int64)])
        if not self.ge_mode:
            for j, col in enumerate(self._omic_columns(omics_rows, n)):
                arrays[f"omic_{j}"] = col
        return self.stager.stage([arrays])

    def _staged_batch(self, staged, n_real: int) -> Dict[str, Any]:
        """The batch of :meth:`_batch` from :meth:`_stage`'s tensors, on the
        current stream (padded on the device: the same tensors, bit for
        bit)."""
        t = staged.take()
        omics = None if self.ge_mode else [t[f"omic_{j}"] for j in range(len(self.omic_sizes))]
        return self._assemble(t["wsi"], t["mask"], omics, n_real)

    # ----------------------------------------------------------------- warmup
    def warmup(self, buckets=None, verbose: bool = False) -> list:
        """Build the kernels (on the GPU) and run each bucket once at each
        batch size a request takes (``min_rows`` for ``predict_bag``,
        ``batch_size`` for ``predict_bags``) on zero batches, so the first
        request pays neither. Returns the warmed (bucket, rows) pairs."""
        if self.device.type == "cuda":
            from multimodal_path_omic_tpu_torch.ops import kernels

            kernels.build_all()
        warmed = []
        data, seq = (1, 1) if self.mesh is None else (self.mesh.data, self.mesh.seq)
        for bucket in sorted(set(buckets or self.buckets)):
            for n in sorted({self.min_rows, self.batch_size}):
                # this rank's slice of the batch
                wsi = torch.zeros((n // data, bucket // seq, self.wsi_dim), device=self.device)
                mask = torch.zeros(wsi.shape[:2], dtype=torch.bool, device=self.device)
                rows = [] if self.ge_mode else [
                    [np.zeros(s, np.float32) for s in self.omic_sizes]] * n
                self.eval_step(self._batch(wsi, mask, rows, 0))["y"].cpu()
                warmed.append((bucket, n))
            if verbose:
                print(f"warmed bucket {bucket}")
        return warmed

    # ----------------------------------------------------------------- single
    def predict_bag(self, bag: np.ndarray, omics=None, mc_samples: int = 0,
                    mc_seed: int = 0) -> Dict[str, np.ndarray]:
        """Score one bag [M, D] (with its omics signature list for survival
        models); the bag is padded to its bucket and the outputs de-batched
        (leading dimension 1). ``mc_samples`` > 0 adds the MC-dropout columns
        (``risk_mean`` / ``risk_std`` / ..., see ``make_mc_eval_step``) of
        that many stochastic forwards, seeded by ``mc_seed``."""
        if not self.ge_mode and omics is None:
            raise ValueError("survival models need the omics signature list")
        bucket = bucket_for(bag.shape[0], self.buckets)
        batch = self._staged_batch(self._stage([bag], bucket, self.min_rows, [omics]), 1)
        out = self._debatch(self._eval(batch), 1)
        if mc_samples > 0:
            out = self._mc_augment(out, batch, 1, mc_samples, mc_seed)
        return out

    # ------------------------------------------------------------------ multi
    def predict_bags(self, bags: Sequence[np.ndarray], omics=None) -> Dict[str, np.ndarray]:
        """Score a list of bags in bucketed, FIXED-SHAPE batches of
        ``(batch_size, bucket, D)``; ``omics``: one signature list per bag
        (survival models) or None (GE). Outputs are row-aligned with the
        input order and filler rows are dropped. Each batch's patches are
        copied to the device through the stager in a prefetch thread, while
        the device scores the batch before it, and padded there."""
        n = len(bags)
        if n == 0:
            return {}
        if not self.ge_mode and (omics is None or len(omics) != n):
            raise ValueError("survival models need one omics signature list per bag")
        by_bucket: Dict[int, list] = {}
        for i, bag in enumerate(bags):
            by_bucket.setdefault(bucket_for(len(bag), self.buckets), []).append(i)
        bsz = self.batch_size

        def staged():
            for bucket, idxs in sorted(by_bucket.items()):
                for c0 in range(0, len(idxs), bsz):
                    chunk = idxs[c0:c0 + bsz]
                    rows = [] if self.ge_mode else [omics[i] for i in chunk]
                    yield chunk, self._stage([bags[i] for i in chunk], bucket, bsz, rows)

        slots: Dict[str, list] = {}
        for chunk, stage in prefetch(staged()):
            out = self._debatch(self._eval(self._staged_batch(stage, len(chunk))), len(chunk))
            for k, v in out.items():
                slots.setdefault(k, [None] * n)
                for row, i in enumerate(chunk):
                    slots[k][i] = v[row]
        return {k: np.stack(v) for k, v in slots.items()}

    # ---------------------------------------------------------------- dataset
    def predict_dataset(self, dataset=None, mc_samples: int = 0,
                        mc_seed: int = 0) -> Dict[str, np.ndarray]:
        """Score every sample of ``dataset`` (default: the Trainer's whole
        dataset) in the batcher's bucketed batches (no shuffle); returns
        column arrays aligned with ``slide_id``. Each batch is read, padded
        and copied to the device (through the stager) in the prefetch thread
        while the device scores the one before. ``mc_samples`` > 0 adds the MC-dropout
        columns, batch ``i`` drawing from the generator of
        ``(mc_seed, i)``."""
        if dataset is None:
            if self._t is None:
                raise ValueError("predict_dataset needs a dataset (or a Predictor "
                                 "built from a Trainer)")
            dataset = self._t.dataset
        extras = gene_expr_extras if self.ge_mode else survival_extras
        batcher = BucketBatcher(dataset, extras, self.batch_size, self.buckets, shuffle=False,
                                host_slice=self.mesh)

        def staged():
            for indices, bucket in batcher._epoch_plan():
                b = batcher._make_rows(indices, bucket)
                yield indices, self.stager.stage_batch(b, self.ge_mode)

        rows: Dict[str, list] = {}
        for bi, (indices, stage) in enumerate(prefetch(staged())):
            dev = stage.take()
            real = len(indices)  # the plan's real rows lead the global batch
            out = self._debatch(self._eval(dev), real)
            if mc_samples > 0:
                out = self._mc_augment(out, dev, real, mc_samples, mc_seed, fold=bi)
            out["slide_id"] = np.array([dataset.slide_id(int(i)) for i in indices])
            for k, v in out.items():
                rows.setdefault(k, []).append(v)
        return {k: np.concatenate(v) for k, v in rows.items()}

    def predict_to_csv(self, path: str, dataset=None, mc_samples: int = 0,
                       mc_seed: int = 0) -> str:
        """:meth:`predict_dataset` as a CSV, one row a slide: slide_id, risk,
        hazard_j / surv_j, y_j, then the MC columns (risk_mc_mean,
        risk_mc_std, y_j_mc_std) and the ensemble's (risk_ens_std,
        y_j_ens_std), the JAX package's columns in its order."""
        import pandas as pd

        cols = self.predict_dataset(dataset, mc_samples=mc_samples, mc_seed=mc_seed)
        if self.mesh is not None and self.mesh.rank != 0:  # rank 0 writes the file
            return path
        flat: Dict[str, Any] = {"slide_id": cols["slide_id"]}
        if "risk" in cols:
            flat["risk"] = cols["risk"]
            for j in range(cols["hazards"].shape[1]):
                flat[f"hazard_{j}"] = cols["hazards"][:, j]
                flat[f"surv_{j}"] = cols["survs"][:, j]
        for j in range(cols["y"].shape[1]):
            flat[f"y_{j}"] = cols["y"][:, j]
        if mc_samples > 0:
            if "risk_std" in cols:
                flat["risk_mc_mean"] = cols["risk_mean"]
                flat["risk_mc_std"] = cols["risk_std"]
            for j in range(cols["y_std"].shape[1]):
                flat[f"y_{j}_mc_std"] = cols["y_std"][:, j]
        if "risk_ens_std" in cols:
            flat["risk_ens_std"] = cols["risk_ens_std"]
        if "y_ens_std" in cols:
            for j in range(cols["y_ens_std"].shape[1]):
                flat[f"y_{j}_ens_std"] = cols["y_ens_std"][:, j]
        pd.DataFrame(flat).to_csv(path, index=False)
        return path

    # ------------------------------------------------------------------- util
    def _debatch(self, res: Dict[str, Any], real: int) -> Dict[str, np.ndarray]:
        keys = ("y",) if self.ge_mode else ("y", "risk", "hazards", "survs")
        keys += tuple(k for k in ("risk_ens_std", "y_ens_std") if k in res)
        return {k: res[k][:real].cpu().numpy() for k in keys}
