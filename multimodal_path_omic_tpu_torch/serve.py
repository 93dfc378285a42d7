"""Batch inference API (``multimodal_path_omic_tpu/serve.py``): a
``Predictor`` that scores single bags or lists of bags in bucketed,
fixed-shape batches.

The eval step mirrors the JAX package's ``train/loop.py::make_eval_step``.
Survival models (MCAT and NaCAGaT, ``ces`` and ``cesar`` losses): a
deterministic forward (the co-attention map is requested for ``cesar``,
whose loss consumes it, or with ``need_attention=True``), then the loss,
risk = -sum(survs), hazards, survs and y. GE-NaCAGaT (WSI
only, loss ``ce``): the class probabilities y and the raw MIL scores; bags
come without omics.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from multimodal_path_omic_tpu_torch.data.bags import DEFAULT_BUCKETS, bucket_for, pad_bag
from multimodal_path_omic_tpu_torch.device import resolve_device
from multimodal_path_omic_tpu_torch.models import build_model, is_ge_model
from multimodal_path_omic_tpu_torch.ops.losses import cross_entropy_on_probs, survival_loss
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params, seeded_init_

LOSSES = ("ces", "cesar")


class Predictor:
    """Inference-only wrapper around a model.

    ``params``: a JAX-package parameter tree (nested dicts of numpy arrays)
    to load; None draws random weights from ``seed``. ``device`` defaults to
    the GPU (see ``device.resolve_device``). A GE model name (``GE-NaCAGaT``,
    ``GeneExpr-NaCAGaT``) selects GE mode: no ``omic_sizes``, 3 classes and
    the ``ce`` loss by default. ``need_attention=True`` makes ``eval_step``
    return the survival models' co-attention map [B, N, M] under
    ``attention['coattn']`` for every loss. ``lean=False`` switches the
    co-attention off its lean routes (``ops/attention.py``): k and v are
    projected over the patch axis and the plain-K kernels run.
    """

    def __init__(self, model_name: str = "NaCAGaT", *, omic_sizes: Sequence[int] = (),
                 model_size: str = "medium", fusion: str = "concat",
                 n_classes: Optional[int] = None, wsi_dim: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, batch_size: int = 32,
                 loss: Optional[str] = None, alpha: float = 0.75,
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0,
                 device=None, lean: bool = True, need_attention: bool = False):
        self.ge_mode = is_ge_model(model_name)
        allowed = ("ce",) if self.ge_mode else LOSSES
        loss = loss or allowed[0]
        if loss not in allowed:
            raise NotImplementedError(
                f"loss {loss!r} is not ported for {model_name} (takes {allowed})")
        self.device = resolve_device(device)
        self.omic_sizes = tuple(int(s) for s in omic_sizes)
        if not self.ge_mode and not self.omic_sizes:
            raise ValueError("survival models need omic_sizes (one width per signature)")
        self.buckets = tuple(sorted(buckets))
        self.batch_size = int(batch_size)
        self.loss_name = loss
        self.alpha = alpha
        self.need_attention = bool(need_attention)
        self.min_rows = 1  # smallest servable batch (no data-parallel mesh)
        model = build_model(model_name, omic_sizes=self.omic_sizes,
                            model_size=model_size, fusion=fusion,
                            n_classes=n_classes, wsi_dim=wsi_dim,  # None: the model's own
                            lean=lean)
        if params is not None:
            load_jax_params(model, params)
        else:
            seeded_init_(model, seed)
        self.model = model.to(self.device).eval()

    # ------------------------------------------------------------------- step
    @torch.inference_mode()
    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One deterministic forward + loss on a batch of device tensors:
        wsi [B, M, D], mask [B, M], label [B], weight [B] (0 for filler
        rows) and, for survival models, omics (list of [B, s_i]) and
        censorship [B]."""
        weight = batch["weight"]
        if self.ge_mode:
            # 'path' MIL scores are always produced; 'attn' (M x M) is None
            y, attn = self.model(batch["wsi"], batch["mask"])
            return {
                "loss": cross_entropy_on_probs(y, batch["label"], sample_weight=weight),
                "y": y,
                "attention": attn,
                "n_real": weight.sum(),
            }
        want_attn = self.need_attention or self.loss_name == "cesar"
        out = self.model(batch["wsi"], batch["omics"], batch["mask"],
                         need_attention=want_attn)
        loss, attn_loss = survival_loss(self.loss_name, out, batch["label"],
                                        batch["censorship"], self.alpha, weight)
        return {
            "loss": loss,
            "attn_loss": attn_loss,
            "risk": -out.survs.sum(dim=1),
            "hazards": out.hazards,
            "survs": out.survs,
            "y": out.y,
            "attention": out.attention if want_attn else None,
            "n_real": weight.sum(),
        }

    def _batch(self, wsi, mask, omics_rows, n_real: int) -> Dict[str, Any]:
        """Device batch of ``len(wsi)`` rows; rows past ``n_real`` are
        zero-weight filler (with zero omics for survival models)."""
        dev, n = self.device, wsi.shape[0]
        batch = {
            "wsi": wsi,
            "mask": mask,
            "label": torch.zeros((n,), dtype=torch.long, device=dev),
            "weight": (torch.arange(n, device=dev) < n_real).float(),
        }
        if self.ge_mode:
            return batch
        omics = []
        for j, s in enumerate(self.omic_sizes):
            col = np.zeros((n, s), np.float32)
            for row, sig in enumerate(omics_rows):
                col[row] = np.asarray(sig[j], np.float32)
            omics.append(torch.from_numpy(col).to(dev))
        batch["omics"] = omics
        batch["censorship"] = torch.zeros((n,), device=dev)
        return batch

    # ----------------------------------------------------------------- single
    def predict_bag(self, bag: np.ndarray, omics=None) -> Dict[str, np.ndarray]:
        """Score one bag [M, D] (with its omics signature list for survival
        models); the bag is padded to its bucket and the outputs de-batched."""
        if not self.ge_mode and omics is None:
            raise ValueError("survival models need the omics signature list")
        n = self.min_rows
        bucket = bucket_for(bag.shape[0], self.buckets)
        padded, m = pad_bag(np.asarray(bag, np.float32), bucket)
        wsi = np.zeros((n,) + padded.shape, np.float32)
        wsi[0] = padded
        mask = np.zeros((n,) + m.shape, bool)
        mask[0] = m
        batch = self._batch(torch.from_numpy(wsi).to(self.device),
                            torch.from_numpy(mask).to(self.device), [omics], 1)
        return self._debatch(self.eval_step(batch), 1)

    # ------------------------------------------------------------------ multi
    def predict_bags(self, bags: Sequence[np.ndarray], omics=None) -> Dict[str, np.ndarray]:
        """Score a list of bags in bucketed, FIXED-SHAPE batches of
        ``(batch_size, bucket, D)``; ``omics``: one signature list per bag
        (survival models) or None (GE). Outputs are row-aligned with the
        input order and filler rows are dropped. Each bag is copied straight
        into its row of a zeroed device batch (no padded host copy)."""
        n = len(bags)
        if n == 0:
            return {}
        if not self.ge_mode and (omics is None or len(omics) != n):
            raise ValueError("survival models need one omics signature list per bag")
        by_bucket: Dict[int, list] = {}
        for i, bag in enumerate(bags):
            by_bucket.setdefault(bucket_for(len(bag), self.buckets), []).append(i)
        slots: Dict[str, list] = {}
        bsz, dev = self.batch_size, self.device
        dim = int(np.asarray(bags[0]).shape[1])
        for bucket, idxs in sorted(by_bucket.items()):
            for c0 in range(0, len(idxs), bsz):
                chunk = idxs[c0:c0 + bsz]
                wsi = torch.zeros((bsz, bucket, dim), device=dev)
                mask = torch.zeros((bsz, bucket), dtype=torch.bool, device=dev)
                for row, i in enumerate(chunk):
                    bag = torch.from_numpy(np.ascontiguousarray(bags[i], np.float32))
                    wsi[row, :len(bag)] = bag.to(dev)
                    mask[row, :len(bag)] = True
                rows = [] if self.ge_mode else [omics[i] for i in chunk]
                batch = self._batch(wsi, mask, rows, len(chunk))
                out = self._debatch(self.eval_step(batch), len(chunk))
                for k, v in out.items():
                    slots.setdefault(k, [None] * n)
                    for row, i in enumerate(chunk):
                        slots[k][i] = v[row]
        return {k: np.stack(v) for k, v in slots.items()}

    # ------------------------------------------------------------------- util
    def _debatch(self, res: Dict[str, Any], real: int) -> Dict[str, np.ndarray]:
        keys = ("y",) if self.ge_mode else ("y", "risk", "hazards", "survs")
        return {k: res[k][:real].cpu().numpy() for k in keys}
