"""Ahead-of-time model export for deployment on ``torch.export``
(``multimodal_path_omic_tpu/deploy.py``).

The reference has no deployment surface: its only inference path is the
in-process leave-one-out ``test()`` loop (reference: mcat/main.py:158-183).
Here a trained model is exported as one ``torch.export`` program per
(bucket, batch size), the trained parameters inside, so a consumer scores
bags from the bundle and the port's op library alone: no model classes, no
config, no checkpoint.

Bundle layout (one directory):

    manifest.json            model / bucket / omics metadata (the JAX keys,
                             plus the device the programs were exported on)
    b{bucket}_n{batch}.pt2   the forward program (``torch.export.save``)

Programs take ``(wsi [N, bucket, D] f32, mask [N, bucket] bool, *omics
[N, s_i] f32)`` and return ``{"hazards", "survs", "y", "risk"}`` (survival)
or ``{"y"}`` (GE): the Predictor's outputs. The forward is the Predictor's
eval forward: the co-attention map is requested for ``cesar`` (the export
passes), as the eval step requests it.

The kernels are ``ctypes`` calls, which ``torch.export`` cannot trace: the
eval forms a forward reaches are ``torch.library`` custom ops
(``mpo_torch::coattn_fused_k``, ``coattn_plain_k``, ``coattention_weights``
in ``ops/coattn.py``, ``mpo_torch::milpool``, ``mpo_torch::flash_fwd``),
each one node of the program: on the card the hand-written kernel, on the
CPU its plain version. The shape predicates choose each route at export
time from the static shapes, as the model chooses them at run time. (The
JAX bundle runs XLA only, ``use_pallas=False``; the port's runs its
kernels.) One artifact serves the CPU and the card: :class:`ExportedModel`
moves it to its device with ``torch.export.passes.move_to_device_pass``.
Loading imports the op modules, which register the ops; on the card it
builds the kernel libraries, and a library that does not build raises: a
bundle never runs a plain version on the card.

CLI: ``python -m multimodal_path_omic_tpu_torch.cli export-model --config
cfg.yaml --checkpoint ck --out bundle_dir``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def _platform(name: str) -> str:
    """A platform name as a torch device type ("tpu" and "gpu" mean the card)."""
    return "cuda" if name in ("tpu", "gpu", "cuda") else name


class _Forward(nn.Module):
    """The exported forward: the model in eval mode, deterministic, its
    parameters inside. ``weights_dtype`` bfloat16 stores them in bfloat16
    and upcasts them to float32 inside the program (a storage cast: every
    product still computes in float32)."""

    def __init__(self, model: nn.Module, ge_mode: bool, need_attention: bool,
                 weights_dtype: str):
        super().__init__()
        self.model = model
        self.ge_mode = ge_mode
        self.need_attention = need_attention
        self.bf16 = weights_dtype == "bfloat16"
        if self.bf16:
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)

    def forward(self, wsi, mask, *omics):
        if self.bf16:
            params = {k: v.float() for k, v in self.model.named_parameters()}
            call = lambda *a, **kw: torch.func.functional_call(self.model, params, a, kw)  # noqa: E731
        else:
            call = self.model
        if self.ge_mode:
            y, _ = call(wsi, mask)
            return {"y": y}
        out = call(wsi, list(omics), mask, need_attention=self.need_attention)
        # risk = -sum(survs): the reference's risk score (mcat/main.py:148)
        return {"hazards": out.hazards, "survs": out.survs, "y": out.y,
                "risk": -out.survs.sum(dim=1)}


def export_model(trainer, out_dir: str, *, buckets: Optional[Sequence[int]] = None,
                 batch_sizes: Sequence[int] = (1,), platforms: Optional[Sequence[str]] = None,
                 max_bag: Optional[int] = None, weights_dtype: str = "float32") -> Dict:
    """Export the trainer's (trained) model as a bundle, one program per
    (bucket, batch size), traced on the trainer's device. ``trainer``: a
    ``Trainer``, or a ``serve.Predictor`` (its model, buckets and loss).

    ``max_bag``: the in-process path takes a bag beyond the largest bucket
    by rounding up to a multiple of it (``data/bags.py::bucket_for``); a
    bundle has fixed shapes, so pass the largest bag you expect and the
    rounded-up buckets are exported too. ``platforms``: the devices each
    program is checked on after export (loaded, moved and run once on
    zeros; "cpu", "cuda", with "tpu" / "gpu" meaning the card; default the
    trainer's device); one listed without its device raises.
    ``weights_dtype`` "bfloat16" stores the parameters in bfloat16 (about
    half the bytes) and computes in float32; its outputs differ from the
    float32 bundle's by the weights' rounding."""
    from multimodal_path_omic_tpu_torch.data.bags import bucket_for
    from multimodal_path_omic_tpu_torch.ops.layers import set_mesh

    if weights_dtype not in ("float32", "bfloat16"):
        raise ValueError(f'weights_dtype must be "float32" or "bfloat16", got {weights_dtype!r}')
    device = trainer.device
    platforms = tuple(_platform(p) for p in (platforms or (device.type,)))
    for p in platforms:
        if p not in ("cpu", "cuda"):
            raise ValueError(f"unknown platform {p!r} (cpu, cuda)")
        if p == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("platform cuda listed but no CUDA device is available")
    model = set_mesh(copy.deepcopy(trainer.model), None).eval()  # exported at mesh size 1
    for p in model.parameters():
        p.requires_grad_(False)
    dim = int(model.H.fc.in_features)
    buckets = tuple(int(b) for b in (buckets or trainer.buckets))
    if max_bag is not None and max_bag > buckets[-1]:
        largest = buckets[-1]
        buckets = buckets + tuple(range(2 * largest, bucket_for(int(max_bag), buckets) + 1,
                                        largest))
    batch_sizes = tuple(int(n) for n in batch_sizes)
    ge_mode = bool(trainer.ge_mode)
    omic_sizes = () if ge_mode else tuple(int(s) for s in trainer.omic_sizes)
    loss = getattr(trainer, "loss_name", None) or trainer.config.training.loss
    need_attention = (not ge_mode) and loss == "cesar"
    fwd = _Forward(model, ge_mode, need_attention, weights_dtype)

    os.makedirs(out_dir, exist_ok=True)
    artifacts: Dict[str, str] = {}
    for bucket in buckets:
        for n in batch_sizes:
            args = _zero_args(n, bucket, dim, omic_sizes, device)
            with torch.no_grad():
                program = torch.export.export(fwd, args)
            program.example_inputs = None  # zeros of the program's shapes: not worth saving
            name = f"b{bucket}_n{n}.pt2"
            torch.export.save(program, os.path.join(out_dir, name))
            artifacts[f"{bucket}:{n}"] = name
    manifest = {
        "format_version": _FORMAT_VERSION,
        "model": type(trainer.model).__name__,
        "n_params": int(trainer.n_params),
        "weights_dtype": weights_dtype,
        "ge_mode": ge_mode,
        "dim": dim,
        "omic_sizes": list(omic_sizes),
        "buckets": list(buckets),
        "batch_sizes": list(batch_sizes),
        "platforms": list(platforms),
        "outputs": ["y"] if ge_mode else ["hazards", "survs", "y", "risk"],
        "artifacts": artifacts,
        "exported_on": device.type,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    for p in platforms:  # every program loads and runs where the bundle is meant to serve
        ExportedModel(out_dir, device=p).warmup()
    return manifest


def _zero_args(n: int, bucket: int, dim: int, omic_sizes, device) -> tuple:
    return ((torch.zeros((n, bucket, dim), device=device),
             torch.ones((n, bucket), dtype=torch.bool, device=device))
            + tuple(torch.zeros((n, s), device=device) for s in omic_sizes))


def _register_ops(device: torch.device) -> None:
    """Import the op modules (they register the ``mpo_torch::`` ops); on the
    card, build every kernel library now, so that a library that does not
    build raises here and not at the first request."""
    from multimodal_path_omic_tpu_torch.ops import coattn, flash, kernels, milpool  # noqa: F401

    if device.type == "cuda":
        kernels.build_all()


class ExportedModel:
    """Scores bags from a bundle: no model code, no checkpoint.

    ``device``: where the programs run (None: the GPU, as every entry point
    of the port; "cpu" asks for the CPU). A program exported on another
    device is moved on load. Programs are loaded once per (bucket, batch
    size); padding and bucket choice are the in-process path's
    (``data/bags.py``), so the outputs are a float32 Predictor's. A bag
    beyond the exported buckets raises (re-export with ``--max-bag``)."""

    def __init__(self, bundle_dir: str, device=None):
        from multimodal_path_omic_tpu_torch.device import resolve_device

        with open(os.path.join(bundle_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported bundle format {self.manifest.get('format_version')!r}")
        self._dir = bundle_dir
        self.device = resolve_device(_platform(device) if device is not None else None)
        _register_ops(self.device)
        self._programs: Dict[Tuple[int, int], nn.Module] = {}

    def _program(self, bucket: int, n: int) -> nn.Module:
        key = (bucket, n)
        if key not in self._programs:
            name = self.manifest["artifacts"].get(f"{bucket}:{n}")
            if name is None:
                raise ValueError(f"bundle has no program for bucket={bucket} batch={n}; "
                                 f"available: {sorted(self.manifest['artifacts'])}")
            program = torch.export.load(os.path.join(self._dir, name))
            if self.manifest.get("exported_on", "cpu") != self.device.type:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, str(self.device))
            self._programs[key] = program.module()
        return self._programs[key]

    def _bucket_for(self, m: int) -> int:
        from multimodal_path_omic_tpu_torch.data.bags import bucket_for

        buckets = sorted(self.manifest["buckets"])
        bucket = bucket_for(m, buckets)
        if bucket not in buckets:
            raise ValueError(f"bag of {m} patches needs bucket {bucket}, which this bundle does "
                             f"not carry (buckets: {buckets}); re-export with export-model "
                             "--max-bag")
        return bucket

    def _run(self, bucket: int, n: int, args) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self._program(bucket, n)(*args)

    def warmup(self, verbose: bool = False) -> list:
        """Load and run every (bucket, batch size) program once on zeros, so
        that the first request pays neither."""
        man = self.manifest
        warmed = []
        for key in sorted(man["artifacts"]):
            bucket, n = (int(x) for x in key.split(":"))
            res = self._run(bucket, n, _zero_args(n, bucket, man["dim"], man["omic_sizes"],
                                                  self.device))
            res["y"].cpu()
            warmed.append((bucket, n))
            if verbose:
                print(f"warmed bucket {bucket} batch {n}")
        return warmed

    def predict_bag(self, bag, omics=None) -> Dict[str, np.ndarray]:
        """Score one bag [M, D] (with its omics signature list for survival
        models); outputs de-batched."""
        out = self.predict_bags([bag], None if omics is None else [omics])
        return {k: v[0] for k, v in out.items()}

    def predict_bags(self, bags, omics=None) -> Dict[str, np.ndarray]:
        """Score a list of bags in the bundle's fixed-shape (bucket, batch
        size) programs: each bucket's bags in chunks of the smallest exported
        batch size that holds the rest (else the largest); outputs aligned
        with the input."""
        from multimodal_path_omic_tpu_torch.data.bags import pad_bag

        man = self.manifest
        n_bags = len(bags)
        if n_bags == 0:
            return {}
        if not man["ge_mode"] and (omics is None or len(omics) != n_bags):
            raise ValueError("survival bundles need one omics list per bag")
        dim = man["dim"]
        sizes = sorted(man["batch_sizes"])
        by_bucket: Dict[int, list] = {}
        for i, bag in enumerate(bags):
            if np.ndim(bag) != 2 or np.shape(bag)[1] != dim:
                raise ValueError(f"a bag must be [patches, {dim}], got {np.shape(bag)}")
            by_bucket.setdefault(self._bucket_for(len(bag)), []).append(i)
        slots: Dict[str, list] = {k: [None] * n_bags for k in man["outputs"]}
        for bucket, idxs in sorted(by_bucket.items()):
            c0 = 0
            while c0 < len(idxs):
                left = len(idxs) - c0
                n = next((s for s in sizes if s >= left), sizes[-1])
                chunk = idxs[c0:c0 + n]
                c0 += len(chunk)
                wsi = np.zeros((n, bucket, dim), np.float32)
                mask = np.zeros((n, bucket), bool)
                for row, i in enumerate(chunk):
                    wsi[row], mask[row] = pad_bag(np.asarray(bags[i], np.float32), bucket)
                args = [torch.from_numpy(wsi).to(self.device),
                        torch.from_numpy(mask).to(self.device)]
                if not man["ge_mode"]:
                    for j, s in enumerate(man["omic_sizes"]):
                        col = np.zeros((n, s), np.float32)
                        for row, i in enumerate(chunk):
                            col[row] = np.asarray(omics[i][j], np.float32)
                        args.append(torch.from_numpy(col).to(self.device))
                res = self._run(bucket, n, args)
                for k in man["outputs"]:
                    v = res[k].cpu().numpy()
                    for row, i in enumerate(chunk):
                        slots[k][i] = v[row]
        return {k: np.stack(v) for k, v in slots.items()}


def load_exported(bundle_dir: str, device=None) -> ExportedModel:
    return ExportedModel(bundle_dir, device=device)
