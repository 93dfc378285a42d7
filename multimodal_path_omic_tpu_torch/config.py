"""Typed configuration mirroring the reference YAML schema
(``multimodal_path_omic_tpu/config.py``; the port's own copy).

The reference loads a raw YAML dict with sections ``device / wandb / dataset /
model / training`` (reference: models/mcat/config/config.yaml:1-76,
models/mcat/main.py:218-220) and accesses keys untyped. Here the same schema is
parsed into validated dataclasses, so an existing reference config file loads
unchanged, plus a few TPU-specific extensions (bag buckets, batch size, dtype,
mesh axes) under ``tpu:``. The ``tpu:`` section keeps its name and field
names, so every configuration file of the JAX package loads here unchanged.

:func:`require_supported` names the settings the port cannot honour yet;
``train/trainer.py`` calls it before it builds anything.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

VALID_LOSSES = ("ce", "ces", "sct", "cesar", "nll", "cox")
VALID_OPTIMIZERS = ("sgd", "adam", "rms", "adamax", "adadelta")
VALID_SCHEDULERS = (None, "exp", "cosine", "step")
VALID_FUSIONS = ("concat", "gated_concat", "bilinear")
VALID_MODEL_SIZES = ("small", "medium", "big")


@dataclass
class WandbConfig:
    """reference: models/mcat/main.py:186-215 (wandb_init)."""

    enabled: bool = False
    project: str = ""


@dataclass
class DatasetConfig:
    """reference: models/mcat/config/config.yaml:12-30, dataset/dataset.py:13-114."""

    name: str = "synthetic"
    file: Optional[str] = None
    patches_dir: Optional[str] = None
    h5_dataset: Optional[str] = None
    signatures: Optional[str] = None
    decider_only: bool = False
    tcga_only: bool = False
    diagnostic_only: bool = False
    normalize: bool = False
    standardize: bool = True


@dataclass
class ModelConfig:
    """reference: models/mcat/config/config.yaml:33-45."""

    name: str = "MCAT"
    load_from_checkpoint: Optional[str] = None
    checkpoint_epoch: int = 0
    checkpoint_dir: str = "checkpoints/"
    fusion: str = "concat"
    model_size: str = "medium"
    gene: Optional[str] = None  # GE-NaCAGaT only (ge_nacagat/config/config.yaml:18)
    n_classes: int = 4
    dropout: float = 0.25

    def __post_init__(self):
        if self.fusion not in VALID_FUSIONS:
            raise ValueError(f"fusion must be one of {VALID_FUSIONS}, got {self.fusion!r}")
        if self.model_size not in VALID_MODEL_SIZES:
            raise ValueError(
                f"model_size must be one of {VALID_MODEL_SIZES}, got {self.model_size!r}"
            )


@dataclass
class TrainingConfig:
    """reference: models/mcat/config/config.yaml:48-76."""

    leave_one_out: Optional[str] = None
    output_attn_epoch: int = 20
    test_output_dir: str = "outputs/"
    train_size: float = 0.8
    loss: str = "ces"
    epochs: int = 20
    optimizer: str = "adam"
    lr: float = 2e-4
    weight_decay: float = 1e-5
    grad_acc_step: int = 32
    scheduler: Optional[str] = None
    alpha: float = 0.75
    lambda_: float = 0.0  # "lambda" in YAML; L1 reg coefficient
    gamma: float = 1.0
    seed: int = 0  # NEW: the reference split shuffle is unseeded (dataset.py:154)
    # Attention-map export format: "npy" (native) or "pt" (drop-in compatible
    # with the reference's torch.save export, mcat/main.py:180-183).
    attn_export_format: str = "npy"
    # Replicate the reference's bugs exactly for A/B reproduction studies
    # (SURVEY.md §7.1): unseeded patient split (dataset.py:154), misaligned
    # signature/label subsets in splits (dataset.py:238-241, ge_dataset.py:114),
    # frozen untrained gates in GatedConcatFusion (fusion.py:25-27).
    bug_compat: bool = False
    # Best-model retention: whenever the monitored validation metric improves,
    # overwrite a rolling checkpoint at <ckpt_dir>/<model>_<dataset>_best.
    # (No reference equivalent — it keeps only periodic timestamped saves,
    # mcat/main.py:88-100.)
    keep_best: bool = False
    # Early stopping patience: stop after this many consecutive validated
    # epochs without improvement of the monitored metric. 0 disables.
    early_stopping: int = 0
    # Metric watched by keep_best/early_stopping. "auto" = val_c_index for
    # survival models, val_accuracy for GE (falls back to val_loss when the
    # epoch produced no metric). val_loss is minimized; the others maximized.
    monitor: str = "auto"
    # Global-gradient-norm clipping before the optimizer update
    # (torch.nn.utils.clip_grad_norm_ semantics). 0 disables — the
    # reference's exact behavior (it never clips).
    grad_clip: float = 0.0
    # Epoch-indexed LR schedule knobs (train/optim.py::schedule_lr). The
    # reference's only scheduler is ExponentialLR (mcat/main.py:302-305);
    # "cosine" (torch CosineAnnealingLR shape, decaying to min_lr) and
    # "step" (StepLR: lr *= gamma every step_size epochs) are additions,
    # and warmup_epochs linearly ramps the first W epochs under ANY
    # scheduler (including none/exp). All default to off.
    warmup_epochs: int = 0
    min_lr: float = 0.0
    step_size: int = 10
    # Patch dropout: each TRAIN step hides this fraction of every bag's real
    # patches from attention (seeded, per bag per step; eval always sees the
    # full bag). The TPU-native form of the patch-subsampling regularizer
    # common in large-scale MIL: static shapes, dynamic masks — the masked
    # softmax excludes hidden patches EXACTLY on every path (XLA, fused
    # kernel, ring, seq-parallel). 0 disables (the reference has no
    # equivalent). Bags whose every real patch would be hidden keep their
    # full mask instead.
    patch_dropout: float = 0.0
    # NaN debugging: enables jax_debug_nans, which re-runs the offending
    # computation op-by-op when any jit output goes non-finite and raises
    # pinpointing the exact primitive. Opt-in: it synchronizes every
    # dispatch (the headline throughput config is dispatch-bound). The
    # always-on guard is cheaper and coarser: every epoch's losses are
    # finiteness-checked on the host and a non-finite one aborts the run
    # naming epoch + step (trainer.py::_train_epoch) — the survival losses
    # are log/clamp minefields by heritage (reference: loss.py:21-25).
    debug_nans: bool = False

    def __post_init__(self):
        if self.loss not in VALID_LOSSES:
            raise ValueError(f"loss must be one of {VALID_LOSSES}, got {self.loss!r}")
        if self.attn_export_format not in ("npy", "pt"):
            raise ValueError(
                f'attn_export_format must be "npy" or "pt", got {self.attn_export_format!r}'
            )
        if self.scheduler not in VALID_SCHEDULERS:
            raise ValueError(
                f"scheduler must be one of {VALID_SCHEDULERS}, got {self.scheduler!r}"
            )
        if not 0.0 < self.train_size < 1.0:
            raise ValueError("train_size should be a float between 0 and 1.")
        if self.grad_acc_step < 1:
            raise ValueError(
                f"grad_acc_step must be >= 1, got {self.grad_acc_step} "
                "(it is the effective batch; tpu.batch_size=0 inherits it)"
            )
        # The reference silently falls back to adam for unknown optimizer names
        # (mcat/main.py:296-299); keep that lenience but normalise the name.
        if self.optimizer not in VALID_OPTIMIZERS:
            self.optimizer = "adam"
        if self.warmup_epochs < 0:
            raise ValueError(
                f"warmup_epochs must be >= 0, got {self.warmup_epochs}"
            )
        if self.min_lr < 0:
            raise ValueError(f"min_lr must be >= 0, got {self.min_lr}")
        if self.step_size < 1:
            raise ValueError(
                f"step_size must be >= 1 (epochs between step-LR decays), "
                f"got {self.step_size}"
            )
        if not 0.0 <= self.patch_dropout < 1.0:
            raise ValueError(
                f"patch_dropout must be in [0, 1), got {self.patch_dropout}"
            )
        if self.early_stopping < 0:
            raise ValueError(
                f"early_stopping must be >= 0 (patience in validated epochs; "
                f"0 disables), got {self.early_stopping}"
            )
        valid_monitors = ("auto", "val_c_index", "val_accuracy", "val_loss")
        if self.monitor not in valid_monitors:
            raise ValueError(
                f"monitor must be one of {valid_monitors}, got {self.monitor!r}"
            )
        if self.grad_clip < 0:
            raise ValueError(
                f"grad_clip must be >= 0 (max global grad norm; 0 disables), "
                f"got {self.grad_clip}"
            )


@dataclass
class TpuConfig:
    """TPU-specific extensions with sensible defaults (no reference equivalent)."""

    # Padded bag-length buckets: each bag is padded up to the smallest bucket
    # that fits it; one jit trace is compiled per bucket.
    bag_buckets: List[int] = field(default_factory=lambda: [512, 1024, 2048, 4096, 8192, 16384, 24576])
    # Device batch: bags per optimizer step. 0 (default) inherits
    # training.grad_acc_step — the reference's effective batch
    # (mcat/main.py:69-74) — so a reference YAML that changes grad_acc_step
    # keeps its optimizer-update cadence here without also setting this.
    # Setting it explicitly overrides grad_acc_step.
    batch_size: int = 0
    # Compute dtype for layer activations: "auto", "float32" or "bfloat16".
    # Survival heads always stay f32 (bf16 sigmoid saturates, round-2 fix).
    # "auto" (default) = bfloat16 on TPU when the device batch is >= 128
    # (measured +14% at B=256 on top of bf16 feeding; cast overhead LOSES
    # ~12% at B=32), float32 otherwise. On TPU the MXU runs bf16 matmul
    # passes at default precision either way — this knob additionally makes
    # the elementwise/normalization chain bf16 (halved HBM traffic).
    compute_dtype: str = "auto"
    # XLA matmul precision: "default" (fast bf16 MXU passes) or "highest"
    # (true f32 accumulation — use for strict numerics parity runs).
    matmul_precision: str = "default"
    # PRNG implementation for dropout keys: "rbg" (fast counter-based PRNG,
    # ~10% step-time win on TPU) or "threefry2x32" (jax default).
    prng_impl: str = "rbg"
    # Dtype for the host->device WSI transfer: "auto", "float32", "bfloat16"
    # (halves H2D bytes) or "int8" (quarter H2D bytes; per-patch symmetric
    # quantization, data/quant.py — patch embeddings tolerate it).
    # "auto" (default) = bfloat16 on TPU, float32 elsewhere: under the
    # default matmul precision the MXU consumes bf16 operands anyway, so f32
    # feeding only buys a giant on-device convert (profiled at ~19% of a
    # B=256 step, round 3) — bf16 feeding is bit-identical math.
    transfer_dtype: str = "auto"
    # Storage dtype of the device-resident dataset cache: "auto", "float32",
    # "bfloat16" (half the budget per bag, convert-free MXU feeding) or
    # "int8" (~4x more cohort fits device_cache_budget_bytes, 4x cheaper
    # on-device batch gathers; same quantization as transfer_dtype=int8).
    # "auto" = bfloat16 on TPU, float32 elsewhere (same reasoning as
    # transfer_dtype).
    cache_dtype: str = "auto"
    # Run the first (WSI 1024->d) projection as s8 x s8 -> s32 on the MXU
    # when bags arrive int8-quantized (transfer_dtype/cache_dtype "int8"):
    # the kernel quantizes per-column in-graph and dequant happens AFTER the
    # dot (ops/layers.py::w8a8_linear), so the [B, M, 1024] float activation
    # never exists and the dominant matmul runs at the int8 MAC rate.
    # No effect unless the feed is int8. Training only; eval dequantizes.
    int8_matmul: bool = False
    # Data-parallel mesh axis size (1 = single chip).
    data_axis: int = 1
    # Sequence-parallel mesh axis size (patch dimension sharding).
    seq_axis: int = 1
    # Use Pallas fused kernels where available.
    use_pallas: bool = True
    # Recompute the [B, M, d] patch-axis intermediates in the backward pass
    # instead of saving them (ops/remat.py: the WSI-encoder activations and
    # the attention q/k/v projections, the tensors JAX tags 'remat_big').
    # Trades one extra pass of those matmuls for the model's largest
    # residuals; the gradients are the same bit for bit.
    remat: bool = False
    # Host pipeline prefetch depth: dispatch groups read, padded and staged
    # on the card ahead of the steps (data/pipeline.py::prefetch).
    prefetch: int = 2
    # C++ pipelined epoch executor (native slot ring). The Trainer closes the
    # slot-aliasing hazard in _device_batch (copy on CPU / transfer-completion
    # on accelerators), so it is safe to auto-engage.
    use_native_pipeline: bool = True
    # Optimizer steps per dispatch group: K consecutive same-bucket batches
    # staged together and run as one multi-step (train/loop.py::
    # multi_step_of; each step a CUDA graph replay on the card), EXACTLY K
    # single steps. 0 (default) = auto: 64, with leftovers grouped down a
    # (K, 8, 1) ladder and host-fed groups capped at 1 GiB of stacked bags.
    steps_per_dispatch: int = 0
    # Device-resident dataset cache (data/device_cache.py): upload every bag
    # once, gather training batches on device — steady-state epochs transfer
    # only KBs of indices. "auto" engages for whatever fits the budget below
    # (buckets beyond it host-feed: partial caching); "on" forces the full
    # cohort; "off" disables. Composes with meshes (the cache shards its
    # patch axis over every mesh device) AND multi-host (each process
    # contributes its addressable shards of the global cache arrays);
    # multi-host does not partial-cache — over budget it host-feeds.
    device_cache: str = "auto"
    # PER-DEVICE cache budget: on an n-device mesh the cohort capacity is
    # n x this (the cache is sharded, not replicated).
    device_cache_budget_bytes: int = 4 << 30
    # Persistent XLA compilation cache directory (jax_compilation_cache_dir):
    # repeated runs skip the multi-minute first-epoch compile. Empty = off.
    compilation_cache_dir: str = ""

    def __post_init__(self):
        if self.compute_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f'compute_dtype must be "auto", "float32" or "bfloat16", '
                f"got {self.compute_dtype!r}"
            )
        if self.transfer_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                f'transfer_dtype must be "auto", "float32", "bfloat16" or '
                f'"int8", got {self.transfer_dtype!r}'
            )
        if self.cache_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                f'cache_dtype must be "auto", "float32", "bfloat16" or '
                f'"int8", got {self.cache_dtype!r}'
            )
        # normalize + validate: only exact 'auto'/'on' engage the cache, so a
        # stray capitalization ("On") or typo would otherwise silently disable
        self.device_cache = str(self.device_cache).strip().lower()
        if self.device_cache not in ("auto", "on", "off"):
            raise ValueError(
                f'device_cache must be "auto", "on" or "off", got {self.device_cache!r}'
            )
        if self.batch_size < 0:
            raise ValueError(
                f"batch_size must be >= 0 (0 = inherit grad_acc_step), got {self.batch_size}"
            )
        if self.steps_per_dispatch < 0:
            raise ValueError(
                f"steps_per_dispatch must be >= 0 (0 = auto), got {self.steps_per_dispatch}"
            )


@dataclass
class Config:
    device: str = "tpu"
    wandb: WandbConfig = field(default_factory=WandbConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)


def parse_cli_scalar(raw: str) -> Any:
    """YAML-parse one CLI-provided value (``--set``/``--grid``) with the
    on/off guard: YAML 1.1 coerces on/off/yes/no to booleans, which silently
    corrupts string-valued settings (``--set tpu.device_cache=on`` became the
    string "True"). Only true/false spellings mean booleans here; the typed
    config coerces strings onto bool fields as needed (_apply_override)."""
    parsed = yaml.safe_load(raw)
    if isinstance(parsed, bool) and raw.strip().lower() not in ("true", "false"):
        parsed = raw.strip()
    return parsed


def _build(cls, raw: Dict[str, Any]):
    """Construct a dataclass from a raw dict, mapping the YAML key ``lambda``
    to ``lambda_``. Unknown keys are TOLERATED (reference configs may carry
    extras; drop-in compatibility requires not erroring) but warned about —
    a typo'd knob (``device_cahce: off``) silently keeping its default is a
    far worse failure mode than one stderr line."""
    if raw is None:
        raw = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        name = "lambda_" if key == "lambda" else key
        if name in fields:
            kwargs[name] = value
        else:
            import sys as _sys

            print(
                f"WARNING: unknown config key '{key}' in the "
                f"{cls.__name__} section — ignored (typo?)",
                file=_sys.stderr,
            )
    return cls(**kwargs)


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a reference-schema YAML config file into a typed `Config`.

    ``overrides`` is a flat dict of dotted keys (e.g. ``{"training.lr": 1e-3}``)
    applied after parsing — the CLI uses this (the reference has no CLI and
    hard-codes the config path, mcat/main.py:343-345).
    """
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = config_from_dict(raw)
    if overrides:
        for dotted, value in overrides.items():
            _apply_override(cfg, dotted, value)
    return cfg


def config_from_dict(raw: Dict[str, Any]) -> Config:
    return Config(
        device=raw.get("device", "tpu"),
        wandb=_build(WandbConfig, raw.get("wandb")),
        dataset=_build(DatasetConfig, raw.get("dataset")),
        model=_build(ModelConfig, raw.get("model")),
        training=_build(TrainingConfig, raw.get("training")),
        tpu=_build(TpuConfig, raw.get("tpu")),
    )


def _apply_override(cfg: Config, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    obj: Any = cfg
    for part in parts[:-1]:
        obj = getattr(obj, part)
    leaf = "lambda_" if parts[-1] == "lambda" else parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"Unknown config key: {dotted}")
    current = getattr(obj, leaf)
    if isinstance(current, bool) and isinstance(value, str):
        # bool("off") would be True; map the usual spellings explicitly
        low = value.strip().lower()
        if low in ("true", "yes", "on", "1"):
            value = True
        elif low in ("false", "no", "off", "0"):
            value = False
        else:
            raise ValueError(f"cannot parse {value!r} as a boolean for {dotted}")
    elif current is not None and value is not None and not isinstance(value, type(current)):
        coerced = type(current)(value)
        if isinstance(current, int) and isinstance(value, float) and coerced != value:
            # int(19.9) == 19 would silently run with a different value than
            # the user asked for — reject non-integral overrides of int fields
            raise ValueError(
                f"{dotted}={value!r} is not an integer (field is int-typed)"
            )
        value = coerced
    setattr(obj, leaf, value)
    # dataclass validation runs in __post_init__, which plain setattr skips —
    # re-run it so a bad override fails at load time, not mid-training; on
    # failure roll the field back so the config object stays usable (a later
    # override must not re-trip on the rejected value)
    post = getattr(obj, "__post_init__", None)
    if post is not None:
        try:
            post()
        except Exception:
            setattr(obj, leaf, current)
            raise


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    # round-trip the YAML spelling of lambda
    d["training"]["lambda"] = d["training"].pop("lambda_")
    return d



def resolve_dtype(value: str) -> str:
    """A ``tpu.compute_dtype`` / ``transfer_dtype`` / ``cache_dtype`` value
    as the port runs it: "auto" is "float32", as the JAX package resolves it
    off a TPU (``resolve_compute_dtype``, ``_feed_dtype``: bfloat16 only on a
    TPU); "float32", "bfloat16" and "int8" stand."""
    return "float32" if value == "auto" else value


def require_supported(cfg: Config, world: Optional[int] = None) -> None:
    """Raise for a setting the port cannot honour. A mesh (``tpu.data_axis`` x ``tpu.seq_axis`` > 1) needs exactly that
    many ranks, one a device (torchrun's world, ``world``; by default the
    process group's or torchrun's ``WORLD_SIZE``): another world size raises
    ``ValueError`` naming it, as the JAX ``make_mesh`` refuses a mesh that
    needs more devices than exist. A reference ``.pt`` checkpoint under
    ``model.load_from_checkpoint`` is refused where it is read
    (``Trainer.restore``); and a bfloat16 shape whose float32 kernel has no
    bfloat16 instance on the card, where the module reaches it
    (``kernels.takes``: only the eval fuse-K form at E != F, which no
    shipped configuration reaches)."""
    t = cfg.tpu
    n = t.data_axis * t.seq_axis
    if n > 1:
        if world is None:
            from multimodal_path_omic_tpu_torch.parallel.comm import world_size

            world = world_size()
        if n != world:
            raise ValueError(
                f"tpu.data_axis={t.data_axis} x tpu.seq_axis={t.seq_axis} needs {n} ranks, one a "
                f"device, but the world size is {world}: launch {n} ranks with torchrun "
                f"(--nproc-per-node {n})")
