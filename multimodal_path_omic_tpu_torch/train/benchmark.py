"""Training throughput (``multimodal_path_omic_tpu/train/benchmark.py``):
``cli bench`` on the user's own config and data, and the headline workload
of the repository's ``bench.py`` on the card.

:func:`benchmark_training` runs untimed warm-up epochs (the kernels' build,
the CUDA graphs' capture, the device cache's upload), then times
steady-state epochs with the host clock around work that ends in a device
sync, and prints one JSON line.

:func:`headline` trains ``bench.py``'s three models at their published
widths on batches staged on the card once: MCAT ``medium`` (``ces``),
NaCAGaT ``medium`` (``cesar``) and GE-NaCAGaT ``medium`` (``ce``), B = 32
bags of 500 1024-wide patches padded to the 512 bucket, six omic groups of
100..600 genes, Adam (lr 2e-4, weight decay 1e-5), dropout 0.25, random
weights from seed 0. Each call is one multi-step of K steps over a
[K, 32, ...] batch (``make_multi_train_step``; one batch repeated, as in
``bench.py``), timed graphed and eager; the best of several windows. One JSON line per model, MCAT last
(``mcat_train_bags_per_sec``). The patches are fed in bfloat16, as
``bench.py`` feeds them (``bench.py:73-80``); the models compute in float32
(their first layer casts the patches).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict

import numpy as np
import torch

OMIC_SIZES = (100, 200, 300, 400, 500, 600)
BATCH, BAG, BUCKET, WSI_DIM = 32, 500, 512, 1024
HEADLINE_MODELS = (("nacagat", "NaCAGaT", "cesar"), ("ge", "GE-NaCAGaT", "ce"),
                   ("mcat", "MCAT", "ces"))


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_training(config, epochs: int = 5, warmup: int = 1, validate: bool = False,
                       verbose: bool = True) -> Dict[str, Any]:
    """Run ``warmup`` untimed epochs, then ``epochs`` timed ones; returns the
    measurement (printed as one JSON line when ``verbose``).
    ``validate`` times ``validated_epoch`` (training, validation and one
    metric fetch, as ``fit`` runs them) instead of ``train_epoch``."""
    if epochs < 1 or warmup < 0:
        raise ValueError("need epochs >= 1 and warmup >= 0")
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    trainer = Trainer(config, verbose=False)
    n_train = len(trainer.train_ds)
    if n_train == 0:
        raise ValueError("empty training split: nothing to benchmark")
    t0 = time.perf_counter()
    cache_engaged = trainer._ensure_device_cache()
    _sync(trainer.device)
    upload_s = time.perf_counter() - t0

    def run(e: int) -> None:
        if validate:
            trainer.validated_epoch(e)
        else:
            trainer.train_epoch(e)
        _sync(trainer.device)

    for e in range(warmup):
        run(e)
    train_s = []
    for e in range(warmup, warmup + epochs):
        t0 = time.perf_counter()
        run(e)
        train_s.append(time.perf_counter() - t0)
    med = float(np.median(train_s))
    result: Dict[str, Any] = {
        "metric": "train_bags_per_sec_e2e",
        "value": round(n_train / med, 1),
        "unit": "bags/sec",
        "backend": trainer.device.type,
        "device": _device_name(trainer.device),
        "n_train_bags": n_train,
        "steps_per_epoch": getattr(trainer, "last_epoch_steps", None),
        # a validated epoch is one chain; its time is all under the train key
        "median_train_epoch_s": round(med, 4),
        "median_val_epoch_s": 0.0 if validate else None,
        "validated_cadence": bool(validate),
        "warmup_epochs": warmup,
        "timed_epochs": epochs,
        "device_cache": bool(cache_engaged),
        "cache_dtype": trainer.cache_dtype if cache_engaged else None,
        "cache_upload_s": round(upload_s, 3),
        "steps_per_dispatch": trainer.steps_per_dispatch,
        "batch_size": trainer.batch_size,
        "cuda_graphs": trainer.graphs is not None,
    }
    if verbose:
        print(json.dumps(result), flush=True)
    return result


def headline_batch(device, ge_mode: bool, k: int) -> Dict[str, Any]:
    """``bench.py``'s batch (numpy seed 0) on ``device``, broadcast to a
    [k, ...] stack without copies."""
    rng = np.random.default_rng(0)
    mask = np.zeros((BATCH, BUCKET), bool)
    mask[:, :BAG] = True
    batch = {
        "wsi": rng.normal(size=(BATCH, BUCKET, WSI_DIM)).astype(np.float32),
        "mask": mask,
        "label": rng.integers(0, 3 if ge_mode else 4, BATCH).astype(np.int64),
        "weight": np.ones((BATCH,), np.float32),
    }
    if not ge_mode:
        batch["omics_packed"] = np.concatenate(
            [rng.normal(size=(BATCH, s)).astype(np.float32) for s in OMIC_SIZES], axis=1)
        batch["censorship"] = rng.integers(0, 2, BATCH).astype(np.float32)
        batch["survival_months"] = rng.uniform(1, 100, BATCH).astype(np.float32)
    out = {key: torch.from_numpy(v).to(device) for key, v in batch.items()}
    out["wsi"] = out["wsi"].to(torch.bfloat16)  # bench.py's bfloat16 feed
    return {key: t.expand((k,) + t.shape) for key, t in out.items()}


def _bags_per_sec(step, state, stacked, k: int, n_calls: int, n_windows: int,
                  device) -> float:
    for _ in range(2):  # warm-up: the kernels' build, the graph's capture
        state, metrics = step(state, stacked)
        # one batch over and over (as bench.py trains) overfits: censored
        # rows are driven toward S_y = 1, where the censored term
        # (1 - c) * log(1 - S_y) of cross_entropy_survival is 0 * (-inf) =
        # NaN once S_y rounds to 1.0 in float32. The port keeps that term as
        # the JAX package and the reference have it, on purpose (parity), so
        # only the warm-up's losses are held finite
        if not bool(torch.isfinite(metrics.loss).all()):
            raise FloatingPointError("a headline training loss is not finite")
    best = 0.0
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            state, metrics = step(state, stacked)
        float(metrics.loss[-1])  # the chained last step: a hard sync
        best = max(best, n_calls * k * BATCH / (time.perf_counter() - t0))
    return best


def headline(device=None, k: int = 16, n_calls: int = 8, n_windows: int = 4,
             verbose: bool = True):
    """Train bags/s of ``bench.py``'s three models (see the module doc),
    graphed and eager, K steps a call; one JSON line per model, MCAT last.
    Returns the rows."""
    from multimodal_path_omic_tpu_torch.device import resolve_device
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_multi_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    device = resolve_device(device)
    rows = []
    for key, name, loss in HEADLINE_MODELS:
        ge_mode = key == "ge"
        stacked = headline_batch(device, ge_mode, k)
        rates = {}
        for graphs in (False, True):  # each from the same start
            model = build_model(name, omic_sizes=() if ge_mode else OMIC_SIZES,
                                model_size="medium", dropout=0.25, wsi_dim=WSI_DIM,
                                n_classes=3 if ge_mode else None)
            model = seeded_init_(model, 0).to(device)
            opt = make_optimizer("adam", 2e-4, 1e-5)
            step = make_multi_train_step(model, loss, opt, ge_mode=ge_mode,
                                         omic_sizes=None if ge_mode else OMIC_SIZES,
                                         graphs=graphs)
            rates[graphs] = _bags_per_sec(step, init_train_state(model, opt, seed=1), stacked,
                                          k, n_calls, n_windows, device)
        row = {"metric": f"{key}_train_bags_per_sec", "value": round(rates[True], 1),
               "unit": "bags/sec", "eager_bags_per_sec": round(rates[False], 1),
               "cuda_graphs": device.type == "cuda", "steps_per_call": k, "batch": BATCH,
               "bucket": BUCKET, "loss": loss, "device": _device_name(device)}
        rows.append(row)
        if verbose:
            print(json.dumps(row), flush=True)
        del model, opt, step, stacked
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows
