"""Synthetic dataset generator for tests and benchmarks
(``multimodal_path_omic_tpu/data/synthetic.py``; the port's own copy: the
same seed writes the same CSV and the same bags).

The reference's integration tests depend on absent external data
(reference: dataset.py:250-343 needs ../input/*.csv). This generator builds a
self-contained miniature cohort on disk — clinical CSV with rnaseq/cnv/mut
columns, a signatures CSV, and bags in any backend format — so the full
pipeline (CSV -> split -> buckets -> train -> c-index) is testable hermetically.

The survival signal is planted: survival_months correlates with the mean of a
subset of rnaseq columns, so a working model/trainer should achieve a c-index
meaningfully above 0.5.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import pandas as pd
import torch


def make_synthetic_cohort(
    out_dir: str,
    *,
    n_patients: int = 24,
    slides_per_patient: int = 1,
    n_genes: int = 60,
    n_signatures: int = 6,
    bag_lengths: Sequence[int] = (200, 350, 500),
    embedding_dim: int = 1024,
    bag_format: str = "npy",
    seed: int = 0,
    signal_strength: float = 1.0,
    informative_patch_frac: float = 1.0,
    informative_patch_scale: float = 1.0,
    label_noise: float = 0.0,
) -> Tuple[str, str, str]:
    """Write a synthetic cohort; returns (csv_path, signatures_path, patches_dir).

    Schema matches what the reference expects (dataset/dataset.py:13-114):
    columns patient, slide_id (.svs names), survival_months, censorship,
    is_decider, source, plus <gene>_rnaseq/_cnv/_mut feature columns.

    Cohort hardness knobs (defaults reproduce the original dense cohort,
    bit-identically — the extra RNG draws only happen when engaged):

    * ``informative_patch_frac`` < 1.0 plants the WSI risk signal on only
      that fraction of each bag's patches (min 1) instead of every patch —
      the MIL-attention regime real WSIs live in, where regularizers like
      patch_dropout can actually matter.
    * ``informative_patch_scale`` multiplies the per-patch signal on those
      informative patches (compensates the pooled-signal dilution).
    * ``label_noise`` resamples that fraction of patients' survival times
      independently of their risk (broken labels).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    patches_dir = os.path.join(out_dir, "patches")
    os.makedirs(patches_dir, exist_ok=True)

    genes = [f"G{i:03d}" for i in range(n_genes)]
    rows = []
    bag_specs = []
    for p in range(n_patients):
        patient = f"P{p:03d}"
        rnaseq = rng.normal(size=n_genes)
        cnv = rng.normal(size=n_genes // 2)
        mut = rng.integers(0, 2, size=n_genes // 4).astype(float)
        # planted signal: risk driven by the first 10 genes
        risk = signal_strength * rnaseq[:10].mean() + 0.3 * rng.normal()
        survival = float(np.exp(2.0 - risk) * 10.0)
        if label_noise > 0.0 and rng.random() < label_noise:
            # broken label: survival independent of this patient's risk
            survival = float(np.exp(2.0 - rng.normal(scale=0.8)) * 10.0)
        censorship = float(rng.random() < 0.3)
        for s in range(slides_per_patient):
            slide = f"{patient}_S{s}.svs"
            row = {
                "patient": patient,
                "slide_id": slide,
                "survival_months": survival,
                "censorship": censorship,
                "is_decider": float(p % 2),
                "source": "diagnostic_slide" if p % 3 == 0 else "frozen_slide",
            }
            for g, v in zip(genes, rnaseq):
                row[f"{g}_rnaseq"] = v
            for i, v in enumerate(cnv):
                row[f"C{i:03d}_cnv"] = v
            for i, v in enumerate(mut):
                row[f"M{i:03d}_mut"] = v
            rows.append(row)
            m = int(rng.choice(bag_lengths))
            bag_specs.append((slide, m, risk))

    df = pd.DataFrame(rows)
    csv_path = os.path.join(out_dir, "cohort.csv")
    df.to_csv(csv_path, index=False)

    # signatures: n_signatures columns, ragged gene lists
    sig = {}
    per = max(2, n_genes // n_signatures)
    for i in range(n_signatures):
        chunk = genes[i * per : (i + 1) * per]
        sig[f"SIG{i}"] = pd.Series(chunk)
    sig_path = os.path.join(out_dir, "signatures.csv")
    pd.DataFrame(sig).to_csv(sig_path, index=False)

    def _plant(bag: np.ndarray, m: int, risk: float) -> None:
        # visual/risk signal in channel 0: every patch (dense cohort) or a
        # sparse informative subset (MIL-attention regime)
        if informative_patch_frac >= 1.0:
            bag[:, 0] += risk
        else:
            k = max(1, int(round(informative_patch_frac * m)))
            idx = rng.choice(m, size=k, replace=False)
            bag[idx, 0] += risk * informative_patch_scale

    # bags: embeddings whose mean encodes the planted risk weakly
    for slide, m, risk in bag_specs:
        bag = rng.normal(size=(m, embedding_dim)).astype(np.float32)
        _plant(bag, m, risk)
        stem = slide[:-4]
        if bag_format == "npy":
            np.save(os.path.join(patches_dir, stem + ".npy"), bag)
        elif bag_format == "pt":
            torch.save(torch.tensor(bag), os.path.join(patches_dir, stem + ".pt"))
        elif bag_format == "h5":
            pass  # written below in one file
        else:
            raise ValueError(bag_format)

    if bag_format == "h5":
        import h5py

        h5_path = os.path.join(out_dir, "bags.h5")
        with h5py.File(h5_path, "w") as f:
            for slide, m, risk in bag_specs:
                bag = rng.normal(size=(m, embedding_dim)).astype(np.float32)
                _plant(bag, m, risk)
                f.create_dataset(slide[:-4], data=bag)
        return csv_path, sig_path, h5_path

    return csv_path, sig_path, patches_dir


def synthetic_config_dict(
    csv_path: str, sig_path: str, patches_dir: str, h5: bool = False
) -> dict:
    """A reference-schema YAML-style config dict pointing at the cohort."""
    dataset = {
        "name": "synthetic",
        "file": csv_path,
        "patches_dir": None if h5 else patches_dir,
        "signatures": sig_path,
        "decider_only": False,
        "tcga_only": False,
        "diagnostic_only": False,
        "normalize": False,
        "standardize": True,
    }
    if h5:
        dataset["h5_dataset"] = patches_dir  # patches_dir holds the .h5 path
    return {
        "device": "tpu",
        "wandb": {"enabled": False, "project": "synthetic"},
        "dataset": dataset,
        "model": {
            "name": "MCAT",
            "load_from_checkpoint": None,
            "checkpoint_epoch": 0,
            "checkpoint_dir": "checkpoints/",
            "fusion": "concat",
            "model_size": "small",
        },
        "training": {
            "leave_one_out": None,
            "output_attn_epoch": 20,
            "test_output_dir": "outputs/",
            "train_size": 0.8,
            "loss": "ces",
            "epochs": 1,
            "optimizer": "adam",
            "lr": 2e-4,
            "weight_decay": 1e-5,
            "grad_acc_step": 8,
            "scheduler": None,
            "alpha": 0.75,
            "lambda": 0.0,
            "gamma": 1.0,
        },
        "tpu": {"bag_buckets": [512], "batch_size": 8},
    }
