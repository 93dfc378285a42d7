"""Patient-level k-fold cross-validation (``multimodal_path_omic_tpu/train/cv.py``).

The reference evaluates on one seeded train/val split a run
(reference: mcat/main.py:239-252); the MCAT literature reports the
patient-level cross-validated c-index. :func:`cross_validate` runs k full
trainings over seeded patient-level folds (``data/tables.py::patient_kfold``)
and aggregates the final validation metric.

CLI: ``python -m multimodal_path_omic_tpu_torch.cli cv --config cfg.yaml
--folds 5 [--out cv_results.json] [--save-folds] [--fold-indices 0,2]``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional

import numpy as np


def cross_validate(config, k: int = 5, verbose: bool = True, fold_indices=None,
                   save_folds: bool = False) -> Dict:
    """Train ``k`` patient-level folds of ``config`` and aggregate: the rows
    of each fold's final metrics, and the mean and (population) standard
    deviation of the quality metric (``val_c_index`` for survival models,
    ``val_accuracy`` for GE). Each fold is a full training run, its split
    seeded from ``training.seed``.

    ``fold_indices``: the folds to run (one a job of an array, say); the
    split is always over all k. ``save_folds``: save each fold's final model
    under ``<checkpoint_dir>/fold<i>/`` (tag ``cv<i>``) and report the
    paths; repeated ``--checkpoint`` flags load them as an ensemble
    (``serve.py::Predictor.from_config``)."""
    from multimodal_path_omic_tpu_torch.data.dataset import GeneExprDataset, MultimodalDataset
    from multimodal_path_omic_tpu_torch.data.tables import patient_kfold
    from multimodal_path_omic_tpu_torch.models import is_ge_model
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    # the patient column of the dataset each fold's Trainer builds (its row
    # filters and missing-bag drops), without a Trainer's model
    ge_mode = is_ge_model(config.model.name)
    if ge_mode:
        ds = GeneExprDataset(config.dataset.file, config, gene=config.model.gene, verbose=False)
    else:
        ds = MultimodalDataset(config.dataset.file, config, use_signatures=True, verbose=False)
    patients = ds.table.patients
    metric_key = "val_accuracy" if ge_mode else "val_c_index"
    del ds

    folds = patient_kfold(patients, k, seed=config.training.seed)
    run = list(range(k)) if fold_indices is None else list(fold_indices)
    if not run:
        raise ValueError("fold_indices is empty: nothing to run")
    bad = [i for i in run if not 0 <= i < k]
    if bad:
        raise ValueError(f"fold_indices {bad} out of range for k={k}")
    rows = []
    for i in run:
        tr_rows, va_rows = folds[i]
        if verbose:
            print(f"=== fold {i + 1}/{k}: {len(tr_rows)} train / {len(va_rows)} val rows")
        fold_cfg = copy.deepcopy(config)
        if fold_cfg.model.checkpoint_dir:
            # one namespace a fold: folds would otherwise share the
            # minute-resolution checkpoint names
            fold_cfg.model.checkpoint_dir = os.path.join(fold_cfg.model.checkpoint_dir,
                                                         f"fold{i}")
        trainer = Trainer(fold_cfg, verbose=False, split_rows=(tr_rows, va_rows))
        out = trainer.fit()
        row = {"fold": i, **{m: float(v) for m, v in out.items()}}
        if save_folds:
            if not fold_cfg.model.checkpoint_dir:
                raise ValueError("save_folds needs model.checkpoint_dir set in the config")
            # save() takes the 0-based epoch just finished
            row["checkpoint"] = trainer.save(config.training.epochs - 1,
                                             row.get("val_loss", 0.0), tag=f"cv{i}")
        rows.append(row)
        if verbose:
            print(f"    fold {i + 1}: {metric_key}={row[metric_key]:.4f}")
    vals = np.array([r[metric_key] for r in rows])
    result = {"metric": metric_key, "folds": rows, "mean": float(vals.mean()),
              "std": float(vals.std()), "k": k}
    if verbose:
        print(f"{k}-fold {metric_key}: {result['mean']:.4f} ± {result['std']:.4f}")
    return result


def save_results(result: Dict, path: Optional[str]) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
