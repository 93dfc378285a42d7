"""Hyperparameter grid sweep (``multimodal_path_omic_tpu/train/sweep.py``).

The reference tunes by editing its YAML and resubmitting jobs by hand
(reference: models/mcat/config.yaml + README.md:14-33). One command trains
the cartesian product of dotted-config grids and ranks the points by the
run's quality metric:

    python -m multimodal_path_omic_tpu_torch.cli sweep --config cfg.yaml \\
        --grid training.lr=1e-4,2e-4 --grid model.fusion=concat,bilinear \\
        --out sweep.json

Each point is a full training run under the merged config; its row carries
the point's overrides beside the final metrics, best first.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence


def parse_grid(specs: Sequence[str]) -> List[Dict]:
    """``key=v1,v2,...`` specs -> the override dicts of their cartesian
    product. Values parse as ``--set`` values do (``config.parse_cli_scalar``)."""
    from multimodal_path_omic_tpu_torch.config import parse_cli_scalar

    axes = []
    for spec in specs:
        if "=" not in spec:
            raise ValueError(f"--grid expects key=v1,v2,..., got {spec!r}")
        key, values = spec.split("=", 1)
        parsed = [parse_cli_scalar(raw) for raw in values.split(",")]
        if not parsed:
            raise ValueError(f"--grid {key!r} has no values")
        axes.append((key, parsed))
    return [dict(zip((k for k, _ in axes), combo))
            for combo in itertools.product(*(vs for _, vs in axes))]


def run_sweep(config_path: str, grids: Sequence[str], base_overrides: Optional[Dict] = None,
              metric: Optional[str] = None, verbose: bool = True) -> Dict:
    """Train every grid point; rows best first by ``metric`` (default:
    ``val_c_index`` for survival models, ``val_accuracy`` for GE). A metric
    named like a loss (``*loss*`` / ``*mse*``) ranks ascending, any other
    descending. An unknown ``metric`` raises after the first run, not after
    the whole grid."""
    from multimodal_path_omic_tpu_torch.config import load_config
    from multimodal_path_omic_tpu_torch.models import is_ge_model
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    points = parse_grid(grids)
    rows = []
    for i, point in enumerate(points):
        cfg = load_config(config_path, {**(base_overrides or {}), **point})
        if metric is None:
            metric = "val_accuracy" if is_ge_model(cfg.model.name) else "val_c_index"
        if cfg.model.checkpoint_dir:  # one namespace a point, as for the cv folds
            cfg.model.checkpoint_dir = os.path.join(cfg.model.checkpoint_dir, f"point{i}")
        if verbose:
            print(f"=== sweep point {i + 1}/{len(points)}: {point}")
        out = Trainer(cfg, verbose=False).fit()
        if metric not in out:
            raise ValueError(f"metric {metric!r} not in run results {sorted(out)}: aborting "
                             "before training the remaining grid points")
        row = {"point": point, **{k: float(v) for k, v in out.items()}}
        rows.append(row)
        if verbose:
            print(f"    {metric}={row[metric]:.4f}")
    lower_is_better = "loss" in metric or "mse" in metric
    rows.sort(key=lambda r: r[metric], reverse=not lower_is_better)
    result = {"metric": metric, "lower_is_better": lower_is_better, "rows": rows,
              "best": rows[0]}
    if verbose:
        print(f"best {metric}={rows[0][metric]:.4f} at {rows[0]['point']}")
    return result
