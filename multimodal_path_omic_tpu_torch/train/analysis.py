"""Risk stratification analysis: Kaplan-Meier groups + log-rank test, and
the evaluation panels (``multimodal_path_omic_tpu/train/analysis.py``, on
the port's ``Predictor`` and ``train/metrics.py``).

The MCAT-family papers report their models as KM curves of predicted
high/low-risk groups with a log-rank p-value; the reference repo computes
only the c-index (reference: mcat/main.py:81) and leaves the figure to
offline notebooks. ``cli stratify`` closes that gap end-to-end: score a
split with the trained model, cut the cohort at a risk quantile, run the
Mantel-Cox log-rank test (train/metrics.py::logrank_test, exact 1-dof
p-value via erfc), and optionally render the KM figure — one command from
checkpoint to the paper statistic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _survival_labels_for(table, slide_ids):
    """Survival labels aligned to prediction rows THROUGH slide_id.

    predict_dataset rows come in BUCKET-EMISSION order (BucketBatcher groups
    bags by padded length), not table order — align by id, never
    positionally. Returns ``(months, event)`` (event = 1 - censorship)."""
    pos = {sid: i for i, sid in enumerate(table.slide_ids)}
    rows = np.array([pos[sid] for sid in slide_ids], dtype=int)
    months = np.asarray(table.survival_months, dtype=float)[rows]
    event = 1.0 - np.asarray(table.censorship, dtype=float)[rows] > 0.5
    return months, event


def _predictor(config, checkpoint, torch_checkpoint, trainer):
    """The Predictor of ``trainer`` (an already-trained in-memory model), else
    one built from ``config`` and the checkpoints (``Predictor.from_config``:
    on the GPU unless the config says ``device: cpu``)."""
    from multimodal_path_omic_tpu_torch.serve import Predictor

    if trainer is not None:
        return Predictor.from_trainer(trainer)
    return Predictor.from_config(config, checkpoint=checkpoint,
                                 torch_checkpoint=torch_checkpoint)


def _resolve_split(t, split: str):
    ds = {"val": t.val_ds, "train": t.train_ds, "all": t.dataset}.get(split)
    if ds is None:
        raise ValueError(f'split must be "val", "train" or "all", got {split!r}')
    return ds


def evaluate(
    config,
    checkpoint: Optional[str] = None,
    torch_checkpoint: Optional[str] = None,
    split: str = "val",
    eval_times=None,
    verbose: bool = True,
    trainer=None,
) -> Dict[str, Any]:
    """Family-dispatching metric panel: survival models get the IPCW panel
    (:func:`evaluate_survival`), GE classification models get the
    per-class precision/recall/F1 + confusion panel
    (:func:`evaluate_classification`)."""
    from multimodal_path_omic_tpu_torch.models import is_ge_model

    if is_ge_model(config.model.name):
        if eval_times is not None:
            raise ValueError("--times applies to survival models only")
        return evaluate_classification(
            config, checkpoint=checkpoint, torch_checkpoint=torch_checkpoint,
            split=split, verbose=verbose, trainer=trainer,
        )
    return evaluate_survival(
        config, checkpoint=checkpoint, torch_checkpoint=torch_checkpoint,
        split=split, eval_times=eval_times, verbose=verbose, trainer=trainer,
    )


def evaluate_classification(
    config,
    checkpoint: Optional[str] = None,
    torch_checkpoint: Optional[str] = None,
    split: str = "val",
    verbose: bool = True,
    trainer=None,
) -> Dict[str, Any]:
    """GE-model metric panel: accuracy, per-class precision/recall/F1 with
    support, macro-F1, and the confusion matrix — the reference's GE runs
    report top-1 accuracy only (ge_nacagat/main.py's correct-count loop)."""
    from multimodal_path_omic_tpu_torch.train.metrics import classification_report

    predictor = _predictor(config, checkpoint, torch_checkpoint, trainer)
    t = predictor._t
    if not t.ge_mode:
        raise ValueError("evaluate_classification needs a GE model")
    ds = _resolve_split(t, split)
    cols = predictor.predict_dataset(ds)
    probs = np.asarray(cols["y"], dtype=float)
    table = ds.table
    pos = {sid: i for i, sid in enumerate(table.slide_ids)}
    rows = np.array([pos[sid] for sid in cols["slide_id"]], dtype=int)
    labels = np.asarray(table.gene_expr_class, dtype=int)[rows]

    report = classification_report(labels, probs)
    result: Dict[str, Any] = {"split": split, "n": int(len(labels)), **report}
    if verbose:
        print(
            f"evaluate[{split}]: n={result['n']}\n"
            f"  accuracy = {report['accuracy']:.4f}  "
            f"macro-F1 = {report['macro_f1']:.4f}"
        )
        for c in range(len(report["f1"])):
            print(
                f"  class {c}: precision={report['precision'][c]:.4f} "
                f"recall={report['recall'][c]:.4f} f1={report['f1'][c]:.4f} "
                f"(n={report['support'][c]})"
            )
        print(f"  confusion (rows=true): {report['confusion']}")
    return result


def evaluate_survival(
    config,
    checkpoint: Optional[str] = None,
    torch_checkpoint: Optional[str] = None,
    split: str = "val",
    eval_times=None,
    verbose: bool = True,
    trainer=None,
) -> Dict[str, Any]:
    """Full time-dependent evaluation of a survival model on one split.

    Reports the c-index (the reference's only metric, mcat/main.py:81) PLUS
    the censoring-weighted (IPCW) metrics the survival literature expects:
    per-time Brier scores + integrated Brier score on the model's survival
    curves, and Uno's cumulative/dynamic AUC(t) on the risk scores
    (train/metrics.py). ``eval_times`` defaults to the interior qcut bin
    edges of the cohort's survival classes — the exact time grid the
    discrete survival head models — clipped to times where the censoring
    KM weight is estimable; pass explicit months to override."""
    from multimodal_path_omic_tpu_torch.train import metrics as M

    predictor = _predictor(config, checkpoint, torch_checkpoint, trainer)
    t = predictor._t
    if t.ge_mode:
        raise ValueError("evaluate_survival needs a survival model (not GE)")
    ds = _resolve_split(t, split)
    if len(ds) < 4:
        raise ValueError(f"split {split!r} has only {len(ds)} samples")

    cols = predictor.predict_dataset(ds)
    risk = np.asarray(cols["risk"], dtype=float)
    survs = np.asarray(cols["survs"], dtype=float)
    months, event = _survival_labels_for(ds.table, cols["slide_id"])

    cindex = M.concordance_index_censored(event, months, risk)[0]

    edges = getattr(ds.table, "survival_bin_edges", None)
    if eval_times is None:
        if edges is not None:
            taus = np.asarray(edges, dtype=float)[1:-1]
        else:
            # fall back to observed-event-time quartiles
            taus = np.quantile(months[event], [0.25, 0.5, 0.75])
        # keep only estimable times: strictly inside the observed follow-up
        # (the metrics' contract) with at least one event by tau and one
        # subject past tau
        lo, hi = float(months.min()), float(months.max())
        ok = []
        for tau in np.unique(taus):
            if not (lo <= tau < hi):
                continue
            if not ((months <= tau) & event).any() or not (months > tau).any():
                continue
            ok.append(float(tau))
        taus = np.asarray(ok, dtype=float)
        if len(taus) == 0:
            raise ValueError(
                "no evaluable times on this split (too few events or all "
                "follow-up censored) — pass eval_times explicitly"
            )
    else:
        taus = np.sort(np.unique(np.asarray(eval_times, dtype=float)))

    if edges is not None:
        surv_at = M.survival_at_times(survs, edges, taus)
    else:
        # without qcut edges, treat bin j as covering the j-th quantile
        # span of observed months — approximate, flagged in the result
        approx_edges = np.quantile(
            np.asarray(ds.table.survival_months, dtype=float),
            np.linspace(0.0, 1.0, survs.shape[1] + 1),
        )
        surv_at = M.survival_at_times(survs, approx_edges, taus)

    bs = M.brier_scores(months, event, surv_at, taus)
    ibs = (
        M.integrated_brier_score(months, event, surv_at, taus)
        if len(taus) >= 2
        else float(bs[0])
    )
    auc = M.cumulative_dynamic_auc(months, event, risk, taus)
    auc_mean = float(np.nanmean(auc)) if np.isfinite(auc).any() else float("nan")

    result: Dict[str, Any] = {
        "split": split,
        "n": int(len(risk)),
        "n_events": int(event.sum()),
        "c_index": float(cindex),
        "eval_times": taus.tolist(),
        "brier_scores": bs.tolist(),
        "integrated_brier_score": ibs,
        "auc": auc.tolist(),
        "mean_auc": auc_mean,
        "bin_edges_exact": bool(edges is not None),
    }
    if verbose:
        times_s = ", ".join(f"{x:.1f}" for x in taus)
        print(
            f"evaluate[{split}]: n={result['n']} ({result['n_events']} events)\n"
            f"  c-index = {cindex:.4f}\n"
            f"  eval times (months): [{times_s}]\n"
            f"  Brier(t) = [{', '.join(f'{x:.4f}' for x in bs)}]  "
            f"IBS = {ibs:.4f}\n"
            f"  AUC(t)   = [{', '.join(f'{x:.4f}' for x in auc)}]  "
            f"mean = {auc_mean:.4f}"
        )
    return result


def stratify(
    config,
    checkpoint: Optional[str] = None,
    torch_checkpoint: Optional[str] = None,
    quantile: float = 0.5,
    split: str = "val",
    out_csv: Optional[str] = None,
    png: Optional[str] = None,
    mc_samples: int = 0,
    verbose: bool = True,
    trainer=None,
) -> Dict[str, Any]:
    """Predict risks for ``split`` ("val" / "train" / "all"), cut at the
    ``quantile`` risk threshold, and test the two groups' survival
    separation. Returns the full result dict (groups, chi2, p_value, KM
    curves); writes per-slide assignments to ``out_csv`` and the KM figure
    to ``png`` when given. ``mc_samples`` adds MC-dropout risk_std columns
    to the CSV. ``trainer``: analyze an ALREADY-TRAINED in-memory Trainer
    instead of building one from config + checkpoint."""
    if not 0.0 < quantile < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {quantile}")
    from multimodal_path_omic_tpu_torch.train.metrics import kaplan_meier, logrank_test

    predictor = _predictor(config, checkpoint, torch_checkpoint, trainer)
    t = predictor._t
    if t.ge_mode:
        raise ValueError("stratify needs a survival model (not GE)")
    ds = _resolve_split(t, split)
    if len(ds) < 4:
        raise ValueError(f"split {split!r} has only {len(ds)} samples")

    cols = predictor.predict_dataset(ds, mc_samples=mc_samples)
    risk = np.asarray(cols["risk"], dtype=float)
    months, event = _survival_labels_for(ds.table, cols["slide_id"])

    thresh = float(np.quantile(risk, quantile))
    high = risk > thresh
    if high.all() or not high.any():
        raise ValueError(
            f"risk quantile {quantile} does not split this cohort "
            "(all risks on one side — degenerate predictions?)"
        )
    chi2, p = logrank_test(months, event, high)
    km = {
        "high": kaplan_meier(months[high], event[high]),
        "low": kaplan_meier(months[~high], event[~high]),
    }
    result: Dict[str, Any] = {
        "split": split,
        "n": int(len(risk)),
        "n_high": int(high.sum()),
        "n_low": int((~high).sum()),
        "risk_threshold": thresh,
        "quantile": quantile,
        "chi2": chi2,
        "p_value": p,
        "median_months_high": float(np.median(months[high])),
        "median_months_low": float(np.median(months[~high])),
        "km": {k: (v[0].tolist(), v[1].tolist()) for k, v in km.items()},
    }
    if verbose:
        print(
            f"stratify[{split}]: n={result['n']} "
            f"(high {result['n_high']} / low {result['n_low']} at "
            f"risk>{thresh:.4f}), log-rank chi2={chi2:.3f}, p={p:.4g}"
        )
    if out_csv:
        import pandas as pd

        flat = {
            "slide_id": cols["slide_id"],
            "risk": risk,
            "group": np.where(high, "high", "low"),
            "survival_months": months,
            "event": event.astype(int),
        }
        if mc_samples > 0:
            flat["risk_mc_std"] = np.asarray(cols["risk_std"], dtype=float)
        pd.DataFrame(flat).to_csv(out_csv, index=False)
        result["csv"] = out_csv
    if png:
        from multimodal_path_omic_tpu_torch.utils.visualize import save_km_png

        save_km_png(km, png, p_value=p, title=f"KM by predicted risk ({split})")
        result["png"] = png
    return result
