"""Cohort preflight checker (``cli check-data``;
``multimodal_path_omic_tpu/data/check.py``, on the port's bag stores).

The reference fails lazily: a missing bag crashes mid-epoch, a signature
gene absent from the CSV silently shrinks that group, a bag longer than
every bucket first surfaces as an unexpected compile
(reference: dataset/dataset.py:43-55, 98-114 have no validation surface).
This runs every data-layer probe up front and prints a report, so problems
surface before any device time is spent.

Checks (survival mode; GE mode swaps the label checks):
* CSV schema: required columns, row/patient counts, censorship rate;
* qcut feasibility: n_classes distinct survival quantiles;
* signature coverage: genes named per signature vs ``<gene>_rnaseq``
  columns actually present;
* bag store: backend, missing bags, feature-dim consistency, length
  distribution vs the configured buckets (lengths beyond the largest
  bucket round up — flagged, not fatal).

Returns a dict (also printed); ``fatal`` is True when training would fail.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def check_data(config, verbose: bool = True) -> Dict:
    import pandas as pd

    from multimodal_path_omic_tpu_torch.data.bags import open_bag_store
    from multimodal_path_omic_tpu_torch.models import is_ge_model

    c = config
    ge_mode = is_ge_model(c.model.name)
    issues: List[str] = []
    warnings: List[str] = []
    report: Dict = {"mode": "ge" if ge_mode else "survival"}

    def say(msg):
        if verbose:
            print(msg)

    # ----- CSV schema ------------------------------------------------------
    df = pd.read_csv(c.dataset.file)
    report["rows"] = len(df)
    required = ["patient", "slide_id"]
    if not ge_mode:
        required += ["survival_months", "censorship"]
    missing_cols = [col for col in required if col not in df.columns]
    if missing_cols:
        issues.append(f"CSV missing required columns: {missing_cols}")
        say(f"FATAL: missing columns {missing_cols}")
        return {**report, "issues": issues, "warnings": warnings, "fatal": True}
    report["patients"] = int(df["patient"].nunique())
    say(f"cohort: {report['rows']} rows, {report['patients']} patients")

    # ----- labels ----------------------------------------------------------
    if ge_mode:
        gene_col = f"{c.model.gene}_rnaseq"
        if gene_col not in df.columns:
            issues.append(f"GE target column {gene_col!r} not in CSV")
        else:
            say(f"GE target: {gene_col}")
    else:
        cens = float(df["censorship"].mean())
        report["censorship_rate"] = round(cens, 3)
        say(f"censorship rate: {cens:.1%}")
        if cens == 1.0:
            issues.append(
                "every sample is censored — the c-index has no comparable "
                "pairs and survival losses have no event terms"
            )
        try:
            pd.qcut(df["survival_months"], q=c.model.n_classes)
        except ValueError as exc:
            issues.append(
                f"qcut into {c.model.n_classes} classes fails: {exc} — "
                "survival_months has too few distinct values"
            )

    # ----- signatures ------------------------------------------------------
    if not ge_mode and c.dataset.signatures:
        sig_df = pd.read_csv(c.dataset.signatures)
        cols = set(df.columns)
        sig_report = {}
        for name in sig_df.columns:
            genes = [g for g in sig_df[name].dropna()]
            present = [g for g in genes if f"{g}_rnaseq" in cols]
            sig_report[name] = {"named": len(genes), "present": len(present)}
            if not present:
                issues.append(
                    f"signature {name!r}: none of its {len(genes)} genes "
                    "have a _rnaseq column — its encoder would get width 0"
                )
            elif len(present) < len(genes):
                warnings.append(
                    f"signature {name!r}: {len(genes) - len(present)} of "
                    f"{len(genes)} genes missing from the CSV"
                )
        report["signatures"] = sig_report
        say(f"signatures: { {k: v['present'] for k, v in sig_report.items()} }")

    # ----- bag store -------------------------------------------------------
    store = open_bag_store(
        c.dataset.patches_dir, getattr(c.dataset, "h5_dataset", None)
    )
    report["store"] = type(store).__name__
    slide_ids = df["slide_id"].to_numpy()
    missing = [s for s in slide_ids if not store.exists(s)]
    report["bags_missing"] = len(missing)
    if missing:
        warnings.append(
            f"{len(missing)}/{len(slide_ids)} bags missing from the store "
            f"(rows are dropped at load; first few: {missing[:5]})"
        )
    present = [s for s in slide_ids if store.exists(s)]
    if not present:
        issues.append("no bags found in the store at all")
    else:
        lengths, dims = [], set()
        for s in present:
            bag = store.get(s)
            if bag.ndim != 2:
                issues.append(f"bag {s!r} has shape {bag.shape}; expected [M, D]")
                continue
            lengths.append(bag.shape[0])
            dims.add(int(bag.shape[1]))
        if len(dims) > 1:
            issues.append(
                f"inconsistent bag feature dims {sorted(dims)} — one model "
                "cannot consume mixed widths"
            )
        if lengths:
            lengths = np.asarray(lengths)
            report["bag_dim"] = sorted(dims)[0] if dims else None
            report["bag_lengths"] = {
                "min": int(lengths.min()),
                "median": int(np.median(lengths)),
                "max": int(lengths.max()),
            }
            say(
                f"bags: {len(lengths)} found ({report['store']}), dim "
                f"{sorted(dims)}, lengths {report['bag_lengths']}"
            )
            buckets = sorted(c.tpu.bag_buckets) if c.tpu.bag_buckets else []
            if buckets and lengths.max() > buckets[-1]:
                n_over = int((lengths > buckets[-1]).sum())
                warnings.append(
                    f"{n_over} bags exceed the largest bucket {buckets[-1]} "
                    "— they round up to multiples of it (extra pad compute; "
                    "consider a larger bucket)"
                )

    report["issues"] = issues
    report["warnings"] = warnings
    report["fatal"] = bool(issues)
    for w in warnings:
        say(f"WARNING: {w}")
    for i in issues:
        say(f"FATAL: {i}")
    if verbose and not issues:
        say("check-data: OK" + (f" ({len(warnings)} warnings)" if warnings else ""))
    return report
