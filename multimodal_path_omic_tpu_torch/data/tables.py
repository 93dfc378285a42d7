"""Host-side tabular layer: clinical CSV -> omics arrays, labels, splits
(``multimodal_path_omic_tpu/data/tables.py``; the port's own copy).

Covers the reference's dataframe handling (reference: dataset/dataset.py:13-114,
dataset/ge_dataset.py:11-47) with numpy outputs ready for device feeding:

* row filters: ``decider_only`` / ``tcga_only`` (on ``is_decider``),
  ``diagnostic_only`` (on ``source``) (dataset.py:16-27);
* survival classes: ``pd.qcut(survival_months, q=4)`` (dataset.py:61-67);
* optional per-column standardize/normalize of ``*_rnaseq`` columns
  (dataset.py:73-81);
* full rnaseq/cnv/mut matrices by column suffix (dataset.py:83-96);
* signature grouping: signatures CSV columns are signature names, cells are
  gene symbols; genes present as ``<gene>_rnaseq`` columns are gathered per
  signature (dataset.py:98-114).

Deliberate fixes over the reference (SURVEY.md §7.1 "fidelity caveats"):
* splits are **seeded** (the reference shuffles patients unseeded,
  dataset.py:154, so checkpoint resume saw a different split);
* subsetting slices signature arrays by the subset's *original* row positions
  (the reference's ``from_dataframe`` misaligns signature omics with patients
  in every split, dataset.py:238-241).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd


def _apply_row_filters(
    df: pd.DataFrame,
    decider_only: bool = False,
    tcga_only: bool = False,
    diagnostic_only: bool = False,
    verbose: bool = True,
) -> pd.DataFrame:
    if decider_only:
        if verbose:
            print("Using DECIDER data only")
        df = df.loc[df["is_decider"] == 1.0]
    if tcga_only:
        if verbose:
            print("Using TCGA data only")
        df = df.loc[df["is_decider"] == 0.0]
    if diagnostic_only:
        if verbose:
            print("Using only diagnostic slides")
        df = df.loc[df["source"] == "diagnostic_slide"]
    return df.reset_index(drop=True)


def _suffix_matrix(df: pd.DataFrame, suffix: str) -> np.ndarray:
    cols = df.columns[df.columns.str.endswith(suffix)]
    return df[cols].astype(float).to_numpy(dtype=np.float32)


def qcut_classes(
    values: pd.Series, q: int, verbose: bool = True, return_bins: bool = False
):
    """Quantile-bin a series into q integer classes (dataset.py:61-67).

    ``return_bins=True`` also returns the q+1 bin boundaries — needed by the
    time-dependent evaluation metrics (train/metrics.py::survival_at_times)
    to place the discrete survival curve on the months axis."""
    classes, intervals = pd.qcut(values, q=q, retbins=True, labels=False)
    if verbose:
        print("Class intervals: [")
        for i in range(q):
            print("\t{}: [{:.2f} - {:.2f}]".format(i, intervals[i], intervals[i + 1]))
        print("]")
    if return_bins:
        return classes.to_numpy(), np.asarray(intervals, dtype=float)
    return classes.to_numpy()


def patient_level_split(
    patients: np.ndarray,
    train_size: float,
    *,
    seed: Optional[int] = 0,
    test: bool = False,
    patient: str = "",
):
    """Row indices for a seeded patient-level split (reference semantics:
    dataset.py:145-185, but reproducible). ``seed=None`` reproduces the
    reference's UNSEEDED shuffle (dataset.py:154) for bug-compat runs.
    Returns (train_rows, val_rows, test_rows-or-None)."""
    if not 0 < train_size < 1:
        raise ValueError("train_size should be a float between 0 and 1.")
    rng = np.random.default_rng(seed)
    unique_patients = pd.unique(patients)
    unique_patients = unique_patients[rng.permutation(len(unique_patients))]
    n_train = int(len(unique_patients) * train_size)
    train_patients = set(unique_patients[:n_train])
    val_patients = set(unique_patients[n_train:])
    in_train = np.array([p in train_patients for p in patients])
    in_val = np.array([p in val_patients for p in patients])
    test_rows = None
    if test:
        is_test = patients == patient
        test_rows = np.where(is_test)[0]
        in_train &= ~is_test
        in_val &= ~is_test
    return np.where(in_train)[0], np.where(in_val)[0], test_rows


def patient_kfold(
    patients: np.ndarray, k: int, *, seed: Optional[int] = 0
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Seeded patient-level k-fold row splits (beyond the reference, which
    only does one train/val split — the MCAT literature evaluates with
    patient-level cross-validation). Returns k (train_rows, val_rows) pairs:
    fold i validates on fold-i patients' rows and trains on the rest; no
    patient appears on both sides of any fold; every row validates exactly
    once across the k folds."""
    if k < 2:
        raise ValueError(f"k-fold needs k >= 2, got {k}")
    unique_patients = pd.unique(patients)
    if k > len(unique_patients):
        raise ValueError(
            f"k={k} folds but only {len(unique_patients)} unique patients"
        )
    rng = np.random.default_rng(seed)
    unique_patients = unique_patients[rng.permutation(len(unique_patients))]
    folds = np.array_split(unique_patients, k)
    out = []
    for fold in folds:
        val_patients = set(fold)
        in_val = np.array([p in val_patients for p in patients])
        out.append((np.where(~in_val)[0], np.where(in_val)[0]))
    return out


@dataclass
class MultimodalTable:
    """Parsed clinical table + omics arrays for the survival models."""

    df: pd.DataFrame
    slide_ids: np.ndarray
    patients: np.ndarray
    survival_months: np.ndarray
    survival_class: np.ndarray
    censorship: np.ndarray
    rnaseq: np.ndarray
    cnv: np.ndarray
    mut: np.ndarray
    use_signatures: bool = False
    signature_names: List[str] = field(default_factory=list)
    signature_data: Dict[str, np.ndarray] = field(default_factory=dict)
    signature_sizes: List[int] = field(default_factory=list)
    # qcut boundaries of survival_class (q+1 edges) — lets the evaluation
    # metrics place the discrete survival curve on the months axis
    # (train/metrics.py::survival_at_times). None on hand-built tables.
    survival_bin_edges: Optional[np.ndarray] = None

    @classmethod
    def from_csv(
        cls,
        file: str,
        *,
        decider_only: bool = False,
        tcga_only: bool = False,
        diagnostic_only: bool = False,
        standardize: bool = False,
        normalize: bool = False,
        signatures: Optional[str] = None,
        n_classes: int = 4,
        keep_rows: Optional[np.ndarray] = None,
        verbose: bool = True,
    ) -> "MultimodalTable":
        df = pd.read_csv(file)
        df = _apply_row_filters(df, decider_only, tcga_only, diagnostic_only, verbose)
        if keep_rows is not None:
            df = df.iloc[keep_rows].reset_index(drop=True)
        return cls.from_dataframe_full(
            df,
            standardize=standardize,
            normalize=normalize,
            signatures=signatures,
            n_classes=n_classes,
            verbose=verbose,
        )

    @classmethod
    def from_dataframe_full(
        cls,
        df: pd.DataFrame,
        *,
        standardize: bool = False,
        normalize: bool = False,
        signatures: Optional[str] = None,
        n_classes: int = 4,
        verbose: bool = True,
    ) -> "MultimodalTable":
        survival_class, survival_bin_edges = qcut_classes(
            df["survival_months"], n_classes, verbose, return_bins=True
        )

        rnaseq_cols = [c for c in df.columns if c.endswith("_rnaseq")]
        if standardize:
            if verbose:
                print("Standardizing RNA-seq data")
            for col in rnaseq_cols:
                df[col] = (df[col] - df[col].mean()) / df[col].std()
        if normalize:
            if verbose:
                print("Normalizing RNA-seq data")
            for col in rnaseq_cols:
                lo, hi = df[col].min(), df[col].max()
                df[col] = 2 * (df[col] - lo) / (hi - lo) - 1

        use_signatures = signatures is not None
        signature_names: List[str] = []
        signature_data: Dict[str, np.ndarray] = {}
        signature_sizes: List[int] = []
        if use_signatures:
            sig_df = pd.read_csv(signatures)
            signature_names = list(sig_df.columns)
            for name in signature_names:
                cols = []
                for gene in sig_df[name].dropna():
                    col = f"{gene}_rnaseq"
                    if col in df.columns:
                        cols.append(col)
                signature_data[name] = df[cols].to_numpy(dtype=np.float32)
                signature_sizes.append(signature_data[name].shape[1])
            if verbose:
                print(f"Signatures size: {signature_sizes}")

        return cls(
            df=df,
            slide_ids=df["slide_id"].to_numpy(),
            patients=df["patient"].to_numpy(),
            survival_months=df["survival_months"].to_numpy(dtype=np.float32),
            survival_class=np.asarray(survival_class, dtype=np.int32),
            censorship=df["censorship"].to_numpy(dtype=np.float32),
            rnaseq=_suffix_matrix(df, "_rnaseq"),
            cnv=_suffix_matrix(df, "_cnv"),
            mut=_suffix_matrix(df, "_mut"),
            use_signatures=use_signatures,
            signature_names=signature_names,
            signature_data=signature_data,
            signature_sizes=signature_sizes,
            survival_bin_edges=survival_bin_edges,
        )

    def __len__(self) -> int:
        return len(self.df)

    def subset(
        self, rows: np.ndarray, misalign_signatures: bool = False
    ) -> "MultimodalTable":
        """Row-aligned subset (fixes the reference's signature misalignment,
        dataset.py:238-241). ``misalign_signatures`` replicates the reference
        bug instead: signature omics come from rows 0..n-1 of the ORIGINAL
        tensors (``from_dataframe`` indexes with the reset index), so they are
        misaligned with the subset's patients — for bug-compat A/B studies."""
        rows = np.asarray(rows)
        sig_rows = np.arange(len(rows)) if misalign_signatures else rows
        return MultimodalTable(
            df=self.df.iloc[rows].reset_index(drop=True),
            slide_ids=self.slide_ids[rows],
            patients=self.patients[rows],
            survival_months=self.survival_months[rows],
            survival_class=self.survival_class[rows],
            censorship=self.censorship[rows],
            rnaseq=self.rnaseq[rows],
            cnv=self.cnv[rows],
            mut=self.mut[rows],
            use_signatures=self.use_signatures,
            signature_names=self.signature_names,
            signature_data={k: v[sig_rows] for k, v in self.signature_data.items()},
            signature_sizes=self.signature_sizes,
            survival_bin_edges=self.survival_bin_edges,
        )

    def omics_for(self, rows: Optional[np.ndarray] = None):
        """Signature omics list (or rnaseq/cnv/mut dict) for given rows."""
        if self.use_signatures:
            if rows is None:
                return [self.signature_data[n] for n in self.signature_names]
            return [self.signature_data[n][rows] for n in self.signature_names]
        if rows is None:
            return {"rnaseq": self.rnaseq, "cnv": self.cnv, "mut": self.mut}
        return {
            "rnaseq": self.rnaseq[rows],
            "cnv": self.cnv[rows],
            "mut": self.mut[rows],
        }

    def split(
        self,
        train_size: float,
        *,
        seed: Optional[int] = 0,
        test: bool = False,
        patient: str = "",
        bug_compat: bool = False,
    ) -> Tuple["MultimodalTable", "MultimodalTable", Optional["MultimodalTable"]]:
        """Patient-level split (reference: dataset.py:145-185), seeded.

        With ``test=True`` the named ``patient`` becomes a one-patient test set
        excluded from train and val (leave-one-out, dataset.py:164-171).
        ``bug_compat`` replicates the reference exactly: unseeded shuffle +
        misaligned signature subsets (dataset.py:154, 238-241).
        """
        tr, va, te = patient_level_split(
            self.patients,
            train_size,
            seed=None if bug_compat else seed,
            test=test,
            patient=patient,
        )
        return (
            self.subset(tr, misalign_signatures=bug_compat),
            self.subset(va, misalign_signatures=bug_compat),
            self.subset(te, misalign_signatures=bug_compat) if te is not None else None,
        )


@dataclass
class GeneExprTable:
    """Table for gene-expression-class prediction (reference:
    dataset/ge_dataset.py:11-47): the target is qcut-3 of one gene's
    ``<gene>_rnaseq`` expression; the gene column is removed from features."""

    df: pd.DataFrame
    slide_ids: np.ndarray
    patients: np.ndarray
    gene_expr_class: np.ndarray

    @classmethod
    def from_csv(
        cls,
        file: str,
        gene: str,
        *,
        decider_only: bool = False,
        n_classes: int = 3,
        keep_rows: Optional[np.ndarray] = None,
        verbose: bool = True,
    ) -> "GeneExprTable":
        df = pd.read_csv(file)
        df = _apply_row_filters(df, decider_only=decider_only, verbose=verbose)
        if keep_rows is not None:
            df = df.iloc[keep_rows].reset_index(drop=True)
        if verbose:
            print(f"Testing gene expression: {gene}")
        gene_col = f"{gene}_rnaseq"
        gene_expr = df[gene_col]
        df = df.drop(gene_col, axis=1)
        gene_expr_class = qcut_classes(gene_expr, n_classes, verbose)
        return cls(
            df=df,
            slide_ids=df["slide_id"].to_numpy(),
            patients=df["patient"].to_numpy(),
            gene_expr_class=np.asarray(gene_expr_class, dtype=np.int32),
        )

    def __len__(self) -> int:
        return len(self.df)

    def subset(self, rows: np.ndarray, misalign_labels: bool = False) -> "GeneExprTable":
        """``misalign_labels`` replicates the reference's from_dataframe bug:
        the subset keeps positions 0..n-1 of the ORIGINAL gene_expr_class
        array (ge_dataset.py:114 copies the full array; __getitem__ then
        indexes it by subset row position)."""
        rows = np.asarray(rows)
        label_rows = np.arange(len(rows)) if misalign_labels else rows
        return GeneExprTable(
            df=self.df.iloc[rows].reset_index(drop=True),
            slide_ids=self.slide_ids[rows],
            patients=self.patients[rows],
            gene_expr_class=self.gene_expr_class[label_rows],
        )

    def split(
        self,
        train_size: float,
        *,
        seed: Optional[int] = 0,
        test: bool = False,
        patient: str = "",
        bug_compat: bool = False,
    ):
        tr, va, te = patient_level_split(
            self.patients,
            train_size,
            seed=None if bug_compat else seed,
            test=test,
            patient=patient,
        )
        return (
            self.subset(tr, misalign_labels=bug_compat),
            self.subset(va, misalign_labels=bug_compat),
            self.subset(te, misalign_labels=bug_compat) if te is not None else None,
        )
