"""Dataset objects: table + bag store, reference-compatible surface
(``multimodal_path_omic_tpu/data/dataset.py``; the port's own copy).

``MultimodalDataset`` mirrors the reference dataset's API
(reference: dataset/dataset.py:13-185): constructed from a config dict/object,
``len()``, per-item access returning (survival_months, survival_class,
censorship, omics, bag), a ``split(train_size, test, patient)`` method, and a
``signature_sizes`` attribute consumed by model construction
(mcat/main.py:256). The per-item path exists for compatibility and export
flows; training feeds through the bucketed batch pipeline
(data/pipeline.py) instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd

from multimodal_path_omic_tpu_torch.data.bags import BagStore, filter_existing, open_bag_store
from multimodal_path_omic_tpu_torch.data.tables import (
    GeneExprTable,
    MultimodalTable,
    _apply_row_filters,
    qcut_classes,
)


def _dataset_cfg(config):
    """Accept either our typed Config or a raw reference-style YAML dict."""
    if hasattr(config, "dataset"):
        return config.dataset
    d = config["dataset"]

    class _D:
        pass

    o = _D()
    o.file = d.get("file")
    o.patches_dir = d.get("patches_dir")
    o.h5_dataset = d.get("h5_dataset")
    o.signatures = d.get("signatures")
    o.decider_only = d.get("decider_only", False)
    o.tcga_only = d.get("tcga_only", False)
    o.diagnostic_only = d.get("diagnostic_only", False)
    o.standardize = d.get("standardize", False)
    o.normalize = d.get("normalize", False)
    return o


class MultimodalDataset:
    def __init__(
        self,
        file: str,
        config,
        use_signatures: bool = False,
        remove_incomplete_samples: bool = True,
        verbose: bool = True,
    ):
        d = _dataset_cfg(config)
        self.store: BagStore = open_bag_store(d.patches_dir, d.h5_dataset)

        # Filter to rows whose bag exists BEFORE computing labels, matching the
        # reference's ordering (drop-missing happens before qcut,
        # dataset.py:39-67).
        df = pd.read_csv(file)
        df = _apply_row_filters(
            df, d.decider_only, d.tcga_only, d.diagnostic_only, verbose
        )
        if remove_incomplete_samples:
            rows = filter_existing(df["slide_id"].to_numpy(), self.store, verbose)
            df = df.iloc[rows].reset_index(drop=True)

        self.table = MultimodalTable.from_dataframe_full(
            df,
            standardize=d.standardize,
            normalize=d.normalize,
            signatures=d.signatures if use_signatures else None,
            verbose=verbose,
        )
        self.use_signatures = use_signatures

    # --- reference-compatible surface -------------------------------------
    @property
    def signature_sizes(self):
        return self.table.signature_sizes

    @property
    def rnaseq_size(self):
        return self.table.rnaseq.shape[1]

    def __len__(self) -> int:
        return len(self.table)

    def bag(self, index: int) -> np.ndarray:
        return self.store.get(self.table.slide_ids[index])

    def slide_id(self, index: int) -> str:
        return self.table.slide_ids[index]

    def __getitem__(self, index: int):
        t = self.table
        if self.use_signatures:
            omics = [t.signature_data[n][index] for n in t.signature_names]
        else:
            omics = {
                "rnaseq": t.rnaseq[index],
                "cnv": t.cnv[index],
                "mut": t.mut[index],
            }
        return (
            t.survival_months[index],
            t.survival_class[index],
            t.censorship[index],
            omics,
            self.bag(index),
        )

    def split(
        self,
        train_size: float,
        test: bool = False,
        patient: str = "",
        seed: Optional[int] = 0,
        bug_compat: bool = False,
    ) -> Tuple["MultimodalDataset", "MultimodalDataset", Optional["MultimodalDataset"]]:
        tr, va, te = self.table.split(
            train_size, seed=seed, test=test, patient=patient, bug_compat=bug_compat
        )
        return (
            self._with_table(tr),
            self._with_table(va),
            self._with_table(te) if te is not None else None,
        )

    def _with_table(self, table: MultimodalTable) -> "MultimodalDataset":
        ds = object.__new__(MultimodalDataset)
        ds.table = table
        ds.store = self.store
        ds.use_signatures = self.use_signatures
        return ds


class GeneExprDataset:
    """Gene-expression-class dataset (reference: dataset/ge_dataset.py:11-116)."""

    def __init__(self, file: str, config, gene: str, verbose: bool = True):
        d = _dataset_cfg(config)
        self.store: BagStore = open_bag_store(d.patches_dir, getattr(d, "h5_dataset", None))

        df = pd.read_csv(file)
        df = _apply_row_filters(df, decider_only=d.decider_only, verbose=verbose)
        rows = filter_existing(df["slide_id"].to_numpy(), self.store, verbose)
        df = df.iloc[rows].reset_index(drop=True)

        if verbose:
            print(f"Testing gene expression: {gene}")
        gene_col = f"{gene}_rnaseq"
        gene_expr = df[gene_col]
        df = df.drop(gene_col, axis=1)
        gene_expr_class = qcut_classes(gene_expr, 3, verbose)
        self.table = GeneExprTable(
            df=df,
            slide_ids=df["slide_id"].to_numpy(),
            patients=df["patient"].to_numpy(),
            gene_expr_class=np.asarray(gene_expr_class, dtype=np.int32),
        )

    def __len__(self) -> int:
        return len(self.table)

    def bag(self, index: int) -> np.ndarray:
        return self.store.get(self.table.slide_ids[index])

    def slide_id(self, index: int) -> str:
        return self.table.slide_ids[index]

    def __getitem__(self, index: int):
        return self.table.gene_expr_class[index], self.bag(index)

    def split(
        self,
        train_size: float,
        test: bool = False,
        patient: str = "",
        seed: Optional[int] = 0,
        bug_compat: bool = False,
    ):
        tr, va, te = self.table.split(
            train_size, seed=seed, test=test, patient=patient, bug_compat=bug_compat
        )
        return (
            self._with_table(tr),
            self._with_table(va),
            self._with_table(te) if te is not None else None,
        )

    def _with_table(self, table: GeneExprTable) -> "GeneExprDataset":
        ds = object.__new__(GeneExprDataset)
        ds.table = table
        ds.store = self.store
        return ds
