"""Per-batch label and omics columns of a dataset.

A copy of ``survival_extras`` and ``gene_expr_extras`` of
``multimodal_path_omic_tpu/data/pipeline.py`` (numpy only): the port keeps
its own copy rather than importing the JAX package. A dataset is any object
with ``__len__``, ``bag(i) -> [M, D]`` and a ``table`` holding the columns
read here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def survival_extras(dataset, indices: np.ndarray) -> Dict[str, np.ndarray]:
    """Labels + signature omics for the survival models."""
    t = dataset.table
    return {
        "survival_months": t.survival_months[indices],
        "label": t.survival_class[indices],
        "censorship": t.censorship[indices],
        "omics": [t.signature_data[n][indices] for n in t.signature_names],
    }


def gene_expr_extras(dataset, indices: np.ndarray) -> Dict[str, np.ndarray]:
    return {"label": dataset.table.gene_expr_class[indices]}
