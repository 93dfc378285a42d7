"""HDF5 dataset shape probes (reference: models/utils.py:7-30; the port's copy of
``multimodal_path_omic_tpu/utils/hdf5.py``).

Same on-disk layout expectations as the reference: per-case groups with an
``omics/`` group of named categories, and a ``genomics/`` group with
``rnaseq`` / ``cnv`` vectors.
"""

from __future__ import annotations

from typing import List

import h5py


def get_omics_sizes_from_dataset(hdf5_file: str) -> List[int]:
    """Lengths of the first case's omics categories, sorted by category name."""
    with h5py.File(hdf5_file, "r") as f:
        first_case = next(iter(f.keys()))
        omics = f[first_case]["omics"]
        return [len(omics[name]) for name in sorted(omics.keys())]


def get_rnaseq_size_from_dataset(hdf5_file: str) -> int:
    with h5py.File(hdf5_file, "r") as f:
        first_case = next(iter(f.keys()))
        return len(f[first_case]["genomics"]["rnaseq"])


def get_cnv_size_from_dataset(hdf5_file: str) -> int:
    with h5py.File(hdf5_file, "r") as f:
        first_case = next(iter(f.keys()))
        return len(f[first_case]["genomics"]["cnv"])
