"""Checkpoint save/restore on ``torch.save``
(``multimodal_path_omic_tpu/train/checkpoint.py``).

The reference saves {'epoch', 'model_state_dict', 'optimizer_state_dict',
'loss'} every ``checkpoint_epoch`` epochs (reference: mcat/main.py:88-100) and
on resume re-runs the saved epoch with a fresh RNG and another unseeded
split (mcat/main.py:309-312). The Trainer's payload also carries the dropout
generator's state, the step count, the split seed and the next epoch index,
so a resumed run continues an uninterrupted one exactly.

File naming follows the reference: ``<model>_<dataset>_E<n>_<timestamp>.pt``
(mcat/main.py:91), or ``<model>_<dataset>_<tag>.pt`` for a rolling
checkpoint such as the best model's.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(directory: str, payload: Dict[str, Any], *, model_name: str,
                    dataset_name: str, epoch: int, tag: Optional[str] = None) -> str:
    """Write ``payload`` (state dicts, tensors and plain Python values) with
    ``torch.save``; returns the path. ``tag`` names a stable path that every
    save overwrites; without it the timestamped name applies and an
    existing file is an error, never overwritten."""
    os.makedirs(directory, exist_ok=True)
    if tag is not None:
        name = f"{model_name}_{dataset_name}_{tag}"
    else:
        now = datetime.datetime.now().strftime("%Y%m%d%H%M")
        name = f"{model_name}_{dataset_name}_E{epoch + 1}_{now}"
    path = os.path.join(directory, name + ".pt")
    if tag is None and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by :func:`save_checkpoint`, every tensor on
    the CPU (``load_state_dict`` moves them onto the model's device)."""
    return torch.load(path, map_location="cpu", weights_only=True)
