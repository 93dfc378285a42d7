"""Bucketed batching + host prefetch: ragged bags -> fixed-shape device feed
(``multimodal_path_omic_tpu/data/pipeline.py``; the port's own copy).

The reference trains batch-size-1 with 32-step gradient accumulation
(reference: mcat/main.py:69-74, config.yaml:67-68) because bags are ragged.
Here samples are grouped into length buckets, each bag is padded to its
bucket, and whole batches of ``batch_size`` same-bucket bags are emitted:
each step is one optimizer update over the same effective batch the
reference accumulates.

Partial batches are padded with repeated samples carrying ``weight 0`` so
shapes stay fixed; losses use the weights (ops/losses.py ``sample_weight``)
and metrics drop them. For one seed and epoch the batches, and their order,
are the JAX package's. The JAX package's C++ loader and multi-host slicing
are not ported (ROADMAP.md queue 1, tooling and multi-GPU): bags load
through the dataset's store, and :func:`prefetch` overlaps that with the
device in a thread.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from multimodal_path_omic_tpu_torch.data.bags import DEFAULT_BUCKETS, bucket_for, pad_bag


# A batch is a plain dict: wsi [B, Mb, D], mask [B, Mb], omics list of
# [B, s_i], label [B], censorship [B], survival_months [B], weight [B],
# index [B], bucket, n_real.
Batch = Dict[str, Any]


def pad_plan_indices(indices: Sequence[int], batch_size: int):
    """Fixed-shape batch fill: repeat the last index into the padding rows
    and weight them 0 (losses/metrics drop them). Returns (full, weight)."""
    real = len(indices)
    full = list(indices) + [indices[-1]] * (batch_size - real)
    weight = np.zeros((batch_size,), np.float32)
    weight[:real] = 1.0
    return full, weight


class BucketBatcher:
    """Builds bucketed, padded batches from a dataset.

    ``dataset`` needs ``__len__`` and ``bag(i) -> [M, D]``; ``extras_fn(
    dataset, indices)`` gives the per-batch label / omics columns
    (:func:`survival_extras`, :func:`gene_expr_extras`). Epoch ``e`` of a
    shuffled batcher permutes the rows with ``default_rng(seed + e)``; the
    epoch counter advances on every plan (``_epoch`` is set on resume).
    """

    def __init__(self, dataset, extras_fn, batch_size: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, shuffle: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.extras_fn = extras_fn
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._lengths = None  # bag lengths, probed once

    def _bag_lengths(self) -> np.ndarray:
        if self._lengths is None:
            self._lengths = self._lengths_with_sidecar()
        return self._lengths

    def _lengths_with_sidecar(self) -> np.ndarray:
        """Bag lengths via the JSON sidecar ``.bag_lengths.json`` next to a
        directory store, as the JAX package keeps it: probing a .pt store
        otherwise deserializes every bag to read its shape. Entries are
        ``[length, mtime_ns, size]`` validated against the bag file's
        current stat, so re-extracted embeddings invalidate their entry."""
        store = getattr(self.dataset, "store", None)
        sidecar = None
        cache = {}
        patches_dir = getattr(store, "patches_dir", None)
        path_fn = getattr(store, "_path", None)
        if patches_dir and os.path.isdir(patches_dir):
            sidecar = os.path.join(patches_dir, ".bag_lengths.json")
            if os.path.exists(sidecar):
                try:
                    with open(sidecar) as f:
                        cache = json.load(f)
                except (OSError, ValueError):
                    cache = {}

        def _stat(key):
            if path_fn is None:
                return None
            try:
                st = os.stat(path_fn(key))
                return [st.st_mtime_ns, st.st_size]
            except OSError:
                return None

        lengths = []
        dirty = False
        for i in range(len(self.dataset)):
            key = None
            if sidecar is not None and hasattr(self.dataset, "slide_id"):
                key = str(self.dataset.slide_id(i))
            sig = _stat(key) if key is not None else None
            entry = cache.get(key) if key is not None else None
            if isinstance(entry, list) and len(entry) == 3 and sig is not None \
                    and entry[1:] == sig:
                lengths.append(int(entry[0]))
                continue
            m = int(self.dataset.bag(i).shape[0])
            lengths.append(m)
            if key is not None and sig is not None:
                cache[key] = [m, *sig]
                dirty = True
        if sidecar is not None and dirty:
            try:
                with open(sidecar, "w") as f:
                    json.dump(cache, f)
            except OSError:
                pass  # read-only store: skip the cache
        return np.array(lengths)

    def __len__(self) -> int:
        """Exact number of batches an epoch yields (bucket histogram based)."""
        if len(self.dataset) == 0:
            return 0
        counts: Dict[int, int] = {}
        for length in self._bag_lengths():
            b = bucket_for(int(length), self.buckets)
            counts[b] = counts.get(b, 0) + 1
        return sum(-(-c // self.batch_size) for c in counts.values())

    def _epoch_plan(self) -> List:
        """The epoch's batches as (indices, bucket) in emission order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        lengths = self._bag_lengths()
        plan: List = []
        pending: Dict[int, List[int]] = {}
        for i in order:
            b = bucket_for(int(lengths[i]), self.buckets)
            pending.setdefault(b, []).append(int(i))
            if len(pending[b]) == self.batch_size:
                plan.append((pending.pop(b), b))
        for b, idxs in sorted(pending.items()):
            plan.append((idxs, b))
        return plan

    def batches(self) -> Iterator[Batch]:
        """Yield the epoch's bucketed padded batches."""
        for indices, bucket in self._epoch_plan():
            yield self._make_batch(indices, bucket)

    def _make_batch(self, indices: List[int], bucket: int) -> Batch:
        full, weight = pad_plan_indices(indices, self.batch_size)
        masks = np.zeros((len(full), bucket), dtype=bool)
        bags = []
        for row, i in enumerate(full):
            padded, masks[row] = pad_bag(np.asarray(self.dataset.bag(i), np.float32), bucket)
            bags.append(padded)
        batch = dict(wsi=np.stack(bags), mask=masks, weight=weight,
                     index=np.array(full, np.int32), bucket=bucket, n_real=len(indices))
        batch.update(self.extras_fn(self.dataset, np.array(full)))
        return batch


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


def to_device(batch: Batch, device, ge_mode: bool) -> Dict[str, Any]:
    """A host batch's tensors on ``device``, as the steps read them: wsi,
    mask, weight, label and, for survival models, the omics groups as one
    packed [B, sum(s_i)] tensor (the device cache's layout), censorship and
    survival_months."""
    import torch

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    out = {"wsi": put(batch["wsi"], np.float32), "mask": put(batch["mask"], bool),
           "weight": put(batch["weight"], np.float32), "label": put(batch["label"], np.int64)}
    if not ge_mode:
        out["omics_packed"] = put(np.concatenate(
            [np.asarray(o, np.float32) for o in batch["omics"]], axis=-1), np.float32)
        out["censorship"] = put(batch["censorship"], np.float32)
        out["survival_months"] = put(batch["survival_months"], np.float32)
    return out


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch of host batches: bag reads and padding
    overlap the device's work (the reference leans on DataLoader workers,
    mcat/main.py:250-252), at most ``depth`` batches ahead. An exception in
    the source is raised in the consumer; a consumer that stops early
    releases the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    error: List[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that notices an abandoned consumer (a plain put would
        # block forever once the consumer generator is dropped)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    break
        except BaseException as exc:  # raised again in the consumer
            error.append(exc)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join()
