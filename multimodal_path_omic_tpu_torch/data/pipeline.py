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
are the JAX package's. On a mesh each rank reads only its slice of every
global batch (:attr:`BucketBatcher.host_slice`). Bags load through the
dataset's store, and :func:`prefetch` overlaps that with the device in a
thread; with ``use_native_pipeline`` (the Trainer sets it from
``tpu.use_native_pipeline``) a directory of ``.npy`` bags is read by the C++
loader instead (``data/native.py``): :meth:`BucketBatcher.native_pipeline`
fills pinned slots with each batch's own rows, which the :class:`Stager`
copies to the device as they are.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from multimodal_path_omic_tpu_torch.data.bags import DEFAULT_BUCKETS, bucket_for, pad_bag
from multimodal_path_omic_tpu_torch.data.quant import quantize_bag_int8


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

    ``host_slice`` (a ``parallel.mesh.Mesh``, or None; JAX ``host_slice``,
    ``pipeline.py:61-76``): every rank computes the same seed-deterministic
    plan and reads only its slice of each batch: the rows of its data
    position and, of each of their bags, the patches of its seq position
    (a bag padded to its bucket, the bucket split over the seq axis). Ranks
    that share a data position read the same rows.
    """

    # The C++ reader (data/native.py), where the Trainer asks for it: its
    # pipeline's slots are recycled only after their copies to the device
    # (the Trainer's native feed), so the aliasing hazard of JAX
    # ``pipeline.py:230-240`` cannot reach a consumer.
    use_native_pipeline: bool = False

    def __init__(self, dataset, extras_fn, batch_size: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, shuffle: bool = True,
                 seed: int = 0, host_slice=None):
        self.dataset = dataset
        self.extras_fn = extras_fn
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._lengths = None  # bag lengths, probed once
        self._native = None  # the NativeBagStore; False once the Python reader is chosen
        self.reader_note = ""  # why the Python reader reads, where the native one was asked for
        self._slots = None  # the native pipeline's slot ring, kept across epochs
        self.host_slice = host_slice

    def native_store(self):
        """The C++ store (``data/native.py::shared_store``) where
        ``use_native_pipeline`` is set and the dataset's store is a directory
        of ``.npy`` bags, else None (then :attr:`reader_note` says why). A
        loader that does not build raises; the Python reader then does not
        stand in for it."""
        if not self.use_native_pipeline or self._native is False:
            return None
        if self._native is None:
            from multimodal_path_omic_tpu_torch.data.bags import NpyBagStore

            store = getattr(self.dataset, "store", None)
            if not isinstance(store, NpyBagStore) or not hasattr(self.dataset, "slide_id"):
                self._native = False
                self.reader_note = f"the bag store is {type(store).__name__}, not .npy"
                return None
            from multimodal_path_omic_tpu_torch.data.native import shared_store

            self._native = shared_store(store.patches_dir)
            self._lengths = None  # probed again, from the headers
        return self._native

    @property
    def reader(self) -> str:
        """"native" or "python": which reader loads this batcher's bags."""
        if len(self.dataset):
            self._bag_lengths()  # a header the loader cannot parse drops it
        return "native" if self.native_store() is not None else "python"

    def _bag_lengths(self) -> np.ndarray:
        if self._lengths is None:
            native = self.native_store()
            if native is not None:
                lengths = np.array([native.length(self.dataset.slide_id(i))
                                    for i in range(len(self.dataset))], dtype=np.int64)
                if (lengths < 0).any():
                    # a bag the C++ header parser refuses (another dtype, 1-D,
                    # Fortran order) but np.load reads: the Python reader takes
                    # the whole cohort (JAX pipeline.py:104-113)
                    self._native = False
                    self.reader_note = ("a .npy header the native loader cannot parse: "
                                        + self.dataset.slide_id(int(np.argmax(lengths < 0))))
                else:
                    self._lengths = lengths
                    return lengths
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

    @property
    def host_slice(self):
        return self._host_slice

    @host_slice.setter
    def host_slice(self, mesh):
        # checked on every assignment (the Trainer sets it after
        # construction): an indivisible batch would drop rows
        if mesh is not None and self.batch_size % mesh.data != 0:
            raise ValueError(f"batch_size {self.batch_size} not divisible by the data axis "
                             f"{mesh.data}")
        self._host_slice = mesh

    def _local(self, full: List[int], weight: np.ndarray, bucket: int):
        """(this rank's rows of ``full``, their weights, the patch window of
        a bag padded to ``bucket``, its width)."""
        mesh = self.host_slice
        if mesh is None:
            return full, weight, slice(0, bucket), bucket
        rows = mesh.rows(len(full))
        window = mesh.patches(bucket)
        return full[rows], weight[rows], window, window.stop - window.start

    def _row_tasks(self, indices: List[int], bucket: int):
        """The rows of ``_make_rows(indices, bucket)`` as the native pipeline
        reads them: (full, weight, width, [(slide_id, first row, rows)] a
        row, in order)."""
        full, weight = pad_plan_indices(indices, self.batch_size)
        full, weight, window, width = self._local(full, weight, bucket)
        lengths = self._bag_lengths()
        tasks = []
        for i in full:
            n = int(lengths[i])
            if n > bucket:
                raise ValueError(f"bag of {n} patches exceeds bucket {bucket}")
            rows = max(0, min(n, window.stop) - window.start)
            tasks.append((self.dataset.slide_id(i), window.start, rows))
        return full, weight, width, tasks

    def native_pipeline(self, plan, pinned: bool = False):
        """A ``data/native.py::NativePipeline`` over ``plan``'s batches, each
        ``(indices, bucket)`` as :meth:`_epoch_plan` gives them."""
        from multimodal_path_omic_tpu_torch.data.native import NativePipeline

        store = self.native_store()
        dim = store.dim(self.dataset.slide_id(0))
        # one slot ring for the batcher's epochs, reused once the last
        # epoch's copies are done (its consumer waited on each of them)
        pipe = NativePipeline(store, [self._row_tasks(idx, b)[3] for idx, b in plan], dim,
                              pinned=pinned, slots=self._slots)
        self._slots = pipe.slots
        return pipe

    def native_rows(self, indices: List[int], bucket: int, rows) -> Batch:
        """:meth:`_make_rows`' batch with the bags' rows, packed, as one
        part: ``rows`` [P, D], the native pipeline's slot view."""
        full, weight, width, tasks = self._row_tasks(indices, bucket)
        batch = rows_layout([t[2] for t in tasks], width, len(full))
        batch["rows"] = [rows]
        batch.update(weight=weight, index=np.array(full, np.int32), bucket=bucket,
                     n_real=int(weight.sum()))
        batch.update(self.extras_fn(self.dataset, np.array(full)))
        return batch

    def _make_rows(self, indices: List[int], bucket: int) -> Batch:
        """:meth:`_make_batch` without the padding: each row's bag as it is
        ('rows', a list of [M_i, D] float32 arrays, filler rows included) and
        its patches' positions in the batch flattened to [B * bucket]
        ('pos'); the other fields as there. :class:`Stager` carries only
        these patches, and :meth:`Staged.take` pads on the device. Under
        ``host_slice``: this rank's rows, each bag cut to its patch window
        (bucket: the window's width)."""
        full, weight = pad_plan_indices(indices, self.batch_size)
        full, weight, window, width = self._local(full, weight, bucket)
        bags = [np.asarray(self.dataset.bag(i))[window] for i in full]
        batch = bag_rows(bags, width, len(full))
        batch.update(weight=weight, index=np.array(full, np.int32), bucket=bucket,
                     n_real=int(weight.sum()))
        batch.update(self.extras_fn(self.dataset, np.array(full)))
        return batch

    def _make_batch(self, indices: List[int], bucket: int) -> Batch:
        full, weight = pad_plan_indices(indices, self.batch_size)
        full, weight, window, width = self._local(full, weight, bucket)
        masks = np.zeros((len(full), width), dtype=bool)
        bags = []
        for row, i in enumerate(full):
            padded, m = pad_bag(np.asarray(self.dataset.bag(i), np.float32), bucket)
            bags.append(padded[window])
            masks[row] = m[window]
        batch = dict(wsi=np.stack(bags), mask=masks, weight=weight,
                     index=np.array(full, np.int32), bucket=bucket, n_real=int(weight.sum()))
        batch.update(self.extras_fn(self.dataset, np.array(full)))
        return batch


def bag_rows(bags: Sequence[np.ndarray], bucket: int, n: int) -> Dict[str, Any]:
    """An ``n``-row batch of ``bags`` (one a row, each at most ``bucket``
    patches) without its padding: 'rows', the bags as float32 arrays;
    'pos', a list of each bag's positions in the batch flattened to
    [n * bucket]; 'mask' [n, bucket]."""
    rows = [np.asarray(bag, np.float32) for bag in bags]
    out = rows_layout([len(r) for r in rows], bucket, n)
    out["rows"] = rows
    return out


def rows_layout(lengths: Sequence[int], bucket: int, n: int) -> Dict[str, Any]:
    """'pos' and 'mask' of :func:`bag_rows` for bags of ``lengths``."""
    mask = np.zeros((n, bucket), dtype=bool)
    pos = []
    for row, m in enumerate(lengths):
        if m > bucket:
            raise ValueError(f"bag of {m} patches exceeds bucket {bucket}")
        mask[row, :m] = True
        pos.append(row * bucket + np.arange(m, dtype=np.int64))
    return {"pos": pos, "mask": mask}


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


def _transfer_rows(rows: Sequence[np.ndarray], transfer_dtype: str):
    """A batch's bags in the transfer type: (the rows, their int8 row scales
    or None). bfloat16: torch tensors (numpy has no bfloat16), rounded to
    nearest even; int8: each row quantized (``data/quant.py``)."""
    import torch

    if transfer_dtype == "bfloat16":
        return [_as_tensor(np.ascontiguousarray(r, np.float32)).to(torch.bfloat16)
                for r in rows], None
    if transfer_dtype == "int8":
        pairs = [quantize_bag_int8(np.asarray(r)) for r in rows]
        return [q for q, _ in pairs], [sc for _, sc in pairs]
    # float32 rows pass as they are: a native slot stays a pinned tensor
    return [r if isinstance(r, torch.Tensor) and r.dtype == torch.float32
            else np.ascontiguousarray(r, np.float32) for r in rows], None


def device_arrays(batch: Batch, ge_mode: bool, transfer_dtype: str = "float32"
                  ) -> Dict[str, Any]:
    """A host batch's arrays as the steps read them: wsi (or a
    :meth:`BucketBatcher._make_rows` batch's rows and pos) in
    ``transfer_dtype`` (float32; bfloat16, a torch tensor; int8 with its
    float32 row scales, ``wsi_scale`` or ``rows_scale``: the JAX Trainer's
    ``_device_batch`` quantizes the padded batch, this the real rows, which
    is the same per-row quantization, padding rows being q = 0, scale 1), mask
    bool, weight float32, label int64 and, for survival models, the omics
    groups as one packed [..., sum(s_i)] float32 array (the device cache's
    layout), censorship and survival_months float32."""
    if "rows" in batch:  # lists: staged into pinned buffers of a few sizes
        rows, scales = _transfer_rows(batch["rows"], transfer_dtype)
        out = {"rows": rows, "pos": list(batch["pos"])}
        if scales is not None:
            out["rows_scale"] = scales
    else:
        wsi, scales = _transfer_rows([batch["wsi"]], transfer_dtype)
        out = {"wsi": wsi[0]}
        if scales is not None:
            out["wsi_scale"] = scales[0]
    out.update({"mask": np.ascontiguousarray(batch["mask"], bool),
                "weight": np.ascontiguousarray(batch["weight"], np.float32),
                "label": np.ascontiguousarray(batch["label"], np.int64)})
    if not ge_mode:
        out["omics_packed"] = np.ascontiguousarray(np.concatenate(
            [np.asarray(o, np.float32) for o in batch["omics"]], axis=-1))
        out["censorship"] = np.ascontiguousarray(batch["censorship"], np.float32)
        out["survival_months"] = np.ascontiguousarray(batch["survival_months"], np.float32)
    return out


def to_device(batch: Batch, device, ge_mode: bool, transfer_dtype: str = "float32"
              ) -> Dict[str, Any]:
    """A padded host batch's tensors on ``device`` (:func:`device_arrays`'
    fields), copied from pageable memory."""
    return {k: _as_tensor(v).to(device)
            for k, v in device_arrays(batch, ge_mode, transfer_dtype).items()}


def _merged(batches: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """K row batches (:func:`device_arrays` of ``_make_rows`` batches) as
    one: their rows in order, positions shifted into the [K, B, bucket]
    batch, every other field stacked."""
    per = batches[0]["mask"].size
    out = {"rows": [r for b in batches for r in b["rows"]],
           "pos": [p + k * per for k, b in enumerate(batches) for p in b["pos"]]}
    if "rows_scale" in batches[0]:
        out["rows_scale"] = [sc for b in batches for sc in b["rows_scale"]]
    for key in batches[0]:
        if key not in out:
            out[key] = np.stack([b[key] for b in batches])
    return out


def unpad(tensors: Dict[str, Any]) -> Dict[str, Any]:
    """Staged row tensors (rows [P, D], pos [P], mask [..., bucket]) as the
    padded batch: wsi [..., bucket, D], zero but at ``pos``, where the rows
    go in order; int8 rows' scales (rows_scale [P]) as wsi_scale
    [..., bucket], 1 but at ``pos``. Other tensors pass through."""
    import torch

    if "rows" not in tensors:
        return tensors
    out = dict(tensors)
    rows, pos, mask = out.pop("rows"), out.pop("pos"), out["mask"]
    wsi = torch.zeros(tuple(mask.shape) + (rows.shape[-1],), dtype=rows.dtype,
                      device=rows.device)
    wsi.view(-1, rows.shape[-1]).index_copy_(0, pos, rows)
    out["wsi"] = wsi
    if "rows_scale" in out:
        scale = torch.ones(tuple(mask.shape), device=rows.device)
        scale.view(-1).index_copy_(0, pos, out.pop("rows_scale"))
        out["wsi_scale"] = scale
    return out


class Staged:
    """Device tensors a :class:`Stager` is filling: :meth:`take` them on the
    stream that reads them."""

    def __init__(self, tensors: Dict[str, Any], event=None):
        self.tensors = tensors
        self.event = event  # recorded on the copy stream after the copies

    def take(self) -> Dict[str, Any]:
        """The tensors, once the current stream has been made to wait for
        their copies (and the allocator told that this stream reads them);
        staged rows come padded (:func:`unpad`)."""
        if self.event is not None:
            import torch

            stream = torch.cuda.current_stream(next(iter(self.tensors.values())).device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
            self.event = None
        self.tensors = unpad(self.tensors)
        return self.tensors


class Stager:
    """``to_device`` through pinned host buffers: each array is copied into
    a pinned buffer reused across calls (two per array name, shape and
    type; a list of parts per power-of-two count of rows) and from there to the device by a ``non_blocking`` copy on the
    stager's own copy stream, so the copies overlap the compute stream's
    work. A buffer is refilled only after its last copy has finished (its
    event has passed); the consumer's stream waits on the staged batch's
    event (:meth:`Staged.take`). An array that is pinned already (a native
    pipeline's slot) is copied to the device as it is; its owner reuses it
    after the staged batch's event. Meant to run in :func:`prefetch`'s thread;
    calls from several threads take turns (a lock).

    On the CPU it makes the same tensors as :func:`to_device`, with no copy
    stream and no pinned memory."""

    SLOTS = 2  # pinned buffers a ring: one filling while the other's copy runs

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._stream = None
        self._rings: Dict[tuple, list] = {}  # (name, shape, dtype) -> [turn, [(pinned, event)]]

    def stage_batch(self, batch: Batch, ge_mode: bool, transfer_dtype: str = "float32"
                    ) -> Staged:
        """One host batch (:func:`device_arrays`' fields, the wsi in
        ``transfer_dtype``)."""
        return self.stage([device_arrays(batch, ge_mode, transfer_dtype)])

    def stage_group(self, batches: Sequence[Batch], ge_mode: bool,
                    transfer_dtype: str = "float32") -> Staged:
        """K same-shaped host batches as one batch of [K, ...] tensors (the
        device-side counterpart of ``stack_batches`` + ``to_device``)."""
        arrays = [device_arrays(b, ge_mode, transfer_dtype) for b in batches]
        if "rows" in arrays[0]:
            return self.stage([_merged(arrays)])
        return self.stage(arrays, stacked=True)

    def stage(self, rows: Sequence[Dict[str, Any]], stacked: bool = False) -> Staged:
        """``rows``: one dict of host arrays (numpy, or torch tensors on the
        CPU), or with ``stacked`` K dicts of same-shaped arrays, which land as
        [K, ...] tensors. Without ``stacked`` a value may also be a list of
        arrays, which land concatenated along their first axis (the parts
        are copied into the pinned buffer one by one: no host-side
        concatenation)."""
        import torch

        if not stacked and len(rows) != 1:
            raise ValueError("stage takes one dict of arrays unless stacked=True")
        if self.device.type != "cuda":
            return Staged({k: (torch.stack([_as_tensor(r[k]) for r in rows]) if stacked
                               else _joined(rows[0][k])).to(self.device) for k in rows[0]})
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                out = {k: torch.empty(((len(rows),) if stacked else ()) + _shape(a),
                                      dtype=_dtype(a), device=self.device)
                       for k, a in rows[0].items()}
                for i, row in enumerate(rows):
                    for k, a in row.items():
                        dst = out[k][i] if stacked else out[k]
                        if _pinned(a):  # pinned already (a native slot): copied as it is
                            off = 0
                            for part in (a if isinstance(a, list) else [a]):
                                dst[off:off + len(part)].copy_(part, non_blocking=True)
                                off += len(part)
                            continue
                        host, done = self._next_buffer(k, a)
                        if isinstance(a, list):
                            off = 0
                            for part in a:
                                host[off:off + len(part)].copy_(_as_tensor(part))
                                off += len(part)
                            src = host[:off]
                        else:
                            host.copy_(_as_tensor(a))
                            src = host
                        dst.copy_(src, non_blocking=True)
                        done.record(self._stream)
                ready = torch.cuda.Event()
                ready.record(self._stream)
        return Staged(out, ready)

    def _next_buffer(self, name: str, a):
        """The ring's next (pinned buffer, event) for ``a``, once the
        buffer's last copy to the device has finished. A list of parts gets
        a buffer of the next power of two of its rows, so a few buffers
        serve every length."""
        import torch

        shape = _shape(a)
        if isinstance(a, list):
            shape = (1 << max(shape[0] - 1, 0).bit_length(),) + shape[1:]
        ring = self._rings.setdefault((name, shape, _dtype(a)), [-1, []])
        ring[0] = turn = (ring[0] + 1) % self.SLOTS
        if turn == len(ring[1]):
            ring[1].append((torch.empty(shape, dtype=_dtype(a), pin_memory=True),
                            torch.cuda.Event()))
        host, done = ring[1][turn]
        done.synchronize()
        return host, done


def _as_tensor(a):
    """A host array as a CPU tensor (a tensor as it is; numpy without a copy)."""
    import torch

    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _pinned(a) -> bool:
    """Whether ``a`` (or every part of a list) is a pinned CPU tensor."""
    import torch

    parts = a if isinstance(a, list) else [a]
    return bool(parts) and all(isinstance(p, torch.Tensor) and p.is_pinned() for p in parts)


def _joined(a):
    """A value as one CPU tensor: a list of parts concatenated."""
    import torch

    return torch.cat([_as_tensor(p) for p in a]) if isinstance(a, list) else _as_tensor(a)


def _shape(a) -> tuple:
    """An array's shape; a list of parts: their rows summed."""
    if isinstance(a, list):
        return (sum(len(p) for p in a),) + tuple(a[0].shape[1:])
    return tuple(a.shape)


def _dtype(a):
    import torch

    first = a[0] if isinstance(a, list) else a
    if isinstance(first, torch.Tensor):
        return first.dtype
    return torch.from_numpy(np.asarray(first).reshape(-1)[:0]).dtype


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch of host batches: bag reads, padding and
    (through a :class:`Stager`) the copies to the device overlap the
    device's work (the reference leans on DataLoader workers,
    mcat/main.py:250-252), at most ``depth`` items ahead (``tpu.prefetch``). An exception in
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
