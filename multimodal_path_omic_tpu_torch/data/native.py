"""ctypes bindings of the port's C++ bag loader (``csrc_host/bagloader.cc``;
``multimodal_path_omic_tpu/data/native.py``).

The library is built with ``g++ -O3`` at first use, from the package's own
source, into ``<package>/_build/`` (gitignored), named by a hash of the
source and the flags as ``ops/kernels.py`` names the CUDA libraries. A build
that fails raises and names its log: nothing falls back to the Python reader
once the native reader was asked for (``tpu.use_native_pipeline``).

* :class:`NativeBagStore` — a directory of ``.npy`` bags indexed by the C++
  runtime: O(1) length probes from the file headers, threaded fills of
  padded batches (:meth:`NativeBagStore.load_batch`);
* :func:`shared_store` — one store per directory;
* :class:`NativePipeline` — the C++ pipelined executor: worker threads fill a
  ring of slots with each batch's bags, packed (their own rows, no padding),
  ahead of the consumer. On a GPU host the slots are pinned memory, so a
  slot is the Stager's pinned rows: it is copied to the device as it is, and
  goes back to the ring only once that copy has finished
  (:meth:`NativePipeline.release` after the copy's CUDA event).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from multimodal_path_omic_tpu_torch.data.bags import slide_basename

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc_host", "bagloader.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "bl_open": (_P, [ctypes.c_char_p]),
    "bl_count": (_L, [_P]),
    "bl_lookup": (_L, [_P, ctypes.c_char_p]),
    "bl_length": (_L, [_P, _L]),
    "bl_dim": (_L, [_P, _L]),
    "bl_load_batch": (_I, [_P, _P, _L, _L, _L, _P, _P, _I]),
    "bl_close": (None, [_P]),
    "bl_pipe_create": (_P, [_P, _P, _P, _P, _P, _P, _L, _L, _L, _P, _L, _I]),
    "bl_pipe_next": (_L, [_P]),
    "bl_pipe_release": (None, [_P, _L]),
    "bl_pipe_error": (_I, [_P]),
    "bl_pipe_destroy": (None, [_P]),
}


def library_path() -> str:
    """``_build/libbagloader_<hash>.so``: the hash covers the source and the
    flags, so an edited source rebuilds."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libbagloader_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library unless it exists; returns its path. A failed build
    raises, naming its log (``<library>.log``)."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    log = path + ".log"
    with open(log, "w") as fh:
        try:
            rc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], stdout=fh,
                                stderr=subprocess.STDOUT).returncode
        except OSError as exc:  # no compiler
            fh.write(f"{exc}\n")
            rc = -1
    if rc != 0:
        raise RuntimeError(f"the native bag loader did not build (g++ rc={rc}); see {log}")
    os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
    return _LIB


_STORES: dict = {}
_STORES_LOCK = threading.Lock()


def shared_store(patches_dir: str) -> "NativeBagStore":
    """One :class:`NativeBagStore` per directory: ``bl_open`` lists and parses
    every slide's header, so the batchers over one store share one index."""
    key = os.path.abspath(patches_dir)
    with _STORES_LOCK:
        store = _STORES.get(key)
        if store is None:
            store = _STORES[key] = NativeBagStore(patches_dir)
        return store


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class NativeBagStore:
    """A directory of ``.npy`` bags (little-endian float32, C order, 2-D),
    indexed and read by the C++ runtime. A file whose header it cannot parse
    is not indexed: its length is -1 (:meth:`length`)."""

    def __init__(self, patches_dir: str, threads: int = 8):
        self._lib = library()
        self.threads = threads
        self.patches_dir = patches_dir
        self._handle = self._lib.bl_open(patches_dir.encode())
        if not self._handle:
            raise FileNotFoundError(f"cannot open bag directory {patches_dir!r}")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bl_close(handle)
            self._handle = None

    def lookup(self, slide_id: str) -> int:
        return int(self._lib.bl_lookup(self._handle, slide_basename(slide_id).encode()))

    def exists(self, slide_id: str) -> bool:
        return self.lookup(slide_id) >= 0

    def length(self, slide_id: str) -> int:
        return int(self._lib.bl_length(self._handle, self.lookup(slide_id)))

    def dim(self, slide_id: str) -> int:
        return int(self._lib.bl_dim(self._handle, self.lookup(slide_id)))

    def get(self, slide_id: str) -> np.ndarray:
        """One bag [M, D] float32 (the ``BagStore`` protocol)."""
        wsi, _ = self.load_batch([slide_id], bucket=self.length(slide_id),
                                 dim=self.dim(slide_id))
        return wsi[0]

    def load_batch(self, slide_ids: Sequence[str], bucket: int, dim: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """A padded batch: (wsi [n, bucket, D] float32, mask [n, bucket] bool),
        bags past ``bucket`` cut to it."""
        n = len(slide_ids)
        ids = np.array([self.lookup(s) for s in slide_ids], dtype=np.int64)
        if (ids < 0).any():
            missing = [s for s, i in zip(slide_ids, ids) if i < 0]
            raise FileNotFoundError(f"bags missing from the native index: {missing[:4]}")
        wsi = np.empty((n, bucket, dim), dtype=np.float32)
        mask = np.empty((n, bucket), dtype=np.uint8)
        err = self._lib.bl_load_batch(self._handle, _ptr(ids), n, bucket, dim, _ptr(wsi),
                                      _ptr(mask), self.threads)
        if err != 0:
            raise IOError(f"native bag load failed (code {err})")
        return wsi, mask.astype(bool)


class NativePipeline:
    """The C++ pipelined executor over an epoch's plan. ``plan``: one list of
    (slide_id, first row, rows) a batch, in the order the consumer takes
    them; a batch's bags land packed in its slot, one after another.
    ``pinned``: the slots are pinned host memory (a GPU host), so that they
    copy to the device as they are. ``slots``: a ring to reuse (an earlier
    pipeline's :attr:`slots`, every copy from it finished), taken where it
    is large enough: pinning a fresh ring every epoch costs more than the
    epoch's reads.

    :meth:`next` returns the next batch's rows, a [rows, D] float32 view of
    its slot (a torch tensor, pinned or not); the slot is refilled only
    after :meth:`release` of that batch, which the consumer calls once the
    rows are on the device (for an asynchronous copy: once its event has
    passed). :meth:`next` itself releases the batch that held its slot
    ``n_slots`` batches ago, waiting for the event it was given."""

    def __init__(self, store: NativeBagStore, plan: Sequence[Sequence[Tuple[str, int, int]]],
                 dim: int, n_slots: int = 3, threads: int = 4, pinned: bool = False,
                 slots=None):
        import torch

        self._lib = store._lib
        self._store = store  # the C++ index must outlive the pipe
        self.dim = int(dim)
        self.n_slots = int(n_slots)
        ids, src, rows, dst, offsets, totals = [], [], [], [], [0], []
        for batch in plan:
            off = 0
            for slide_id, first, n in batch:
                i = store.lookup(slide_id)
                if i < 0:  # by name now; a -1 handed to C++ is a bare error code
                    raise FileNotFoundError(f"bag missing from the native index: {slide_id!r}")
                ids.append(i)
                src.append(int(first))
                rows.append(int(n))
                dst.append(off)
                off += int(n)
            offsets.append(len(ids))
            totals.append(off)
        self.totals = totals
        self._arrays = [np.array(a, dtype=np.int64) for a in (ids, src, rows, dst, offsets)]
        self.slot_rows = max(totals, default=0)
        if (slots is not None and slots.shape[0] == self.n_slots and slots.shape[2] == self.dim
                and slots.shape[1] >= self.slot_rows and slots.is_pinned() == pinned):
            self.slot_rows = slots.shape[1]
            self.slots = slots  # an earlier epoch's ring, its copies done
        else:
            self.slots = torch.empty((self.n_slots, max(self.slot_rows, 1), self.dim),
                                     dtype=torch.float32, pin_memory=pinned)
        self._pending: List[Tuple[int, object]] = []  # (batch, event or None) not yet released
        self._next = 0
        self._pipe = self._lib.bl_pipe_create(
            store._handle, *(_ptr(a) for a in self._arrays), len(plan), self.dim,
            self.slot_rows, self.slots.data_ptr(), self.n_slots, threads)

    def __len__(self) -> int:
        return len(self.totals)

    def next(self):
        """(batch index, rows [rows, D] view of its slot)."""
        b = self._next
        if b >= len(self.totals):
            raise StopIteration
        self._release_ready(before=b - self.n_slots)
        got = int(self._lib.bl_pipe_next(self._pipe))
        if got != b:
            raise RuntimeError(f"native pipeline returned batch {got}, expected {b}")
        err = int(self._lib.bl_pipe_error(self._pipe))
        if err:
            raise IOError(f"native pipeline fill failed (code {err})")
        self._next += 1
        return b, self.slots[b % self.n_slots, :self.totals[b]]

    def release(self, batch: int, event=None) -> None:
        """Give ``batch``'s slot back to the ring once ``event`` (a CUDA event
        recorded after the slot's copy, or None: now) has passed."""
        self._pending.append((batch, event))
        self._release_ready()

    def _release_ready(self, before: Optional[int] = None) -> None:
        """Release the pending batches whose copies are done, and wait for
        the copy of every batch up to ``before``."""
        keep = []
        for b, event in self._pending:
            if event is not None and before is not None and b <= before:
                event.synchronize()
                event = None
            if event is None or event.query():
                self._lib.bl_pipe_release(self._pipe, b)
            else:
                keep.append((b, event))
        self._pending = keep

    def close(self) -> None:
        """Stop the workers. Copies still in flight keep the slots' memory
        (the pinned host allocator holds a buffer until its copies finish)."""
        if getattr(self, "_pipe", None):
            self._lib.bl_pipe_destroy(self._pipe)
            self._pipe = None

    def __del__(self):
        self.close()
