"""The (data, seq) mesh of the port's ranks and its layouts
(``multimodal_path_omic_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over the devices of one
process and lets GSPMD place the collectives. Here every rank is a process
with one device, so a mesh is this rank's position and its groups, and the
layouts are slicing rules:

* ``data``: bags (the batch rows). Rank (d, s) holds rows
  [d * B / data, (d + 1) * B / data) of every global batch; the gradient
  all-reduce spans the world (``train/loop.py``).
* ``seq``: the patch axis M inside each bag. Rank (d, s) holds patches
  [s * M / seq, (s + 1) * M / seq) of its rows; attention over the patches
  merges its softmax statistics across the seq group
  (``parallel/ring.py``, ``ops/blocks.py``).

Ranks lie data-major, as the JAX package reshapes its device grid
(``mesh.py:38``): rank r is (d, s) = (r // seq, r % seq), on
``cuda:LOCAL_RANK`` (modulo the cards there are, so that several ranks can
share one card over gloo). The world size must equal data x seq.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from multimodal_path_omic_tpu_torch.parallel import comm

# the batch fields whose second axis is the patch axis
PATCH_KEYS = ("wsi", "mask", "wsi_scale")


class Mesh:
    """This rank's place in a (data, seq) mesh: ``data``, ``seq``, ``rank``,
    ``d``, ``s``, its ``device``, and the groups ``world``, ``data_group``
    (the ranks of its seq position, one a data position: the batch rows'
    group) and ``seq_group`` (the ranks of its data position: the patch
    axis' group)."""

    def __init__(self, data: int, seq: int, rank: int, device: torch.device,
                 world: comm.Group, data_group: comm.Group, seq_group: comm.Group):
        self.data, self.seq, self.rank, self.device = data, seq, rank, device
        self.d, self.s = divmod(rank, seq)
        self.world, self.data_group, self.seq_group = world, data_group, seq_group
        self.backend = world.backend

    @property
    def size(self) -> int:
        return self.data * self.seq

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "seq": self.seq}

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.data:
            raise ValueError(f"{n} batch rows do not split over data axis {self.data}")
        per = n // self.data
        return slice(self.d * per, (self.d + 1) * per)

    def patches(self, m: int) -> slice:
        """This rank's patches of a bag padded to ``m`` (its bucket)."""
        if m % self.seq:
            raise ValueError(f"bucket {m} does not split over seq axis {self.seq}")
        per = m // self.seq
        return slice(self.s * per, (self.s + 1) * per)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, seq={self.seq}, rank={self.rank} = ({self.d}, "
                f"{self.s}), device={self.device}, backend={self.backend})")


def make_mesh(data: int = 1, seq: int = 1, *, device=None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's (data, seq) mesh: joins the process group torchrun
    describes if it is not joined (``comm.init_from_env``; ``backend`` for
    the tests and the smoke), then builds the data and seq groups. The world
    must hold exactly data x seq ranks (the JAX ``make_mesh`` refuses a mesh
    that needs more devices than exist). ``device``: None is
    ``cuda:LOCAL_RANK`` (modulo the cards present), "cpu" the CPU."""
    n = data * seq
    world_n = comm.world_size()
    if n > world_n:
        raise ValueError(f"mesh {data}x{seq} needs {n} devices, have {world_n} "
                         f"(the world size: one rank a device)")
    if n != world_n:
        raise ValueError(f"mesh {data}x{seq} spans {n} ranks but the world size is "
                         f"{world_n}: set the axes to span every rank")
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to build a "
                               "mesh of CPU ranks")
        index = (torch.device(device).index if device is not None
                 and torch.device(device).index is not None
                 else comm.local_rank() % torch.cuda.device_count())
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    device = torch.device(device)
    if n > 1:
        comm.init_from_env(device, backend)
    me = comm.rank()
    world = comm.world_group()
    data_groups = [comm.new_group([d * seq + s for d in range(data)], me) for s in range(seq)]
    seq_groups = [comm.new_group([d * seq + s for s in range(seq)], me) for d in range(data)]
    d, s = divmod(me, seq)
    return Mesh(data, seq, me, device, world, data_groups[s], seq_groups[d])


def batch_spec(key: str, stacked: bool = False):
    """The mesh axes of a batch field's dimensions (JAX ``batch_spec``):
    ("data", "seq") for wsi, mask and wsi_scale ([B, M, ...]: rows over
    data, patches over seq), ("data",) for the per-sample fields; with
    ``stacked`` a leading dispatch-group axis, unsplit (None)."""
    spec = ("data", "seq") if key in PATCH_KEYS else ("data",)
    return (None,) + spec if stacked else spec


def cache_patches(bucket: int, mesh: Mesh) -> slice:
    """This rank's patches of every bag of a device-cache bucket (JAX
    ``cache_spec``: the bag axis unsplit, so a gather over it needs no
    collective; the patch axis split over every rank, chunk r on rank r;
    the label and omics tables replicated)."""
    if bucket % mesh.size:
        raise ValueError(f"bucket {bucket} does not split over the {mesh.size} ranks of "
                         "the mesh")
    per = bucket // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def local_slice(value, key: str, mesh: Mesh, stacked: bool = False):
    """A global batch field's slice for this rank, by :func:`batch_spec`."""
    shape = tuple(value.shape)  # numpy arrays and tensors alike
    idx = [slice(None)] * len(shape)
    for axis, name in enumerate(batch_spec(key, stacked)):
        if name == "data":
            idx[axis] = mesh.rows(shape[axis])
        elif name == "seq":
            idx[axis] = mesh.patches(shape[axis])
    return value[tuple(idx)]


def shard_batch(batch: Dict[str, Any], mesh: Mesh, process_local: bool = True,
                stacked: bool = False) -> Dict[str, Any]:
    """A batch's tensors on this rank's device in its layout. With
    ``process_local`` (the default: every rank is its own process) each
    field already holds this rank's slice (``BucketBatcher.host_slice``)
    and is copied as it is; otherwise the fields hold the global batch and
    are sliced here (:func:`local_slice`). 'omics' (a list) slices
    element-wise; 'bucket', 'n_real' and 'index' pass through."""
    out = {}
    for key, value in batch.items():
        if key in ("bucket", "n_real", "index"):
            out[key] = value
            continue
        if key == "omics":
            out[key] = [_to(o if process_local else local_slice(o, "label", mesh, stacked),
                            mesh.device) for o in value]
            continue
        out[key] = _to(value if process_local else local_slice(value, key, mesh, stacked),
                       mesh.device)
    return out


def _to(value, device) -> torch.Tensor:
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
    return t.to(device)


def replicate(tensors, mesh: Mesh) -> None:
    """Broadcast ``tensors`` (parameters, buffers, optimizer state) from
    rank 0 in place, then check that every rank holds the same values
    (``check_replicated``)."""
    tensors = [t for t in tensors if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            comm.broadcast_(t.data, mesh.world)
    check_replicated(tensors, mesh)


def check_replicated(tensors, mesh: Mesh) -> None:
    """Raise unless every rank holds bitwise the same ``tensors``: their
    bytes' sums and maxima, compared over the world."""
    if mesh.size == 1:
        return
    probe = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 4 == 0:  # 32-bit words: a quarter of the int64 probe
            b = b.view(torch.int32)
        b = b.to(torch.int64)
        pos = torch.arange(1, b.numel() + 1, device=b.device) % 65521
        probe.append(torch.stack([b.sum(), (b % 65521 * pos).sum()]))
    if not probe:
        return
    mine = torch.stack(probe).to(torch.float64)
    top = comm.all_reduce(mine, mesh.world, "max")
    low = -comm.all_reduce(-mine, mesh.world, "max")
    if not torch.equal(top, low):
        bad = int(torch.nonzero((top != low).any(dim=1))[0, 0])
        raise RuntimeError(f"tensor {bad} differs across the ranks of {mesh}")


def reshard_cache_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A global batch gathered from this rank's slice of the device cache,
    [B, bucket / size, ...] (:func:`cache_patches`: rank r holds patch chunk
    r of every bag), as this rank's part of the batch layout, [B / data,
    bucket / seq, ...]: one all-to-all over the world (JAX: the sharding
    constraint in ``loop.py::_gather_batch``). Chunk r lies in seq slice
    r // data, so rank r sends rows d' of its chunk to each rank (d', r //
    data), and a rank joins the ``data`` chunks of its seq slice in order."""
    if mesh.size == 1:
        return x
    b = x.shape[0]
    rows = b // mesh.data
    my_slice = mesh.rank // mesh.data  # the seq slice this rank's chunk lies in
    pieces, recv = [], []
    piece_bytes = rows * x[0].numel() * x.element_size()
    for r in range(mesh.size):
        d, s = divmod(r, mesh.seq)
        pieces.append(x[d * rows:(d + 1) * rows] if s == my_slice else None)
        recv.append(piece_bytes if r // mesh.data == mesh.s else 0)
    got = comm.all_to_all_bytes(pieces, recv, mesh.world, x.device)
    parts = [g.view(x.dtype).reshape((rows,) + tuple(x.shape[1:])) for g in got if g.numel()]
    return torch.cat(parts, dim=1)
