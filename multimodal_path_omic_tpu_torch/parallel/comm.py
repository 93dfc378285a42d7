"""Collectives of the port's mesh over ``torch.distributed``: the one module
that calls it.

The JAX package runs one process over many devices and XLA inserts its
collectives from the arrays' shardings (``parallel/mesh.py``). The port runs
one process per GPU (``torchrun --nproc-per-node N -m
multimodal_path_omic_tpu_torch.cli train ...``), so the collectives that
GSPMD would insert are written out: the gradient all-reduce of a training
step, the softmax-statistic merges of a patch axis split over ranks, the
all-to-all of the sharded device cache, the ring of ``parallel/ring.py``,
the all-gather of the cox loss's risk sets, and the requests a mesh server's
rank 0 hands to the other ranks (:func:`broadcast_request`).

* :func:`init_from_env` joins the process group torchrun describes
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); the backend
  follows the device, NCCL on CUDA and gloo on the CPU, unless the caller
  names one (the tests and ``chip_smoke.py`` run several ranks on one card
  over gloo).
* :class:`Group` is a set of ranks (the world, a data or a seq group of a
  mesh) with its backend. A group of one rank communicates nothing.
* Under gloo a CUDA tensor is staged through a pinned host buffer for every
  collective (gloo's send / recv and all-to-all take CPU tensors only); the
  NCCL branch stages nothing, and its collectives can be captured in a CUDA
  graph (``train/graphs.py``).
* Where a gradient crosses a collective it is an autograd ``Function``:
  :class:`AllReduceSum` (backward: the all-reduce sum of the incoming
  gradients; every rank of a group that holds a replicated result
  back-propagates its share, so the sum is the whole gradient) and
  :class:`AllGather` (backward: that sum, then this rank's slice).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def world_size() -> int:
    """The number of ranks: the process group's, or torchrun's
    ``WORLD_SIZE`` before the group is joined (1 outside torchrun)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK`` (0 outside torchrun)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_from_env(device: torch.device, backend: Optional[str] = None,
                  timeout_s: float = 600.0) -> str:
    """Join the process group torchrun describes, if it is not joined yet;
    returns its backend. ``backend`` None: NCCL for a CUDA ``device``, gloo
    for the CPU; the tests and the smoke name gloo to run several ranks on
    one card."""
    if dist.is_initialized():
        return dist.get_backend()
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        if key not in os.environ:
            raise RuntimeError(
                f"{key} is not set: launch the ranks with torchrun (or initialise "
                "torch.distributed before building the mesh)")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, rank=rank(), world_size=world_size(),
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return backend


class Group:
    """A set of ranks of the world (``ranks``, in group order) and the
    process group over them: None for a data or seq group of one rank, which
    communicates nothing (the world of a joined process group keeps its
    group even at one rank: its collectives run, a copy each). ``index`` is
    this rank's position in it."""

    def __init__(self, ranks: Sequence[int], pg, me: int):
        self.ranks = list(ranks)
        self.pg = pg
        self.size = len(self.ranks)
        self.local = pg is None  # nothing to communicate
        self.index = self.ranks.index(me) if me in self.ranks else -1
        self.backend = None if pg is None or self.index < 0 else dist.get_backend(pg)

    @property
    def staged(self) -> bool:
        """Whether a CUDA tensor crosses this group through host memory."""
        return self.backend == "gloo"


def new_group(ranks: Sequence[int], me: int) -> Group:
    """A :class:`Group` over ``ranks``. Every rank of the world must call
    this for every group, in the same order (``torch.distributed``'s rule)."""
    ranks = list(ranks)
    pg = dist.new_group(ranks) if len(ranks) > 1 else None
    return Group(ranks, pg, me)


def world_group() -> Group:
    joined = dist.is_available() and dist.is_initialized()
    return Group(range(world_size()), dist.group.WORLD if joined else None, rank())


# ----------------------------------------------------------------- staging


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (gloo's side of a collective)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _staged(group: Group, t: torch.Tensor) -> bool:
    return group.staged and t.is_cuda


# ------------------------------------------------------------- collectives


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``t`` over ``group``, a new tensor on
    ``t``'s device, the same on every rank."""
    if group.local:
        return t.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _staged(group, t):
        buf = _host(t)
        dist.all_reduce(buf, op=red, group=group.pg)
        return buf.to(t.device)
    out = t.clone()
    dist.all_reduce(out, op=red, group=group.pg)
    return out


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in place (the gradient buffer)."""
    if group.local:
        return t
    if _staged(group, t):
        buf = _host(t)
        dist.all_reduce(buf, group=group.pg)
        t.copy_(buf)
        return t
    dist.all_reduce(t, group=group.pg)
    return t


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group order."""
    if group.local:
        return t
    t = t.contiguous()
    if group.backend == "gloo":  # the list form; a CUDA tensor through host memory
        src = _host(t) if t.is_cuda else t
        parts = [torch.empty_like(src) for _ in range(group.size)]
        dist.all_gather(parts, src, group=group.pg)
        return torch.cat(parts, dim=dim).to(t.device)
    out = torch.empty((group.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group.pg)
    return torch.cat(out.unbind(0), dim=dim)


def broadcast_(t: torch.Tensor, group: Group, src_index: int = 0) -> torch.Tensor:
    """``t`` from the group's rank ``src_index``, in place."""
    if group.local:
        return t
    src = group.ranks[src_index]
    if _staged(group, t):
        buf = _host(t)
        dist.broadcast(buf, src, group=group.pg)
        t.copy_(buf)
        return t
    dist.broadcast(t, src, group=group.pg)
    return t


def all_to_all_bytes(pieces: List[Optional[torch.Tensor]], recv_sizes: Sequence[int],
                     group: Group, device) -> List[torch.Tensor]:
    """All-to-all of uneven byte blocks: ``pieces[i]`` (a contiguous tensor
    or None: nothing) goes to the group's rank i, and the block of
    ``recv_sizes[j]`` bytes that rank j sends here comes back as a uint8
    tensor, in group order. Tensors travel as their bytes, so any type
    does (bool, bfloat16, int8: the device cache)."""
    flat = [torch.zeros(0, dtype=torch.uint8, device=device) if p is None
            else p.contiguous().reshape(-1).view(torch.uint8) for p in pieces]
    send_sizes = [int(f.numel()) for f in flat]
    if group.local:
        return flat
    src = torch.cat(flat)
    out = torch.empty(int(sum(recv_sizes)), dtype=torch.uint8, device=device)
    if _staged(group, out):
        hs, ho = _host(src), torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        dist.all_to_all_single(ho, hs, list(recv_sizes), send_sizes, group=group.pg)
        out.copy_(ho)
    else:
        dist.all_to_all_single(out, src, list(recv_sizes), send_sizes, group=group.pg)
    return list(out.split(list(recv_sizes)))


def ring_shift(tensors: Sequence[torch.Tensor], group: Group,
               step: int = 1) -> List[torch.Tensor]:
    """Each tensor sent to the group rank ``index + step`` and received from
    ``index - step`` (``lax.ppermute`` around the ring), as new tensors, by
    one ``batch_isend_irecv``."""
    if group.local:
        return list(tensors)
    dst = group.ranks[(group.index + step) % group.size]
    src = group.ranks[(group.index - step) % group.size]
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        staged = _staged(group, t)
        send = _host(t) if staged else t
        recv = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged
                else torch.empty_like(t))
        ops.append(dist.P2POp(dist.isend, send, dst, group=group.pg))
        ops.append(dist.P2POp(dist.irecv, recv, src, group=group.pg))
        outs.append((recv, t.device, staged))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(dev) if staged else r for r, dev, staged in outs]


def barrier(group: Group) -> None:
    if not group.local:
        dist.barrier(group=group.pg)


def broadcast_object(obj, group: Group, src_index: int = 0):
    """A picklable object from the group's rank ``src_index`` (a
    checkpoint's path)."""
    if group.local:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, group.ranks[src_index], group=group.pg)
    return box[0]


def broadcast_request(header, arrays, group: Group, src_index: int = 0):
    """A request from the group's rank ``src_index`` to every rank: a small
    picklable ``header`` by :func:`broadcast_object` (with the arrays'
    shapes), then the float32 ``arrays`` (numpy) as one flat buffer by
    :func:`broadcast_` (on the CPU under gloo, on this rank's card under
    NCCL). The other ranks pass anything for ``header`` and ``arrays``.
    Returns ``(header, arrays)`` on every rank, the arrays as float32 numpy
    arrays."""
    import numpy as np

    if group.local:
        return header, [np.asarray(a, np.float32) for a in arrays]
    src = group.index == src_index
    if src:
        arrays = [np.ascontiguousarray(a, np.float32) for a in arrays]
    header, shapes = broadcast_object(
        (header, [a.shape for a in arrays]) if src else None, group, src_index)
    sizes = [int(np.prod(s)) for s in shapes]
    device = "cpu" if group.backend == "gloo" else torch.device("cuda",
                                                                torch.cuda.current_device())
    if src:
        flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays])
                                if arrays else np.zeros(0, np.float32)).to(device)
    else:
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    if flat.numel():
        broadcast_(flat, group, src_index)
    parts = np.split(flat.cpu().numpy(), np.cumsum(sizes)[:-1]) if sizes else []
    return header, [p.reshape(s) for p, s in zip(parts, shapes)]


# ---------------------------------------------------------------- autograd


class AllReduceSum(torch.autograd.Function):
    """y = the sum of x over ``group`` (the same y on every rank). Backward:
    the all-reduce sum of the incoming gradients: each rank that holds the
    replicated y back-propagates its share of the loss, and the sum of the
    shares is the gradient of the whole (the adjoint of sum-then-replicate)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class AllGather(torch.autograd.Function):
    """y = every rank's x concatenated along ``dim`` (the same y on every
    rank). Backward: the all-reduce sum of the incoming gradients, then this
    rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.contiguous(), ctx.group)
        return total.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n), None, None


def sum_over(x: torch.Tensor, group: Group) -> torch.Tensor:
    """:class:`AllReduceSum` (the identity for a group of one rank)."""
    return x if group.local else AllReduceSum.apply(x, group)


def gather_over(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """:class:`AllGather` (the identity for a group of one rank)."""
    return x if group.local else AllGather.apply(x, group, dim)


def max_over(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise maximum over ``group``, without a gradient (a
    softmax's shift)."""
    return x.detach() if group.local else all_reduce(x.detach(), group, "max")
