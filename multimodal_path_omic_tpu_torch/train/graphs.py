"""CUDA graphs over the train and eval steps: the port's counterpart of
``jax.jit`` over a step (``multimodal_path_omic_tpu/train/loop.py``).

A step on the card is a few hundred kernel launches from Python; at the
shipped shapes the host takes longer to issue them than the card to run
them. :class:`StepGraphs` records each step once as a CUDA graph and then
replays it: one launch for the whole step.

* One graph per key: the caller's step kind plus the shapes and types of the
  step's tensor inputs (a bucket's batch shapes are static), plus whatever
  the caller adds (the device cache a cached step reads). The first call
  with a key runs the step eagerly on the graphs' side stream (the warm-up:
  lazy initialisation, the kernels' one-time attribute calls and the
  optimizer's state happen there, and its result is the call's result), then
  captures it; every later call copies its inputs into the graph's static
  input buffers and replays.
* Every graph of one :class:`StepGraphs` shares one memory pool
  (``torch.cuda.graph_pool_handle()``). Graphs replay one at a time on the
  current stream, and each replay's outputs are cloned before the call
  returns, so no graph reads what another one's replay overwrote.
* The dropout generators a step draws from are registered with its graph
  (``CUDAGraph.register_generator_state``): each replay advances their
  Philox offsets by what the step draws, so replays and eager steps draw the
  same bits in the same order.
* Capture runs the step's Python once, so the kernel wrappers count their
  launches then; those counts are taken back, and every replay adds them
  again: ``LAUNCH_COUNTS`` count launches, not captures.
* A capture that fails raises. Nothing falls back to the eager step.

A graph holds raw pointers: the parameters, the optimizer's state, its lr
tensor and the caller's constant tensors must stay where they were at
capture. :meth:`StepGraphs.reset` drops every graph (after an optimizer's
``load_state_dict``, which replaces its state tensors).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree


def launch_counts() -> Tuple[Dict[str, int], ...]:
    """Every kernel wrapper's ``LAUNCH_COUNTS`` table."""
    from multimodal_path_omic_tpu_torch.ops import coattn, flash, gather, milpool

    return coattn.LAUNCH_COUNTS, flash.LAUNCH_COUNTS, gather.LAUNCH_COUNTS, milpool.LAUNCH_COUNTS


def _snapshot() -> List[Dict[str, int]]:
    return [dict(t) for t in launch_counts()]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so devices compare by index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _signature(leaves: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


class _Graph:
    def __init__(self, graph, static_in, static_out, launches, keep):
        self.graph = graph
        self.static_in = static_in  # flat list of input buffers
        self.static_out = static_out  # the captured step's output tree
        self.launches = launches  # [(table, name, count)] recorded at capture
        self.keep = keep  # the objects whose tensors the graph points at


class StepGraphs:
    """The CUDA graphs of a set of steps on one device, in one memory pool.

    ``run(key, fn, inputs, generators=(), keep=())`` returns ``fn(inputs)``:
    ``inputs`` is a tree (dicts, lists, tuples) of CUDA tensors, ``fn`` a
    function of such a tree returning a tree of tensors (or None leaves).
    ``generators`` are the ``torch.Generator`` objects ``fn`` draws from;
    ``keep`` are objects the graph must keep alive (the optimizer, the
    device cache), which also become part of the key."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = _indexed(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None
        self._stream = None

    def __len__(self) -> int:
        return len(self._graphs)

    def reset(self) -> None:
        """Drop every graph (their pool memory returns to the allocator once
        the last graph of the pool is gone)."""
        self._graphs.clear()

    def run(self, key: Hashable, fn: Callable[[Any], Any], inputs: Any,
            generators: Sequence[torch.Generator] = (), keep: Sequence[Any] = ()) -> Any:
        leaves, spec = pytree.tree_flatten(inputs)
        for t in leaves:
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                raise TypeError(f"a graphed step takes tensors on {self.device} only, got "
                                f"{type(t).__name__}"
                                + (f" on {t.device}" if isinstance(t, torch.Tensor) else ""))
        full_key = (key, str(spec), _signature(leaves), tuple(id(k) for k in keep),
                    tuple(id(g) for g in generators))
        entry = self._graphs.get(full_key)
        if entry is None:
            return self._first_call(full_key, fn, leaves, spec, generators, keep)
        with torch.no_grad():
            for dst, src in zip(entry.static_in, leaves):
                dst.copy_(src, non_blocking=True)
        entry.graph.replay()
        for table, name, count in entry.launches:
            table[name] += count
        with torch.no_grad():
            return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                   entry.static_out)

    def _first_call(self, full_key, fn, leaves, spec, generators, keep):
        """Warm up (the call's result) on the side stream, then capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        with torch.no_grad():
            static_in = [torch.empty_like(t) for t in leaves]
            for dst, src in zip(static_in, leaves):
                dst.copy_(src)
        inputs = pytree.tree_unflatten(static_in, spec)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = fn(inputs)
        current.wait_stream(self._stream)
        # what the warm-up returns was made on the side stream, and is read on
        # the current one
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(current)

        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = _snapshot()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                static_out = fn(inputs)
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of the step {full_key[0]!r} failed: {exc}") \
                from exc
        finally:
            after = _snapshot()
            for table, old in zip(launch_counts(), before):
                table.update(old)  # the capture launched nothing
        launches = [(table, name, after[i][name] - old[name])
                    for i, (table, old) in enumerate(zip(launch_counts(), before))
                    for name in old if after[i][name] != old[name]]
        self._graphs[full_key] = _Graph(graph, static_in, static_out, launches,
                                        (tuple(keep), tuple(generators)))
        return out


def resolve(graphs, device) -> "StepGraphs | None":
    """The :class:`StepGraphs` a step built with ``graphs=`` uses on
    ``device``: None (eager) on the CPU or with ``graphs=False``; a given
    :class:`StepGraphs` as it is (it must be on ``device``); True: a new one."""
    device = torch.device(device)
    if graphs is False or device.type != "cuda":
        return None
    if isinstance(graphs, StepGraphs):
        if graphs.device != _indexed(device):
            raise ValueError(f"the StepGraphs are on {graphs.device}, the step on {device}")
        return graphs
    if graphs is not True:
        raise TypeError(f"graphs must be True, False or a StepGraphs, got {graphs!r}")
    return StepGraphs(device)
