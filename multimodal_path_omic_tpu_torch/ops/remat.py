"""``tpu.remat``: the backward recomputes the large patch-axis activations
instead of keeping them (JAX ``train/loop.py:349``: ``jax.checkpoint`` with
``save_anything_except_these_names("remat_big")``).

JAX tags the WSI encoder's ``fc`` output and its post-dropout ``h``
(``ops/blocks.py:184-190``) and the attention's q / k / v projections
(``ops/attention.py:251-268``); every other residual is saved as usual.
Here ``h`` and the projections are tagged (:func:`tag`) inside a
:func:`scope` that the training step opens around its forward; the ``fc``
output is saved by nothing (its ReLU keeps only its sign,
:class:`ReluSavingSign`). ``torch.utils.checkpoint`` over the producing
modules would not do: a region's output is still saved by the operations
that consume it (the co-attention kernels save their ``kv``), so the saving
is intercepted where it happens, with the hooks ``checkpoint`` itself is
built on. The scope's
``torch.autograd.graph.saved_tensors_hooks`` keep, in place of a tagged
tensor (or a view of one) that an operation saves for its backward, a
recipe that recomputes it from the tensors it was computed from, once, when
the backward first unpacks it. A recipe reaches a tagged input through that
input's own recipe, so no tagged tensor is held. The untagged residuals
are saved as they are: the per-patch dropout mask (bool), the raw input.

Dropout under recompute: the port draws its masks from explicit
generators (``ops/layers.py``), which ``torch.utils.checkpoint``'s
``preserve_rng_state`` would not restore. No recipe draws: the WSI
encoder's keep mask is drawn once, in the forward, and the recipe reuses
it, so the recomputed ``h`` is the forward's bit for bit and the generator
ends where a step without remat leaves it. The co-attention kernels'
Philox masks are keyed by a seed tensor the forward drew, and their
backward regenerates them as it does without remat.

Nothing is captured here that a CUDA graph cannot replay: a recipe runs
device operations only, inside the backward of the same step.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Optional

import torch

_STATE = threading.local()


def active() -> bool:
    """Whether a :func:`scope` is open on this thread (tagging is inert
    outside one)."""
    return getattr(_STATE, "scope", None) is not None


class _Recompute:
    """A tagged tensor's recipe, and its value once recomputed."""

    __slots__ = ("fn", "args", "value")

    def __init__(self, fn: Callable, args):
        self.fn, self.args, self.value = fn, args, None

    def get(self) -> torch.Tensor:
        if self.value is None:
            args = [a.get() if isinstance(a, _Recompute) else a for a in self.args]
            with torch.no_grad():
                self.value = self.fn(*args)
            self.args = None
        return self.value


class _Saved:
    """What the autograd graph keeps for a tagged tensor, or a view of one."""

    __slots__ = ("recompute", "view")

    def __init__(self, recompute: _Recompute, view=None):
        self.recompute, self.view = recompute, view

    def unpack(self) -> torch.Tensor:
        base = self.recompute.get()
        if self.view is None:
            return base
        size, stride, offset = self.view
        return base.as_strided(size, stride, base.storage_offset() + offset)


class _Scope:
    def __init__(self):
        self.tagged = {}  # id(tensor) -> (weakref to it, its _Recompute)

    def find(self, t: torch.Tensor) -> Optional[_Recompute]:
        entry = self.tagged.get(id(t))
        return entry[1] if entry is not None and entry[0]() is t else None

    def pack(self, t: torch.Tensor):
        rc = self.find(t)
        if rc is not None:
            return _Saved(rc)
        base = t._base
        if base is not None:
            rc = self.find(base)
            if rc is not None:
                return _Saved(rc, (tuple(t.size()), tuple(t.stride()),
                                   t.storage_offset() - base.storage_offset()))
        return t


def _unpack(x):
    return x.unpack() if isinstance(x, _Saved) else x


@contextlib.contextmanager
def scope(enabled: bool = True):
    """Tag and drop the 'remat_big' tensors of the forward run inside (a
    no-op unless ``enabled``). Open it around a training forward; the
    backward may run after it closed."""
    if not enabled:
        yield
        return
    outer = getattr(_STATE, "scope", None)
    sc = _STATE.scope = _Scope()
    try:
        with torch.autograd.graph.saved_tensors_hooks(sc.pack, _unpack):
            yield
    finally:
        _STATE.scope = outer


def tag(t: torch.Tensor, fn: Callable, *args) -> torch.Tensor:
    """Mark ``t == fn(*args)`` (bit for bit, without drawing from a
    generator) as recomputed in the backward rather than saved; an argument
    that is tagged itself is reached through its recipe. Returns ``t``."""
    sc = getattr(_STATE, "scope", None)
    if sc is None or not t.requires_grad:
        return t
    resolved = tuple(sc.find(a) or a if isinstance(a, torch.Tensor) else a for a in args)
    sc.tagged[id(t)] = (weakref.ref(t), _Recompute(fn, resolved))
    return t


class ReluSavingSign(torch.autograd.Function):
    """``relu`` that saves where its input is positive (a bool tensor), not
    its float output: under remat nothing of the WSI encoder's [B, M, d]
    activations stays saved. The gradient is ``relu``'s, bit for bit (the
    output is positive exactly where the input is)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x > 0)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, grad):
        (positive,) = ctx.saved_tensors
        return torch.where(positive, grad, torch.zeros_like(grad))
