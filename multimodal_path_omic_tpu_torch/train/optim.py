"""Optimizer factory (``multimodal_path_omic_tpu/train/optim.py``) on
``torch.optim``.

``make_optimizer(name, lr, weight_decay, grad_clip)`` returns an
:class:`OptimizerSpec`, the counterpart of the optax transformation: it holds
no state; ``init(params)`` builds the ``torch.optim`` optimizer (the
counterpart of optax's ``opt_state``) and ``update`` clips and steps it.

* ``sgd``      -> SGD(lr), no weight decay (as the reference's sgd branch)
* ``adadelta`` -> Adadelta(lr, rho 0.9, eps 1e-6)
* ``adamax``   -> Adamax(lr, betas (0.9, 0.999), eps 1e-8)
* ``adam``     -> Adam(lr, betas (0.9, 0.999), eps 1e-8); also the fallback
                  for unknown names, as in the reference
* ``rms``      -> RMSprop(lr, alpha 0.99, eps 1e-8)

Weight decay is L2 added to the gradient (torch's ``weight_decay``, which is
optax's ``add_decayed_weights`` chained before the update), not decoupled.
``grad_clip`` > 0 scales the gradients by clip / max(global norm, clip)
before the step, and so before the decay is added (optax's
``clip_by_global_norm``; torch's ``clip_grad_norm_`` would add 1e-6 to the
norm). Where torch and optax place an epsilon differently (Adamax adds it
inside the running max, RMSprop outside the square root) the updates differ
in the last digits; SGD and Adam match optax's.

The learning rate lives in the optimizer's parameter groups: the epoch
loop sets it (:func:`set_lr`, with :func:`schedule_lr`'s epoch-indexed
value) or steps it (:func:`step_exponential`) without touching the state.

On a CUDA device the optimizer is built so that a CUDA graph can capture its
step (``train/graphs.py``) and the eager step runs the same arithmetic:
every group's lr is a 0-dim float32 tensor on the device, which
:func:`set_lr` writes in place, so a graph's next replay reads the new value
(a Python float would be frozen into the graph); Adam, Adamax, RMSprop and
Adadelta take ``capturable=True`` (their step counts on the device); SGD,
whose torch step reads a tensor lr on the host, updates ``p -= lr * g`` with
device-side products (:meth:`OptimizerSpec.update`). On the CPU the lr is a
Python float and nothing of this applies.
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple

import torch


class OptimizerSpec(NamedTuple):
    name: str
    lr: float
    weight_decay: float = 0.0
    grad_clip: float = 0.0

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        """The torch optimizer (and its state) over ``params``; on a CUDA
        device in its capturable form (see the module doc)."""
        params, wd = list(params), self.weight_decay
        cuda = bool(params) and params[0].device.type == "cuda"
        lr = torch.tensor(self.lr, device=params[0].device) if cuda else self.lr
        kw = {"capturable": True} if cuda else {}
        if self.name == "sgd":
            return torch.optim.SGD(params, lr=lr)
        if self.name == "adadelta":
            return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6, weight_decay=wd, **kw)
        if self.name == "adamax":
            return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=wd, **kw)
        if self.name == "rms":
            return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8, weight_decay=wd,
                                       **kw)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
                                **kw)

    def update(self, optimizer: torch.optim.Optimizer) -> None:
        """One step from the parameters' ``.grad``, clipped first."""
        if self.grad_clip > 0.0:
            grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        if self.name == "sgd" and isinstance(optimizer.param_groups[0]["lr"], torch.Tensor):
            with torch.no_grad():
                for group in optimizer.param_groups:
                    params = [p for p in group["params"] if p.grad is not None]
                    torch._foreach_add_(params, torch._foreach_mul(
                        [p.grad for p in params], -group["lr"]))
            return
        optimizer.step()


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> OptimizerSpec:
    """The optimizer named as in the reference's config (see module doc)."""
    return OptimizerSpec((name or "adam").lower(), float(lr), float(weight_decay or 0.0),
                         float(grad_clip or 0.0))


def current_lr(optimizer: torch.optim.Optimizer) -> float:
    """The learning rate in use (``optimizer.param_groups[0]['lr']``)."""
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group, keeping the state; a
    tensor lr (the capturable form) is written in place."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = lr
    return optimizer


def load_state(optimizer: torch.optim.Optimizer, state: dict) -> torch.optim.Optimizer:
    """``optimizer.load_state_dict(state)`` keeping the optimizer's own
    device form: a state saved on the card (tensor lr, ``capturable``) loads
    into a CPU optimizer and one saved on the CPU into a card optimizer; the
    lr's value is the saved one."""
    own = [(g["lr"], g.get("capturable")) for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (lr, capturable) in zip(optimizer.param_groups, own):
        value = float(group["lr"])
        group["lr"] = lr
        if capturable is not None:
            group["capturable"] = capturable
        for p in group["params"]:
            step = optimizer.state.get(p, {}).get("step")
            if isinstance(step, torch.Tensor):  # capturable: on the device; else on the host
                optimizer.state[p]["step"] = step.to("cpu" if not capturable else p.device)
    set_lr(optimizer, value)
    return optimizer


def step_exponential(optimizer: torch.optim.Optimizer, gamma: float) -> torch.optim.Optimizer:
    """Per-epoch ExponentialLR step: lr *= gamma (mcat/main.py:84)."""
    return set_lr(optimizer, current_lr(optimizer) * gamma)


def schedule_lr(name, base_lr: float, epoch: int, *, gamma: float = 1.0,
                total_epochs: int = 0, warmup_epochs: int = 0, min_lr: float = 0.0,
                step_size: int = 10) -> float:
    """Absolute lr for 0-based ``epoch`` under the epoch-indexed schedules:

    * ``cosine``: torch CosineAnnealingLR shape, a half cosine from base_lr
      to ``min_lr`` over the run after warmup, clamped at min_lr after;
    * ``step``: torch StepLR, lr = base * gamma^(epoch // step_size);
    * ``exp``: base * gamma^epoch (the reference's ExponentialLR);
    * linear warmup (``warmup_epochs``): epochs 0..W-1 ramp
      (e+1)/W * base_lr, under any schedule (None included).

    Epoch-indexed, so a resumed run lands on the lr a straight-through run
    would use at that epoch."""
    if warmup_epochs and epoch < warmup_epochs:
        return base_lr * (epoch + 1) / warmup_epochs
    e = epoch - warmup_epochs
    if name == "cosine":
        horizon = max(1, total_epochs - warmup_epochs - 1)
        t = min(e, horizon)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t / horizon))
    if name == "step":
        return base_lr * gamma ** (e // max(1, step_size))
    if name == "exp":
        return base_lr * gamma**e
    return base_lr
