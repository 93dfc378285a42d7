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
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


class OptimizerSpec(NamedTuple):
    name: str
    lr: float
    weight_decay: float = 0.0
    grad_clip: float = 0.0

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        """The torch optimizer (and its state) over ``params``."""
        params, lr, wd = list(params), self.lr, self.weight_decay
        if self.name == "sgd":
            return torch.optim.SGD(params, lr=lr)
        if self.name == "adadelta":
            return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6, weight_decay=wd)
        if self.name == "adamax":
            return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=wd)
        if self.name == "rms":
            return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8, weight_decay=wd)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)

    def update(self, optimizer: torch.optim.Optimizer) -> None:
        """One step from the parameters' ``.grad``, clipped first."""
        if self.grad_clip > 0.0:
            grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
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
    """Set the learning rate of every parameter group, keeping the state."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
