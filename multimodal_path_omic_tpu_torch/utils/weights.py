"""Weights for the port's models: the bridge from the JAX package's
parameter trees, and a seeded random init.

The JAX tree is taken as nested dicts of numpy arrays, exactly as
``model.init(...)["params"]`` gives it after ``np.asarray`` (the name map of
``multimodal_path_omic_tpu/utils/transplant.py`` documents every name). The
port mirrors those names, so the bridge is a handful of rules:

* flax ``kernel [in, out]`` -> torch ``weight [out, in]`` (transposed);
  LayerNorm ``scale`` -> ``weight``;
* the packed in-projection ``in_proj_kernel [E, 3E]`` -> ``in_proj_weight
  [3E, E]`` (transposed; q, k, v stay in the same column blocks);
* the fused omic stack (``G.fc1_kernel [n, max_s, d1]`` ...) keeps its
  layout, zero-padded rows included;
* ``branch_transformer`` / ``branch_pool`` leaves carry a leading stacked
  axis of 2 (the vmapped branch pair): slot i goes to ``<name>.<i>``, and a
  flax ``layer_<j>`` is the port's ``layers.<j>``.

MCAT's tree has NaCAGaT's names with a plain ``co_attention``
(``in_proj_kernel``, ``in_proj_bias``, ``out_proj``) in place of the
pre-gated one (``co_attention.mha`` / ``co_attention.cag``); the same rules
carry it. GE-NaCAGaT's tree (``H``, ``self_attention``, ``path_transformer``,
``path_pool``, ``classifier``) has no stacked axis and needs only the first
two rules and ``layer_<j>``. Loading is strict: a tree of another model
(unknown or missing names) raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_path_omic_tpu_torch.ops.attention import MultiheadAttention
from multimodal_path_omic_tpu_torch.ops.blocks import OmicEncoderStack

STACKED = ("branch_transformer", "branch_pool")


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def _port_name(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    parts = []
    for p in path[:-1]:
        if p.startswith("layer_") and p[6:].isdigit():
            parts += ["layers", p[6:]]
        else:
            parts.append(p)
    leaf = path[-1]
    if leaf in ("kernel", "in_proj_kernel"):
        leaf, value = leaf.replace("kernel", "weight"), value.T
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(parts + [leaf]), value


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX MCAT, NaCAGaT or GE-NaCAGaT parameter tree onto the port's
    state_dict names."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        if path[0] in STACKED:
            for slot in range(value.shape[0]):
                name, v = _port_name((path[0], str(slot)) + path[1:], value[slot])
                state[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
        else:
            name, v = _port_name(path, value)
            state[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return state


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a JAX parameter tree into ``model`` (strict: every port
    parameter is covered and every JAX leaf lands somewhere)."""
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, with
    the JAX package's init distributions: torch-Linear U(+-1/sqrt(fan_in)),
    xavier over the packed in-projection with zero in/out biases, LayerNorm
    ones/zeros, per-signature blocks (padded rows zero) in the omic stack.
    Drawn on the CPU, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(int(seed))

    def uniform(t: torch.Tensor, bound: float) -> None:
        t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            uniform(mod.weight, bound)
            uniform(mod.bias, bound)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, MultiheadAttention):
            uniform(mod.in_proj_weight, math.sqrt(6.0 / (4 * mod.embed_dim)))
            mod.in_proj_bias.zero_()
        elif isinstance(mod, OmicEncoderStack):
            mod.fc1_kernel.zero_()
            for i, s in enumerate(mod.sizes):
                uniform(mod.fc1_kernel[i, :s], 1.0 / math.sqrt(s))
                uniform(mod.fc1_bias[i], 1.0 / math.sqrt(s))
            dim1 = mod.fc2_kernel.shape[1]
            uniform(mod.fc2_kernel, 1.0 / math.sqrt(dim1))
            uniform(mod.fc2_bias, 1.0 / math.sqrt(dim1))
    for mod in model.modules():  # torch MHA zero-inits the out-projection bias
        if isinstance(mod, MultiheadAttention):
            mod.out_proj.bias.zero_()
    return model
