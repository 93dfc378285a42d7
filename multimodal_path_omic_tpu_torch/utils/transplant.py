"""Reference PyTorch checkpoints: the reference's state-dict names onto the
port's (``multimodal_path_omic_tpu/utils/transplant.py``, the port's own
rules).

A user of the reference brings ``.pt`` checkpoints saved as
``{'epoch', 'model_state_dict', 'optimizer_state_dict', 'loss'}``
(reference: models/mcat/main.py:95-100). The reference is torch, like the
port, so every tensor is taken in its own layout (Linear ``[out, in]``, the
packed ``in_proj_weight`` ``[3E, E]``, ``nn.Bilinear`` ``[out, in1, in2]``),
with two exceptions that follow the port's own layout:

* the reference's per-signature SNN blocks ``G.<i>.0.0`` / ``G.<i>.1.0`` go,
  transposed, into rows ``:s_i`` of slot ``i`` of the port's fused omic
  stack (``G.fc1_kernel [n, max_s, d1]`` ..., zero-padded rows kept);
* the reference's path and omic branches (``path_transformer`` /
  ``omic_transformer``, ``path_attention_head`` + ``path_rho`` / ...) go to
  slot 0 and slot 1 of ``branch_transformer`` / ``branch_pool``.

A ``module.`` prefix (DataParallel) is stripped. A rule whose key the state
dict lacks, and a state-dict key no rule reads, each warn, as in JAX; the
parameter then keeps the model's current value. ``gated_concat`` gates never
appear in reference state dicts (the reference keeps them in a plain list,
fusion.py:25-27), so they keep the model's init.
"""

from __future__ import annotations

import pickle
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

# (reference key, port key, omic-stack slot or None)
Rule = Tuple[str, str, Optional[int]]


def _linear(ref: str, port: str) -> List[Rule]:
    return [(f"{ref}.weight", f"{port}.weight", None), (f"{ref}.bias", f"{port}.bias", None)]


def _mha(ref: str, port: str) -> List[Rule]:
    return [(f"{ref}.in_proj_weight", f"{port}.in_proj_weight", None),
            (f"{ref}.in_proj_bias", f"{port}.in_proj_bias", None),
            *_linear(f"{ref}.out_proj", f"{port}.out_proj")]


def _transformer(ref: str, port: str, num_layers: int = 2) -> List[Rule]:
    rules: List[Rule] = []
    for layer in range(num_layers):
        r, p = f"{ref}.layers.{layer}", f"{port}.layers.{layer}"
        rules += _mha(f"{r}.self_attn", f"{p}.self_attn")
        for name in ("linear1", "linear2", "norm1", "norm2"):
            rules += _linear(f"{r}.{name}", f"{p}.{name}")
    return rules


def _mil_pool(head: str, rho: str, port: str) -> List[Rule]:
    return [*_linear(f"{head}.attention_a.0", f"{port}.attention_head.attention_a"),
            *_linear(f"{head}.attention_b.0", f"{port}.attention_head.attention_b"),
            *_linear(f"{head}.attention_c", f"{port}.attention_head.attention_c"),
            *_linear(f"{rho}.0", f"{port}.rho")]


def _cag(ref: str, port: str) -> List[Rule]:
    return [*_linear(f"{ref}.fc1.0", f"{port}.fc1"), *_linear(f"{ref}.fc2.0", f"{port}.fc2"),
            *_linear(f"{ref}.fc3.0", f"{port}.fc3"), *_linear(f"{ref}.G.1", f"{port}.ln_g"),
            *_linear(f"{ref}.E.1", f"{port}.ln_e"), *_linear(f"{ref}.fc_c.0", f"{port}.fc_c")]


def _fusion(fusion: str) -> List[Rule]:
    if fusion in ("concat", "gated_concat"):  # the gates are absent from reference dicts
        return [*_linear("fusion_layer.fusion_layer.0", "fusion_layer.fc1"),
                *_linear("fusion_layer.fusion_layer.2", "fusion_layer.fc2")]
    if fusion == "bilinear":
        rules: List[Rule] = []
        for i in (1, 2):
            rules += _linear(f"fusion_layer.linear_h{i}.0", f"fusion_layer.linear_h{i}")
            rules += _linear(f"fusion_layer.linear_z{i}", f"fusion_layer.linear_z{i}")
            rules += _linear(f"fusion_layer.linear_o{i}.0", f"fusion_layer.linear_o{i}")
        return rules + _linear("fusion_layer.fc1.0", "fusion_layer.fc1") \
            + _linear("fusion_layer.fc2.0", "fusion_layer.fc2")
    raise ValueError(f"unknown fusion {fusion!r}")


def transplant_rules(model: str, n_signatures: int = 6, fusion: str = "concat") -> List[Rule]:
    """The (reference key, port key, slot) rules of ``model`` ("mcat",
    "nacagat" or "ge_nacagat"; the config's spellings are normalized).
    ``slot`` i marks a SNN block that goes, transposed, into rows ``:s_i``
    of slot i of the fused omic stack."""
    key = model.lower().replace("-", "_").replace(" ", "")
    rules = _linear("H.0", "H.fc")
    if key in ("mcat", "nacagat"):
        for i in range(n_signatures):
            rules += [(f"G.{i}.0.0.weight", "G.fc1_kernel", i),
                      (f"G.{i}.0.0.bias", "G.fc1_bias", i),
                      (f"G.{i}.1.0.weight", "G.fc2_kernel", i),
                      (f"G.{i}.1.0.bias", "G.fc2_bias", i)]
        if key == "mcat":
            rules += _mha("co_attention", "co_attention")
        else:
            rules += _mha("co_attention", "co_attention.mha")
            rules += _cag("co_attention.CAG", "co_attention.cag")
        for slot, branch in ((0, "path"), (1, "omic")):
            rules += _transformer(f"{branch}_transformer", f"branch_transformer.{slot}")
            rules += _mil_pool(f"{branch}_attention_head", f"{branch}_rho",
                               f"branch_pool.{slot}")
        rules += _fusion(fusion)
    elif key in ("ge_nacagat", "genacagat", "geneexpr_nacagat", "geneexprnacagat"):
        rules += _mha("self_attention", "self_attention")
        rules += _transformer("path_transformer", "path_transformer")
        rules += _mil_pool("path_attention_head", "path_rho", "path_pool")
    else:
        raise ValueError(f"unknown model {model!r}")
    return rules + _linear("classifier", "classifier")


def from_torch_state_dict(model: str, state_dict: Dict[str, Any],
                          init_state: Dict[str, torch.Tensor], n_signatures: int = 6,
                          fusion: str = "concat") -> Dict[str, torch.Tensor]:
    """A port state dict: ``init_state`` (the model's own, e.g.
    ``model.state_dict()``) with every entry a rule finds in the reference
    ``state_dict`` replaced (shapes checked). ``init_state`` is not
    modified."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
          for k, v in state_dict.items()}
    out = {k: v.detach().clone() for k, v in init_state.items()}
    matched = set()
    for ref_key, port_key, slot in transplant_rules(model, n_signatures, fusion):
        if ref_key not in sd:
            warnings.warn(f"transplant: {ref_key} missing from state_dict")
            continue
        value = sd[ref_key].detach().to(torch.float32)
        target = out[port_key]
        if slot is not None:  # a SNN block into its rows of the fused stack
            value = value.t() if value.ndim == 2 else value
            rows = target[slot, :value.shape[0]]
            if value.ndim == 2:
                rows = rows[:, :value.shape[1]]
            if rows.shape != value.shape:
                raise ValueError(f"shape mismatch for {ref_key} -> {port_key}[{slot}]: "
                                 f"{tuple(rows.shape)} vs {tuple(value.shape)}")
            rows.copy_(value)
        else:
            if target.shape != value.shape:
                raise ValueError(f"shape mismatch for {ref_key} -> {port_key}: "
                                 f"{tuple(target.shape)} vs {tuple(value.shape)}")
            out[port_key] = value.to(target.dtype).clone()
        matched.add(ref_key)
    unmatched = set(sd) - matched
    if unmatched:
        warnings.warn(f"transplant: unused torch keys: {sorted(unmatched)[:8]}...")
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference ``.pt`` checkpoint onto the CPU: the payload dict
    {'epoch', 'model_state_dict', 'optimizer_state_dict', 'loss'}
    (reference: mcat/main.py:95-100). It is read with ``weights_only=True``
    (tensors, containers and plain Python values, as the reference saves
    them): a payload holding any other pickled object is refused before it
    can run code, and there is no retry without that guard."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(
            f"{path}: refused by torch.load(weights_only=True): the payload holds "
            "objects other than tensors, containers and plain values; a reference "
            "checkpoint holds only those") from exc
