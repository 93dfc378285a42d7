"""Late-fusion heads (``multimodal_path_omic_tpu/ops/fusion.py``); inputs
are batched ``[B, dim_i]`` vectors. Every head takes ``generator=`` (the
dropout bits of :class:`BilinearFusion` in training mode; the others have no
dropout site). Each head computes in its ``compute_dtype`` (``ops/layers.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_path_omic_tpu_torch.ops.layers import FastDropout, TorchLinear, cast


class ConcatFusion(nn.Module):
    """Concat -> Linear-ReLU-Linear-ReLU."""

    def __init__(self, in_size: int, hidden_size: int = 256, output_size: int = 256):
        super().__init__()
        self.fc1 = TorchLinear(in_size, hidden_size)
        self.fc2 = TorchLinear(hidden_size, output_size)

    def forward(self, *x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self.fc1(torch.cat(x, dim=-1)))
        return F.relu(self.fc2(h))


class _ZeroGrad(torch.autograd.Function):
    """The identity forward, a zero gradient backward (JAX's
    ``stop_gradient``): the parameter gets a zero gradient, not None, so an
    optimizer still applies its weight decay to it, as optax does."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


class GatedConcatFusion(nn.Module):
    """Per-input scalar sigmoid gates, then the concat MLP.

    The gates are registered parameters (``gate_<i>``, trained). Under
    ``bug_compat`` they are the reference's unregistered gates: applied at
    their random init and never trained (``gate_<i>_kernel`` [dim_i, 1] and
    ``gate_<i>_bias`` [1], the JAX package's names and layout, behind a
    zero-gradient identity), while gradients flow through the inputs."""

    def __init__(self, in_dims: Sequence[int], hidden_size: int = 256,
                 output_size: int = 256, bug_compat: bool = False):
        super().__init__()
        self.in_dims = tuple(int(d) for d in in_dims)
        self.bug_compat = bool(bug_compat)
        for i, d in enumerate(self.in_dims):
            if self.bug_compat:
                bound = 1.0 / math.sqrt(d)
                self.register_parameter(
                    f"gate_{i}_kernel", nn.Parameter(torch.empty(d, 1).uniform_(-bound, bound)))
                self.register_parameter(
                    f"gate_{i}_bias", nn.Parameter(torch.empty(1).uniform_(-bound, bound)))
            else:
                setattr(self, f"gate_{i}", TorchLinear(d, 1))
        self.fc1 = TorchLinear(sum(self.in_dims), hidden_size)
        self.fc2 = TorchLinear(hidden_size, output_size)

    def forward(self, *x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gated = []
        for i, item in enumerate(x):
            if self.bug_compat:
                kernel = _ZeroGrad.apply(getattr(self, f"gate_{i}_kernel"))
                bias = _ZeroGrad.apply(getattr(self, f"gate_{i}_bias"))
                g = torch.sigmoid(cast(item, self) @ cast(kernel, self) + cast(bias, self))
            else:
                g = torch.sigmoid(getattr(self, f"gate_{i}")(item))
            gated.append(item * g)
        h = F.relu(self.fc1(torch.cat(gated, dim=-1)))
        return F.relu(self.fc2(h))


class Bilinear(nn.Module):
    """``nn.Bilinear``: y_k = x1^T A_k x2 + b_k, A [out, in1, in2], weight and
    bias U(-k, k) with k = 1/sqrt(in1)."""

    def __init__(self, in1: int, in2: int, features: int):
        super().__init__()
        k = 1.0 / math.sqrt(in1)
        self.weight = nn.Parameter(torch.empty(features, in1, in2).uniform_(-k, k))
        self.bias = nn.Parameter(torch.empty(features).uniform_(-k, k))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...i,kij,...j->...k", cast(x1, self), cast(self.weight, self),
                            cast(x2, self)) + cast(self.bias, self)


def _normal_linear(in_size: int, out_size: int) -> TorchLinear:
    """A Linear with init_max_weights: weight N(0, 1/sqrt(fan_in)), bias 0."""
    lin = TorchLinear(in_size, out_size)
    with torch.no_grad():
        lin.weight.normal_(0.0, 1.0 / math.sqrt(in_size))
        lin.bias.zero_()
    return lin


class BilinearFusion(nn.Module):
    """Gated bilinear Kronecker fusion of two inputs.

    Per modality: h_i = ReLU(W x_i); z_i = Bilinear(x_i, x_other);
    o_i = Dropout(ReLU(W(sigmoid(z_i) * h_i))). Then a ones column appended to
    each o_i, their outer (Kronecker) product flattened, Dropout, Linear-ReLU,
    Dropout, the skip concat of o1, o2, Linear-ReLU, Dropout: five dropout
    sites, in the JAX package's order. Linear weights N(0, 1/sqrt(fan_in)),
    biases 0."""

    def __init__(self, in_dims: Sequence[int], hidden_size: int = 32,
                 output_size: int = 64, mm_hidden_size: int = 64,
                 use_skip_connection: bool = True, use_bilinear: bool = True,
                 use_gates: bool = True, dropout_rate: float = 0.25):
        super().__init__()
        if len(in_dims) != 2:
            raise RuntimeError("Bilinear fusion is possible only on 2 inputs")
        d1, d2 = (int(d) for d in in_dims)
        h = hidden_size
        self.use_skip_connection = use_skip_connection
        self.use_bilinear = use_bilinear
        self.use_gates = use_gates
        if use_gates:
            self.linear_h1 = _normal_linear(d1, h)
            self.linear_z1 = Bilinear(d1, d2, h) if use_bilinear else _normal_linear(d1 + d2, h)
        self.linear_o1 = _normal_linear(h if use_gates else d1, h)
        if use_gates:
            self.linear_h2 = _normal_linear(d2, h)
            self.linear_z2 = Bilinear(d2, d1, h) if use_bilinear else _normal_linear(d1 + d2, h)
        self.linear_o2 = _normal_linear(h if use_gates else d2, h)
        self.fc1 = _normal_linear((h + 1) ** 2, mm_hidden_size)
        skip = 2 * (h + 1) if use_skip_connection else 0
        self.fc2 = _normal_linear(mm_hidden_size + skip, output_size)
        self.drops = nn.ModuleList(FastDropout(dropout_rate) for _ in range(5))

    def _branch(self, i: int, x, other, generator):
        """o_i of modality ``i`` (1 or 2), through dropout site i - 1."""
        if self.use_gates:
            h = F.relu(getattr(self, f"linear_h{i}")(x))
            z_lin = getattr(self, f"linear_z{i}")
            z = z_lin(x, other) if self.use_bilinear else z_lin(torch.cat([x, other], dim=-1))
            x = torch.sigmoid(z) * h
        return self.drops[i - 1](F.relu(getattr(self, f"linear_o{i}")(x)), generator)

    def forward(self, *x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if len(x) != 2:
            raise RuntimeError("Bilinear fusion is possible only on 2 inputs")
        x1, x2 = x
        o1 = self._branch(1, x1, x2, generator)
        o2 = self._branch(2, x2, x1, generator)
        ones = torch.ones(o1.shape[:-1] + (1,), dtype=o1.dtype, device=o1.device)
        o1p, o2p = torch.cat([o1, ones], dim=-1), torch.cat([o2, ones], dim=-1)
        out = torch.einsum("...i,...j->...ij", o1p, o2p).flatten(-2)
        out = self.drops[2](out, generator)
        out = self.drops[3](F.relu(self.fc1(out)), generator)
        if self.use_skip_connection:
            out = torch.cat([out, o1p, o2p], dim=-1)
        return self.drops[4](F.relu(self.fc2(out)), generator)


def make_fusion(kind: str, in_dims: Sequence[int], hidden: int, output: int,
                bug_compat: bool = False) -> nn.Module:
    """Fusion factory (the JAX package's ``make_fusion``): ``in_dims`` are
    the widths of the fused inputs. ``bilinear`` keeps its own hidden widths
    (32, mm 64) and dropout rate (0.25), as the JAX factory does."""
    if kind == "concat":
        return ConcatFusion(sum(in_dims), hidden, output)
    if kind == "gated_concat":
        return GatedConcatFusion(in_dims, hidden, output, bug_compat=bug_compat)
    if kind == "bilinear":
        return BilinearFusion(in_dims, output_size=output)
    raise RuntimeError(f"Fusion mechanism {kind} not implemented")
