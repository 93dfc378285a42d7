"""Layer utilities with the JAX package's semantics
(``multimodal_path_omic_tpu/ops/layers.py``).

Dropout draws its bits from a ``torch.Generator`` the caller passes in (the
trainer owns one); the bits cannot match JAX's generator, only the keep rule
and the formulas do.

Compute dtype: every module of the port reads its ``compute_dtype``
attribute (None: float32, the default), set on a whole model by
:func:`set_compute_dtype` (``models.build_model(..., dtype=)``), as the JAX
modules carry ``dtype``. Parameters stay float32; each is cast to the
compute dtype where it is used (:func:`cast`), so its gradient comes back in
float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# Large-negative (finite) masking constant, as in the JAX package: -inf would
# turn fully-masked softmax rows into NaN; here they come out uniform.
NEG_INF = -1e9


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values rounded to bfloat16 and kept in float32, the gradient
    passed straight through: the bfloat16 kernels' roundings (k, tanh(q),
    tanh(k) in the co-attention kernels; p and ds in the flash kernels),
    whose backward uses the rounded values and no rounding of the
    cotangent."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Set ``compute_dtype`` on ``module`` and every submodule (None or
    float32: float32; bfloat16). Returns ``module``."""
    dtype = None if dtype in (None, torch.float32) else dtype
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    for m in module.modules():
        m.compute_dtype = dtype
    return module


def compute_dtype_of(module: nn.Module) -> torch.dtype:
    """A module's compute dtype (float32 unless set)."""
    return getattr(module, "compute_dtype", None) or torch.float32


def cast(x: Optional[torch.Tensor], module: nn.Module) -> Optional[torch.Tensor]:
    """``x`` in ``module``'s compute dtype (the JAX modules'
    ``x.astype(self.dtype)``; a no-op when it already is)."""
    return None if x is None else x.to(compute_dtype_of(module))


def quantize_cols_int8(w: torch.Tensor):
    """Symmetric per-column int8 quantization of an [F, E] kernel: one scale
    per output feature (the contraction axis F is reduced, so the scales
    factor out of the product exactly). -> (q int8 [F, E], scale float32 [E])."""
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def int_mm_supports(rows: int, f: int, e: int) -> bool:
    """The shapes ``torch._int_mm`` takes on the card: more than 16 rows,
    and the inner (F) and outer (E) widths multiples of 8."""
    return rows > 16 and f > 0 and f % 8 == 0 and e % 8 == 0


class W8A8Linear(torch.autograd.Function):
    """First-layer Linear on int8 activations (JAX ``w8a8_linear``).

    ``q`` [..., F] int8 per-row-quantized activations with ``row_scale``
    [...] (the device cache's format, ``data/quant.py``), ``weight`` [E, F]
    (torch layout) and ``bias`` [E] float. The forward quantizes the kernel
    per column and runs ``s8 x s8 -> s32`` (``torch._int_mm``), dequantizing
    after the product: y = (q @ qk) * (row_scale x col_scale) + bias, in
    ``dtype``. A plain product, as the JAX package computes it outside
    Pallas (``lax.dot_general``). On the card a shape ``_int_mm`` refuses
    (:func:`int_mm_supports`) raises; it is never quietly dequantized.

    Backward: the input is data, so it gets no gradient; dW =
    dequant(q)^T dy and db = sum(dy), straight through the kernel's own
    quantization (as if the float kernel had been used)."""

    @staticmethod
    def forward(ctx, q, row_scale, weight, bias, dtype):
        f, e = q.shape[-1], weight.shape[0]
        q2 = q.reshape(-1, f)
        if q.device.type == "cuda" and not int_mm_supports(q2.shape[0], f, e):
            raise ValueError(f"w8a8_linear: torch._int_mm takes more than 16 rows and F, E "
                             f"multiples of 8; got {q2.shape[0]} rows, F={f}, E={e}")
        qk, col_scale = quantize_cols_int8(weight.float().t())
        # mat2 column-major (the weight's own [E, F] rows), as cuBLASLt's
        # int8 products take it
        acc = torch._int_mm(q2.contiguous(), qk.t().contiguous().t())
        y = acc.float() * (row_scale.reshape(-1, 1).float() * col_scale)
        y = y.to(dtype) + bias.to(dtype)
        ctx.save_for_backward(q, row_scale)
        ctx.dtype = dtype
        return y.reshape(*q.shape[:-1], e)

    @staticmethod
    def backward(ctx, dy):
        q, row_scale = ctx.saved_tensors
        x2 = (q.to(ctx.dtype) * row_scale[..., None].to(ctx.dtype)).reshape(-1, q.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        dw = torch.matmul(dy2.t().float(), x2.float())  # [E, F], float32 accumulation
        db = dy2.float().sum(dim=0)
        return None, None, dw, db, None


def w8a8_linear(q: torch.Tensor, row_scale: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:class:`W8A8Linear` (``dtype`` None: float32)."""
    return W8A8Linear.apply(q, row_scale, weight, bias, dtype or torch.float32)


class TorchLinear(nn.Linear):
    """``nn.Linear`` with torch's default init, computing in the module's
    ``compute_dtype`` (input, weight and bias cast where used).

    The weight keeps torch's ``[out, in]`` layout; the JAX package's flax
    kernels are ``[in, out]``, so the weight bridge (``utils/weights.py``)
    transposes them. ``row_scale`` with an int8 ``x``: the int8 route
    (:func:`w8a8_linear`), the [..., F] float activation never formed.
    """

    def forward(self, x: torch.Tensor, row_scale: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        dt = compute_dtype_of(self)
        if row_scale is not None and x.dtype == torch.int8:
            bias = self.bias if self.bias is not None else torch.zeros(
                self.out_features, device=x.device)
            return w8a8_linear(x, row_scale, self.weight, bias, dt)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in float32 and returning the module's
    compute dtype (flax's ``LayerNorm(dtype=)``: statistics in float32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype_of(self)
        if dt == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(dt)


class ShardedDraws:
    """The dropout generator of one rank of a mesh (``parallel/mesh.py``):
    every draw is made at the global batch's shape and this rank's slice is
    kept, rows by its data position and, where the site names its patch
    axis (``seq_dim``), patches by its seq position. Every rank then draws
    the masks a one-device step draws for the same rows and patches, and
    the generators of all ranks stay in step (JAX gets this from GSPMD:
    a partitioned draw is the global draw's slice). ``generator``: the
    wrapped ``torch.Generator``; ``mesh``: the rank's mesh."""

    def __init__(self, generator: torch.Generator, mesh):
        self.generator = generator
        self.mesh = mesh

    def draw(self, fn, shape, seq_dim: Optional[int] = None) -> torch.Tensor:
        """``fn(global_shape, generator)``'s slice for this rank."""
        m = self.mesh
        shape = list(shape)
        glob = list(shape)
        glob[0] *= m.data
        if seq_dim is not None:
            glob[seq_dim] *= m.seq
        out = fn(tuple(glob), self.generator)
        out = out.narrow(0, m.d * shape[0], shape[0])
        if seq_dim is not None:
            out = out.narrow(seq_dim, m.s * shape[seq_dim], shape[seq_dim])
        return out


def draw(generator, fn, shape, seq_dim: Optional[int] = None) -> torch.Tensor:
    """``fn(shape, torch_generator)``; for :class:`ShardedDraws`, the slice
    of the global draw (``seq_dim``: the patch axis, split over a seq axis)."""
    if isinstance(generator, ShardedDraws):
        return generator.draw(fn, shape, seq_dim)
    return fn(tuple(shape), require_generator(generator))


def fast_keep_mask(generator: torch.Generator, rate: float, shape, device,
                   seq_dim: Optional[int] = None):
    """Dropout keep mask by a uint16 threshold: (keep [bool], keep_prob).

    keep iff a 16-bit draw is >= thresh = round(rate * 65536), so
    keep_prob = 1 - thresh / 65536 exactly (the rate itself for multiples of
    1/65536, 0.25 included). A rate that rounds to 1 drops everything and
    returns keep_prob 1.0, so that 1 / keep_prob stays finite. Draws come
    from ``generator`` (on ``device``'s type), never from a global RNG; a
    :class:`ShardedDraws` draws the global mask and keeps this rank's slice
    (``seq_dim``: the axis that holds the sharded patches, if any).
    """
    thresh = int(round(float(rate) * 65536.0))
    if thresh >= 65536:
        return torch.zeros(shape, dtype=torch.bool, device=device), 1.0
    bits = draw(generator, lambda s, g: torch.randint(0, 65536, s, generator=g, device=device,
                                                      dtype=torch.int32), shape, seq_dim)
    return bits >= thresh, 1.0 - thresh / 65536.0


def require_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The ``torch.Generator`` a dropout draw uses (a :class:`ShardedDraws`'
    own); None raises (no global RNG)."""
    if generator is None:
        raise ValueError("training-mode dropout draws from an explicit torch.Generator: "
                         "pass generator=")
    if isinstance(generator, ShardedDraws):
        return generator.generator
    return generator


def set_mesh(module: nn.Module, mesh) -> nn.Module:
    """Set ``mesh`` on ``module`` and every submodule: the modules that run
    over the patch axis carry the mesh, as the JAX modules carry
    ``ring_mesh`` (their routes and their dropout sites' patch axis read
    it). Returns ``module``."""
    for m in module.modules():
        m.mesh = mesh
    return module


def seq_sharded(module: nn.Module) -> bool:
    """Whether ``module`` runs over a patch axis split over a seq mesh axis."""
    mesh = getattr(module, "mesh", None)
    return mesh is not None and mesh.seq > 1


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], seq_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout with the uint16-threshold keep mask:
    ``where(keep, x / keep_prob, 0)``; the identity at rate 0."""
    if rate == 0.0:
        return x
    kw = {} if seq_dim is None else {"seq_dim": seq_dim}
    keep, keep_prob = fast_keep_mask(generator, rate, x.shape, x.device, **kw)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class FastDropout(nn.Module):
    """:func:`dropout` in training mode, the identity in eval mode. On a
    module tree whose patch axis is split over a seq mesh axis
    (:func:`set_mesh`), the mask is the global one's slice along dim 1 too,
    unless ``over_patches`` is False (a site after the patch axis is pooled
    away)."""

    mesh = None

    def __init__(self, rate: float, over_patches: bool = True):
        super().__init__()
        self.rate = float(rate)
        self.over_patches = over_patches

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, generator,
                       1 if self.over_patches and seq_sharded(self) else None)

    def keep_mask(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        """The (keep, keep_prob) that :meth:`forward` draws for ``x``, or
        None where it is the identity (eval mode, rate 0); :meth:`apply`
        then gives its output (``ops/remat.py`` reuses the draw)."""
        if not self.training or self.rate == 0.0:
            return None
        kw = {"seq_dim": 1} if self.over_patches and seq_sharded(self) else {}
        return fast_keep_mask(generator, self.rate, x.shape, x.device, **kw)

    @staticmethod
    def apply(x: torch.Tensor, drawn) -> torch.Tensor:
        """:func:`dropout` of ``x`` with the :meth:`keep_mask` draw ``drawn``."""
        if drawn is None:
            return x
        keep, keep_prob = drawn
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class AlphaDropout(FastDropout):
    """SELU-preserving alpha dropout with torch's formula: dropped units take
    alpha' = -1.7580993408473766, and the output is corrected affinely,
    ``a * where(keep, x, alpha') + b`` with
    a = ((1 - p)(1 + p alpha'^2))^-1/2, b = -a alpha' p, p the effective rate."""

    ALPHA_PRIME = -1.7580993408473766

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep, keep_prob = fast_keep_mask(generator, self.rate, x.shape, x.device)
        p = 1.0 - keep_prob
        a = ((1.0 - p) * (1.0 + p * self.ALPHA_PRIME ** 2)) ** -0.5
        b = -a * self.ALPHA_PRIME * p
        return a * torch.where(keep, x, torch.full_like(x, self.ALPHA_PRIME)) + b


def masked_softmax(
    scores: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1
) -> torch.Tensor:
    """Softmax with a boolean validity mask broadcast over ``scores``.

    mask True = valid. Fully-masked rows yield a uniform distribution over
    the masked entries (finite fill value), never NaN.
    """
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=dim)
