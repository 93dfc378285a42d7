"""The flash kernels' bfloat16 plain versions (``ops/flash.py``), which the
bfloat16 instances of ``csrc/flash.cu`` and ``csrc/flash_bwd.cu`` are held
to on the card, against the JAX package on the CPU:

* (a) JAX's library TPU flash kernel itself (the kernel
  ``multimodal_path_omic_tpu/ops/flash.py`` hands GE's self-attention to),
  run in TPU interpret mode on bfloat16 q, k, v with the mask as segment
  ids, 128-key blocks at L = 256: o, dq, dk, dv within one bfloat16 unit
  in the last place at each tensor's largest magnitude, m and l (float32)
  within 1e-5. The
  plain version follows the TPU kernel's key blocks (``key_tile=128``): p is
  rounded against the running maximum of the blocks seen so far. The two
  packages disagree on pad queries (segment ids let a pad query attend the
  pad keys; the port's pad query attends the valid keys), so o is compared
  on valid rows and the cotangent is 0 on pad rows, where both then give
  exactly no gradient.
* (b) The JAX package's CPU dispatch (``ops/coattn.py::fused_attention`` in
  bfloat16, which takes ``attention_core``): output and gradients within
  twice the distance between that dispatch in bfloat16 and in float32 on
  the same values (a witness, as ``test_torch_port_bf16.py`` sets its bars).
* (c) The plain versions' own rules: the backward against autograd through
  the forward (straight-through roundings), both near float32's gradients,
  query chunking, and the key tiles p is rounded against.
* (d) The route: GE's self-attentions take the flash route under bfloat16
  (``test_torch_port_dispatch.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.experimental.pallas.ops.tpu import flash_attention as fa  # noqa: E402

from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import flash  # noqa: E402

BF16 = torch.bfloat16
L, BLOCK = 256, 128
STAT_TOL = 1e-5  # m absolute, l relative: float32 sums in other orders (measured <= 1e-6)
# o, dq, dk, dv against the TPU kernel: one bfloat16 unit at the tensor's
# largest magnitude (2^-8 of it). Element by element an output can sit a few
# units off where its sum cancels (measured up to 5 in o): a p or ds that
# rounds to the other neighbour on one side (XLA's exp and torch's differ in
# the last float32 bits) moves it by 2^-8 of one term.
TOP_TOL = 2.0 ** -8
WITNESS_SHARE = 2.0


def _round(x: np.ndarray) -> np.ndarray:
    """float32 values of ``x`` rounded to bfloat16."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _inputs(b, heads, width, lengths, seed):
    """GE's scale (chip_smoke.py ``ge_flash_inputs``), bfloat16 values held in
    float32: q of std 1.5, k and v of std 1; a cotangent that is 0 on pad
    rows; the mask (None without ``lengths``)."""
    rng = np.random.default_rng(seed)
    shape = (b, heads, L, width)
    q = _round(1.5 * rng.standard_normal(shape))
    k, v = (_round(rng.standard_normal(shape)) for _ in range(2))
    mask = None if lengths is None else np.arange(L)[None] < np.asarray(lengths)[:, None]
    dout = rng.standard_normal(shape)
    if mask is not None:
        dout = dout * mask[:, None, :, None]
    return q, k, v, mask, _round(dout)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _ulps(got, ref) -> float:
    """The largest |got - ref| in units of the last place of ref's bfloat16
    value (a zero ref counts its neighbour 1e-6)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), 1e-6)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(got - ref) / ulp).max())


def _of_top(got, ref) -> float:
    """The largest |got - ref| over ref's largest magnitude."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _tpu_kernel(q, k, v, mask, dout, sm_scale):
    """JAX's library TPU kernel in interpret mode: (o, l, m, dq, dk, dv)."""
    sizes = fa.BlockSizes(**{f: BLOCK for f in (
        "block_q", "block_k_major", "block_k", "block_q_major_dkv", "block_k_major_dkv",
        "block_k_dkv", "block_q_dkv", "block_k_major_dq", "block_k_dq", "block_q_dq")},
        block_b=1)
    seg = None
    if mask is not None:
        ids = jnp.asarray(mask.astype(np.int32))
        seg = fa.SegmentIds(q=ids, kv=ids)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: fa.flash_attention(
            a, b, c, segment_ids=seg, sm_scale=sm_scale, block_sizes=sizes), jq, jk, jv)
        grads = vjp(jdo)
        _, l, m = fa._flash_attention_impl(jq, jk, jv, None, seg, True, False, sm_scale, 1,
                                           BLOCK, BLOCK, BLOCK, False)
    as_np = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    l, m = (as_np(x).reshape(q.shape[:3] + (-1,))[..., 0] for x in (l, m))
    return (as_np(o), l, m, *(as_np(g) for g in grads))


TPU_CASES = [(32, None), (32, (200, 100)), (64, None), (64, (256, 77))]


@pytest.mark.parametrize("width,lengths", TPU_CASES,
                         ids=[f"d{w}-{'masked' if n else 'nomask'}" for w, n in TPU_CASES])
def test_bf16_plain_matches_the_tpu_kernel(width, lengths):
    """(a) bf16 plain forward and backward against the library TPU kernel
    in interpret mode (two heads; masked: one bag with a masked tail in its
    second block, one whose second block has no valid key)."""
    b = 1 if lengths is None else len(lengths)
    q, k, v, mask, dout = _inputs(b, 2, width, lengths, width + b)
    scale = width ** -0.5
    o_j, l_j, m_j, *grads_j = _tpu_kernel(q, k, v, mask, dout, scale)
    tq, tk, tv, tmask, tdo = (_t(x) for x in (q, k, v, mask, dout))
    tq, tk, tv, tdo = (x.to(BF16) for x in (tq, tk, tv, tdo))
    o, m, l = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True, key_tile=BLOCK)
    grads = flash.flash_attention_bwd_plain(tq, tk, tv, tmask, o, m, l, tdo)
    assert o.dtype == BF16 and m.dtype == l.dtype == torch.float32
    rows = np.ones(q.shape[:3], bool) if mask is None else np.broadcast_to(
        mask[:, None, :], q.shape[:3])
    readings = {"o": _of_top(o.float().numpy()[rows], o_j[rows]),
                "o_units": _ulps(o.float().numpy()[rows], o_j[rows]),
                "m": float(np.abs(m.numpy() - m_j)[rows].max()),
                "l": float((np.abs(l.numpy() - l_j) / l_j)[rows].max())}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, grads_j):
        assert got.dtype == BF16
        readings[name] = _of_top(got.float().numpy(), ref)
    print({k_: f"{v_:.3g}" for k_, v_ in readings.items()})
    assert max(readings[n] for n in ("o", "dq", "dk", "dv")) <= TOP_TOL, readings
    assert readings["m"] <= STAT_TOL and readings["l"] <= STAT_TOL, readings


@pytest.mark.parametrize("heads,width", [(1, 256), (8, 32)])
def test_bf16_plain_matches_the_jax_dispatch(heads, width):
    """(b) GE medium's two widths against ``jcoattn.fused_attention`` (the
    JAX package's CPU route for the same call) in bfloat16: output on valid
    rows and dq, dk, dv each within twice the largest distance between that
    dispatch in bfloat16 and in float32."""
    q, k, v, mask, dout = _inputs(2, heads, width, (256, 150), width)
    jmask = jnp.asarray(mask)

    def jax_run(dtype):
        args = [jnp.asarray(x, dtype) for x in (q, k, v)]
        out, vjp = jax.vjp(lambda a, b, c: jcoattn.fused_attention(a, b, c, jmask), *args)
        return [np.asarray(jnp.asarray(x, jnp.float32))
                for x in (out, *vjp(jnp.asarray(dout, dtype)))]

    ref, f32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    tq, tk, tv, tdo = (_t(x).to(BF16) for x in (q, k, v, dout))
    o, m, l = flash.flash_attention_plain(tq, tk, tv, _t(mask), return_stats=True)
    got = [o] + list(flash.flash_attention_bwd_plain(tq, tk, tv, _t(mask), o, m, l, tdo))
    rows = np.broadcast_to(mask[:, None, :, None], q.shape)
    for name, g, r, w in zip(("o", "dq", "dk", "dv"), got, ref, f32):
        g = g.float().numpy()
        if name == "o":
            g, r, w = (np.where(rows, x, 0.0) for x in (g, r, w))
        err, witness = float(np.abs(g - r).max()), float(np.abs(w - r).max())
        print(f"{name}: {err:.3e} against JAX's bf16-vs-f32 distance {witness:.3e}")
        assert err <= WITNESS_SHARE * witness, (name, err, witness)


ST_GRAD_RTOL = 2e-2  # of each tensor's largest magnitude (chip_smoke.py BF16_GRAD_RTOL)


@pytest.mark.parametrize("heads,width", [(1, 128), (8, 16)])
def test_bf16_plain_gradients_and_chunks(heads, width):
    """(c) The bf16 backward against autograd through the bf16 forward (its
    roundings pass the gradient straight through; the backward also rounds
    ds, which autograd does not): dq, dk, dv within 2e-2 of each one's
    largest magnitude, and both within 2e-2 of the float32 gradients on the
    same values. Query chunks of 48 rows change o by at most one bfloat16
    unit (the float32 products may take other kernels), m and l by 1e-6,
    and the backward by one unit at each tensor's largest magnitude (dk and
    dv sum the chunks in another order)."""
    q, k, v, mask, dout = _inputs(2, heads, width, (256, 170), width + 3)
    tmask = _t(mask)
    tq, tk, tv, tdo = (_t(x).to(BF16) for x in (q, k, v, dout))
    o, m, l = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True)
    grads = flash.flash_attention_bwd_plain(tq, tk, tv, tmask, o, m, l, tdo)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    flash.flash_attention_plain(*leaves, tmask).float().backward(tdo.float())
    f32 = [x.float().requires_grad_(True) for x in (tq, tk, tv)]
    flash.flash_attention_plain(*f32, tmask).backward(tdo.float())
    for name, g, a, f in zip(("dq", "dk", "dv"), grads, leaves, f32):
        g, a, f = g.float(), a.grad.float(), f.grad
        top = float(f.abs().max())
        print(f"{name}: backward vs autograd {float((g - a).abs().max()) / top:.3e}, "
              f"vs float32 {float((g - f).abs().max()) / top:.3e} of the largest")
        assert float((g - a).abs().max()) <= ST_GRAD_RTOL * float(a.abs().max()), name
        assert float((g - f).abs().max()) <= ST_GRAD_RTOL * top, name
    o2, m2, l2 = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True, chunk=48)
    assert _ulps(o2.float().numpy(), o.float().numpy()) <= 1.0
    assert torch.allclose(m2, m, rtol=1e-6, atol=0) and torch.allclose(l2, l, rtol=1e-6, atol=0)
    for g2, g in zip(flash.flash_attention_bwd_plain(tq, tk, tv, tmask, o, m, l, tdo, chunk=48),
                     grads):
        assert _of_top(g2.float().numpy(), g.float().numpy()) <= TOP_TOL


def test_bf16_plain_rounds_where_the_kernels_do():
    """p is rounded against the running maximum of the key tiles seen so far,
    as the kernels do (``KEY_TILE``, the kernel's tiles by width): one
    tile gives the untiled function bit for bit; other tiles move o by at
    most two bfloat16 units of its largest magnitude. Float32 ignores the
    tiles. A
    bag without a valid key gives the mean of v over its keys, rounded once
    (to one unit: the float32 sums take another order)."""
    q, k, v, mask, _ = _inputs(2, 1, 256, (200, 0), 11)
    tq, tk, tv = (_t(x).to(BF16) for x in (q, k, v))
    tmask = _t(mask)
    one = flash.flash_attention_plain(tq, tk, tv, tmask, key_tile=L)
    assert torch.equal(flash.flash_attention_plain(tq, tk, tv, tmask, key_tile=2 * L), one)
    tiled = flash.flash_attention_plain(tq, tk, tv, tmask)  # the kernel's 64-key tiles
    assert flash.KEY_TILE[256] == 64 and not torch.equal(tiled, one)
    assert _of_top(tiled.float().numpy(), one.float().numpy()) <= 2.0 ** -7
    f32 = [x.float() for x in (tq, tk, tv)]
    assert torch.equal(flash.flash_attention_plain(*f32, tmask, key_tile=16),
                       flash.flash_attention_plain(*f32, tmask))
    mean = tv[1].float().mean(dim=1, keepdim=True).expand(1, L, 256)
    assert _ulps(tiled[1].float().numpy(), mean.to(BF16).float().numpy()) <= 1.0
