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


# ---------------------------------------------------------------------------
# The bfloat16 kernels on Hopper's warpgroup MMA (csrc/flash.cu,
# csrc/flash_bwd.cu): the plain version's tiles are the forward kernel's, and
# the arithmetic of the warpgroup splits matches the plain versions.
# ---------------------------------------------------------------------------

import os  # noqa: E402
import re  # noqa: E402

WIDTHS = (16, 32, 64, 128, 256, 512)
# o within two bfloat16 units of its largest magnitude across key tilings: p
# is rounded against the running maximum of the tiles seen so far, so two
# tilings may round a p to the two neighbours (the bound of
# test_bf16_plain_rounds_where_the_kernels_do)
TILING_TOL = 2.0 ** -7


def _kernel_key_tiles():
    """{width: keys a tile} from the bfloat16 forward's instance table."""
    src = os.path.join(os.path.dirname(flash.__file__), os.pardir, "csrc", "flash.cu")
    with open(src) as fh:
        text = fh.read()
    table = text[text.index("int mpo_flash_fwd_bf16("):]
    return {int(w): int(bc) for w, bc in
            re.findall(r"case (\d+): return MPO_FWD_WG\(\1, (\d+),", table)}


def test_key_tile_follows_the_bf16_forward_kernel():
    """``flash.KEY_TILE`` (where the plain version rounds p) is the bfloat16
    forward kernel's keys a tile at every width."""
    assert _kernel_key_tiles() == flash.KEY_TILE
    assert sorted(flash.KEY_TILE) == list(WIDTHS)


@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_plain_at_the_kernel_tiles(width):
    """At the kernel's tiles (``KEY_TILE``) the plain forward stays within two
    bfloat16 units of o's largest magnitude of JAX's library TPU kernel in
    interpret mode (128-key blocks) on valid rows, and of the untiled
    function; m and l at the untiled function's within 1e-5 (they do not
    depend on the tiles)."""
    lengths = (256, 141)
    q, k, v, mask, dout = _inputs(len(lengths), 1, width, lengths, 7 * width)
    o_j, *_ = _tpu_kernel(q, k, v, mask, dout, width ** -0.5)
    tq, tk, tv = (_t(x).to(BF16) for x in (q, k, v))
    tmask = _t(mask)
    tiled, m, l = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True)
    one, m1, l1 = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True, key_tile=L)
    rows = np.broadcast_to(mask[:, None, :], q.shape[:3])
    readings = {"tpu": _of_top(tiled.float().numpy()[rows], o_j[rows]),
                "untiled": _of_top(tiled.float().numpy(), one.float().numpy())}
    print(flash.KEY_TILE[width], readings)
    assert max(readings.values()) <= TILING_TOL, readings
    assert torch.allclose(m, m1, rtol=0, atol=STAT_TOL)
    assert torch.allclose(l, l1, rtol=STAT_TOL, atol=0)


def _split_forward(q, k, v, mask, tile, halves):
    """The width-512 forward's arithmetic (float32 from bfloat16 values):
    per key tile the scores as the sum of ``halves`` depth-slice products,
    added in order, times the scale; the online softmax with p rounded to
    bfloat16 against the running maximum; O as ``halves`` column slices. (o,
    m, l) as the kernel writes them."""
    n, d = q.shape[2], q.shape[3]
    scale = d ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    sl = [slice(i * d // halves, (i + 1) * d // halves) for i in range(halves)]
    o = [torch.zeros(q.shape[:3] + (d // halves,)) for _ in sl]
    m = torch.full(q.shape[:3], -3.0e38)
    l = torch.zeros(q.shape[:3])
    for c0 in range(0, n, tile):
        keys = slice(c0, min(c0 + tile, n))
        s = torch.matmul(q[..., sl[0]], k[:, :, keys, sl[0]].transpose(-1, -2))
        for h in sl[1:]:
            s = s + torch.matmul(q[..., h], k[:, :, keys, h].transpose(-1, -2))
        s = torch.where(mask[:, None, None, keys], s * scale, torch.full_like(s, -1e9))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        pr = p.to(BF16).float()
        o = [oh * alpha[..., None] + torch.matmul(pr, v[:, :, keys, h]) for oh, h in zip(o, sl)]
    return (torch.cat(o, dim=-1) / l[..., None]).to(BF16), m, l


def test_split_forward_at_512_matches_the_plain_version():
    """Width 512 (two warpgroups on 64 query rows, S over two depth halves
    summed in a fixed order, O in two column halves) against the plain
    version at the kernel's 32-key tiles: o within one bfloat16 unit of its
    terms' magnitude (the card's bar), m and l within 1e-5."""
    lengths = (256, 141)
    q, k, v, mask, _ = _inputs(len(lengths), 1, 512, lengths, 51)
    tq, tk, tv = (_t(x).to(BF16) for x in (q, k, v))
    tmask = _t(mask)
    o, m, l = _split_forward(tq, tk, tv, tmask, flash.KEY_TILE[512], 2)
    ref, ref_m, ref_l = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True)
    terms = flash.flash_attention_plain(tq, tk, tv.abs(), tmask).float()
    excess = float(((o.float() - ref.float()).abs() / (2.0 ** -7 * terms)).max())
    print(f"o at {excess:.3f} of one unit of its terms")
    assert excess <= 1.0
    assert torch.allclose(m, ref_m, rtol=0, atol=STAT_TOL)
    assert torch.allclose(l, ref_l, rtol=STAT_TOL, atol=0)


def _split_dkv(q, k, v, mask, m, l, dout, tile, halves):
    """The width-256 dkv pass's arithmetic: per query tile, S^T (one
    warpgroup) and dP^T (the other) over the whole depth, p^T and ds^T from
    them in both, dv and dk summed in ``halves`` column slices. (dk, dv)."""
    n, d = q.shape[2], q.shape[3]
    scale = d ** -0.5
    q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
    out = flash.flash_attention_plain(*(t.to(BF16) for t in (q, k, v)), mask).float()
    delta = (dout * out).sum(-1)
    sl = [slice(i * d // halves, (i + 1) * d // halves) for i in range(halves)]
    dk = [torch.zeros(k.shape[:3] + (d // halves,)) for _ in sl]
    dv = [torch.zeros(k.shape[:3] + (d // halves,)) for _ in sl]
    valid = mask[:, None, :, None]  # the keys are the rows
    for c0 in range(0, n, tile):
        qs = slice(c0, min(c0 + tile, n))
        st = torch.matmul(k, q[:, :, qs].transpose(-1, -2))  # [B, H, keys, queries]
        dpt = torch.matmul(v, dout[:, :, qs].transpose(-1, -2))
        st = torch.where(valid, st * scale, torch.full_like(st, -1e9))
        pt = torch.exp(st - m[:, :, None, qs]) * (1.0 / l[:, :, None, qs])
        dst = torch.where(valid, pt * (dpt - delta[:, :, None, qs]), torch.zeros_like(pt))
        pr, dsr = pt.to(BF16).float(), (dst * scale).to(BF16).float()
        dv = [a + torch.matmul(pr, dout[:, :, qs, h]) for a, h in zip(dv, sl)]
        dk = [a + torch.matmul(dsr, q[:, :, qs, h]) for a, h in zip(dk, sl)]
    return torch.cat(dk, dim=-1).to(BF16), torch.cat(dv, dim=-1).to(BF16)


def test_split_dkv_at_256_matches_the_plain_version():
    """Width 256's dkv pass (two warpgroups on 64 keys trading S^T and dP^T,
    dk and dv in two column halves, 32-query tiles) against the plain
    backward: dk and dv within 2e-2 of each one's largest magnitude (the
    card's bar), dk exactly 0 at masked keys."""
    lengths = (256, 141)
    q, k, v, mask, dout = _inputs(len(lengths), 1, 256, lengths, 52)
    tq, tk, tv, tdo = (_t(x).to(BF16) for x in (q, k, v, dout))
    tmask = _t(mask)
    o, m, l = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True)
    _, ref_dk, ref_dv = flash.flash_attention_bwd_plain(tq, tk, tv, tmask, o, m, l, tdo)
    dk, dv = _split_dkv(tq, tk, tv, tmask, m, l, tdo, 32, 2)
    for name, got, ref in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        err = _of_top(got.float().numpy(), ref.float().numpy())
        print(f"{name}: {err:.3e} of the largest")
        assert err <= ST_GRAD_RTOL, name
    assert float(dk[~tmask[:, None, :, None].expand_as(dk)].float().abs().max()) == 0.0


def _split_dq(q, k, v, mask, m, l, dout, tile, halves):
    """The width-512 dq pass's arithmetic: per key tile, S and dP as the sums
    of ``halves`` depth-slice products added in order, p and ds from them,
    dq summed in ``halves`` column slices. dq."""
    n, d = q.shape[2], q.shape[3]
    scale = d ** -0.5
    q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
    out = flash.flash_attention_plain(*(t.to(BF16) for t in (q, k, v)), mask).float()
    delta = (dout * out).sum(-1)
    sl = [slice(i * d // halves, (i + 1) * d // halves) for i in range(halves)]
    dq = [torch.zeros(q.shape[:3] + (d // halves,)) for _ in sl]
    for c0 in range(0, n, tile):
        keys = slice(c0, min(c0 + tile, n))
        s = sum(torch.matmul(q[..., h], k[:, :, keys, h].transpose(-1, -2)) for h in sl)
        dp = sum(torch.matmul(dout[..., h], v[:, :, keys, h].transpose(-1, -2)) for h in sl)
        valid = mask[:, None, None, keys]
        s = torch.where(valid, s * scale, torch.full_like(s, -1e9))
        p = torch.exp(s - m[..., None]) * (1.0 / l[..., None])
        ds = torch.where(valid, p * (dp - delta[..., None]), torch.zeros_like(p))
        dsr = (ds * scale).to(BF16).float()
        dq = [a + torch.matmul(dsr, k[:, :, keys, h]) for a, h in zip(dq, sl)]
    return torch.cat(dq, dim=-1).to(BF16)


def test_split_dq_at_512_matches_the_plain_version():
    """Width 512's dq pass (two warpgroups on 64 query rows, S and dP over two
    depth halves summed in a fixed order, dq in two column halves, 16-key
    tiles) against the plain backward: dq within 2e-2 of its largest
    magnitude (the card's bar), exactly 0 in the bag without a valid key."""
    lengths = (256, 141, 0)
    q, k, v, mask, dout = _inputs(len(lengths), 1, 512, lengths, 53)
    tq, tk, tv, tdo = (_t(x).to(BF16) for x in (q, k, v, dout))
    tmask = _t(mask)
    o, m, l = flash.flash_attention_plain(tq, tk, tv, tmask, return_stats=True)
    ref_dq, _, _ = flash.flash_attention_bwd_plain(tq, tk, tv, tmask, o, m, l, tdo)
    dq = _split_dq(tq, tk, tv, tmask, m, l, tdo, 16, 2)
    err = _of_top(dq.float().numpy(), ref_dq.float().numpy())
    print(f"dq: {err:.3e} of the largest")
    assert err <= ST_GRAD_RTOL
    assert float(dq[-1].float().abs().max()) == 0.0
