"""The bfloat16 fuse-K kernels on Hopper's warpgroup MMA
(``multimodal_path_omic_tpu_torch/csrc/fused_k_sm90.cuh``), their numerics
emulated in torch on the CPU, against the JAX package's Pallas fuse-K
kernels at bfloat16 in interpret mode (the kernels themselves run only on
the card: ``tests/test_torch_port_cuda.py``).

What the emulation repeats: k = kv wk summed in float32 over 16-deep steps in
depth order, + bk, rounded to bfloat16; q.k and tanh(q).tanh(k) summed by
each warpgroup over its half of E in 16-deep steps and the two halves added
in warpgroup order; in the backward da, du and pd as bfloat16 hi + lo parts
in the products that take them, and dk split into hi + lo parts against wk
(dkv) and kv (dwk, dbk).

Tolerances, each with its reason:

* k: each element equal to JAX's or one bfloat16 unit away (2^-7 of it),
  or 1e-6 away where the sum nearly cancels: both round a float32 sum of
  the same exact products, in other orders (measured: 6e-8 at k ~ 5e-6);
* scores and gate: 1e-2 absolute, chip_smoke.py's BF16_STAT_TOL: where an
  element of k or of tanh(k) rounds to the other bfloat16 neighbour in the
  two versions, that key's score moves by up to ~5e-3;
* forward: o within 2^-7 of its largest magnitude (one bfloat16 unit), l,
  m, ssq, sumw within 1e-5 of theirs, as ``test_torch_port_bf16.py`` holds
  the plain versions;
* the dk split: |dk - hi - lo| <= 2^-16 |dk| (two round-to-nearest steps of
  8 significant bits), the products on the split within 2e-2 of JAX's
  float32-accurate products' largest magnitude (chip_smoke.py's
  BF16_GRAD_RTOL; they land ~1e-5 from them);
* backward: 3e-2 of each gradient's largest magnitude, as
  ``test_torch_port_bf16.py`` holds the plain version (the JAX kernel takes
  1 - tanh^2 of bfloat16 values in bfloat16).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import kernels  # noqa: E402

B = 2
NEG = tcoattn.NEG
STAT_RTOL, O_RTOL, SCORE_ATOL = 1e-5, 2.0 ** -7, 1e-2
SPLIT_REL, PRODUCT_RTOL, GRAD_RTOL = 2.0 ** -16, 2e-2, 3e-2


def _bf(x):
    """float32 values exactly representable in bfloat16."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rbf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def parts(x: torch.Tensor):
    """x as the kernels split a float32 operand: hi = bf16(x), lo = bf16(x - hi)."""
    hi = rbf(x)
    return hi, rbf(x - hi)


def _data(n, e, f, m_len, seed):
    rng = np.random.default_rng(seed)
    q = _bf(0.7 * rng.normal(size=(B, n, e)))
    kv = _bf(np.maximum(rng.normal(size=(B, m_len, f)), 0))
    wk = _bf(0.7 * rng.normal(size=(f, e)) / math.sqrt(f))
    bk = _bf(0.1 * rng.normal(size=(e,)))
    return q, kv, wk, bk


def _mask(m_len, case):
    """[B, M] bool: whole masked 64-key tiles mid-bag, a ragged bag; or a bag
    with a single valid key beside a full one."""
    mask = np.zeros((B, m_len), bool)
    if case == "holes":
        mask[0, :601] = True
        mask[0, 64:256] = False
        mask[1] = True
        mask[1, 128:192] = False
    else:  # single-key
        mask[0, 437] = True
        mask[1, :480] = True
    return mask


MASKS = [pytest.param(640, "holes", id="masked-tiles-mid-bag"),
         pytest.param(500, "single-key", id="single-valid-key")]


# ---------------------------------------------------------------- emulation


def project(kv, wk, bk):
    """k as fk90::project_tile / project_step form it: 16-deep steps in depth
    order, each a float32 sum of exact bfloat16 products added into float32
    sums; + bk; rounded to bfloat16."""
    acc = torch.zeros(kv.shape[:-1] + (wk.shape[1],))
    for s0 in range(0, kv.shape[-1], 16):
        acc = acc + kv[..., s0:s0 + 16] @ wk[s0:s0 + 16]
    return rbf(acc + bk)


def half_sums(x, y):
    """sum_e x[.., m, e] y[.., n, e] as fk90::tile_scores forms it: warpgroup
    w sums E half w in 16-deep steps; the halves added in warpgroup order.
    -> [.., n, m]."""
    e = x.shape[-1]
    halves = []
    for w in range(2):
        acc = torch.zeros(x.shape[:-2] + (y.shape[-2], x.shape[-2]))
        for s0 in range(w * e // 2, (w + 1) * e // 2, 16):
            acc = acc + y[..., s0:s0 + 16] @ x[..., s0:s0 + 16].transpose(-1, -2)
        halves.append(acc)
    return halves[0] + halves[1]


def scores(q, k, mask):
    """(s, a, g) of the kernels: a = q.k / sqrt(E), g = (tanh(q).tanh(k) + 1)
    / 2 with tanh rounded to bfloat16, s = a g, NEG where masked."""
    a = half_sums(k, q) * (1.0 / math.sqrt(q.shape[-1]))
    u = half_sums(rbf(torch.tanh(k)), rbf(torch.tanh(q)))
    g = (u + 1.0) * 0.5
    s = torch.where(mask[:, None, :], a * g, torch.full_like(a, NEG))
    return s, a, g


def forward(q, kv, wk, bk, mask):
    """(o in bfloat16, l, m, ssq, sumw) of the kernels' forward at dropout 0,
    k, and o before its rounding."""
    k = project(kv, wk, bk)
    s, _, _ = scores(q, k, mask)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    w = p / l[..., None]
    o32 = (p @ kv) / l[..., None]
    return rbf(o32), l, m, (w * w).sum(-1), w.sum(-1), k, o32


def backward(q, kv, wk, bk, mask, dout, dssq, dsumw):
    """(dq, dkv, dwk, dbk) of fk90::fk_bwd_wg_kernel and dwk_wg_kernel at
    dropout 0 (dq, dkv rounded to bfloat16), and the float32 dk."""
    e = q.shape[-1]
    scale = 1.0 / math.sqrt(e)
    o, l, m, ssq, sumw, k, _ = forward(q, kv, wk, bk, mask)
    s, a, g = scores(q, k, mask)
    tk, tq = rbf(torch.tanh(k)), rbf(torch.tanh(q))
    p = torch.exp(s - m[..., None]) / l[..., None]
    di = (o * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    dp = dout @ kv.transpose(-1, -2)
    ds = p * dp - p * di[..., None] + 2.0 * dssq[..., None] * p * p + dsumw[..., None] * p
    ds = torch.where(mask[:, None, :], ds, torch.zeros_like(ds))
    da, du = ds * g, ds * a * 0.5
    da_p, du_p, pd_p = parts(scale * da), parts(du), parts(p)
    # dk: x = du^T tanh(q), x *= 1 - tanh(k)^2, x += (scale da)^T q
    x = sum(d.transpose(-1, -2) @ tq for d in du_p) * (1.0 - tk * tk)
    dk = x + sum(d.transpose(-1, -2) @ q for d in da_p)
    hi, lo = parts(dk)
    dkv = rbf(hi @ wk.T + lo @ wk.T + sum(d.transpose(-1, -2) @ dout for d in pd_p))
    dwk = (kv.transpose(-1, -2) @ hi + kv.transpose(-1, -2) @ lo).sum(0)
    dbk = (hi + lo).sum((0, 1))
    # dq: scale (z wk + sum(da) bk) + (1 - tanh(q)^2) dqu, from da's and du's parts
    da_hl, du_hl = parts(da), parts(du)
    z = sum(d @ kv for d in da_hl)
    dqu = sum(d @ tk for d in du_hl)
    dq = scale * (z @ wk + da.sum(-1, keepdim=True) * bk) + (1.0 - tq * tq) * dqu
    return (rbf(dq), dkv, dwk, dbk), dk


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _jax_fwd(q, kv, wk, bk, mask):
    """The Pallas forward's (o, l, m, ssq, sumw). One query goes in beside a
    zero second one: with a single query row the Pallas forward on the CPU
    lands 1e-3 off in l from both this emulation and the port's plain
    version (which agree to float32 rounding), and a query's outputs do not
    depend on the others."""
    n = q.shape[1]
    if n == 1:
        q = np.concatenate([q, np.zeros_like(q)], 1)
    outs = jcoattn._coattn_fwd_impl(
        _jb(q), _jb(kv), None, jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=True, block_k=mask.shape[1], interpret=True, dropout_rate=0.0, emit_ssq=True,
        emit_sumw=True, wk=_jb(wk), bk=_jb(bk).reshape(1, -1))
    return [_f32(outs[0])[:, :n]] + [np.asarray(x)[:, 0][:, :n] for x in outs[1:]]


def _close_max(got, ref, rtol, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max(), (name, err, np.abs(ref).max())


# ---------------------------------------------------------------- (a) k and the scores


@pytest.mark.parametrize("e,f", [(128, 128), (256, 256), (256, 128), (512, 512)])
def test_projection_in_k16_steps_matches_jax_k(e, f):
    """k summed in the kernels' 16-deep steps and rounded to bfloat16 against
    JAX's k (the Pallas kernel's expression, ops/coattn.py:136-145): each
    element equal or one bfloat16 unit away, nearly all equal; the scores and
    the gate from it against JAX's within 1e-2."""
    q, kv, wk, bk = _data(3, e, f, 192, e + f)
    k = project(_t(kv), _t(wk), _t(bk))
    k_j = (jnp.einsum("bmf,fe->bme", _jb(kv), _jb(wk), preferred_element_type=jnp.float32)
           + _jb(bk)).astype(jnp.bfloat16)
    k_j = _t(_f32(k_j))
    diff = (k - k_j).abs()
    assert bool((diff <= 2.0 ** -7 * k_j.abs() + 1e-6).all())
    assert float((diff > 0).float().mean()) < 0.02
    mask = torch.ones((B, 192), dtype=torch.bool)
    s, _, g = scores(_t(q), k, mask)
    qj, kj = _jb(q), k_j.numpy().astype(jnp.bfloat16)
    a_j = jnp.einsum("bne,bme->bnm", qj, kj, preferred_element_type=jnp.float32) / math.sqrt(e)
    u_j = jnp.einsum("bne,bme->bnm", jnp.tanh(qj), jnp.tanh(kj),
                     preferred_element_type=jnp.float32)
    g_j = (u_j + 1.0) * 0.5
    np.testing.assert_allclose(g.numpy(), _f32(g_j), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), _f32(a_j * g_j), atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("m_len,case", MASKS)
@pytest.mark.parametrize("n,e,f", [(3, 128, 128), (3, 256, 256), (1, 128, 128),
                                   (8, 128, 128), (3, 256, 128)])
def test_forward_emulation_matches_pallas(n, e, f, m_len, case):
    """The kernels' forward (dropout 0), emulated, against the Pallas forward
    on bfloat16 tiles (one tile of M keys): o, l, m, ssq, sumw; at 1, 3 and
    8 queries (the ends of the padding to 8)."""
    q, kv, wk, bk = _data(n, e, f, m_len, n + e + f + m_len)
    mask = _mask(m_len, case)
    ref = _jax_fwd(q, kv, wk, bk, mask)
    got = forward(_t(q), _t(kv), _t(wk), _t(bk), torch.from_numpy(mask))[:5]
    _close_max(got[0].numpy(), ref[0], O_RTOL, "o")
    for name, a, r in zip(("l", "m", "ssq", "sumw"), got[1:], ref[1:]):
        _close_max(a.numpy(), r, STAT_RTOL, name)


# ---------------------------------------------------------------- (b) the dk split


@pytest.mark.parametrize("e,f", [(128, 256), (256, 256), (512, 512)])
def test_dk_split_and_its_products(e, f):
    """dk's hi + lo parts reconstruct it to 2^-16 of each element, and dkv =
    dk wk^T, dwk = kv^T dk on the parts (float32 sums of exact products) stay
    within 2e-2 of JAX's float32-accurate products (ops/coattn.py:482-492),
    in fact within 1e-4."""
    rng = np.random.default_rng(e + f)
    m_len = 192
    # dk of a backward's scale: products of O(1) cotangents, a few large
    dk = (rng.normal(size=(B, m_len, e)) * np.exp(rng.normal(size=(B, m_len, e)))).astype(
        np.float32)
    _, kv, wk, _ = _data(1, e, f, m_len, e + f + 1)
    hi, lo = parts(_t(dk))
    err = (_t(dk) - hi - lo).abs()
    assert bool((err <= SPLIT_REL * _t(dk).abs()).all())
    dkv = hi @ _t(wk).T + lo @ _t(wk).T
    dwk = (_t(kv).transpose(-1, -2) @ hi + _t(kv).transpose(-1, -2) @ lo).sum(0)
    # float32 dk against the bfloat16 operands widened (exactly) to float32
    dkv_j = jax.lax.dot_general(jnp.asarray(dk), _jb(wk).astype(jnp.float32),
                                (((2,), (1,)), ((), ())), preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
    dwk_j = jax.lax.dot_general(_jb(kv).astype(jnp.float32), jnp.asarray(dk),
                                (((0, 1), (0, 1)), ((), ())), preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
    for name, got, ref in (("dkv", dkv, dkv_j), ("dwk", dwk, dwk_j)):
        _close_max(got.numpy(), _f32(ref), PRODUCT_RTOL, name)
        _close_max(got.numpy(), _f32(ref), 1e-4, name)


def _jax_grads(q, kv, wk, bk, mask, w_o, w_s, w_w):
    """jax.grad of sum(o w_o) + sum(ssq w_s) + sum(sumw w_w) through the
    Pallas kernels at bfloat16 -> (dq, dkv, dwk, dbk). One query goes in
    beside a zero second one with zero cotangents, as in :func:`_jax_fwd`
    (the second adds nothing to dkv, dwk, dbk)."""
    n = q.shape[1]
    if n == 1:
        q, w_o, w_s, w_w = (np.concatenate([x, np.zeros_like(x)], 1) for x in (q, w_o, w_s, w_w))

    def loss(q_, kv_, wk_, bk_):
        o, ssq, sumw = jcoattn.coattention_fused_k(
            q_, kv_, wk_, bk_, jnp.asarray(mask), need_ssq=True, need_sumw=True, interpret=True)
        return (jnp.sum(o.astype(jnp.float32) * w_o) + jnp.sum(ssq * w_s)
                + jnp.sum(sumw * w_w))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(_jb(x) for x in (q, kv, wk, bk)))
    return [_f32(ref[0])[:, :n]] + [_f32(r) for r in ref[1:]]


@pytest.mark.parametrize("n,e,f,cot", [(3, 128, 128, "random"), (3, 256, 256, "random"),
                                       (1, 256, 256, "random"), (1, 256, 256, "o-rounding")])
def test_backward_emulation_matches_pallas(n, e, f, cot):
    """dq, dkv, dwk, dbk of the kernels' backward (dropout 0), emulated with
    the hi + lo parts, against jax.grad through the Pallas kernels at
    bfloat16; dkv exactly 0 at the masked keys of a bag with a valid key.
    The kernels, like JAX's _coattn_fk_bwd, form di = rowsum(o dO) + ...
    from the bfloat16 o; the "o-rounding" cotangent of o is the sign of o's
    rounding error, where di from the float32 o would differ most."""
    m_len = 640
    q, kv, wk, bk = _data(n, e, f, m_len, e + f + 7)
    mask = _mask(m_len, "holes")
    rng = np.random.default_rng(m_len)
    w_o = _bf(rng.normal(size=(B, n, f)))
    w_s, w_w = (rng.normal(size=(B, n)).astype(np.float32) for _ in range(2))
    if cot == "o-rounding":
        o, *_, o32 = forward(_t(q), _t(kv), _t(wk), _t(bk), torch.from_numpy(mask))
        w_o = torch.sign(o - o32).numpy()
    ref = _jax_grads(q, kv, wk, bk, mask, w_o, w_s, w_w)
    got, _ = backward(_t(q), _t(kv), _t(wk), _t(bk), torch.from_numpy(mask), _t(w_o), _t(w_s),
                      _t(w_w))
    for name, a, r in zip(("dq", "dkv", "dwk", "dbk"), got, ref):
        _close_max(a.numpy(), r, GRAD_RTOL, name)
    dkv = got[1].numpy()
    has = mask.any(-1)
    assert not np.any(dkv[has][~mask[has]])


# ---------------------------------------------------------------- (c) names and shapes


def test_bf16_entry_points_and_shapes_unchanged():
    """The bfloat16 fuse-K instances keep their entry points, launch counts
    and the shapes they take: (E, F) in {128, 256}^2 and (512, 512), at most
    eight queries, every form."""
    for lib, name in (("coattn", "mpo_coattn_fwd_fused_k_bf16"),
                      ("coattn", "mpo_coattn_fwd_fused_k_train_bf16"),
                      ("coattn_bwd", "mpo_coattn_bwd_fused_k_bf16")):
        assert name in kernels.SIGNATURES[lib], name
    for name in ("coattn_fwd_fused_k_bf16", "coattn_fwd_fused_k_train_bf16",
                 "coattn_bwd_fused_k_bf16"):
        assert name in tcoattn.LAUNCH_COUNTS, name
    assert tcoattn.BF16_EF == frozenset({(128, 128), (128, 256), (256, 128), (256, 256),
                                         (512, 512)})
    bf = torch.bfloat16
    for e in (128, 256, 512):
        for f in (128, 256, 512):
            for train in (False, True):
                for n in (1, 8, 9):
                    want = (e, f) in tcoattn.BF16_EF and n <= 8
                    assert tcoattn.fused_k_supports(n, e, f, 640, train=train, dtype=bf) == want, \
                        (n, e, f, train)
