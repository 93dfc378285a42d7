"""The port's co-attention kernels (their plain PyTorch versions, which the
CUDA kernels are held to on the card) against the JAX package's Pallas TPU
kernels run in interpret mode, on the same numpy inputs.

Sizes: B=2, M=1024 (two 512-key tiles on the TPU kernel) or a ragged
M=1000, E=D=128, F=256, N=3.

Tolerance 2e-5 absolute: both sides compute in float32 but sum in other
orders (the TPU kernel per 512-key tile with an online softmax, the port in
one pass), which moves outputs of magnitude ~1 by a few 1e-7. The softmax
normalizer l is a sum of up to M terms of magnitude up to 1 (l ~ 1e2..1e3),
so it is compared with an added relative tolerance of 1e-6 (a few float32
ulps of l). The export output ``out = w @ v`` is a float32 matmul over M
keys on top of the weights' own error, so it adds a relative 1e-5. The
weights w are also held relative to themselves (1e-4, floor 1e-8 absolute):
a row sums to 1 over up to 1024 keys, so the absolute 2e-5 alone would pass
weights that were wrong (or 0) wherever they are small.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import attention as tattention  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402

ATOL = 2e-5
L_RTOL = 1e-6
OUT_RTOL = 1e-5
W_RTOL, W_ATOL = 1e-4, 1e-8
B, N, E, F = 2, 3, 128, 256


def _data(m, seed, *, masked=True, fully_masked_row=False, f=F):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, E)).astype(np.float32)
    kv = rng.normal(size=(B, m, f)).astype(np.float32)
    wk = (rng.normal(size=(f, E)) / math.sqrt(f)).astype(np.float32)
    bk = (0.1 * rng.normal(size=(E,))).astype(np.float32)
    k = rng.normal(size=(B, m, E)).astype(np.float32)
    mask = None
    if masked:
        lengths = np.array([m - 37, m // 2 + 3])
        if fully_masked_row:
            lengths[1] = 0
        mask = np.arange(m)[None, :] < lengths[:, None]
    return q, kv, wk, bk, k, mask


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _mask_f(mask, m):
    if mask is None:
        return jnp.ones((B, 1, m), jnp.float32)
    return jnp.asarray(mask, jnp.float32)[:, None, :]


def _close(got, ref, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL, rtol=rtol)


def _close_w(got, ref):
    _close(got, ref)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=W_ATOL, rtol=W_RTOL)


CASES = [
    pytest.param(False, False, id="no-mask"),
    pytest.param(True, False, id="ragged-mask"),
    pytest.param(True, True, id="fully-masked-row"),
]


@pytest.mark.parametrize("masked,fully", CASES)
def test_fused_k_forward_matches_pallas(masked, fully):
    """o, l, m, sumw of the fuse-K forward (pre-gate on, no dropout) against
    _coattn_fwd_impl(fuse_k=True, emit_sumw=True), two 512-key tiles."""
    m_len = 1024
    q, kv, wk, bk, _, mask = _data(m_len, 1, masked=masked, fully_masked_row=fully)
    o_j, l_j, m_j, _, sumw_j = jcoattn._coattn_fwd_impl(
        _j(q), _j(kv), None, _mask_f(mask, m_len), None, pre_gate=True,
        block_k=512, interpret=True, dropout_rate=0.0, emit_ssq=False,
        emit_sumw=True, wk=_j(wk), bk=_j(bk).reshape(1, -1),
    )
    o, l, m, sumw = tcoattn.coattn_fwd_fused_k(_t(q), _t(kv), _t(wk), _t(bk), _t(mask))
    _close(o, o_j)
    _close(l, l_j[:, 0], rtol=L_RTOL)
    _close(m, m_j[:, 0])
    _close(sumw, sumw_j[:, 0])
    assert np.isfinite(o.numpy()).all()


def test_fused_k_ragged_m_matches_pallas():
    """A non-tile-multiple M (1000 keys; the TPU kernel pads to 1024) through
    the public coattention_fused_k, o and sumw."""
    q, kv, wk, bk, _, mask = _data(1000, 2)
    o_j, sumw_j = jcoattn.coattention_fused_k(
        _j(q), _j(kv), _j(wk), _j(bk), _j(mask), need_sumw=True, interpret=True,
    )
    o, _, _, sumw = tcoattn.coattn_fwd_fused_k(_t(q), _t(kv), _t(wk), _t(bk), _t(mask))
    _close(o, o_j)
    _close(sumw, sumw_j)


def test_fully_masked_row_is_uniform_over_m():
    """At a ragged M a fully-masked row is uniform over exactly its M keys,
    as the JAX package's plain attention path computes it (the TPU kernel
    would spread it over its padded length): its o is the mean of kv."""
    q, kv, wk, bk, _, mask = _data(1000, 3, fully_masked_row=True)
    o, l, _, sumw = tcoattn.coattn_fwd_fused_k(_t(q), _t(kv), _t(wk), _t(bk), _t(mask))
    k = jnp.dot(_j(kv), _j(wk)) + _j(bk)
    ref, _ = jcoattn.attention_core(
        _j(q)[:, None], k[:, None], _j(kv)[:, None], _j(mask), pre_gate=True,
        dropout_rate=0.0, deterministic=True, need_weights=False,
    )
    _close(o, ref[:, 0])
    _close(o[1], np.broadcast_to(kv[1].mean(axis=0), o[1].shape))
    assert float(l[1, 0]) == 1000.0
    _close(sumw, np.ones((B, N)))


@pytest.mark.parametrize("masked,fully", CASES)
def test_stats_forward_matches_pallas(masked, fully):
    """Plain-K stats form (export pass 1): l, m against _coattn_fwd_impl
    with zero values, as coattention_weights runs it."""
    m_len = 1024
    q, _, _, _, k, mask = _data(m_len, 4, masked=masked, fully_masked_row=fully)
    _, l_j, m_j, _, _ = jcoattn._coattn_fwd_impl(
        _j(q), _j(k), jnp.zeros_like(_j(k)), _mask_f(mask, m_len), None,
        pre_gate=True, block_k=512, interpret=True, dropout_rate=0.0,
        emit_ssq=False,
    )
    l, m = tcoattn.coattn_stats(_t(q), _t(k), _t(mask), pre_gate=True)
    _close(l, l_j[:, 0], rtol=L_RTOL)
    _close(m, m_j[:, 0])


@pytest.mark.parametrize(
    "m_len,masked,fully",
    [
        pytest.param(1024, False, False, id="no-mask"),
        pytest.param(1024, True, True, id="fully-masked-row"),
        pytest.param(1000, True, False, id="ragged-m"),
    ],
)
def test_weights_emission_matches_pallas(m_len, masked, fully):
    """Both export passes (stats, then the weights kernel) against
    coattention_weights in interpret mode, 512-key tiles."""
    q, _, _, _, k, mask = _data(m_len, 5, masked=masked, fully_masked_row=fully)
    w_j = jcoattn.coattention_weights(
        _j(q), _j(k), _j(mask), pre_gate=True, block_k=512, interpret=True,
    )
    w = tcoattn.coattention_weights(_t(q), _t(k), _t(mask), pre_gate=True)
    assert w.shape == (B, N, m_len)
    _close_w(w, w_j)


def test_attention_with_weights_matches_jax():
    """The export dispatcher, [B, H, N, D] layout: weights and out = w @ v
    against the JAX dispatcher (which takes its plain path at this M)."""
    q, _, _, _, k, mask = _data(1024, 6)
    v = np.random.default_rng(7).normal(size=k.shape).astype(np.float32)
    out_j, w_j = jcoattn.attention_with_weights(
        _j(q)[:, None], _j(k)[:, None], _j(v)[:, None], _j(mask), pre_gate=True,
    )
    out, w = tcoattn.attention_with_weights(
        _t(q)[:, None], _t(k)[:, None], _t(v)[:, None], _t(mask), pre_gate=True,
    )
    _close_w(w, w_j)
    _close(out, out_j, rtol=OUT_RTOL)


def test_attention_core_and_tiny_attention_match_jax():
    """The plain attention paths: attention_core (pre-gated and not, with
    weights) and tiny_attention (8 heads over 6 tokens)."""
    from multimodal_path_omic_tpu.ops import attention as jattention

    rng = np.random.default_rng(8)
    q = rng.normal(size=(B, 2, 6, 16)).astype(np.float32)
    k = rng.normal(size=(B, 2, 40, 16)).astype(np.float32)
    v = rng.normal(size=(B, 2, 40, 16)).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([40, 17])[:, None]
    for pre_gate in (False, True):
        o_j, w_j = jattention.attention_core(
            _j(q), _j(k), _j(v), _j(mask), pre_gate=pre_gate, dropout_rate=0.0,
            deterministic=True,
        )
        o, w = tattention.attention_core(_t(q), _t(k), _t(v), _t(mask), pre_gate=pre_gate)
        _close(o, o_j)
        _close(w, w_j)
    x = rng.normal(size=(B, 6, 64)).astype(np.float32)
    tmask = np.array([[True] * 6, [True] * 4 + [False] * 2])
    _close(
        tattention.tiny_attention(_t(x), _t(x) * 0.5, _t(x) + 1.0, _t(tmask), 8),
        jattention.tiny_attention(_j(x), _j(x) * 0.5, _j(x) + 1.0, _j(tmask), 8),
    )


def test_leank_dispatcher_returns_jax_layout():
    """fused_attention_leank keeps the JAX signature: o [B, N, F] alone, or
    (o, sumw) with need_sumw; need_ssq (training) is refused."""
    q, kv, wk, bk, _, mask = _data(1024, 9)
    o = tcoattn.fused_attention_leank(_t(q), _t(kv), _t(wk), _t(bk), _t(mask))
    o2, sumw = tcoattn.fused_attention_leank(
        _t(q), _t(kv), _t(wk), _t(bk), _t(mask), need_sumw=True
    )
    assert o.shape == (B, N, F) and sumw.shape == (B, N)
    assert torch.equal(o, o2)
    with pytest.raises(NotImplementedError):
        tcoattn.fused_attention_leank(_t(q), _t(kv), _t(wk), _t(bk), need_ssq=True)
