"""The port's fuse-K co-attention forward, eval form (``coattn_fwd_fused_k``)
and training form (``coattn_fwd_fused_k_train``, dropout 0), their plain
versions on the CPU, against the JAX package's forward Pallas kernel
(``_coattn_fwd_impl`` with ``wk``/``bk``: the kernel behind
``coattention_fused_k``) in interpret mode, at E in {128, 256, 512} with F = E
and F = 1024, on the masks that the CUDA kernel's skipping of key tiles
depends on: whole masked 64-key tiles in the middle of a bag, a bag with a
single valid key, a bag without a valid key, and M not a multiple of the
64-key tile.

It also pins the property the skipping relies on: in a bag with a valid key,
the masked kv rows reach none of o, l, m, ssq and sumw (rewriting them
changes nothing, bit for bit in the port, within float32 noise in the Pallas
kernel).

Tolerances: 2e-5 absolute, as ``test_torch_port_coattn.py`` (float32 in
other summation orders); l, a sum of up to M terms of magnitude up to 1
(l ~ 1e1..1e3), with an added 1e-5 relative, the card's limit for l: each
term exp(s - m) moves relative by the score's absolute rounding error, and a
score here sums E products of k, each a sum of F (up to 1024) products of
ReLU activations, which two summation orders leave a few 1e-6 apart
(``test_torch_port_coattn.py`` holds l to 1e-6 at F = 256 over
zero-mean activations).
The JAX kernel runs one tile of M keys (M <= 1024), so it pads nothing and a
bag without a valid key is uniform over the same M keys on both sides.
Dropout 0: the TPU kernel's dropout bits are not the port's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402

ATOL = 2e-5
L_RTOL = 1e-5
B, N = 2, 3


def _mask(m_len, case):
    """[B, M] bool. holes: bag 0 valid on 0..600 but for keys 64..255 (three
    whole 64-key tiles), bag 1 on all but 128..191 and 400..463; single-key:
    bag 0 valid on key 437 alone, bag 1 on 0..479; no-valid-key: bag 0 valid
    on 0..249 but for 64..127, bag 1 on none; ragged-m: bag 0 on all but
    128..255, bag 1 on 0..776."""
    mask = np.zeros((B, m_len), bool)
    if case == "holes":
        mask[0, :601] = True
        mask[0, 64:256] = False
        mask[1] = True
        mask[1, 128:192] = False
        mask[1, 400:464] = False
    elif case == "single-key":
        mask[0, 437] = True
        mask[1, :480] = True
    elif case == "no-valid-key":
        mask[0, :250] = True
        mask[0, 64:128] = False
    else:  # ragged-m
        mask[0] = True
        mask[0, 128:256] = False
        mask[1, :777] = True
    return mask


def _data(e, f, m_len, seed):
    rng = np.random.default_rng(seed)
    q = (0.7 * rng.normal(size=(B, N, e))).astype(np.float32)
    kv = np.maximum(rng.normal(size=(B, m_len, f)), 0).astype(np.float32)
    wk = (0.7 * rng.normal(size=(f, e)) / math.sqrt(f)).astype(np.float32)
    bk = (0.1 * rng.normal(size=(e,))).astype(np.float32)
    return q, kv, wk, bk


def _jax_fwd(q, kv, wk, bk, mask):
    """(o, l, m, ssq, sumw) of the Pallas forward over one tile of M keys."""
    m_len = kv.shape[1]
    o, l, m, ssq, sumw = jcoattn._coattn_fwd_impl(
        jnp.asarray(q), jnp.asarray(kv), None, jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=True, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=True,
        emit_sumw=True, wk=jnp.asarray(wk), bk=jnp.asarray(bk).reshape(1, -1),
    )
    return [np.asarray(x) if i == 0 else np.asarray(x)[:, 0] for i, x in enumerate((o, l, m, ssq,
                                                                                    sumw))]


def _port_fwd(q, kv, wk, bk, mask, form):
    """(o, l, m, ssq, sumw) of the port's eval form (ssq None) or training
    form at dropout 0."""
    args = [torch.from_numpy(x) for x in (q, kv, wk, bk, mask)]
    if form == "eval":
        o, l, m, sumw = tcoattn.coattn_fwd_fused_k(*args)
        return [o.numpy(), l.numpy(), m.numpy(), None, sumw.numpy()]
    seed = torch.zeros((1,), dtype=torch.int32)
    return [x.numpy() for x in tcoattn.coattn_fwd_fused_k_train(*args, seed, 0.0)]


def _close(got, ref):
    names = ("o", "l", "m", "ssq", "sumw")
    for name, a, r in zip(names, got, ref):
        if a is None:
            continue
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=L_RTOL if name == "l" else 0.0,
                                   err_msg=name)


MASKS = [
    pytest.param(640, "holes", id="masked-tiles-mid-bag"),
    pytest.param(500, "single-key", id="single-valid-key"),
    pytest.param(300, "no-valid-key", id="no-valid-key"),
    pytest.param(1000, "ragged-m", id="m-not-tile-multiple"),
]


@pytest.mark.parametrize("m_len,case", MASKS)
@pytest.mark.parametrize("e,f", [(128, 128), (256, 256), (512, 512), (128, 1024)],
                         ids=["e128", "e256", "e512", "e128-f1024"])
def test_fused_k_eval_forward_matches_pallas(e, f, m_len, case):
    """o, l, m, sumw of the eval form against the Pallas forward; a bag
    without a valid key is uniform over its M keys (o = the mean of kv)."""
    q, kv, wk, bk = _data(e, f, m_len, e + f + m_len)
    mask = _mask(m_len, case)
    got = _port_fwd(q, kv, wk, bk, mask, "eval")
    _close(got, _jax_fwd(q, kv, wk, bk, mask))
    empty = ~mask.any(-1)
    if empty.any():
        np.testing.assert_allclose(got[0][empty], np.broadcast_to(
            kv[empty].mean(axis=1)[:, None], got[0][empty].shape), atol=ATOL, rtol=0)
        assert np.all(got[1][empty] == float(m_len))


@pytest.mark.parametrize("m_len,case", MASKS)
@pytest.mark.parametrize("e", [128, 256, 512])
def test_fused_k_training_forward_matches_pallas(e, m_len, case):
    """The training form at dropout 0: o, l, m, ssq, sumw against the Pallas
    forward, and o, l, m, sumw equal to the eval form's."""
    q, kv, wk, bk = _data(e, e, m_len, 3 * e + m_len)
    mask = _mask(m_len, case)
    got = _port_fwd(q, kv, wk, bk, mask, "train")
    _close(got, _jax_fwd(q, kv, wk, bk, mask))
    ev = _port_fwd(q, kv, wk, bk, mask, "eval")
    for i in (0, 1, 2, 4):
        np.testing.assert_allclose(got[i], ev[i], atol=ATOL, rtol=L_RTOL if i == 1 else 0.0)


@pytest.mark.parametrize("e,f,m_len,case", [(256, 256, 640, "holes"), (512, 512, 500, "single-key"),
                                            (128, 1024, 300, "no-valid-key"),
                                            (128, 128, 1000, "ragged-m")])
def test_masked_kv_rows_do_not_reach_the_forward(e, f, m_len, case):
    """Rewriting the masked kv rows of the bags with a valid key leaves o, l,
    m, ssq and sumw unchanged: bit for bit in the port's eval and training
    forms, within float32 noise in the Pallas kernel. This is what lets the
    CUDA kernel skip a key tile without a valid key."""
    q, kv, wk, bk = _data(e, f, m_len, e + m_len + 11)
    mask = _mask(m_len, case)
    kv2 = kv.copy()
    rewrite = mask.any(-1)[:, None] & ~mask
    kv2[rewrite] = 3.0 + np.random.default_rng(5).normal(size=(int(rewrite.sum()), f))
    for form in ("eval", "train"):
        before, after = (_port_fwd(q, x, wk, bk, mask, form) for x in (kv, kv2))
        for a, r in zip(after, before):
            if a is not None:
                np.testing.assert_array_equal(a, r)
    _close(_jax_fwd(q, kv2, wk, bk, mask), _jax_fwd(q, kv, wk, bk, mask))
