"""The port's fuse-K co-attention backward (``ops/coattn.py::FusedKTrain``:
the training forward and ``coattn_bwd_fused_k``, their plain versions on the
CPU) against ``jax.grad`` through the JAX package's
``coattention_fused_k(..., need_ssq=True, need_sumw=True)`` in interpret
mode (its custom VJP: the backward Pallas kernel), on the masks that the
CUDA kernel's skipping of key tiles depends on: whole masked 64-key tiles in
the middle of a bag, a bag with a single valid key, a bag without a valid
key, and M not a multiple of the 64-key tile; at E = 128, F = 256 and, for
the first two, at NaCAGaT big's E = F = 512 (the CUDA kernel's streamed-kv
instance).

It also pins to the reference the two properties the skipping relies on: in
a bag with a valid key a masked key's dkv row is exactly 0, and the masked
kv rows do not reach dq, dwk or dbk (changing them changes none of the
three).

Tolerances as ``test_torch_port_train.py``: outputs 2e-5 absolute,
gradients 5e-5 of each gradient's largest magnitude (float32 in other
summation orders). Dropout 0: the TPU kernel's dropout bits are not the
port's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402

KERNEL_ATOL = 2e-5
GRAD_RTOL = 5e-5
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
    cot = (rng.normal(size=(B, N, f)).astype(np.float32),
           rng.normal(size=(B, N)).astype(np.float32), rng.normal(size=(B, N)).astype(np.float32))
    return (q, kv, wk, bk), cot


def _jax_grads(q, kv, wk, bk, mask, cot):
    w_o, w_s, w_w = cot

    def loss(q_, kv_, wk_, bk_):
        o, ssq, sumw = jcoattn.coattention_fused_k(
            q_, kv_, wk_, bk_, jnp.asarray(mask), need_ssq=True, need_sumw=True, interpret=True)
        return jnp.sum(o * w_o) + jnp.sum(ssq * w_s) + jnp.sum(sumw * w_w), (o, ssq, sumw)

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (q, kv, wk, bk)))
    return [np.asarray(x) for x in outs], [np.asarray(x) for x in grads]


def _port_grads(q, kv, wk, bk, mask, cot):
    """Autograd through FusedKTrain (the leank dispatcher's training form),
    and the backward wrapper called directly with the forward's l, m and
    di: both must give the same gradients."""
    w_o, w_s, w_w = (torch.from_numpy(x) for x in cot)
    mask_t = torch.from_numpy(mask)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, kv, wk, bk)]
    outs = tcoattn.fused_attention_leank(*ins, mask_t, need_ssq=True, need_sumw=True)
    ((outs[0] * w_o).sum() + (outs[1] * w_s).sum() + (outs[2] * w_w).sum()).backward()
    raw = [t.detach() for t in ins]
    seed = torch.zeros((1,), dtype=torch.int32)
    o, l, m, ssq, sumw = tcoattn.coattn_fwd_fused_k_train(*raw, mask_t, seed, 0.0)
    di = (o * w_o).sum(-1) + 2.0 * w_s * ssq + w_w * sumw
    direct = tcoattn.coattn_bwd_fused_k(*raw, mask_t, seed, 0.0, w_o, l, m, di, w_s, w_w)
    for a, t in zip(direct, ins):
        torch.testing.assert_close(a, t.grad, atol=0.0, rtol=0.0)
    return [x.detach().numpy() for x in outs], [t.grad.numpy() for t in ins]


def _close_rel(got, ref):
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= GRAD_RTOL * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize(
    "e,f,m_len,case",
    [
        pytest.param(128, 256, 640, "holes", id="masked-tiles-mid-bag"),
        pytest.param(128, 256, 500, "single-key", id="single-valid-key"),
        # 300 keys: one JAX tile of 300 (no padding), so the bag without a
        # valid key is uniform over the same 300 keys on both sides
        pytest.param(128, 256, 300, "no-valid-key", id="no-valid-key"),
        pytest.param(128, 256, 1000, "ragged-m", id="m-not-tile-multiple"),
        pytest.param(512, 512, 640, "holes", id="e512-masked-tiles-mid-bag"),
        pytest.param(512, 512, 500, "single-key", id="e512-single-valid-key"),
    ],
)
def test_fused_k_backward_matches_pallas_on_skipping_masks(e, f, m_len, case):
    """o, ssq, sumw and dq, dkv, dwk, dbk against the Pallas kernels; dkv
    exactly 0 at the masked keys of bags with a valid key, on both sides."""
    ins, cot = _data(e, f, m_len, m_len + 7)
    mask = _mask(m_len, case)
    outs_j, grads_j = _jax_grads(*ins, mask, cot)
    outs_t, grads_t = _port_grads(*ins, mask, cot)
    for got, ref in zip(outs_t, outs_j):
        np.testing.assert_allclose(got, ref, atol=KERNEL_ATOL, rtol=0)
    for got, ref in zip(grads_t, grads_j):
        _close_rel(got, ref)
    has = mask.any(-1)
    for dkv in (grads_t[1], grads_j[1]):
        assert not np.any(dkv[has][~mask[has]])


@pytest.mark.parametrize("m_len,case", [(640, "holes"), (500, "single-key"),
                                        (300, "no-valid-key")])
def test_masked_kv_rows_do_not_reach_dq_dwk_dbk(m_len, case):
    """Rewriting the masked kv rows of the bags with a valid key leaves dq,
    dwk and dbk unchanged (bit for bit in the port, within float32 noise in
    the Pallas kernels), and the dkv of those rows 0: the property that lets
    the CUDA kernel skip a key tile with no valid key."""
    f = 256
    (q, kv, wk, bk), cot = _data(128, f, m_len, m_len + 11)
    mask = _mask(m_len, case)
    has = mask.any(-1)
    kv2 = kv.copy()
    rewrite = has[:, None] & ~mask
    kv2[rewrite] = 3.0 + np.random.default_rng(5).normal(size=(int(rewrite.sum()), f))
    grads = {}
    for name, kv_ in (("before", kv), ("after", kv2)):
        grads[name] = (_port_grads(q, kv_, wk, bk, mask, cot)[1],
                       _jax_grads(q, kv_, wk, bk, mask, cot)[1])
    for i in (0, 2, 3):  # dq, dwk, dbk
        np.testing.assert_array_equal(grads["after"][0][i], grads["before"][0][i])
        _close_rel(grads["after"][1][i], grads["before"][1][i])
    for side in (0, 1):
        assert not np.any(grads["after"][side][1][rewrite])
