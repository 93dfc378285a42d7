"""The port's plain-K co-attention with values (``coattn_fwd_plain_k`` and
``coattn_bwd_plain_k``: their plain versions on the CPU, which the CUDA
kernels are held to on the card) against the JAX package's ``coattention``
and its custom VJP (the forward and backward Pallas kernels in interpret
mode, dropout 0), with and without the pre-gate, on the masks that the CUDA
kernels' skipping of key tiles depends on: whole masked 64-key tiles in the
middle of a bag, a bag with a single valid key, a bag without a valid key,
and M not a multiple of the 64-key tile.

It also pins the property the skipping relies on: in a bag with a valid key,
the masked k and v rows reach none of o, l, m, ssq, sumw and dq (rewriting
them changes nothing, bit for bit in the port), and their dk and dv are
exactly 0.

Tolerances: 2e-5 absolute on o, m, ssq and sumw, l with an added 1e-5
relative (float32 in other summation orders; the sibling files' limits);
gradients 5e-5 of each gradient's largest magnitude. The JAX kernels run one
tile of M keys (M <= 1024), so they pad nothing and a bag without a valid
key is uniform over the same M keys on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402

from test_torch_port_coattn_fwd import _mask  # noqa: E402

ATOL = 2e-5
L_RTOL = 1e-5
GRAD_RTOL = 5e-5
B, N, D = 2, 3, 128

MASKS = [
    pytest.param(640, "holes", id="masked-tiles-mid-bag"),
    pytest.param(500, "single-key", id="single-valid-key"),
    pytest.param(300, "no-valid-key", id="no-valid-key"),
    pytest.param(1000, "ragged-m", id="m-not-tile-multiple"),
]
GATES = [pytest.param(False, id="plain"), pytest.param(True, id="pre-gate")]


def _data(m_len, seed):
    rng = np.random.default_rng(seed)
    q = (0.7 * rng.normal(size=(B, N, D))).astype(np.float32)
    k = (0.7 * rng.normal(size=(B, m_len, D))).astype(np.float32)
    v = rng.normal(size=(B, m_len, D)).astype(np.float32)
    cot = (rng.normal(size=(B, N, D)).astype(np.float32),
           rng.normal(size=(B, N)).astype(np.float32), rng.normal(size=(B, N)).astype(np.float32))
    return (q, k, v), cot


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close_rel(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    assert err <= GRAD_RTOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("pre_gate", GATES)
@pytest.mark.parametrize("m_len,case", MASKS)
def test_plain_forward_matches_pallas(m_len, case, pre_gate):
    """o, l, m, ssq, sumw of the plain version and of the wrapper's CPU path
    (training form at rate 0; eval form: o, l, m) against the forward Pallas
    kernel over one tile of M keys."""
    (q, k, v), _ = _data(m_len, m_len + pre_gate)
    mask = _mask(m_len, case)
    out = jcoattn._coattn_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask, jnp.float32)[:, None, :],
        None, pre_gate=pre_gate, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=True,
        emit_sumw=True,
    )
    ref = [np.asarray(x) if i == 0 else np.asarray(x)[:, 0] for i, x in enumerate(out)]
    args = [_t(x) for x in (q, k, v, mask)]
    got = tcoattn.coattn_fwd_plain_k_plain(*args, None, 0.0, pre_gate=pre_gate)
    train = tcoattn.coattn_fwd_plain_k(*args, torch.zeros((1,), dtype=torch.int32), 0.0,
                                       pre_gate=pre_gate)
    ev = tcoattn.coattn_fwd_plain_k(*args, pre_gate=pre_gate, train=False)
    assert ev[3] is None and ev[4] is None
    for name, a, t, e, r in zip(("o", "l", "m", "ssq", "sumw"), got, train, ev, ref):
        for x in (a, t) + ((e,) if e is not None else ()):
            assert torch.isfinite(x).all(), name
            np.testing.assert_allclose(x.numpy(), r, atol=ATOL,
                                       rtol=L_RTOL if name == "l" else 0.0, err_msg=name)
    if case == "no-valid-key":  # bag 1: uniform over its M keys
        np.testing.assert_allclose(got[0][1].numpy(), np.broadcast_to(v[1].mean(0), (N, D)),
                                   atol=ATOL)
    if case == "single-key":  # bag 0: that key's v row
        np.testing.assert_allclose(got[0][0].numpy(), np.broadcast_to(v[0, 437], (N, D)),
                                   atol=ATOL)


@pytest.mark.parametrize("pre_gate", GATES)
@pytest.mark.parametrize("m_len,case", MASKS)
def test_plain_backward_matches_pallas_vjp(m_len, case, pre_gate):
    """dq, dk, dv of the plain backward (and of the wrapper's CPU path) under
    cotangents on o, ssq and sumw against jax.vjp through coattention in
    interpret mode (its custom VJP: the backward Pallas kernel)."""
    (q, k, v), cot = _data(m_len, 50 + m_len + pre_gate)
    mask = _mask(m_len, case)
    mask_j = jnp.asarray(mask)

    def fj(q_, k_, v_):
        return jcoattn.coattention(q_, k_, v_, mask_j, pre_gate=pre_gate, need_ssq=True,
                                   need_sumw=True, block_k=m_len, interpret=True)

    _, vjp = jax.vjp(fj, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    args = [_t(x) for x in (q, k, v, mask)]
    seed = torch.zeros((1,), dtype=torch.int32)
    tcot = [_t(c) for c in cot]
    got = tcoattn.coattn_bwd_plain_k_plain(*args, seed, 0.0, *tcot, pre_gate=pre_gate)
    o, l, m, ssq, sumw = tcoattn.coattn_fwd_plain_k_plain(*args, seed, 0.0, pre_gate=pre_gate)
    di = (o * tcot[0]).sum(-1) + 2.0 * tcot[1] * ssq + tcot[2] * sumw
    wrapped = tcoattn.coattn_bwd_plain_k(*args, seed, 0.0, tcot[0], l, m, di, tcot[1], tcot[2],
                                         pre_gate=pre_gate)
    for name, a, w, r in zip(("dq", "dk", "dv"), got, wrapped, ref):
        _close_rel(a.numpy(), r, name)
        assert torch.equal(a, w), name
    masked = ~_t(mask)
    assert float(got[1][masked].abs().max()) == 0.0  # the mask is a where: no dk there


@pytest.mark.parametrize("pre_gate", GATES)
@pytest.mark.parametrize("m_len,case", [MASKS[0], MASKS[1], MASKS[3]])
def test_masked_rows_of_a_bag_with_a_valid_key_reach_nothing(m_len, case, pre_gate):
    """The premise of the kernels' skipped tiles: in a bag with a valid key,
    rewriting the masked k and v rows changes none of o, l, m, ssq, sumw and
    dq, bit for bit, at rate 0 and with dropout; dk and dv are exactly 0
    there."""
    (q, k, v), cot = _data(m_len, 90 + m_len + pre_gate)
    mask = _mask(m_len, case)
    assert mask.any(-1).all()
    rng = np.random.default_rng(m_len)
    k2, v2 = k.copy(), v.copy()
    k2[~mask] = (3.0 * rng.normal(size=k2[~mask].shape)).astype(np.float32)
    v2[~mask] = (3.0 * rng.normal(size=v2[~mask].shape)).astype(np.float32)
    seed = torch.tensor([7], dtype=torch.int32)
    tcot = [_t(c) for c in cot]
    for rate in (0.0, 0.25):
        outs = []
        for kk, vv in ((k, v), (k2, v2)):
            args = [_t(x) for x in (q, kk, vv, mask)]
            fwd = tcoattn.coattn_fwd_plain_k_plain(*args, seed, rate, pre_gate=pre_gate)
            grads = tcoattn.coattn_bwd_plain_k_plain(*args, seed, rate, *tcot, pre_gate=pre_gate)
            outs.append((fwd, grads))
        (fwd, grads), (fwd2, grads2) = outs
        for name, a, b in zip(("o", "l", "m", "ssq", "sumw"), fwd, fwd2):
            assert torch.equal(a, b), (rate, name)
        assert torch.equal(grads[0], grads2[0]), (rate, "dq")
        masked = ~_t(mask)
        for g in (grads, grads2):
            assert float(g[1][masked].abs().max()) == 0.0, (rate, "dk")
            assert float(g[2][masked].abs().max()) == 0.0, (rate, "dv")
