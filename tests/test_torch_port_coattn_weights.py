"""The port's attention-map export passes (``coattn_stats``, ``coattn_weights``
and ``coattention_weights``: their plain versions on the CPU, which the CUDA
kernels are held to on the card) against the JAX package's Pallas kernels in
interpret mode: ``_coattn_fwd_impl`` with zero values, as
``coattention_weights`` runs it for the (l, m) statistics, and
``coattention_weights`` itself, on the same numpy inputs. Each case runs with
and without the pre-gate (``pre_gate=False`` is MCAT's export form), at D in
{128, 256, 512} and N in {1, 6, 8}, on the masks the CUDA kernels' skipping
depends on: whole masked 64-key tiles in the middle of a bag, a bag with a
single valid key in the first tile and in a late one, a bag without a valid
key, and M a multiple of neither 64 nor 16 (and, once, not of 4).

It also pins the premises of the skipping: in a bag with a valid key,
rewriting the masked k rows changes nothing in l, m and w, bit for bit in the
port, and their w is exactly 0; in a bag without one, m = NEG, l = M and
w = 1/M whatever k holds; and the torch reference of the kernels' key-tile
list that the card's flag and list passes are held to.

Tolerances: 2e-5 absolute on m, with an added 2e-6 relative (about 17
float32 ulps): pre-gated at D = 512 the scores reach ~20, and a score that
sums 512 products of either sign is ~1.5e-6 of itself apart between two
summation orders (3.1e-5 absolute, measured), where the absolute 2e-5 alone
is 10 ulps. l with an added 1e-5 relative (a sum of up to M terms). w 2e-5
absolute and 1e-4 relative with a 1e-8 floor (``_close_w``'s rule: a row
sums to 1 over up to 1000 keys, so an absolute limit alone would pass
weights that were wrong, or 0, wherever they are small). Both sides compute
in float32 and sum in other orders. The JAX
kernels run one tile of M keys (M <= 1024), so they pad nothing and a bag
without a valid key is uniform over the same M keys on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402

ATOL = 2e-5
L_RTOL = 1e-5
M_RTOL = 2e-6
W_RTOL, W_ATOL = 1e-4, 1e-8
B = 2

# (M, mask kind): the kinds of _mask
MASKS = [
    pytest.param(640, "holes", id="masked-tiles-mid-bag"),
    pytest.param(500, "one-first-tile", id="single-key-first-tile"),
    pytest.param(1000, "one-late-tile", id="single-key-late-tile"),
    pytest.param(300, "no-valid-key", id="no-valid-key"),
    pytest.param(1000, "ragged-m", id="m-not-64-nor-16-multiple"),
    pytest.param(203, "odd-m", id="m-not-4-multiple"),
]
GATES = [pytest.param(False, id="plain"), pytest.param(True, id="pre-gate")]
D_VALUES = (128, 256, 512)
N_VALUES = (1, 6, 8)
# every D with every mask, N turning with both: each (D, N) pair meets
# several masks, and every case runs both gates
CASES = [
    pytest.param(m.values[0], m.values[1], d, N_VALUES[(i + j) % 3],
                 id=f"{m.id}-d{d}-n{N_VALUES[(i + j) % 3]}")
    for i, m in enumerate(MASKS) for j, d in enumerate(D_VALUES)
]


def _mask(m_len, kind):
    """[B, M] bool. holes: bag 0 valid on 0..600 but for keys 64..255 (three
    whole 64-key tiles), bag 1 on all but 128..191 and 400..463;
    one-first-tile: bag 0 valid on key 37 alone, bag 1 on 0..479;
    one-late-tile: bag 0 on key 937 alone (tile 14), bag 1 on all but
    256..511; no-valid-key: bag 0 on 0..249 but for 64..127, bag 1 on none;
    ragged-m: bag 0 on all but 128..255, bag 1 on 0..776; odd-m: bag 0 on
    all but 64..127, bag 1 on none."""
    mask = np.zeros((B, m_len), bool)
    if kind == "holes":
        mask[0, :601] = True
        mask[0, 64:256] = False
        mask[1] = True
        mask[1, 128:192] = False
        mask[1, 400:464] = False
    elif kind == "one-first-tile":
        mask[0, 37] = True
        mask[1, :480] = True
    elif kind == "one-late-tile":
        mask[0, 937] = True
        mask[1] = True
        mask[1, 256:512] = False
    elif kind == "no-valid-key":
        mask[0, :250] = True
        mask[0, 64:128] = False
    elif kind == "ragged-m":
        mask[0] = True
        mask[0, 128:256] = False
        mask[1, :777] = True
    else:  # odd-m
        mask[0] = True
        mask[0, 64:128] = False
    return mask


def _data(m_len, n, d, seed):
    rng = np.random.default_rng(seed)
    q = (0.7 * rng.normal(size=(B, n, d))).astype(np.float32)
    k = (0.7 * rng.normal(size=(B, m_len, d))).astype(np.float32)
    return q, k


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, ref, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL, rtol=rtol)


def _close_w(got, ref):
    _close(got, ref)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=W_ATOL, rtol=W_RTOL)


@pytest.mark.parametrize("pre_gate", GATES)
@pytest.mark.parametrize("m_len,kind,d,n", CASES)
def test_export_passes_match_pallas(m_len, kind, d, n, pre_gate):
    """l, m of coattn_stats against _coattn_fwd_impl with zero values over
    one tile of M keys; w of coattn_weights (from those l, m) and of
    coattention_weights against coattention_weights in interpret mode."""
    q, k = _data(m_len, n, d, 7 * m_len + d + n + pre_gate)
    mask = _mask(m_len, kind)
    qj, kj = jnp.asarray(q), jnp.asarray(k)
    _, l_j, m_j, _, _ = jcoattn._coattn_fwd_impl(
        qj, kj, jnp.zeros_like(kj), jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=pre_gate, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=False,
    )
    w_j = jcoattn.coattention_weights(qj, kj, jnp.asarray(mask), pre_gate=pre_gate,
                                      block_k=m_len, interpret=True)
    tq, tk, tm = _t(q), _t(k), _t(mask)
    l, m = tcoattn.coattn_stats(tq, tk, tm, pre_gate=pre_gate)
    _close(l, np.asarray(l_j)[:, 0], rtol=L_RTOL)
    _close(m, np.asarray(m_j)[:, 0], rtol=M_RTOL)
    w = tcoattn.coattn_weights(tq, tk, tm, l, m, pre_gate=pre_gate)
    assert w.shape == (B, n, m_len)
    _close_w(w, w_j)
    both = tcoattn.coattention_weights(tq, tk, tm, pre_gate=pre_gate)
    _close_w(both, w_j)
    assert torch.equal(both, w)
    for got in (l, m, w):
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("d", D_VALUES)
@pytest.mark.parametrize("pre_gate", GATES)
@pytest.mark.parametrize("m_len,kind", MASKS)
def test_masked_k_rows_reach_nothing(m_len, kind, pre_gate, d):
    """The premises of the kernels' skipping: rewriting the masked k rows
    changes none of l, m and w, bit for bit; in a bag with a valid key their
    w is exactly 0 (so a skipped tile's weights need no k); a bag without one
    has m = NEG, l = M and w = 1/M exactly (so its k is never read)."""
    n = 6
    q, k = _data(m_len, n, d, 3 * m_len + d + pre_gate)
    mask = _mask(m_len, kind)
    rng = np.random.default_rng(m_len + d)
    k2 = k.copy()
    k2[~mask] = (3.0 * rng.normal(size=k2[~mask].shape)).astype(np.float32)
    outs = []
    for kk in (k, k2):
        args = (_t(q), _t(kk), _t(mask))
        l, m = tcoattn.coattn_stats(*args, pre_gate=pre_gate)
        w = tcoattn.coattn_weights(*args, l, m, pre_gate=pre_gate)
        outs.append((l, m, w, tcoattn.coattention_weights(*args, pre_gate=pre_gate)))
    for name, a, b in zip(("l", "m", "w", "coattention_weights"), *outs):
        assert torch.equal(a, b), name
    l, m, w, _ = outs[0]
    has = mask.any(-1)
    masked = np.broadcast_to((~mask & has[:, None])[:, None, :], w.shape)
    assert float(w.numpy()[masked].max(initial=0.0)) == 0.0
    empty = ~has
    if empty.any():
        assert (l.numpy()[empty] == m_len).all()
        assert (m.numpy()[empty] == np.float32(tcoattn.NEG)).all()
        assert (w.numpy()[empty] == np.float32(1.0 / m_len)).all()


@pytest.mark.parametrize("lone", [pytest.param(False, id="every-tile"),
                                  pytest.param(True, id="lone-filler")])
@pytest.mark.parametrize("m_len,kind", MASKS)
def test_tile_list_reference(m_len, kind, lone):
    """``coattn_tiles_plain``, the reference the card's flag and list passes
    are held to, against a loop over the 64-key tiles: a tile is computed
    where it holds a valid key; a bag without one computes every tile or,
    ``lone``, is one unit at tile 0 with flag TILE_LONE; the list holds the
    computed units bag * T + tile in order and the offsets each bag's first
    position."""
    mask = _mask(m_len, kind)
    t = -(-m_len // tcoattn.FK_TILE)
    flags = np.zeros((B, t), np.uint8)
    for b in range(B):
        for i in range(t):
            tile = mask[b, i * tcoattn.FK_TILE:(i + 1) * tcoattn.FK_TILE]
            if not mask[b].any():
                flags[b, i] = (tcoattn.TILE_LONE if i == 0 else 0) if lone else 1
            else:
                flags[b, i] = tile.any()
    units = [b * t + i for b in range(B) for i in range(t) if flags[b, i]]
    offsets = [0]
    for b in range(B):
        offsets.append(offsets[-1] + int((flags[b] != 0).sum()))
    got = tcoattn.coattn_tiles(_t(mask), lone=lone)
    np.testing.assert_array_equal(got[0].numpy(), flags)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(units, np.int32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(offsets, np.int32))
    assert got[1].dtype == got[2].dtype == torch.int32
