"""The two rules the K6 flash kernels (``csrc/flash.cu``, ``csrc/flash_bwd.cu``)
rest on, held in plain PyTorch on the CPU, where no kernel runs:

* 3xTF32: the kernels run their products on the tensor cores with each
  float32 operand split into big = tf32(x) and small = tf32(x - big)
  (``flash_common.cuh``). An emulation of that split, applied to the
  forward's two products (S = q k^T, O = P V) at every head width the kernels
  have (16 .. 512), stays within the on-card tolerance of the float32 plain
  forward (``chip_smoke.py`` GE_ATOL = 1e-4), and 1xTF32 (big x big alone)
  does not: that is the reason the kernels pay three products for one.
* Skipped key tiles: with at least one valid key in a bag, a key tile whose
  keys are all masked adds exactly 0 to every output, so the forward and the
  dq pass skip it and the dkv pass writes dk = dv = 0 for it. A tile-by-tile
  emulation that drops such tiles (and computes a bag without a valid key in
  full) matches the plain forward and backward within 1e-6 on ragged and
  scattered masks.

The emulations compute each product exactly (float64) from the rounded
operands, as the tensor cores multiply TF32 values exactly; the on-card
kernels add one rounding a step (``mma_group``), held by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_path_omic_tpu_torch.ops import flash  # noqa: E402
from multimodal_path_omic_tpu_torch.ops.layers import NEG_INF  # noqa: E402

CARD_ATOL = 1e-4  # chip_smoke.py GE_ATOL: the flash forward against its plain version
SKIP_ATOL = 1e-6
WIDTHS = (16, 32, 64, 128, 256, 512)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round a float32 to 10 mantissa bits, to nearest,
    ties away from zero (add half of the dropped 13 bits' range to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def emulated_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels' tensor-core products form it: 3 passes
    (a_big b_small + a_small b_big + a_big b_big) or 1 (a_big b_big), each
    product exact, the sum rounded once to float32."""
    ab, bb = tf32(a), tf32(b)
    out = ab.double() @ bb.double()
    if passes == 3:
        a_s, b_s = tf32(a - ab), tf32(b - bb)
        out = out + (ab.double() @ b_s.double() + a_s.double() @ bb.double())
    return out.float()


def emulated_forward(q, k, v, mask, passes: int):
    """The flash forward's math with both products emulated."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = emulated_matmul(q * scale, k.transpose(-1, -2), passes)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return emulated_matmul(p, v, passes) / p.sum(dim=-1, keepdim=True)


def _ge_inputs(b, heads, width, m_len, seed):
    """GE's scale (chip_smoke.py ge_flash_inputs): q of std 1.5, k and v of
    std 1, ragged masks, the last bag without a valid key."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(1.5 * rng.standard_normal((b, heads, m_len, width), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, heads, m_len, width), dtype=np.float32))
            for _ in range(2))
    lengths = rng.integers(m_len // 5, m_len + 1, size=b)
    lengths[-1] = 0
    return q, k, v, torch.from_numpy(np.arange(m_len)[None] < lengths[:, None])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 1.0 + 3 * 2.0 ** -11, -1.5 - 2.0 ** -12,
                      3.0e-39], dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -1.5, 0.0],
                        dtype=torch.float32)
    assert torch.equal(got[:5], want[:5])  # ties go away from zero
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # big + small carries 22 significant bits: 2^-22 relative at most
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = tf32(x)
    rest = (x.double() - big.double() - tf32(x - big).double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("width", WIDTHS)
def test_3xtf32_forward_stays_within_the_card_tolerance_and_1xtf32_does_not(width):
    heads = 8 if width <= 64 else 1
    q, k, v, mask = _ge_inputs(2, heads, width, 384, width)
    ref = flash.flash_attention_plain(q, k, v, mask)
    err3 = float((emulated_forward(q, k, v, mask, 3) - ref).abs().max())
    err1 = float((emulated_forward(q, k, v, mask, 1) - ref).abs().max())
    assert err3 < CARD_ATOL / 10, err3  # with room for the card's summation orders
    assert err1 > CARD_ATOL, err1


# ---------------------------------------------------------------------------
# Skipped key tiles
# ---------------------------------------------------------------------------


def _tiles_kept(mask_b, n_tiles, tile):
    """The key tiles a block walks: those with a valid key, or every tile in
    a bag without one."""
    if mask_b is None or not bool(mask_b.any()):
        return list(range(n_tiles))
    return [t for t in range(n_tiles) if bool(mask_b[t * tile:(t + 1) * tile].any())]


def skipping_forward(q, k, v, mask, tile=64):
    """The kernel's online softmax over the kept key tiles only: (out, m, l)."""
    b, h, n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    outs, ms, ls = [], [], []
    for bi in range(b):
        mask_b = None if mask is None else mask[bi]
        m_run = torch.full((h, n), -3.0e38)
        l_run = torch.zeros(h, n)
        o = torch.zeros(h, n, d)
        for t in _tiles_kept(mask_b, -(-n // tile), tile):
            keys = slice(t * tile, (t + 1) * tile)
            s = (q[bi] * scale) @ k[bi, :, keys].transpose(-1, -2)
            if mask_b is not None:
                s = torch.where(mask_b[keys], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + p @ v[bi, :, keys]
            m_run = m_new
        outs.append(o / l_run[..., None])
        ms.append(m_run)
        ls.append(l_run)
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


def skipping_backward(q, k, v, mask, out, m, l, dout, tile=64):
    """The dq pass over the kept key tiles; the dkv pass with every key
    block (of ``tile`` keys) that holds no valid key written as zeros."""
    b, h, n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    delta = (dout * out).sum(dim=-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for bi in range(b):
        mask_b = None if mask is None else mask[bi]
        for t in _tiles_kept(mask_b, -(-n // tile), tile):
            keys = slice(t * tile, (t + 1) * tile)
            s = (q[bi] * scale) @ k[bi, :, keys].transpose(-1, -2)
            valid = None if mask_b is None else mask_b[keys]
            if valid is not None:
                s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - m[bi][..., None]) / l[bi][..., None]
            ds = p * (dout[bi] @ v[bi, :, keys].transpose(-1, -2) - delta[bi][..., None])
            if valid is not None:
                ds = torch.where(valid, ds, torch.zeros_like(ds))
            dq[bi] += scale * ds @ k[bi, :, keys]
            # the dkv pass walks every query for a kept key block
            dv[bi, :, keys] = p.transpose(-1, -2) @ dout[bi]
            dk[bi, :, keys] = scale * ds.transpose(-1, -2) @ q[bi]
    return dq, dk, dv


def _masks(kind, b, m_len, rng):
    if kind == "none":
        return None
    if kind == "ragged":  # prefixes, the last bag without a valid key
        lengths = rng.integers(1, m_len + 1, size=b)
        lengths[-1] = 0
        return torch.from_numpy(np.arange(m_len)[None] < lengths[:, None])
    # scattered: random holes and long masked runs (whole tiles), one empty bag
    mask = rng.random((b, m_len)) > 0.3
    mask[:, 64:200] = False
    mask[0, 260:] = False
    mask[-1] = False
    return torch.from_numpy(mask)


@pytest.mark.parametrize("kind", ["ragged", "scattered", "none"])
def test_skipping_all_masked_key_tiles_changes_nothing(kind):
    rng = np.random.default_rng(3)
    b, h, n, d = 3, 2, 300, 16
    q = torch.from_numpy(1.5 * rng.standard_normal((b, h, n, d), dtype=np.float32))
    k, v, dout = (torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32))
                  for _ in range(3))
    mask = _masks(kind, b, n, rng)
    out, m, l = skipping_forward(q, k, v, mask)
    ref_out, ref_m, ref_l = flash.flash_attention_plain(q, k, v, mask, return_stats=True)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=SKIP_ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), ref_m.numpy(), atol=SKIP_ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), ref_l.numpy(), atol=0, rtol=SKIP_ATOL)
    grads = skipping_backward(q, k, v, mask, ref_out, ref_m, ref_l, dout)
    refs = flash.flash_attention_bwd_plain(q, k, v, mask, ref_out, ref_m, ref_l, dout)
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=SKIP_ATOL, rtol=0)
    if mask is not None:
        # the plain backward gives exactly 0 where the kernels write 0: dk and
        # dv of every key block without a valid key, in a bag with one
        for bi in range(b):
            if not bool(mask[bi].any()):
                continue
            for t in range(-(-n // 64)):
                keys = slice(t * 64, (t + 1) * 64)
                if not bool(mask[bi, keys].any()):
                    assert bool((refs[1][bi, :, keys] == 0).all())
                    assert bool((refs[2][bi, :, keys] == 0).all())
        if kind != "none":  # some tiles really were dropped
            assert any(len(_tiles_kept(mask[bi], -(-n // 64), 64)) < -(-n // 64)
                       for bi in range(b) if bool(mask[bi].any()))
