"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrappers' input checks, and the GPU Predictor against the CPU
one. Marked ``cuda``; every test skips where no CUDA device is present.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -p no:cacheprovider

Tolerance 1e-4 absolute (l: plus 1e-5 relative): float32 on both sides in
other summation orders; an indexing or masking fault moves outputs by O(1).
Gradients (the training backward kernel, the training step) are held to 1e-4
of each tensor's largest magnitude: dwk and dbk are sums over B*M terms, so
their absolute rounding error grows with them.
The weights w are held relative to themselves (1e-4, floor 1e-8 absolute):
a row sums to 1 over up to 4096 keys, so an absolute 1e-4 would pass a kernel
that wrote 0 for every small weight; the scores differ by ~1e-5 absolute
between the two summation orders, which exp turns into ~1e-5 relative in w.
The GE kernels (gated-MIL pool, flash forward) are held to 1e-4 absolute on
pooled rows, raw scores and attention outputs (valid and pad rows alike):
outputs of magnitude ~1 in other summation orders move by ~1e-6 to 1e-5.
The flash backward's dq, dk, dv are held like the other gradients, to 1e-4 of
each tensor's largest magnitude, and two runs must agree bitwise.
The plain-K kernels with values are held like the fuse-K ones (1e-4 absolute
forward, gradients 1e-4 of each tensor's largest magnitude, two backward runs
bitwise equal); the row gather must equal ``index_select`` bit for bit.
The export passes are held like the other kernels (l 1e-5 relative, m 1e-4,
w as above), two runs bitwise equal, w exactly 0 at the masked keys of a bag
with a valid key and 1/M in a bag without one; the key-tile passes bit for
bit against their torch reference.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_path_omic_tpu_torch.ops import coattn, flash, gather, milpool  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402

pytestmark = pytest.mark.cuda
ATOL, L_RTOL = 1e-4, 1e-5
GRAD_RTOL = 1e-4
W_RTOL, W_ATOL = 1e-4, 1e-8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    from multimodal_path_omic_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _inputs(dev, b, n, e, m_len, f, seed):
    g = torch.Generator().manual_seed(seed)
    q = 0.7 * torch.randn(b, n, e, generator=g)
    kv = torch.relu(torch.randn(b, m_len, f, generator=g))
    wk = 0.7 * torch.randn(f, e, generator=g) / math.sqrt(f)
    bk = 0.1 * torch.randn(e, generator=g)
    k = 0.7 * torch.randn(b, m_len, e, generator=g)
    lengths = torch.randint(1, m_len + 1, (b,), generator=g)
    lengths[-1] = 0  # a fully-masked filler row
    mask = torch.arange(m_len)[None] < lengths[:, None]
    return [t.to(dev) for t in (q, kv, wk, bk, k, mask)]


def _close(got, ref, rtol=0.0, atol=ATOL):
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "b,n,e,m_len,f",
    [(2, 3, 128, 1000, 256), (4, 6, 256, 4096, 256), (3, 8, 256, 777, 1024), (1, 1, 256, 70, 256),
     (2, 6, 512, 4096, 512), (3, 8, 512, 777, 1024), (2, 3, 256, 1000, 80)],
)
def test_kernels_match_plain_on_card(dev, b, n, e, m_len, f):
    q, kv, wk, bk, k, mask = _inputs(dev, b, n, e, m_len, f, m_len)
    before = dict(coattn.LAUNCH_COUNTS)
    got = coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
    ref = coattn.coattn_fwd_fused_k_plain(q, kv, wk, bk, mask)
    for a, r, rtol in zip(got, ref, (0.0, L_RTOL, 0.0, 0.0)):
        _close(a, r, rtol)
    l, m = coattn.coattn_stats(q, k, mask)
    l_ref, m_ref = coattn.coattn_stats_plain(q, k, mask)
    _close(l, l_ref, L_RTOL)
    _close(m, m_ref)
    _close(coattn.coattn_weights(q, k, mask, l_ref, m_ref),
           coattn.coattn_weights_plain(q, k, mask, l_ref, m_ref), W_RTOL, W_ATOL)
    torch.cuda.synchronize()
    for k in ("coattn_fwd_fused_k", "coattn_stats", "coattn_weights"):
        assert coattn.LAUNCH_COUNTS[k] == before[k] + 1


def _export_inputs(dev, n, d, kind, seed):
    """Four bags: one full, one by ``kind`` (holes: keys 128..447 and 1024..1087
    masked, six whole 64-key tiles mid-bag, M = 1500; single-key: key 900
    alone, a late tile, M = 1500; ragged: 1000 of M = 1001 keys, no M a
    multiple of 4), one with a single valid key in its first tile (key 5),
    and a filler bag without a valid key."""
    g = torch.Generator().manual_seed(seed)
    m_len = 1001 if kind == "ragged" else 1500
    q = 0.7 * torch.randn(4, n, d, generator=g)
    k = 0.7 * torch.randn(4, m_len, d, generator=g)
    mask = torch.zeros(4, m_len, dtype=torch.bool)
    mask[0] = True
    if kind == "holes":
        mask[1] = True
        mask[1, 128:448] = False
        mask[1, 1024:1088] = False
    elif kind == "single-key":
        mask[1, 900] = True
    else:
        mask[1, :1000] = True
    mask[2, 5] = True
    return q.to(dev), k.to(dev), mask.to(dev)


@pytest.mark.parametrize("pre_gate", [False, True])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("d", [128, 256, 512])
@pytest.mark.parametrize("kind", ["holes", "single-key", "ragged"])
def test_export_kernels_match_plain_on_card(dev, kind, d, n, pre_gate):
    """The export passes (stats, weights, and both on one tile list through
    coattention_weights) against their plain versions: l 1e-5 relative, m
    1e-4, w 1e-4 relative (1e-8 floor); two runs bitwise equal; w exactly 0
    at the masked keys of a bag with a valid key, 1/M in the filler bag; one
    launch each a call."""
    q, k, mask = _export_inputs(dev, n, d, kind, d + n)
    m_len = mask.shape[1]
    before = dict(coattn.LAUNCH_COUNTS)
    l, m = coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)
    l_ref, m_ref = coattn.coattn_stats_plain(q, k, mask, pre_gate=pre_gate)
    w = coattn.coattn_weights(q, k, mask, l_ref, m_ref, pre_gate=pre_gate)
    torch.cuda.synchronize()
    assert coattn.LAUNCH_COUNTS["coattn_stats"] == before["coattn_stats"] + 1
    assert coattn.LAUNCH_COUNTS["coattn_weights"] == before["coattn_weights"] + 1
    _close(l, l_ref, L_RTOL)
    _close(m, m_ref)
    w_ref = coattn.coattn_weights_plain(q, k, mask, l_ref, m_ref, pre_gate=pre_gate)
    _close(w, w_ref, W_RTOL, W_ATOL)
    both = coattn.coattention_weights(q, k, mask, pre_gate=pre_gate)
    _close(both, w_ref, W_RTOL, W_ATOL)
    l2, m2 = coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)
    assert torch.equal(l, l2) and torch.equal(m, m2)
    assert torch.equal(w, coattn.coattn_weights(q, k, mask, l_ref, m_ref, pre_gate=pre_gate))
    masked = (~mask[:3])[:, None, :].expand(3, n, m_len)
    assert float(w[:3][masked].abs().max()) == 0.0
    assert float(both[:3][masked].abs().max()) == 0.0
    assert bool((w[3] == 1.0 / m_len).all()) and bool((both[3] == 1.0 / m_len).all())
    assert bool((l[3] == m_len).all())


@pytest.mark.parametrize("kind", ["holes", "single-key", "ragged"])
def test_tile_passes_match_reference_on_card(dev, kind):
    """The key-tile flag and list passes, bit for bit against their torch
    reference, as the fuse-K and plain-K kernels run them and with lone
    filler bags (the export passes)."""
    _, _, mask = _export_inputs(dev, 1, 128, kind, 0)
    for lone in (False, True):
        got = coattn.coattn_tiles(mask, lone=lone)
        ref = coattn.coattn_tiles_plain(mask, lone=lone)
        for a, r in zip(got, ref):
            assert torch.equal(a, r), lone


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, kv, wk, bk, k, mask = _inputs(dev, 2, 3, 256, 256, 256, 0)
    with pytest.raises(ValueError, match="queries"):  # past MAX_PLAIN_QUERIES
        coattn.coattn_stats(torch.zeros(2, 257, 256, device=dev), k, mask)
    with pytest.raises(TypeError):
        coattn.coattn_stats(q.double(), k.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattn_stats(q, k.transpose(1, 2).contiguous().transpose(1, 2), mask)
    with pytest.raises(ValueError, match="unsupported"):
        coattn.coattn_fwd_fused_k(torch.zeros(2, 3, 64, device=dev), kv, wk[:, :64].contiguous(),
                                  bk[:64].contiguous(), mask)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattn_stats(q, k.cpu(), mask)


@pytest.mark.parametrize("loss", ["ces", "cesar"])
def test_predictor_on_card_matches_cpu(dev, loss):
    rng = np.random.default_rng(0)
    sizes = (10, 20, 30)
    bags = [rng.standard_normal((n, 256), dtype=np.float32) for n in (300, 900, 450)]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in sizes] for _ in bags]
    kw = dict(omic_sizes=sizes, model_size="small", wsi_dim=256, buckets=(512, 1024),
              batch_size=2, loss=loss, seed=3)
    coattn.reset_launch_counts()
    got = Predictor(device=dev, **kw).predict_bags(bags, omics)
    counts = dict(coattn.LAUNCH_COUNTS)
    ref = Predictor(device="cpu", **kw).predict_bags(bags, omics)
    for key in ("hazards", "survs", "y", "risk"):
        np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0)
    if loss == "ces":
        assert counts["coattn_fwd_fused_k"] == 2 and counts["coattn_stats"] == 0
    else:
        assert counts["coattn_stats"] == 2 and counts["coattn_weights"] == 2


def _close_rel(got, ref, rtol=GRAD_RTOL):
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= rtol * ref.abs().max()


def _close_fk_grads(grads, ref, q, kv, wk, bk, mask, fwd, dout, dssq, dsumw, di):
    """dq, dkv, dwk, dbk against the plain backward's. In a bag with one valid
    key that key's weight is 1 and o = pd kv_r, so ds = pd dp - p di +
    2 dssq pd^2 + dsumw pd is 0 in exact arithmetic, and so are the bag's dq
    and dk (its dkv keeps pd^T dO): both sides hold float32 noise alone,
    which a bound relative to the tensor's own largest value cannot compare.
    There dq is held to 1e-4 of the terms that cancel, c_n = |o_n.dO_n| +
    |di_n| + 2 |dssq_n ssq_n| + |dsumw_n sumw_n|, times the largest factor ds
    meets on its way to dq (scale |k|max + |a|max / 2, |a| bounded by
    scale |q_n|_1 |k|max); those bags' dk, bounded the same way, adds its
    share to the limits of dwk (times |kv|max) and dbk. Every other bag, and
    dkv, to 1e-4 of the tensor's largest value, as before."""
    o, _, _, ssq, sumw = fwd
    scale = q.shape[-1] ** -0.5
    one = mask.sum(-1) == 1
    kmax = (torch.matmul(kv, wk) + bk).abs().amax((1, 2))  # [B]
    c = (o * dout).sum(-1).abs() + di.abs() + 2 * (dssq * ssq).abs() + (dsumw * sumw).abs()
    amax = scale * q.abs().sum(-1) * kmax[:, None]  # [B, N]
    floor_dq = GRAD_RTOL * c * (scale * kmax[:, None] + amax / 2)  # [B, N]
    floor_dk = torch.where(one, GRAD_RTOL * (c * (scale * q.abs().amax(-1) + amax / 2)).sum(-1), 0.0)
    floors = ((floor_dk * kv.abs().amax((1, 2))).sum(), floor_dk.sum())
    dq, dkv, dwk, dbk = grads
    for a in (dq, dkv, dwk, dbk):
        assert torch.isfinite(a).all()
    if bool(one.any()):
        limit = floor_dq[one][..., None]
        assert bool((dq[one].abs() <= limit).all()) and bool((ref[0][one].abs() <= limit).all())
    _close_rel(dq[~one], ref[0][~one])
    _close_rel(dkv, ref[1])
    for a, r, floor in zip((dwk, dbk), ref[2:], floors):
        assert (a - r).abs().max() <= GRAD_RTOL * r.abs().max() + floor


def _training_mask(dev, b, m_len, kind, seed):
    """prefix: ragged lengths from 1, the last bag without a valid key;
    holes: the same with keys 64..191 (two whole 64-key tiles) and 300..399
    masked in every bag; one: bag 0 with a single valid key late in the bag
    (1337 of 1500), bag 1 ragged, the last without a valid key."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, m_len + 1, (b,), generator=g)
    lengths[-1] = 0
    mask = torch.arange(m_len)[None] < lengths[:, None]
    if kind == "holes":
        mask[:, 64:192] = False
        mask[:, 300:400] = False
    elif kind == "one":
        mask[0] = False
        mask[0, min(1337, m_len - 1)] = True
    return mask.to(dev)


@pytest.mark.parametrize(
    "b,n,e,f,m_len,rate,kind",
    [(2, 3, 128, 128, 1000, 0.25, "prefix"), (4, 6, 256, 256, 4096, 0.25, "prefix"),
     (3, 8, 128, 256, 333, 0.0, "prefix"), (1, 1, 256, 128, 70, 0.5, "prefix"),
     (3, 6, 256, 256, 4000, 0.25, "holes"), (2, 6, 128, 256, 1000, 0.0, "holes"),
     (3, 6, 256, 256, 1500, 0.25, "one"), (3, 6, 256, 128, 1, 0.25, "prefix"),
     (2, 8, 256, 256, 4001, 0.25, "prefix"), (4, 6, 256, 256, 8192, 0.25, "holes"),
     (3, 6, 128, 128, 1500, 0.25, "one"), (2, 8, 256, 128, 3000, 0.0, "holes"),
     (3, 6, 512, 512, 4000, 0.25, "holes"), (2, 6, 512, 512, 1500, 0.25, "one"),
     (2, 8, 512, 512, 777, 0.0, "prefix")],
)
def test_training_kernels_match_plain_on_card(dev, b, n, e, f, m_len, rate, kind):
    """The training forward (dropout, ssq, sumw, l, m) and the backward
    against their plain versions, on prefix masks, masks with whole masked
    key tiles in the middle of a bag (skipped by the backward), a bag with a
    single valid key, M = 1 and M not a multiple of the 64-key tile; dkv is
    exactly 0 at masked keys of bags with a valid key; two backward runs
    agree bitwise."""
    q, kv, wk, bk, _, _ = _inputs(dev, b, n, e, m_len, f, m_len)
    mask = _training_mask(dev, b, m_len, kind, m_len + 1)
    seed = torch.tensor([m_len * 7 + 1], dtype=torch.int32, device=dev)
    before = dict(coattn.LAUNCH_COUNTS)
    got = coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, rate)
    ref = coattn.coattn_fwd_fused_k_train_plain(q, kv, wk, bk, mask, seed, rate)
    for a, r, rtol in zip(got, ref, (0.0, L_RTOL, 0.0, 0.0, 0.0)):
        _close(a, r, rtol)
    o, l, m, ssq, sumw = got
    g = torch.Generator().manual_seed(m_len)
    dout = torch.randn(b, n, f, generator=g).to(dev)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    di = (o * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, kv, wk, bk, mask, seed, rate, dout, l, m, di, dssq, dsumw)
    grads = coattn.coattn_bwd_fused_k(*args)
    again = coattn.coattn_bwd_fused_k(*args)
    ref = coattn.coattn_bwd_fused_k_plain(q, kv, wk, bk, mask, seed, rate, dout, dssq, dsumw)
    _close_fk_grads(grads, ref, q, kv, wk, bk, mask, got, dout, dssq, dsumw, di)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    has = mask.any(-1)
    assert bool((grads[1][has][~mask[has]] == 0).all())
    torch.cuda.synchronize()
    assert coattn.LAUNCH_COUNTS["coattn_fwd_fused_k_train"] == before["coattn_fwd_fused_k_train"] + 1
    assert coattn.LAUNCH_COUNTS["coattn_bwd_fused_k"] == before["coattn_bwd_fused_k"] + 2


@pytest.mark.parametrize("sms", [1, 7])
def test_fused_k_backward_grid_does_not_change_the_gradients(dev, monkeypatch, sms):
    """The backward's main pass shares the computed key tiles out over one
    block an SM, its dwk pass over SM / (dwk tiles) blocks, and a reduction
    sums their partials: with one block (one dq partial a bag, one dwk and
    dbk partial) or 7 (bags split at other places) the gradients agree with
    the full grid's and with the plain version's."""
    b, n, e, f, m_len = 4, 6, 256, 256, 3000
    q, kv, wk, bk, _, _ = _inputs(dev, b, n, e, m_len, f, 3)
    mask = _training_mask(dev, b, m_len, "holes", 4)
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    o, l, m, ssq, sumw = coattn.coattn_fwd_fused_k_train_plain(q, kv, wk, bk, mask, seed, 0.25)
    g = torch.Generator().manual_seed(6)
    dout = torch.randn(b, n, f, generator=g).to(dev)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    di = (o * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, kv, wk, bk, mask, seed, 0.25, dout, l, m, di, dssq, dsumw)
    full = coattn.coattn_bwd_fused_k(*args)
    from multimodal_path_omic_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "sm_count", lambda device: sms)
    few = coattn.coattn_bwd_fused_k(*args)
    ref = coattn.coattn_bwd_fused_k_plain(q, kv, wk, bk, mask, seed, 0.25, dout, dssq, dsumw)
    assert torch.equal(few[1], full[1])  # dkv is per key: the grid does not touch it
    for a, r, x in zip(few, ref, full):
        _close_rel(a, r)
        _close_rel(a, x)


def test_leank_training_form_gradients_on_card(dev):
    """fused_attention_leank with dropout and ssq (the autograd Function over
    both kernels) against autograd through the plain training form."""
    q, kv, wk, bk, _, mask = _inputs(dev, 3, 6, 256, 900, 256, 5)
    seed = torch.tensor([11], dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(3)
    w_o = torch.randn(3, 6, 256, generator=g).to(dev)
    w_s, w_w = (torch.randn(3, 6, generator=g).to(dev) for _ in range(2))
    grads = []
    for fn in ("kernel", "plain"):
        ins = [t.clone().requires_grad_(True) for t in (q, kv, wk, bk)]
        if fn == "kernel":
            o, ssq, sumw = coattn.fused_attention_leank(
                *ins, mask, dropout_rate=0.25, dropout_seed=seed, need_ssq=True, need_sumw=True)
        else:
            o, _, _, ssq, sumw = coattn.coattn_fwd_fused_k_train_plain(*ins, mask, seed, 0.25)
        ((o * w_o).sum() + (ssq * w_s).sum() + (sumw * w_w).sum()).backward()
        grads.append([t.grad for t in ins])
    for a, r in zip(*grads):
        _close_rel(a, r)


@pytest.mark.parametrize("e,f,kind", [(128, 128, "holes"), (256, 256, "one"), (256, 128, "prefix")])
def test_fused_k_eval_and_training_forms_agree_at_dropout_0(dev, e, f, kind):
    """The two forms share one kernel (a template flag): at dropout 0 the
    training form's o, l, m and sumw are the eval form's, within 1e-4."""
    b, n, m_len = 3, 6, 1500
    q, kv, wk, bk, _, _ = _inputs(dev, b, n, e, m_len, f, 21)
    mask = _training_mask(dev, b, m_len, kind, 22)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    ev = coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
    o, l, m, _, sumw = coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, 0.0)
    for a, r, rtol in zip((o, l, m, sumw), ev, (0.0, L_RTOL, 0.0, 0.0)):
        _close(a, r, rtol)


@pytest.mark.parametrize("e,f,kind", [(256, 256, "holes"), (512, 512, "prefix"),
                                      (512, 1024, "one"), (128, 256, "one")])
def test_fused_k_forward_runs_agree_bitwise(dev, e, f, kind):
    """Each form run twice gives the same bits: every block writes its
    partials at fixed places and the merge sums them in block order."""
    b, n, m_len = 4, 6, 3000
    q, kv, wk, bk, _, _ = _inputs(dev, b, n, e, m_len, f, 31)
    mask = _training_mask(dev, b, m_len, kind, 32)
    runs = [coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    if (e, f) in coattn.FUSED_K_TRAIN_EF:
        seed = torch.tensor([9], dtype=torch.int32, device=dev)
        runs = [coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, 0.25) for _ in range(2)]
        assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize("e,f", [(256, 256), (512, 512), (128, 1024)])
@pytest.mark.parametrize("key", [3, 1337])
def test_fused_k_one_valid_key_pools_its_row(dev, e, f, key):
    """A bag whose only valid key lies in the first tile (key 3) or a late one
    (1337 of 2000): every other tile is skipped, the key's weight is 1, so o
    is that key's kv row, l is 1 and sumw is 1, within 1e-4."""
    b, n, m_len = 2, 6, 2000
    q, kv, wk, bk, _, _ = _inputs(dev, b, n, e, m_len, f, 41)
    mask = torch.zeros(b, m_len, dtype=torch.bool, device=dev)
    mask[0, key] = True
    mask[1, : m_len // 2] = True
    forms = [coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)]
    if (e, f) in coattn.FUSED_K_TRAIN_EF:
        seed = torch.zeros((1,), dtype=torch.int32, device=dev)
        o, l, m, _, sumw = coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, 0.0)
        forms.append((o, l, m, sumw))
    for o, l, _, sumw in forms:
        _close(o[0], kv[0, key].expand(n, f))
        _close(l[0], torch.ones_like(l[0]))
        _close(sumw[0], torch.ones_like(sumw[0]))


def test_training_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """(E, F) = (256, 512) and (512, 256) have no instance and raise; E = F =
    512 (NaCAGaT big) runs."""
    q, kv, wk, bk, _, mask = _inputs(dev, 2, 3, 256, 256, 256, 0)
    seed = torch.tensor([1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        coattn.coattn_fwd_fused_k_train(q, torch.zeros(2, 256, 512, device=dev),
                                        torch.zeros(512, 256, device=dev), bk, mask, seed, 0.25)
    q5 = torch.zeros(2, 3, 512, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        coattn.coattn_fwd_fused_k_train(q5, kv, torch.zeros(256, 512, device=dev),
                                        torch.zeros(512, device=dev), mask, seed, 0.25)
    kv5, wk5, b5 = (torch.zeros(s, device=dev) for s in ((2, 256, 512), (512, 512), (512,)))
    o = coattn.coattn_fwd_fused_k_train(q5, kv5, wk5, b5, mask, seed, 0.25)[0]
    assert o.shape == (2, 3, 512)
    with pytest.raises(TypeError):
        coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed.long(), 0.25)
    with pytest.raises(ValueError, match="rate"):
        coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed.cpu(), 0.25)


def test_train_step_on_card_matches_cpu(dev):
    """Three SGD steps of a small NaCAGaT (dropout 0, cesar) on the card and
    on the CPU from the same weights: the same parameters, the training
    kernels launched once each per step."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    rng = np.random.default_rng(0)
    sizes, m_len = (10, 20, 30), 700
    host = {
        "wsi": rng.standard_normal((4, m_len, 256), dtype=np.float32),
        "mask": np.arange(m_len)[None] < np.array([700, 500, 90, 0])[:, None],
        "omics": [rng.standard_normal((4, s), dtype=np.float32) for s in sizes],
        "label": np.array([0, 1, 2, 3]), "censorship": np.array([0.0, 1.0, 0.0, 1.0], np.float32),
        "weight": np.array([1.0, 1.0, 1.0, 0.0], np.float32),
    }
    params = {}
    for device in (dev, torch.device("cpu")):
        model = seeded_init_(build_model("NaCAGaT", omic_sizes=sizes, model_size="small",
                                         dropout=0.0, wsi_dim=256), 0).to(device)
        opt = make_optimizer("sgd", 0.1)
        state, step = init_train_state(model, opt, 0), make_train_step(model, "cesar", opt)
        batch = {k: ([torch.from_numpy(o).to(device) for o in v] if k == "omics"
                     else torch.from_numpy(v).to(device)) for k, v in host.items()}
        coattn.reset_launch_counts()
        for _ in range(3):
            state, metrics = step(state, batch)
        assert np.isfinite(float(metrics.loss))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert coattn.LAUNCH_COUNTS["coattn_fwd_fused_k_train"] == 3
            assert coattn.LAUNCH_COUNTS["coattn_bwd_fused_k"] == 3
        params[device.type] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for k, v in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][k].numpy(), v.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# GE-NaCAGaT serving: the gated-MIL pool and the flash forward
# ---------------------------------------------------------------------------


def _pool_inputs(dev, b, m_len, d, h, seed, masked=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, m_len, d, generator=g)
    wa, wb = (torch.randn(d, h, generator=g) / math.sqrt(d) for _ in range(2))
    ba, bb = (0.1 * torch.randn(h, generator=g) for _ in range(2))
    wc, bc = 0.25 * torch.randn(h, 1, generator=g), 0.1 * torch.randn(1, generator=g)
    mask = None
    if masked:
        lengths = torch.randint(1, m_len + 1, (b,), generator=g)
        lengths[-1] = 0  # a fully-masked filler bag
        mask = (torch.arange(m_len)[None] < lengths[:, None]).to(dev)
    return [x.to(dev), mask] + [t.to(dev) for t in (wa, ba, wb, bb, wc, bc)]


@pytest.mark.parametrize(
    "b,m_len,d,h,masked",
    [(2, 1000, 128, 128, True), (8, 4096, 256, 256, True), (3, 777, 512, 384, True),
     (2, 300, 1024, 128, True), (1, 70, 256, 256, True), (4, 2000, 256, 256, False),
     (140, 130, 128, 128, True)],
)
def test_mil_pool_kernel_matches_plain_on_card(dev, b, m_len, d, h, masked):
    args = _pool_inputs(dev, b, m_len, d, h, m_len + d, masked)
    before = milpool.LAUNCH_COUNTS["milpool"]
    pooled, scores = milpool.fused_gated_mil_pool(*args)
    pooled_ref, scores_ref = milpool.gated_mil_pool_plain(*args)
    _close(pooled, pooled_ref)
    _close(scores, scores_ref)  # raw, pad positions included
    if masked:  # the filler bag pools uniformly over its M patches
        _close(pooled[-1], args[0][-1].mean(dim=0))
    # the module's transposed torch weights (strided views) give the same
    x, mask, wa, ba, wb, bb, wc, bc = args
    again = milpool.fused_gated_mil_pool(x, mask, wa.t().contiguous().t(), ba,
                                         wb.t().contiguous().t(), bb, wc, bc)
    assert torch.equal(again[0], pooled) and torch.equal(again[1], scores)
    torch.cuda.synchronize()
    assert milpool.LAUNCH_COUNTS["milpool"] == before + 2


def _flash_inputs(dev, b, heads, width, m_len, seed, packed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    e = heads * width
    qkv = torch.randn(b, m_len, 3 * e, generator=g)
    qkv[..., :e] *= 1.5
    qkv = qkv.to(dev).to(dtype)
    q, k, v = (t.reshape(b, m_len, heads, width).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    lengths = torch.randint(1, m_len + 1, (b,), generator=g)
    if b > 1:
        lengths[-1] = 0  # no valid key
    return q, k, v, (torch.arange(m_len)[None] < lengths[:, None]).to(dev)


def _close_flash_grads(grads, ref, q, k, mask, out, dout, sm_scale):
    """dq, dk, dv against the plain backward's. In a bag with one valid key
    every weight is 0 or 1, so dq and dk are 0 in exact arithmetic: ds =
    p (dp - delta) with dp = delta, and both sides hold float32 noise alone,
    which a bound relative to the tensor's own largest value cannot compare.
    There dq and dk are held to 1e-4 of the terms that cancel (sm_scale
    |delta_i| |k| for a dq row, the sum over query rows i of sm_scale
    |delta_i| |q_i| for dk); every other bag to 1e-4 of the tensor's largest
    value, as before."""
    one = (torch.zeros(q.shape[0], dtype=torch.bool, device=q.device) if mask is None
           else mask.sum(-1) == 1)
    delta = (dout * out).sum(-1).abs()  # [B, H, L]
    floor_dq = GRAD_RTOL * sm_scale * delta.amax(-1) * k.abs().amax((-2, -1))  # [B, H]
    floor_dk = GRAD_RTOL * sm_scale * (delta[..., None] * q.abs()).sum(-2).amax(-1)  # [B, H]
    for a, r, floor in zip(grads, ref, (floor_dq, floor_dk, None)):
        assert torch.isfinite(a).all()
        if floor is not None and bool(one.any()):
            limit = floor[one][..., None, None]
            assert bool((a[one].abs() <= limit).all()) and bool((r[one].abs() <= limit).all())
            a, r = a[~one], r[~one]
        if a.numel():
            _close_rel(a, r)


@pytest.mark.parametrize(
    "b,heads,width,m_len,packed",
    [(2, 1, 256, 1000, True), (3, 8, 32, 777, True), (1, 1, 256, 70, False),
     (2, 8, 32, 4096, False), (2, 1, 256, 4096, True), (1, 8, 32, 1, True), (2, 2, 32, 129, True),
     (2, 1, 128, 1000, True), (3, 8, 16, 777, True), (2, 1, 512, 1000, True),
     (3, 8, 64, 777, False), (1, 2, 512, 70, True), (2, 4, 64, 129, True)],
)
def test_flash_kernel_matches_plain_on_card(dev, b, heads, width, m_len, packed):
    q, k, v, mask = _flash_inputs(dev, b, heads, width, m_len, m_len + heads, packed)
    name = f"flash_fwd_d{width}"
    before = flash.LAUNCH_COUNTS[name]
    out = flash.flash_attention(q, k, v, mask)
    ref = flash.flash_attention_plain(q, k, v, mask, chunk=512)
    assert out.shape == ref.shape
    _close(out, ref)  # every query row, pad rows too
    if b > 1:  # the uniform mean of v
        _close(out[-1], v[-1].mean(dim=1, keepdim=True).expand_as(out[-1]))
    _close(flash.flash_attention(q, k, v, None), flash.flash_attention_plain(q, k, v, None))
    _close(flash.flash_attention(q, k, v, mask, sm_scale=0.05),
           flash.flash_attention_plain(q, k, v, mask, sm_scale=0.05))
    # merging the heads of the result is a view: [B, L, H, D] underneath
    assert out.transpose(1, 2).is_contiguous()
    torch.cuda.synchronize()
    assert flash.LAUNCH_COUNTS[name] == before + 3


def test_ge_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, mask = _flash_inputs(dev, 2, 8, 32, 100, 0, True)
    with pytest.raises(ValueError, match="unsupported head width"):  # no instance for 24
        flash.flash_attention(q[..., :24], k[..., :24], v[..., :24], mask)
    with pytest.raises(TypeError):
        flash.flash_attention(q.double(), k.double(), v.double(), mask)
    with pytest.raises(ValueError, match="stride"):
        flash.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k.cpu(), v, mask)
    with pytest.raises(ValueError, match="key_mask"):
        flash.flash_attention(q, k, v, mask[:, :50])
    with pytest.raises(ValueError, match="unsupported head width"):  # in training too
        flash.flash_attention(q[..., :24].clone().requires_grad_(True), k[..., :24], v[..., :24],
                              mask)
    args = _pool_inputs(dev, 2, 100, 256, 256, 0)
    with pytest.raises(ValueError, match="unsupported"):
        milpool.fused_gated_mil_pool(args[0][..., :250].contiguous(), args[1],
                                     args[2][:250].contiguous(), *args[3:])
    with pytest.raises(ValueError, match="unsupported"):  # H not a multiple of 128
        milpool.fused_gated_mil_pool(args[0], args[1], args[2][:, :64], args[3][:64],
                                     args[4][:, :64], args[5][:64], args[6][:64], args[7])
    with pytest.raises(TypeError):
        milpool.fused_gated_mil_pool(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="wa"):
        milpool.fused_gated_mil_pool(args[0], args[1], args[2].cpu(), *args[3:])
    with pytest.raises(NotImplementedError, match="no backward"):
        milpool.fused_gated_mil_pool(args[0].clone().requires_grad_(True), *args[1:])


def test_ge_predictor_on_card_matches_cpu(dev):
    """GE-NaCAGaT medium (the widths the flash kernel takes) on short bags:
    three flash launches and one pool launch per batch, y as on the CPU."""
    rng = np.random.default_rng(0)
    bags = [rng.standard_normal((n, 64), dtype=np.float32) for n in (300, 900, 450)]
    kw = dict(model_size="medium", wsi_dim=64, buckets=(512, 1024), batch_size=2, seed=3)
    for mod in (coattn, flash, milpool):
        mod.reset_launch_counts()
    pred = Predictor("GE-NaCAGaT", device=dev, **kw)
    got = pred.predict_bags(bags)
    torch.cuda.synchronize()
    assert flash.LAUNCH_COUNTS == {**{name: 0 for name in flash.LAUNCH_COUNTS},
                                   "flash_fwd_d256": 2, "flash_fwd_d32": 4}
    assert milpool.LAUNCH_COUNTS["milpool"] == 2
    assert not any(coattn.LAUNCH_COUNTS.values())
    cpu = Predictor("GE-NaCAGaT", device="cpu", **kw)
    ref = cpu.predict_bags(bags)
    assert set(got) == {"y"}
    np.testing.assert_allclose(got["y"], ref["y"], atol=ATOL, rtol=0)
    # the raw MIL scores of an eval step carry every layer's output
    wsi = torch.zeros(2, 512, 64)
    mask = torch.zeros(2, 512, dtype=torch.bool)
    for row, i in enumerate((0, 2)):
        wsi[row, :len(bags[i])] = torch.from_numpy(bags[i])
        mask[row, :len(bags[i])] = True
    scores = []
    for p in (pred, cpu):
        out = p.eval_step({"wsi": wsi.to(p.device), "mask": mask.to(p.device),
                           "label": torch.zeros(2, dtype=torch.long, device=p.device),
                           "weight": torch.ones(2, device=p.device)})
        scores.append(out["attention"]["path"][:, 0].cpu())
    np.testing.assert_allclose(scores[0][mask].numpy(), scores[1][mask].numpy(), atol=ATOL, rtol=0)


def test_ge_widths_without_a_kernel_instance_raise_on_card(dev):
    """GE small (heads of width 128 and 16) and big (512 and 64) once had no
    flash instance and raised on the card; every GE width has one now, so
    this holds them against the CPU: y within 1e-4, through the flash
    kernels of their own widths and no other."""
    rng = np.random.default_rng(1)
    bags = [rng.standard_normal((n, 64), dtype=np.float32) for n in (40, 300, 250)]
    for size, widths in (("small", (128, 16)), ("big", (512, 64))):
        kw = dict(model_size=size, wsi_dim=64, buckets=(64, 512), batch_size=2, seed=2)
        flash.reset_launch_counts()
        got = Predictor("GE-NaCAGaT", device=dev, **kw).predict_bags(bags)
        torch.cuda.synchronize()
        # bucket 64 holds one bag (40 > 32 positions: flash), bucket 512 two
        assert flash.LAUNCH_COUNTS == {**{name: 0 for name in flash.LAUNCH_COUNTS},
                                       f"flash_fwd_d{widths[0]}": 2,
                                       f"flash_fwd_d{widths[1]}": 4}
        ref = Predictor("GE-NaCAGaT", device="cpu", **kw).predict_bags(bags)
        np.testing.assert_allclose(got["y"], ref["y"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("heads,width", [(1, 256), (8, 32), (1, 128), (8, 16), (1, 512), (8, 64)])
def test_flash_kernels_skip_masked_key_tiles_on_card(dev, heads, width):
    """Masks with whole key tiles masked (runs of valid keys between long
    masked runs) and a bag without a valid key: forward, (m, l) and the
    backward against the plain versions; dk and dv exactly 0 on every key of
    a skipped block, dq and dk exactly 0 through every masked key."""
    b, m_len = 3, 1500
    q, k, v, _ = _flash_inputs(dev, b, heads, width, m_len, width, True)
    mask = torch.zeros(b, m_len, dtype=torch.bool)
    mask[:, 5:60] = True
    mask[:, 700:790] = True
    mask[0, 1300:] = True
    mask[-1] = False
    mask = mask.to(dev)
    out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
    ref_out, ref_m, ref_l = flash.flash_attention_plain(q, k, v, mask, return_stats=True)
    _close(out, ref_out)
    _close(m, ref_m)
    _close(l, ref_l, L_RTOL)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    grads = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
    for a, r in zip(grads, flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout)):
        _close_rel(a, r)
    dq, dk, dv = grads
    assert float(dk[~mask[:, None, :, None].expand_as(dk)].abs().max()) == 0.0
    assert float(dv[:2, :, 900:1300].abs().max()) == 0.0  # keys masked in both bags
    assert float(dq[-1].abs().max()) == 0.0 and float(dv[-1].abs().max()) > 0.0


@pytest.mark.parametrize("heads,width", [(1, 256), (8, 32), (1, 128), (8, 16), (1, 512), (8, 64)])
def test_flash_kernels_one_valid_key_on_card(dev, heads, width):
    """Bags with one valid key among 1500 (the first key; a key in a late
    tile) and a bag without one: every other key tile is skipped, the output
    is the key's value row on every query row, dv on the key is the sum of
    the cotangent over the query rows and exactly 0 on every other key, dk
    exactly 0 on the masked keys, and the rest against the plain versions."""
    b, m_len, keys = 3, 1500, (0, 1337)
    q, k, v, _ = _flash_inputs(dev, b, heads, width, m_len, width + 1, True)
    mask = torch.zeros(b, m_len, dtype=torch.bool)
    for i, key in enumerate(keys):
        mask[i, key] = True
    mask = mask.to(dev)
    out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
    for i, key in enumerate(keys):
        _close(out[i], v[i, :, key:key + 1].expand_as(out[i]))
    ref_out, ref_m, ref_l = flash.flash_attention_plain(q, k, v, mask, return_stats=True)
    _close(out, ref_out)
    _close(m, ref_m)
    _close(l, ref_l, L_RTOL)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev)
    grads = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
    ref = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout)
    _close_flash_grads(grads, ref, q, k, mask, out, dout, width ** -0.5)
    dq, dk, dv = grads
    assert float(dk[~mask[:, None, :, None].expand_as(dk)].abs().max()) == 0.0
    for i, key in enumerate(keys):
        _close_rel(dv[i, :, key], dout[i].sum(dim=1))
        assert float(dv[i, :, :key].abs().sum() + dv[i, :, key + 1:].abs().sum()) == 0.0


def test_refused_coattention_shapes_on_card_match_cpu(dev):
    """Shapes the co-attention kernels do not take go to attention_core by
    the kernels' predicates, never to a raise: cross-attention of 6 queries
    over 100 keys in 8 heads of width 32; 257 pre-gated queries (one past the
    JAX kernels' range), with and without the map. The card within 1e-4 of
    the CPU, no co-attention launch."""
    rng = np.random.default_rng(3)
    torch.manual_seed(0)
    from multimodal_path_omic_tpu_torch.ops import attention

    kv = torch.from_numpy(rng.standard_normal((2, 100, 256), dtype=np.float32))
    mask = torch.arange(100)[None] < torch.tensor([[93], [0]])
    for heads, pre_gate, n, need_weights in ((8, False, 6, False), (1, True, 257, False),
                                             (1, True, 257, True)):
        mha = attention.MultiheadAttention(256, heads, pre_gate=pre_gate).eval()
        q = torch.from_numpy(rng.standard_normal((2, n, 256), dtype=np.float32))
        outs = []
        for device in (dev, torch.device("cpu")):
            coattn.reset_launch_counts()
            with torch.no_grad():
                out, w = mha.to(device)(q.to(device), kv.to(device), kv.to(device),
                                        mask.to(device), need_weights=need_weights)
            outs.append([out.cpu()] + ([w.cpu()] if need_weights else []))
            assert not any(coattn.LAUNCH_COUNTS.values())
        for a, r in zip(*outs):
            _close(a, r)


def test_twelve_groups_take_the_slab_instances_on_card(dev):
    """NaCAGaT with 12 signature groups, which the kernels refused up to
    eight queries: ces serves through the plain-K forward's slab instance,
    cesar through the export passes' (one launch a batch each), the card
    within 1e-4 of the CPU."""
    rng = np.random.default_rng(3)
    bags = [rng.standard_normal((n, 256), dtype=np.float32) for n in (300, 700, 90)]
    sizes = (12,) * 12
    for loss, want in (("ces", {"coattn_plain_slabs": 2}),
                       ("cesar", {"coattn_stats_slabs": 2, "coattn_weights_slabs": 2})):
        omics = [[rng.standard_normal(s_, dtype=np.float32) for s_ in sizes] for _ in bags]
        kw = dict(omic_sizes=sizes, model_size="small", wsi_dim=256, buckets=(1024,),
                  batch_size=2, loss=loss, seed=1)
        coattn.reset_launch_counts()
        got = Predictor(device=dev, **kw).predict_bags(bags, omics)
        torch.cuda.synchronize()
        assert {k: v for k, v in coattn.LAUNCH_COUNTS.items() if v} == want
        ref = Predictor(device="cpu", **kw).predict_bags(bags, omics)
        for key in ("hazards", "survs", "y", "risk"):
            np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0)


def test_nacagat_big_ces_predictor_on_card_matches_cpu(dev):
    """NaCAGaT big (E = F = 512) serving with ces takes the fuse-K eval
    kernel's E = 512 instance through the lean-V gate: one launch a batch and
    no other co-attention kernel, the card within 1e-4 of the CPU."""
    rng = np.random.default_rng(3)
    sizes = (10, 20, 30)
    bags = [rng.standard_normal((n, 256), dtype=np.float32) for n in (300, 700, 90)]
    omics = [[rng.standard_normal(s_, dtype=np.float32) for s_ in sizes] for _ in bags]
    kw = dict(omic_sizes=sizes, model_size="big", wsi_dim=256, buckets=(1024,), batch_size=2,
              loss="ces", seed=1)
    coattn.reset_launch_counts()
    got = Predictor(device=dev, **kw).predict_bags(bags, omics)
    torch.cuda.synchronize()
    counts = dict(coattn.LAUNCH_COUNTS)
    assert counts == {**{k: 0 for k in counts}, "coattn_fwd_fused_k": 2}, counts  # 2 batches
    ref = Predictor(device="cpu", **kw).predict_bags(bags, omics)
    for key in ("hazards", "survs", "y", "risk"):
        np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0)


def test_nacagat_big_cesar_train_step_on_card_matches_cpu(dev):
    """One cesar SGD step of NaCAGaT big (E = F = 512: the fuse-K training
    forward's and backward's 512 instances) on the card and on the CPU from
    the same weights: the same parameters; on the card one launch of each
    training kernel and no other co-attention launch."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    rng = np.random.default_rng(4)
    sizes, m_len = (10, 20, 30), 300
    host = {
        "wsi": rng.standard_normal((3, m_len, 256), dtype=np.float32),
        "mask": np.arange(m_len)[None] < np.array([300, 120, 0])[:, None],
        "omics": [rng.standard_normal((3, s), dtype=np.float32) for s in sizes],
        "label": np.array([0, 1, 2]), "censorship": np.array([0.0, 1.0, 0.0], np.float32),
        "weight": np.array([1.0, 1.0, 0.0], np.float32),
    }
    params = {}
    for device in (dev, torch.device("cpu")):
        model = seeded_init_(build_model("NaCAGaT", omic_sizes=sizes, model_size="big",
                                         dropout=0.0, wsi_dim=256), 0).to(device)
        opt = make_optimizer("sgd", 0.1)
        state, step = init_train_state(model, opt, 0), make_train_step(model, "cesar", opt)
        batch = {k: ([torch.from_numpy(o).to(device) for o in v] if k == "omics"
                     else torch.from_numpy(v).to(device)) for k, v in host.items()}
        coattn.reset_launch_counts()
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics.loss))
        train = ("coattn_fwd_fused_k_train", "coattn_bwd_fused_k")
        assert coattn.LAUNCH_COUNTS == {
            name: int(device.type == "cuda" and name in train) for name in coattn.LAUNCH_COUNTS}
        params[device.type] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for k, v in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][k].numpy(), v.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# GE-NaCAGaT training: the flash backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b,heads,width,m_len,packed",
    [(2, 1, 256, 1000, True), (3, 8, 32, 777, True), (1, 1, 256, 70, False),
     (2, 8, 32, 4096, False), (2, 1, 256, 4096, True), (1, 8, 32, 3, True), (2, 2, 32, 129, True),
     (2, 1, 256, 33, True), (2, 1, 128, 1000, True), (3, 8, 16, 777, True),
     (2, 1, 512, 1000, True), (3, 8, 64, 777, False), (1, 1, 512, 33, True),
     (2, 8, 16, 129, False)],
)
def test_flash_backward_kernel_matches_plain_on_card(dev, b, heads, width, m_len, packed):
    """The forward's (m, l) and the backward's dq, dk, dv against the plain
    versions, from the forward kernel's own out and statistics; a random
    cotangent on every row, laid out [B, L, E] as the out-projection's input
    gradient is; two runs bitwise equal; no dq/dk through a masked key."""
    q, k, v, mask = _flash_inputs(dev, b, heads, width, m_len, m_len + heads, packed)
    before = dict(flash.LAUNCH_COUNTS)
    out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
    assert torch.equal(out, flash.flash_fwd(q, k, v, mask)[0])  # the same bits without (m, l)
    ref_out, ref_m, ref_l = flash.flash_attention_plain(q, k, v, mask, chunk=512,
                                                        return_stats=True)
    _close(out, ref_out)
    _close(m, ref_m)
    _close(l, ref_l, L_RTOL)
    g = torch.Generator().manual_seed(m_len)
    dout = torch.randn(b, m_len, heads * width, generator=g).to(dev)
    dout = dout.reshape(b, m_len, heads, width).transpose(1, 2)
    grads = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
    again = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
    ref = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout, chunk=512)
    assert all(a.shape == r.shape for a, r in zip(grads, ref))
    _close_flash_grads(grads, ref, q, k, mask, out, dout, width ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    dq, dk, dv = grads
    # three views of one packed buffer: the in-projection's gradient needs no gather
    assert dq.untyped_storage().data_ptr() == dv.untyped_storage().data_ptr()
    pad = ~mask[:, None, :, None].expand_as(dk)
    if bool(pad.any()):
        assert float(dk[pad].abs().max()) == 0.0
    if b > 1:  # no valid key: m = -1e9, l = L, weights 1/L that feed dv alone
        assert bool((m[-1] == -1e9).all()) and bool((l[-1] == m_len).all())
        assert float(dq[-1].abs().max()) == 0.0 and float(dv[-1].abs().max()) > 0.0
    # without a mask and with another scale; a cotangent the kernel cannot
    # read in place is copied, not refused
    out, m, l = flash.flash_fwd(q, k, v, None, sm_scale=0.05, need_stats=True)
    odd = dout.transpose(2, 3).contiguous().transpose(2, 3)
    for a, r in zip(flash.flash_bwd(q, k, v, None, out, m, l, odd, sm_scale=0.05),
                    flash.flash_attention_bwd_plain(q, k, v, None, out, m, l, dout,
                                                    sm_scale=0.05)):
        _close_rel(a, r)
    torch.cuda.synchronize()
    assert flash.LAUNCH_COUNTS[f"flash_fwd_d{width}"] == before[f"flash_fwd_d{width}"] + 3
    assert flash.LAUNCH_COUNTS[f"flash_bwd_d{width}"] == before[f"flash_bwd_d{width}"] + 3


@pytest.mark.parametrize("heads,width", [(1, 256), (8, 32), (1, 128), (8, 16), (1, 512), (8, 64)])
def test_flash_attention_gradients_on_card(dev, heads, width):
    """flash_attention on tensors that require grad (the autograd Function
    over both kernels, through the packed projection's head views) against
    autograd through the plain forward."""
    g = torch.Generator().manual_seed(heads)
    qkv0 = torch.randn(2, 600, 3 * heads * width, generator=g).to(dev)
    mask = (torch.arange(600)[None] < torch.tensor([600, 250])[:, None]).to(dev)
    w = torch.randn(2, heads, 600, width, generator=g).to(dev)
    grads = []
    for fn in (flash.flash_attention, flash.flash_attention_plain):
        qkv = qkv0.clone().requires_grad_(True)
        q, k, v = (t.reshape(2, 600, heads, width).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        (fn(q, k, v, mask) * w).sum().backward()
        grads.append(qkv.grad)
    _close_rel(*grads)
    with pytest.raises(ValueError, match="CUDA"):
        out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
        flash.flash_bwd(q, k, v, mask, out, m.cpu(), l, w)


def test_ge_train_step_on_card_matches_cpu(dev):
    """Three SGD steps of GE-NaCAGaT medium (the widths the flash kernels
    take; dropout 0, ce) on short bags, on the card and on the CPU from the
    same weights: the same parameters, 1 + 2 forward and 1 + 2 backward flash
    launches a step and no other kernel."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    rng = np.random.default_rng(0)
    m_len = 700
    host = {
        "wsi": rng.standard_normal((4, m_len, 64), dtype=np.float32),
        "mask": np.arange(m_len)[None] < np.array([700, 500, 90, 0])[:, None],
        "label": np.array([0, 1, 2, 0]),
        "weight": np.array([1.0, 1.0, 1.0, 0.0], np.float32),
    }
    params = {}
    for device in (dev, torch.device("cpu")):
        model = seeded_init_(build_model("GE-NaCAGaT", model_size="medium", dropout=0.0,
                                         wsi_dim=64), 0).to(device)
        opt = make_optimizer("sgd", 0.1)
        state = init_train_state(model, opt, 0)
        step = make_train_step(model, "ce", opt, ge_mode=True)
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        for mod in (coattn, flash, milpool):
            mod.reset_launch_counts()
        for _ in range(3):
            state, metrics = step(state, batch)
        assert np.isfinite(float(metrics.loss))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert flash.LAUNCH_COUNTS == {**{name: 0 for name in flash.LAUNCH_COUNTS},
                                           "flash_fwd_d256": 3, "flash_fwd_d32": 6,
                                           "flash_bwd_d256": 3, "flash_bwd_d32": 6}
            assert not any(coattn.LAUNCH_COUNTS.values()) and not milpool.LAUNCH_COUNTS["milpool"]
        params[device.type] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for k, v in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][k].numpy(), v.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The plain-K kernels with values, the row gather, MCAT and the device cache
# ---------------------------------------------------------------------------


def _close_one_key_plain(grads, ref, q, k, mask, fwd, dout, dssq, dsumw, di):
    """dq and dk of the plain-K backward in bags with one valid key: 0 in
    exact arithmetic (ds = 0, as ``_close_fk_grads`` states), so both sides
    hold float32 noise alone, held to GRAD_RTOL of the terms that cancel,
    c_n, times the largest factor ds meets on its way to dq (scale |k|max +
    |a|max / 2) or, summed over the queries, to dk (scale |q_n|max +
    |a|max / 2; |tanh| <= 1), with |a| <= scale |q_n|_1 |k|max. A query
    whose one weight was dropped has c_n = 0 and ds = 0 exactly."""
    one = mask.sum(-1) == 1
    if not bool(one.any()):
        return
    o, _, _, ssq, sumw = (t[one] for t in fwd)
    q, k, dout, dssq, dsumw, di = (t[one] for t in (q, k, dout, dssq, dsumw, di))
    scale = q.shape[-1] ** -0.5
    kmax = k.abs().amax((1, 2))[:, None]  # [bags, 1]
    c = (o * dout).sum(-1).abs() + di.abs() + 2 * (dssq * ssq).abs() + (dsumw * sumw).abs()
    amax = scale * q.abs().sum(-1) * kmax / 2
    limit_dq = (GRAD_RTOL * c * (scale * kmax + amax))[..., None]
    limit_dk = (GRAD_RTOL * c * (scale * q.abs().amax(-1) + amax)).sum(-1)[:, None, None]
    for i, limit in ((0, limit_dq), (1, limit_dk)):
        for a in (grads[i][one], ref[i][one]):
            assert torch.isfinite(a).all() and bool((a.abs() <= limit).all())


@pytest.mark.parametrize(
    "b,n,d,m_len,pre_gate,rate,kind",
    [(2, 3, 128, 1000, True, 0.25, "prefix"), (4, 6, 256, 4096, False, 0.0, "prefix"),
     (3, 8, 256, 333, True, 0.0, "prefix"), (1, 1, 128, 70, False, 0.5, "prefix"),
     (5, 6, 256, 5000, True, 0.25, "prefix"), (4, 6, 256, 4096, True, 0.25, "holes"),
     (3, 6, 128, 1000, False, 0.0, "holes"), (3, 6, 256, 1500, True, 0.25, "single-key"),
     (3, 6, 128, 700, False, 0.0, "single-key")],
)
def test_plain_k_kernels_match_plain_on_card(dev, b, n, d, m_len, pre_gate, rate, kind):
    """The plain-K forward with values (eval form and training form: dropout,
    ssq, sumw, l, m) and its backward against their plain versions, on
    prefix masks with a fully-masked filler row, on whole masked 64-key
    tiles mid-bag (``holes``, which the kernels skip) and with a bag of one
    valid key (o is its v row; its dq and dk are float32 noise on both
    sides, held to the terms that cancel by ``_close_one_key_plain``); two
    runs of each agree bitwise; no gradient reaches k through a masked key,
    and dv is exactly 0 at the masked keys of bags with a valid key."""
    q, _, _, _, k, mask = _inputs(dev, b, n, d, m_len, d, m_len)
    if kind == "holes":
        mask[:, 64:192] = False
        mask[:, 256:320] = False
    elif kind == "single-key":
        mask[0] = False
        mask[0, m_len // 3] = True
    g = torch.Generator().manual_seed(m_len + 1)
    v = torch.randn(b, m_len, d, generator=g).to(dev)
    dout = torch.randn(b, n, d, generator=g).to(dev)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    seed = torch.tensor([m_len * 3 + 1], dtype=torch.int32, device=dev)
    before = dict(coattn.LAUNCH_COUNTS)
    got = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
    again = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
    ref = coattn.coattn_fwd_plain_k_plain(q, k, v, mask, None, 0.0, pre_gate=pre_gate)
    assert got[3] is None and got[4] is None
    for a, r, rtol in zip(got[:3], ref, (0.0, L_RTOL, 0.0)):
        _close(a, r, rtol)
    assert all(torch.equal(x, y) for x, y in zip(got[:3], again[:3]))
    if kind == "single-key":
        _close(got[0][0], v[0, m_len // 3].expand_as(got[0][0]))
    got = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, rate, pre_gate=pre_gate)
    again = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, rate, pre_gate=pre_gate)
    ref = coattn.coattn_fwd_plain_k_plain(q, k, v, mask, seed, rate, pre_gate=pre_gate)
    for a, r, rtol in zip(got, ref, (0.0, L_RTOL, 0.0, 0.0, 0.0)):
        _close(a, r, rtol)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    o, l, m, ssq, sumw = got
    di = (o * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, k, v, mask, seed, rate, dout, l, m, di, dssq, dsumw)
    grads = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
    again = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
    ref = coattn.coattn_bwd_plain_k_plain(q, k, v, mask, seed, rate, dout, dssq, dsumw,
                                          pre_gate=pre_gate)
    many = mask.sum(-1) != 1
    for i, (a, r) in enumerate(zip(grads, ref)):
        _close_rel(a[many] if i == 0 else a, r[many] if i == 0 else r)
    _close_one_key_plain(grads, ref, q, k, mask, got, dout, dssq, dsumw, di)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    assert float(grads[1][~mask].abs().max()) == 0.0
    has = mask.any(-1)
    assert bool((grads[2][has][~mask[has]] == 0).all())
    torch.cuda.synchronize()
    assert coattn.LAUNCH_COUNTS["coattn_plain"] == before["coattn_plain"] + 4
    assert coattn.LAUNCH_COUNTS["coattn_plain_bwd"] == before["coattn_plain_bwd"] + 2


@pytest.mark.parametrize("d", [128, 256])
def test_plain_k_backward_repeats_bitwise_over_many_bags(dev, d):
    """The pre-gated plain-K backward over 32 bags with masked tiles mid-bag,
    so that most blocks end in a bag and flush its dq partial: eight runs
    give the same bits, and match the plain version. At D = 128 two column
    groups of a block merge their dq sums in shared memory."""
    b, n, m_len = 32, 6, 2000
    q, _, _, _, k, mask = _inputs(dev, b, n, d, m_len, d, m_len)
    mask[:, 64:192] = False
    g = torch.Generator().manual_seed(d)
    v = torch.randn(b, m_len, d, generator=g).to(dev)
    dout = torch.randn(b, n, d, generator=g).to(dev)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    seed = torch.tensor([d + 5], dtype=torch.int32, device=dev)
    o, l, m, ssq, sumw = fwd = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, 0.25,
                                                         pre_gate=True)
    di = (o * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, k, v, mask, seed, 0.25, dout, l, m, di, dssq, dsumw)
    first = coattn.coattn_bwd_plain_k(*args, pre_gate=True)
    for _ in range(7):
        again = coattn.coattn_bwd_plain_k(*args, pre_gate=True)
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    ref = coattn.coattn_bwd_plain_k_plain(q, k, v, mask, seed, 0.25, dout, dssq, dsumw,
                                          pre_gate=True)
    many = mask.sum(-1) != 1
    for i, (a, r) in enumerate(zip(first, ref)):
        _close_rel(a[many] if i == 0 else a, r[many] if i == 0 else r)
    _close_one_key_plain(first, ref, q, k, mask, fwd, dout, dssq, dsumw, di)


@pytest.mark.parametrize("pre_gate", [False, True])
def test_coattention_gradients_on_card(dev, pre_gate):
    """coattention with dropout, ssq and sumw (the autograd Function over
    both plain-K kernels) against autograd through the plain training form;
    fused_attention folds two heads into the batch."""
    q, _, _, _, k, mask = _inputs(dev, 3, 6, 256, 900, 256, 5)
    g = torch.Generator().manual_seed(3)
    v = torch.randn(3, 900, 256, generator=g).to(dev)
    w_o = torch.randn(3, 6, 256, generator=g).to(dev)
    w_s, w_w = (torch.randn(3, 6, generator=g).to(dev) for _ in range(2))
    seed = torch.tensor([11], dtype=torch.int32, device=dev)
    grads = []
    for fn in ("kernel", "plain"):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if fn == "kernel":
            o, ssq, sumw = coattn.coattention(*ins, mask, pre_gate=pre_gate, dropout_rate=0.25,
                                              dropout_seed=seed, need_ssq=True, need_sumw=True)
        else:
            o, _, _, ssq, sumw = coattn.coattn_fwd_plain_k_plain(*ins, mask, seed, 0.25,
                                                                 pre_gate=pre_gate)
        ((o * w_o).sum() + (ssq * w_s).sum() + (sumw * w_w).sum()).backward()
        grads.append([t.grad for t in ins])
    for a, r in zip(*grads):
        _close_rel(a, r)
    q4, k4, v4 = (torch.stack([t, t.flip(0)], dim=1) for t in (q, k, v))  # [B, 2, ., D]
    out = coattn.fused_attention(q4, k4, v4, None, pre_gate=pre_gate)
    ref = coattn.coattn_fwd_plain_k_plain(q, k, v, None, None, 0.0, pre_gate=pre_gate)[0]
    _close(out[:, 0], ref)
    _close(out[:, 1], ref.flip(0))


def test_plain_k_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, _, _, _, k, mask = _inputs(dev, 2, 3, 256, 256, 256, 0)
    v = torch.zeros_like(k)
    seed = torch.tensor([1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported"):  # a width without an instance
        coattn.coattn_fwd_plain_k(torch.zeros(2, 3, 384, device=dev),
                                  torch.zeros(2, 256, 384, device=dev),
                                  torch.zeros(2, 256, 384, device=dev), mask, pre_gate=False)
    with pytest.raises(ValueError, match="queries"):  # past MAX_PLAIN_QUERIES
        coattn.coattn_fwd_plain_k(torch.zeros(2, 257, 256, device=dev), k, v, mask,
                                  pre_gate=False)
    with pytest.raises(ValueError, match="shape"):
        coattn.coattn_fwd_plain_k(q, k, v[:, :100].contiguous(), mask, pre_gate=False)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattn_fwd_plain_k(q, k, v.cpu(), mask, pre_gate=False)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattn_fwd_plain_k(q, k, v, mask, seed.cpu(), 0.25, pre_gate=False)
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattn_fwd_plain_k(q, k, v.transpose(1, 2).contiguous().transpose(1, 2), mask,
                                  pre_gate=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_gather_rows_on_card_is_index_select(dev, dtype):
    g = torch.Generator().manual_seed(1)
    for shape in ((7, 512, 1024), (3, 100, 24), (5, 1, 16)):
        if dtype == torch.int8:
            pool = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(dev)
        else:
            pool = torch.randn(shape, generator=g).to(dev).to(dtype)
        if pool[0].numel() * pool.element_size() % 16:
            with pytest.raises(ValueError, match="multiple of 16|16 bytes"):
                gather.gather_rows(pool, torch.zeros(2, dtype=torch.int64, device=dev))
            continue
        idx = torch.randint(0, shape[0], (9,), generator=g).to(dev)
        before = gather.LAUNCH_COUNTS["gather_rows"]
        for ix in (idx, idx.int()):
            got = gather.take_rows(pool, ix)
            assert got.dtype == dtype and torch.equal(got, torch.index_select(pool, 0, idx))
        assert gather.LAUNCH_COUNTS["gather_rows"] == before + 2


def test_gather_rows_refuses_what_the_kernel_does_not_take(dev):
    pool = torch.zeros(4, 8, 16, device=dev)
    idx = torch.zeros(2, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="idx is on"):
        gather.gather_rows(pool, idx.cpu())
    with pytest.raises(TypeError, match="pool must be"):
        gather.gather_rows(pool.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(pool.transpose(1, 2).contiguous().transpose(1, 2), idx)
    with pytest.raises(ValueError, match="B=0"):
        gather.gather_rows(pool, idx[:0])


@pytest.mark.parametrize("model_name", ["MCAT", "NaCAGaT"])
def test_lean_false_predictor_on_card(dev, model_name):
    """lean=False on the card: one plain-K launch a batch and no other
    kernel; MCAT's lean route launches none; both within 1e-4 of the CPU."""
    rng = np.random.default_rng(0)
    sizes = (10, 20, 30)
    bags = [rng.standard_normal((n, 256), dtype=np.float32) for n in (300, 900, 450)]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in sizes] for _ in bags]
    kw = dict(omic_sizes=sizes, model_size="small", wsi_dim=256, buckets=(512, 1024),
              batch_size=2, loss="ces", seed=3)
    ref = Predictor(model_name, device="cpu", **kw).predict_bags(bags, omics)
    for lean in (True, False):
        coattn.reset_launch_counts()
        got = Predictor(model_name, device=dev, lean=lean, **kw).predict_bags(bags, omics)
        counts = {k: v for k, v in coattn.LAUNCH_COUNTS.items() if v}
        if not lean:
            assert counts == {"coattn_plain": 2}
        else:
            assert counts == ({} if model_name == "MCAT" else {"coattn_fwd_fused_k": 2})
        for key in ("hazards", "survs", "y", "risk"):
            np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0)


class _Cohort:
    """Six seeded bags of one bucket with the columns survival_extras reads."""

    SIZES, LENGTHS = (10, 20, 30), (300, 40, 512, 100, 257, 500)

    def __init__(self):
        rng = np.random.default_rng(0)
        n = len(self.LENGTHS)
        self.bags = [rng.standard_normal((m, 64), dtype=np.float32) for m in self.LENGTHS]
        self.table = self
        self.survival_months = rng.uniform(1, 100, n).astype(np.float32)
        self.survival_class = rng.integers(0, 4, n)
        self.censorship = rng.integers(0, 2, n).astype(np.float32)
        self.signature_names = [f"s{j}" for j in range(len(self.SIZES))]
        self.signature_data = {k: rng.standard_normal((n, s), dtype=np.float32)
                               for k, s in zip(self.signature_names, self.SIZES)}

    def __len__(self):
        return len(self.bags)

    def bag(self, i):
        return self.bags[i]


def test_mcat_cached_train_step_on_card(dev):
    """MCAT medium (the width the plain-K kernels take on the card), lean=False,
    dropout 0.25, SGD: three cached steps equal three host-fed steps bitwise,
    with one gather, one plain-K forward and one plain-K backward launch a
    cached step."""
    from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache, build_meta
    from multimodal_path_omic_tpu_torch.data.pipeline import survival_extras
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import (
        init_train_state,
        make_cached_train_step,
        make_train_step,
    )
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    ds = _Cohort()
    cache = DeviceBagCache(ds, survival_extras, (512,), device=dev, upload_chunk=4)
    params = {}
    for cached in (True, False):
        model = seeded_init_(build_model("MCAT", omic_sizes=ds.SIZES, model_size="medium",
                                         dropout=0.25, wsi_dim=64, lean=False), 0).to(dev)
        opt = make_optimizer("sgd", 0.1)
        state = init_train_state(model, opt, 0)
        make = make_cached_train_step if cached else make_train_step
        step = make(model, "ces", opt, omic_sizes=ds.SIZES)
        for mod in (coattn, gather):
            mod.reset_launch_counts()
        for rows in ([0, 2, 4, 5], [5, 0], [4]):
            meta, _ = build_meta(rows, 4, cache)
            if cached:
                state, metrics = step(state, cache.caches[512], meta)
            else:
                wsi = np.zeros((4, 512, 64), np.float32)
                for j, r in enumerate(meta["row"]):
                    wsi[j, :ds.LENGTHS[r]] = ds.bag(r)
                rows_ = meta["row"]
                state, metrics = step(state, {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in {
                    "wsi": wsi, "mask": np.arange(512)[None] < np.array(ds.LENGTHS)[rows_][:, None],
                    "omics_packed": np.concatenate(
                        [ds.signature_data[n][rows_] for n in ds.signature_names], axis=1),
                    "label": ds.survival_class[rows_], "censorship": ds.censorship[rows_],
                    "weight": meta["weight"]}.items()})
            assert np.isfinite(float(metrics.loss))
        torch.cuda.synchronize()
        assert gather.LAUNCH_COUNTS["gather_rows"] == (3 if cached else 0)
        assert {k: v for k, v in coattn.LAUNCH_COUNTS.items() if v} == {
            "coattn_plain": 3, "coattn_plain_bwd": 3}
        params[cached] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for k, v in params[True].items():
        assert torch.equal(v, params[False][k]), k


@pytest.mark.parametrize("model_name,loss", [("NaCAGaT", "cesar"), ("MCAT", "ces")])
def test_trainer_fit_on_card_matches_cpu(dev, tmp_path, model_name, loss):
    """Two epochs of ``Trainer.fit`` on the card and on the CPU (dropout 0:
    the two devices' generators draw different bits), at the CPU tests'
    size: per-epoch train and val loss within 1e-4 relative, the val risks
    within 1e-4 absolute; NaCAGaT's steps launch the fuse-K training
    kernels and its validation the export passes."""
    from multimodal_path_omic_tpu_torch.config import config_from_dict
    from multimodal_path_omic_tpu_torch.data.synthetic import (
        make_synthetic_cohort,
        synthetic_config_dict,
    )
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    paths = make_synthetic_cohort(str(tmp_path / "cohort"), n_patients=24,
                                  bag_lengths=(48, 80, 120), n_genes=36, n_signatures=4,
                                  seed=0, signal_strength=2.0)
    runs = {}
    for where in ("cuda", "cpu"):
        raw = synthetic_config_dict(*paths)
        raw["model"].update(name=model_name, model_size="small", dropout=0.0,
                            checkpoint_dir=str(tmp_path / where / "ck"))
        raw["training"].update(loss=loss, epochs=2, optimizer="sgd", lr=0.05,
                               test_output_dir=str(tmp_path / where / "out"))
        raw["tpu"] = {"bag_buckets": [128], "batch_size": 8, "device_cache": "off"}
        trainer = Trainer(config_from_dict(raw), verbose=False, device=where)
        coattn.reset_launch_counts()
        epochs = []
        for e in range(2):
            train, val = trainer.validated_epoch(e)
            epochs.append({**train, **val, "risks": trainer.val_risks})
        runs[where] = epochs
        if where == "cuda":
            torch.cuda.synchronize()
            launched = {k for k, v in coattn.LAUNCH_COUNTS.items() if v}
            assert launched == ({"coattn_fwd_fused_k_train", "coattn_bwd_fused_k",
                                 "coattn_stats", "coattn_weights"}
                                if model_name == "NaCAGaT" else set())
    for got, ref in zip(runs["cuda"], runs["cpu"]):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4)
        np.testing.assert_allclose(got["risks"], ref["risks"], atol=ATOL, rtol=0)


def _serving_world(tmp_path, loss="cesar"):
    """A small synthetic cohort, a checkpoint of seeded weights (written by a
    CPU Trainer), and the config that reads both, for the card or the CPU."""
    from multimodal_path_omic_tpu_torch.config import config_from_dict
    from multimodal_path_omic_tpu_torch.data.synthetic import (
        make_synthetic_cohort,
        synthetic_config_dict,
    )
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    paths = make_synthetic_cohort(str(tmp_path / "cohort"), n_patients=12,
                                  bag_lengths=(48, 80, 120), n_genes=24, n_signatures=3, seed=4)

    def cfg(where):
        raw = synthetic_config_dict(*paths)
        raw["device"] = where
        raw["model"].update(name="NaCAGaT", model_size="small",
                            checkpoint_dir=str(tmp_path / "ck"))
        raw["training"].update(loss=loss, test_output_dir=str(tmp_path / "out"))
        raw["tpu"] = {"bag_buckets": [64, 128], "batch_size": 4}
        return config_from_dict(raw)

    ckpt = Trainer(cfg("cpu"), verbose=False).save(0, 0.0, tag="served")
    return cfg, ckpt


def _post(url, body):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _npz(**arrays):
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_server_and_csv_on_card_match_cpu(dev, tmp_path):
    """The server's answers (/predict_npz, /predict_batch_npz) and the CSV
    rows of ``predict_to_csv`` on the card against the CPU within 1e-4: the
    same checkpoint through ``Predictor.from_config`` on each device."""
    import threading

    import pandas as pd

    from multimodal_path_omic_tpu_torch.server import make_server

    cfg, ckpt = _serving_world(tmp_path)
    preds = {w: Predictor.from_config(cfg(w), checkpoint=ckpt) for w in ("cuda", "cpu")}
    servers = {w: make_server(p, port=0) for w, p in preds.items()}
    for s in servers.values():
        threading.Thread(target=s.serve_forever, daemon=True).start()
    try:
        rng = np.random.default_rng(3)
        sizes = preds["cpu"].omic_sizes
        bags = [rng.normal(size=(m, 1024)).astype(np.float32) for m in (40, 100, 70, 128, 90)]
        omics = [[rng.normal(size=(s,)).astype(np.float32) for s in sizes] for _ in bags]
        single = _npz(wsi=bags[1], **{f"omic_{j}": o for j, o in enumerate(omics[1])})
        batch = _npz(**{f"wsi_{i}": b for i, b in enumerate(bags)},
                     **{f"omic_{i}_{j}": o for i, os_ in enumerate(omics)
                        for j, o in enumerate(os_)})
        coattn.reset_launch_counts()
        for path, body in (("/predict_npz", single), ("/predict_batch_npz", batch)):
            got, ref = (_post(f"http://127.0.0.1:{servers[w].server_address[1]}{path}", body)
                        for w in ("cuda", "cpu"))
            for k in ("risk", "hazards", "survs", "y"):
                np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=0)
        torch.cuda.synchronize()
        assert coattn.LAUNCH_COUNTS["coattn_stats"] == 1 + 2  # one batch a bucket
        assert coattn.LAUNCH_COUNTS["coattn_weights"] == 1 + 2
    finally:
        for s in servers.values():
            s.shutdown()
    csv = {w: pd.read_csv(p.predict_to_csv(str(tmp_path / f"{w}.csv"))) for w, p in preds.items()}
    assert list(csv["cuda"].columns) == list(csv["cpu"].columns)
    assert list(csv["cuda"].slide_id) == list(csv["cpu"].slide_id)
    num = [c for c in csv["cpu"].columns if c != "slide_id"]
    np.testing.assert_allclose(csv["cuda"][num].to_numpy(), csv["cpu"][num].to_numpy(),
                               atol=ATOL, rtol=0)


def test_mc_request_launches_the_training_form_n_samples_times(dev, tmp_path):
    """An MC request (``?mc=6``) on the card: the MC forwards launch the fuse-K
    training form 6 times and no export pass (the deterministic columns add
    one stats and one weights pass); the same seed answers bit for bit."""
    import threading

    from multimodal_path_omic_tpu_torch.data.bags import bucket_for, pad_bag
    from multimodal_path_omic_tpu_torch.server import make_server
    from multimodal_path_omic_tpu_torch.train.loop import mc_generator

    cfg, ckpt = _serving_world(tmp_path)
    pred = Predictor.from_config(cfg("cuda"), checkpoint=ckpt)
    server = make_server(pred, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        rng = np.random.default_rng(5)
        bag = rng.normal(size=(100, 1024)).astype(np.float32)
        omics = [rng.normal(size=(s,)).astype(np.float32) for s in pred.omic_sizes]
        body = _npz(wsi=bag, **{f"omic_{j}": o for j, o in enumerate(omics)})
        url = f"http://127.0.0.1:{server.server_address[1]}/predict_npz?mc=6&mc_seed=2"
        coattn.reset_launch_counts()
        first = _post(url, body)
        torch.cuda.synchronize()
        counts = {k: v for k, v in coattn.LAUNCH_COUNTS.items() if v}
        assert counts == {"coattn_fwd_fused_k_train": 6, "coattn_stats": 1,
                          "coattn_weights": 1}
        assert first == _post(url, body) and first["risk_std"][0] > 0
    finally:
        server.shutdown()
    padded, m = pad_bag(bag, bucket_for(len(bag), pred.buckets))
    staged = pred._batch(torch.from_numpy(padded[None]).to(dev),
                         torch.from_numpy(m[None]).to(dev), [omics], 1)
    coattn.reset_launch_counts()
    res = pred._mc_step(6)(staged, mc_generator(dev, 2))
    torch.cuda.synchronize()
    assert {k: v for k, v in coattn.LAUNCH_COUNTS.items() if v} == {
        "coattn_fwd_fused_k_train": 6}
    assert np.array_equal(res["risk_mean"].cpu().numpy(), np.asarray(first["risk_mean"],
                                                                        np.float32))


# ---------------------------------------------------------------------------
# CUDA graphs over the steps (train/graphs.py): graphed equals eager bit for bit
# ---------------------------------------------------------------------------

GRAPH_SIZES = (100, 200, 300, 400, 500, 600)  # the shipped signature groups
GRAPH_M = 4096


def _graph_world(dev, graphs, seed=0):
    """NaCAGaT medium (dropout 0.25 at every site, cesar, Adam lr 2e-4 with
    weight decay 1e-5), random weights from seed 0, generator seeded 0:
    its train step and cached train step, eager or graphed."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train import loop
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    model = seeded_init_(build_model("NaCAGaT", omic_sizes=GRAPH_SIZES, model_size="medium",
                                     dropout=0.25), seed).to(dev)
    opt = make_optimizer("adam", 2e-4, 1e-5)
    kw = dict(omic_sizes=GRAPH_SIZES, graphs=graphs)
    return (model, loop.init_train_state(model, opt, seed=0),
            loop.make_train_step(model, "cesar", opt, **kw),
            loop.make_cached_train_step(model, "cesar", opt, multi=True, **kw),
            loop.make_eval_step(model, "cesar", **kw))


def _graph_cache(dev, n=12, seed=3):
    """A one-bucket device cache of ``n`` bags of 1000..4096 patches."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1000, GRAPH_M + 1, n)
    wsi = torch.from_numpy(rng.standard_normal((n, GRAPH_M, 1024), dtype=np.float32))
    mask = torch.arange(GRAPH_M)[None] < torch.from_numpy(lengths)[:, None]
    cache = {"wsi": wsi * mask[..., None], "mask": mask,
             "label": torch.from_numpy(rng.integers(0, 4, n)),
             "omics_packed": torch.from_numpy(
                 rng.standard_normal((n, sum(GRAPH_SIZES)), dtype=np.float32)),
             "censorship": torch.from_numpy(rng.integers(0, 2, n).astype(np.float32)),
             "survival_months": torch.from_numpy(rng.uniform(1, 100, n).astype(np.float32))}
    return {k: v.to(dev) for k, v in cache.items()}


def _graph_metas(k, b=4, n=12, seed=4):
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.choice(n, b, replace=False) for _ in range(k)])
    weight = np.ones((k, b), np.float32)
    weight[-1, -1] = 0.0  # one filler row
    return {"pos": rows, "row": rows, "weight": weight}


def _batch_of(cache, meta):
    rows = torch.as_tensor(meta["row"], device=cache["wsi"].device)
    return {"wsi": cache["wsi"][rows], "mask": cache["mask"][rows],
            "omics_packed": cache["omics_packed"][rows], "label": cache["label"][rows],
            "censorship": cache["censorship"][rows],
            "weight": torch.as_tensor(meta["weight"], device=cache["wsi"].device)}


def _same_bits(a, b, what):
    for x, y in zip(a, b):
        assert torch.equal(x, y), what


def test_graphed_train_steps_equal_eager_on_card(dev):
    """Five NaCAGaT medium steps (cesar, dropout 0.25) on two alternating
    batches, graphed (the first call eager, then replays) and eager, with the
    lr changed between steps 3 and 4: the parameters, the gradients, every
    metric and the dropout generator's state bit for bit; then one eval
    step each."""
    from multimodal_path_omic_tpu_torch.train.optim import set_lr

    cache = _graph_cache(dev)
    metas = _graph_metas(2)
    batches = [_batch_of(cache, {k: v[i] for k, v in metas.items()}) for i in range(2)]
    runs = {}
    for graphs in (False, True):
        model, state, step, _, evaluate = _graph_world(dev, graphs)
        metrics = []
        for i in range(5):
            if i == 3:
                set_lr(state.optimizer, 1e-4)
            state, m = step(state, batches[i % 2])
            metrics.append(m)
        res = evaluate(batches[0])
        torch.cuda.synchronize()
        runs[graphs] = (model, state, metrics, res)
    (m0, s0, e0, r0), (m1, s1, e1, r1) = runs[False], runs[True]
    _same_bits(m0.parameters(), m1.parameters(), "parameters")
    _same_bits((p.grad for p in m0.parameters()), (p.grad for p in m1.parameters()), "grads")
    for a, b in zip(e0, e1):
        _same_bits(a, b, "metrics")
    assert torch.equal(s0.generator.get_state(), s1.generator.get_state())
    assert s0.step == s1.step == 5
    for k in ("loss", "risk", "hazards", "survs", "y"):
        assert torch.equal(r0[k], r1[k]), k


def test_graphed_cached_multi_step_equals_eager_on_card(dev):
    """``make_cached_train_step(multi=True)`` over two groups of K = 3 metas
    (one filler row), graphed and eager, lr changed between the groups:
    the parameters, the [K]-stacked metrics and the generator bit for bit."""
    from multimodal_path_omic_tpu_torch.train.optim import set_lr

    cache = _graph_cache(dev)
    groups = [_graph_metas(3, seed=4), _graph_metas(3, seed=5)]
    runs = {}
    for graphs in (False, True):
        model, state, _, multi, _ = _graph_world(dev, graphs)
        out = []
        for i, meta in enumerate(groups):
            if i == 1:
                set_lr(state.optimizer, 1e-4)
            state, m = multi(state, cache, meta)
            assert m.loss.shape == (3,) and m.risk.shape == (3, 4)
            out.append(m)
        torch.cuda.synchronize()
        runs[graphs] = (model, state, out)
    (m0, s0, o0), (m1, s1, o1) = runs[False], runs[True]
    _same_bits(m0.parameters(), m1.parameters(), "parameters")
    for a, b in zip(o0, o1):
        _same_bits(a, b, "metrics")
    assert torch.equal(s0.generator.get_state(), s1.generator.get_state())


def test_graph_replays_count_their_launches_on_card(dev):
    """Three graphed steps (a warm-up, a capture, two replays) add the same
    launches to the wrappers' counts as three eager steps; the capture
    itself adds none."""
    from multimodal_path_omic_tpu_torch.ops import gather as tgather
    from multimodal_path_omic_tpu_torch.train.graphs import launch_counts

    cache = _graph_cache(dev)
    meta = _graph_metas(3)
    counts = {}
    for graphs in (False, True):
        _, state, _, multi, _ = _graph_world(dev, graphs)
        coattn.reset_launch_counts()
        tgather.reset_launch_counts()
        multi(state, cache, meta)
        torch.cuda.synchronize()
        counts[graphs] = [dict(t) for t in launch_counts()]
    assert counts[True] == counts[False]
    assert coattn.LAUNCH_COUNTS["coattn_fwd_fused_k_train"] == 3
    assert coattn.LAUNCH_COUNTS["coattn_bwd_fused_k"] == 3
    assert tgather.LAUNCH_COUNTS["gather_rows"] == 3


def test_failed_capture_raises_on_card(dev):
    """A step that reads a value on the host cannot be captured: the first
    call's eager warm-up runs, its capture raises; nothing falls back."""
    from multimodal_path_omic_tpu_torch.train.graphs import StepGraphs

    graphs = StepGraphs(dev)
    x = torch.ones(4, device=dev)

    def host_read(t):
        return t * float(t.sum())

    with pytest.raises(RuntimeError, match="capture"):
        graphs.run("host_read", host_read, x)
    assert len(graphs) == 0


def test_stager_on_card_equals_to_device(dev):
    """Pinned staging on the card (copy stream, events, pinned rings reused
    across calls, a row batch padded on the device, a stacked group) gives
    the tensors ``to_device`` gives from the padded host batches, bit for
    bit, across more calls than the ring has slots."""
    from multimodal_path_omic_tpu_torch.data import pipeline
    from multimodal_path_omic_tpu_torch.train.loop import stack_batches

    rng = np.random.default_rng(6)

    class Bags:
        bags = [rng.normal(size=(m, 64)).astype(np.float32) for m in (5, 200, 77, 1, 256, 90)]
        table = type("T", (), dict(
            survival_months=rng.uniform(1, 9, 6).astype(np.float32),
            survival_class=rng.integers(0, 4, 6), censorship=np.ones(6, np.float32),
            signature_names=["a", "b"],
            signature_data={"a": rng.normal(size=(6, 5)), "b": rng.normal(size=(6, 7))}))

        def __len__(self):
            return len(self.bags)

        def bag(self, i):
            return self.bags[i]

    batcher = pipeline.BucketBatcher(Bags(), pipeline.survival_extras, 4, (256,))
    stager = pipeline.Stager(dev)
    for rows in ([0, 1, 2], [3, 4, 5, 0], [5, 1], [2, 3, 4]):
        got = stager.stage_batch(batcher._make_rows(rows, 256), False).take()
        ref = pipeline.to_device(batcher._make_batch(rows, 256), dev, False)
        for key, value in ref.items():
            assert torch.equal(got[key], value), key
    groups = ([0, 1, 2], [3, 4, 5, 0])
    got = stager.stage_group([batcher._make_rows(g, 256) for g in groups], False).take()
    ref = pipeline.to_device(stack_batches([batcher._make_batch(g, 256) for g in groups]),
                             dev, False)
    for key, value in ref.items():
        assert torch.equal(got[key], value), key


# ---------------------------------------------------------------- bfloat16 instances
# The bfloat16 instances against their plain versions (which the CPU tests
# hold to the Pallas kernels at bfloat16, test_torch_port_bf16.py): the
# bfloat16 outputs (o, dq, dkv; dwk and dbk cast to bfloat16) to one unit in
# the last place, 2^-7 relative (both round the same float32 value, summed in
# another order); the float32 statistics and weights to 1e-2 (relative; m
# absolute): where one element of k (the kernel's projection and cuBLAS's sum
# in other orders) or of tanh rounds to the other bfloat16 neighbour in the
# two versions, that key's score moves by up to ~5e-3; gradients to 2e-2 of
# each tensor's largest magnitude (the outputs' own rounding, and the
# kernel's 1 - tanh^2 of the rounded tanh where autograd takes it of the
# unrounded one). An indexing or masking fault moves any of them by O(1).
BF16 = torch.bfloat16
BF16_RTOL, BF16_STAT_TOL, BF16_GRAD_RTOL = 2.0 ** -7, 1e-2, 2e-2


def _bf16_inputs(dev, b, n, e, m_len, kind, seed):
    q, kv, wk, bk, k, _ = _inputs(dev, b, n, e, m_len, e, seed)
    mask = _training_mask(dev, b, m_len, kind, seed + 1)
    return [t.to(BF16) for t in (q, kv, wk, bk, k)] + [mask]


def _close_bf16_fwd(got, ref):
    """(o, l, m[, ssq], sumw) of a bfloat16 fuse-K forward."""
    assert got[0].dtype == BF16 and all(t.dtype == torch.float32 for t in got[1:])
    _close(got[0].float(), ref[0].float(), rtol=BF16_RTOL)
    _close(got[1], ref[1], rtol=BF16_STAT_TOL)
    for a, r in zip(got[2:], ref[2:]):
        _close(a, r, atol=BF16_STAT_TOL)


@pytest.mark.parametrize("n", [1, 6, 8])
@pytest.mark.parametrize("e", [128, 256, 512])
@pytest.mark.parametrize("m_len,kind", [(4096, "prefix"), (4000, "holes"), (1500, "one")])
def test_bf16_fused_k_instances_match_plain_on_card(dev, e, m_len, kind, n):
    """The bfloat16 fuse-K eval and training forms (dropout 0.25) and the
    backward against their plain versions at 1, 6 and 8 queries (the ends of
    the wgmma kernels' padding of the queries to 8); two runs bitwise equal;
    dkv exactly 0 at the masked keys of bags with a valid key; each launch
    counted under its _bf16 name."""
    b = 3
    q, kv, wk, bk, _, mask = _bf16_inputs(dev, b, n, e, m_len, kind, m_len + e)
    seed = torch.tensor([e + m_len], dtype=torch.int32, device=dev)
    before = dict(coattn.LAUNCH_COUNTS)
    got = coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
    _close_bf16_fwd(got, coattn.coattn_fwd_fused_k_plain(q, kv, wk, bk, mask))
    assert all(torch.equal(x, y) for x, y in zip(got, coattn.coattn_fwd_fused_k(q, kv, wk, bk,
                                                                                mask)))
    fwd = coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, 0.25)
    _close_bf16_fwd(fwd, coattn.coattn_fwd_fused_k_train_plain(q, kv, wk, bk, mask, seed, 0.25))
    o, l, m, ssq, sumw = fwd
    g = torch.Generator().manual_seed(m_len)
    dout = torch.randn(b, n, e, generator=g).to(dev).to(BF16)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    di = (o.float() * dout.float()).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, kv, wk, bk, mask, seed, 0.25, dout, l, m, di, dssq, dsumw)
    grads = coattn.coattn_bwd_fused_k(*args)
    again = coattn.coattn_bwd_fused_k(*args)
    ref = coattn.coattn_bwd_fused_k_plain(q, kv, wk, bk, mask, seed, 0.25, dout, dssq, dsumw)
    one = mask.sum(-1) == 1  # dq of a one-key bag: noise on both sides (its terms cancel)
    for name, a, r in zip(("dq", "dkv", "dwk", "dbk"), grads, ref):
        assert a.dtype == BF16, name
        if name == "dq":
            a, r = a[~one], r[~one]
        _close_rel(a.float(), r.float(), BF16_GRAD_RTOL)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    has = mask.any(-1)
    assert bool((grads[1][has][~mask[has]] == 0).all())
    torch.cuda.synchronize()
    for name, calls in (("coattn_fwd_fused_k_bf16", 2), ("coattn_fwd_fused_k_train_bf16", 1),
                        ("coattn_bwd_fused_k_bf16", 2), ("coattn_fwd_fused_k", 0),
                        ("coattn_bwd_fused_k", 0)):
        assert coattn.LAUNCH_COUNTS[name] == before[name] + calls, name


@pytest.mark.parametrize("pre_gate", [False, True])
@pytest.mark.parametrize("d", [128, 256, 512])
@pytest.mark.parametrize("kind", ["holes", "one", "prefix"])
def test_bf16_export_instances_match_plain_on_card(dev, kind, d, pre_gate):
    """The bfloat16 export passes (stats, weights, both on one tile list)
    against their plain versions; two runs bitwise equal; w exactly 0 at
    the masked keys of a bag with a valid key, 1/M in a bag without one."""
    b, n, m_len = 3, 6, 1500
    q, _, _, _, k, mask = _bf16_inputs(dev, b, n, d, m_len, kind, d + 7)
    before = dict(coattn.LAUNCH_COUNTS)
    l, m = coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)
    lp, mp = coattn.coattn_stats_plain(q, k, mask, pre_gate=pre_gate)
    _close(l, lp, rtol=BF16_STAT_TOL)
    _close(m, mp, atol=BF16_STAT_TOL)
    w = coattn.coattention_weights(q, k, mask, pre_gate=pre_gate)
    wp = coattn.coattn_weights_plain(q, k, mask, lp, mp, pre_gate=pre_gate)
    assert w.dtype == torch.float32
    _close(w, wp, rtol=BF16_STAT_TOL, atol=W_ATOL)
    assert torch.equal(w, coattn.coattention_weights(q, k, mask, pre_gate=pre_gate))
    assert torch.equal(coattn.coattn_weights(q, k, mask, l, m, pre_gate=pre_gate),
                       coattn.coattn_weights(q, k, mask, l, m, pre_gate=pre_gate))
    has = mask.any(-1)
    masked = (~mask & has[:, None])[:, None, :].expand_as(w)
    assert bool((w[masked] == 0).all())
    assert bool((w[~has] == 1.0 / m_len).all())
    torch.cuda.synchronize()
    assert coattn.LAUNCH_COUNTS["coattn_stats_bf16"] == before["coattn_stats_bf16"] + 3
    assert coattn.LAUNCH_COUNTS["coattn_weights_bf16"] == before["coattn_weights_bf16"] + 4
    assert coattn.LAUNCH_COUNTS["coattn_stats"] == before["coattn_stats"]


def test_bf16_wrappers_refuse_what_the_instances_do_not_take(dev):
    """The eval form at E = 512 with F = 256 (float32 takes it; the bfloat16
    instances take E = F) has no bfloat16 instance (the wrapper refuses such
    a shape; the dispatchers raise before a wrapper is reached: the next
    test); the plain-K form with values has one at every shipped width and
    refuses only a width without an instance; mixed types raise."""
    q, kv, wk, bk, k, mask = _bf16_inputs(dev, 2, 3, 512, 300, "prefix", 5)
    kv, wk = kv[..., :256].contiguous(), wk[:256].contiguous()
    with pytest.raises(ValueError, match="unsupported shape"):
        coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
    q, kv, wk, bk, k, mask = _bf16_inputs(dev, 2, 3, 256, 300, "prefix", 6)
    with pytest.raises(TypeError, match="bfloat16"):
        coattn.coattn_fwd_fused_k(q, kv.float(), wk, bk, mask)
    with pytest.raises(TypeError, match="bfloat16"):
        coattn.coattn_fwd_plain_k(q, k, k.float(), mask, pre_gate=False, train=False)
    with pytest.raises(ValueError, match="unsupported shape"):
        coattn.coattn_fwd_plain_k(q[..., :192].contiguous(), k[..., :192].contiguous(),
                                  k[..., :192].contiguous(), mask, pre_gate=False, train=False)
    assert not coattn.fused_k_supports(3, 512, 256, 300, train=False, dtype=BF16)
    assert coattn.fused_k_supports(3, 512, 256, 300, train=False)
    assert coattn.fused_k_supports(3, 512, 512, 300, train=True, dtype=BF16)
    assert all(coattn.plain_k_supports(3, d, 300, values=True, dtype=BF16)
               for d in (128, 256, 512))


def test_bf16_shapes_without_an_instance_raise_on_card(dev, tmp_path):
    """On the card a bfloat16 module at a shape that a float32 kernel takes
    and no bfloat16 instance does raises before any launch (kernels.takes),
    where the CPU takes attention_core: the eval fuse-K form at E = 512 with
    F = 256. NaCAGaT ``big``'s pre-gated co-attention (fuse-K at E = F =
    512), its export map (D = 512) and the plain-K form with values (D =
    256, ``lean=False``), once refused, now run on their bfloat16
    instances, within 5e-2 of their largest magnitude of the CPU's plain
    versions on the same weights (the bar the dispatch tests hold the CPU's
    bfloat16 routes to JAX's float32 with: cuBLAS and the CPU round the
    projections at other places); and the Trainer builds NaCAGaT ``big``
    under bfloat16 and trains and validates an epoch on them."""
    import copy

    from multimodal_path_omic_tpu_torch.config import config_from_dict
    from multimodal_path_omic_tpu_torch.data.synthetic import (
        make_synthetic_cohort,
        synthetic_config_dict,
    )
    from multimodal_path_omic_tpu_torch.ops.attention import MultiheadAttention
    from multimodal_path_omic_tpu_torch.ops.layers import set_compute_dtype
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    from multimodal_path_omic_tpu_torch.ops.kernels import takes

    before = dict(coattn.LAUNCH_COUNTS)
    with pytest.raises(NotImplementedError, match="queue 2 item 5"):
        takes("fuse-K", coattn.fused_k_supports, dev, 6, 512, 256, 100, train=False, dtype=BF16)
    assert not takes("fuse-K", coattn.fused_k_supports, "cpu", 6, 512, 256, 100, train=False,
                     dtype=BF16)
    assert dict(coattn.LAUNCH_COUNTS) == before
    g = torch.Generator().manual_seed(0)
    mask = torch.ones(2, 100, dtype=torch.bool)
    for e, pre_gate, lean, need in ((512, True, True, False), (512, True, True, True),
                                    (256, False, False, False)):
        module = set_compute_dtype(MultiheadAttention(e, 1, pre_gate=pre_gate, lean=lean),
                                   BF16).eval()
        q = torch.randn(2, 6, e, generator=g)
        kv = torch.randn(2, 100, e, generator=g)
        card = copy.deepcopy(module).to(dev)
        qd, kvd, maskd = q.to(dev), kv.to(dev), mask.to(dev)  # key is value: the lean routes
        before = dict(coattn.LAUNCH_COUNTS)
        with torch.no_grad():
            got = card(qd, kvd, kvd, maskd, need_weights=need)
            ref = module(q, kv, kv, mask, need_weights=need)
        torch.cuda.synchronize()
        launched = {k_: v_ - before[k_] for k_, v_ in coattn.LAUNCH_COUNTS.items()
                    if v_ != before[k_]}
        assert launched and all(k_.endswith("_bf16") for k_ in launched), launched
        for a, r in zip(got, ref):
            if r is not None:
                a, r = a.float().cpu(), r.float()
                assert float((a - r).abs().max()) <= 5e-2 * float(r.abs().max())
    paths = make_synthetic_cohort(str(tmp_path / "cohort"), n_patients=12,
                                  bag_lengths=(48, 80, 120), n_genes=36, n_signatures=4, seed=0)
    raw = synthetic_config_dict(*paths)
    raw["model"].update(name="NaCAGaT", model_size="big", dropout=0.0,
                        checkpoint_dir=str(tmp_path / "ck"))
    raw["training"].update(loss="cesar", epochs=1, test_output_dir=str(tmp_path / "out"))
    raw["tpu"] = {"bag_buckets": [128], "batch_size": 4, "compute_dtype": "bfloat16"}
    trainer = Trainer(config_from_dict(raw), verbose=False, device="cuda")
    coattn.reset_launch_counts()
    train, val = trainer.validated_epoch(0)
    torch.cuda.synchronize()
    assert math.isfinite(train["train_loss"]) and math.isfinite(val["val_loss"])
    assert {k_ for k_, v_ in coattn.LAUNCH_COUNTS.items() if v_} == {
        "coattn_fwd_fused_k_train_bf16", "coattn_bwd_fused_k_bf16", "coattn_stats_bf16",
        "coattn_weights_bf16"}


def test_bf16_nacagat_train_step_on_card_matches_cpu(dev, monkeypatch):
    """NaCAGaT small under bfloat16 compute, one cesar SGD step at dropout 0.
    The card's step (the bfloat16 fuse-K instances, forward and backward)
    against the same step on the card with the plain versions in their
    place, everything else alike: each parameter's update, leaf by leaf,
    within 2e-2 of that leaf's largest update or within twice the distance
    bfloat16 moves the leaf (the card's float32 step on the same weights
    against the plain bfloat16 one). The loss within 1e-2 relative of the
    CPU's bfloat16 step (the plain versions there, and cuBLAS against the
    CPU's products elsewhere: those round at other places, and a ReLU gate
    whose pre-activation lies within bfloat16's resolution of 0 can fall on
    the other side, so the CPU's updates are no per-leaf yardstick). A leaf
    whose gradient sums terms that cancel (H.fc.weight: 4096 patch rows)
    moves by a good share of itself under bfloat16; a leaf the kernels got
    wrong or left at 0 moves by its whole size."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train import loop
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    sizes = (10, 20, 30)
    g = torch.Generator().manual_seed(0)
    batch = {"wsi": torch.randn(4, 1024, 64, generator=g),
             "mask": torch.arange(1024)[None] < torch.tensor([[1024], [700], [300], [90]]),
             "omics": [torch.randn(4, s, generator=g) for s in sizes],
             "label": torch.tensor([0, 1, 2, 3]), "censorship": torch.tensor([0.0, 1, 0, 1]),
             "weight": torch.ones(4)}

    def run(where, dtype):
        model = seeded_init_(build_model("NaCAGaT", omic_sizes=sizes, model_size="small",
                                         dropout=0.0, wsi_dim=64, dtype=dtype), 0).to(where)
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        spec = make_optimizer("sgd", 0.05)
        step = loop.make_train_step(model, "cesar", spec, omic_sizes=sizes, graphs=False)
        b = {k: ([t.to(where) for t in v] if k == "omics" else v.to(where))
             for k, v in batch.items()}
        before = dict(coattn.LAUNCH_COUNTS)
        _, metrics = step(loop.init_train_state(model, spec, 0), b)
        launched = {k: v - before[k] for k, v in coattn.LAUNCH_COUNTS.items() if v != before[k]}
        return float(metrics.loss), {k: (v.detach().cpu() - start[k].cpu())
                                     for k, v in model.state_dict().items()}, launched

    loss_k, upd_k, launched = run(dev, BF16)
    assert launched == {"coattn_fwd_fused_k_train_bf16": 1, "coattn_bwd_fused_k_bf16": 1}
    _, upd_f, _ = run(dev, None)
    loss_c = run("cpu", BF16)[0]
    monkeypatch.setattr(coattn, "coattn_fwd_fused_k_train", coattn.coattn_fwd_fused_k_train_plain)
    monkeypatch.setattr(coattn, "coattn_bwd_fused_k", lambda *a: coattn.coattn_bwd_fused_k_plain(
        *a[:8], *a[11:]))  # the plain version takes no l, m, di
    _, upd_p, launched = run(dev, BF16)
    assert launched == {}
    assert abs(loss_k - loss_c) <= 1e-2 * abs(loss_c)
    shares = {}
    for name, u in upd_p.items():
        err = float((upd_k[name] - u).abs().max())
        moved = float((upd_f[name] - u).abs().max())
        assert err <= max(2e-2 * float(u.abs().max()), 2.0 * moved), (name, err, moved)
        shares[name] = (err / moved if moved else 0.0, err, moved, float(u.abs().max()))
    worst = max(shares, key=lambda k: shares[k][0])
    print(f"largest share of the bfloat16 distance: {shares[worst][0]:.3f} ({worst}); "
          "H.fc.weight: error {1:.3e}, distance {2:.3e}, largest update {3:.3e}".format(
              *shares["H.fc.weight"]))


def test_ge_bf16_trainer_is_refused_on_card(dev):
    """GE-NaCAGaT with tpu.compute_dtype bfloat16 on the card, once refused
    (the flash kernels had no bfloat16 instance): the Trainer's gate now
    passes at every size, and the model at each size takes a training
    forward and backward on the card through its two widths' bfloat16
    instances (1 + 2 forward and 1 + 2 backward launches) with the class
    probabilities within 5e-2 of the CPU's bfloat16 plain versions on the
    same weights (cuBLAS and the CPU round the other matmuls at other
    places) and float32 parameter gradients."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.ops.kernels import takes
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    g = torch.Generator().manual_seed(5)
    wsi = torch.randn(2, 300, 64, generator=g)
    mask = torch.arange(300)[None] < torch.tensor([[300], [170]])
    for size, widths in (("small", (128, 16)), ("medium", (256, 32)), ("big", (512, 64))):
        assert all(takes("flash", flash.supports, dev, 2, widths[0] // w, 300, w, dtype=BF16)
                   for w in widths)
        ys = []
        for where in (dev, "cpu"):
            model = seeded_init_(build_model("GE-NaCAGaT", model_size=size, dropout=0.0,
                                             wsi_dim=64, dtype=BF16), 0).to(where).train()
            before = dict(flash.LAUNCH_COUNTS)
            y, _ = model(wsi.to(where), mask.to(where),
                         generator=torch.Generator(device=where).manual_seed(0))
            y[:, 0].sum().backward()
            assert all(p.grad.dtype == torch.float32 for p in model.parameters())
            ys.append(y.detach().cpu())
            if where == dev:
                torch.cuda.synchronize()
                launched = {k_: v_ - before[k_] for k_, v_ in flash.LAUNCH_COUNTS.items()
                            if v_ != before[k_]}
                assert launched == {f"flash_fwd_d{widths[0]}_bf16": 1,
                                    f"flash_fwd_d{widths[1]}_bf16": 2,
                                    f"flash_bwd_d{widths[0]}_bf16": 1,
                                    f"flash_bwd_d{widths[1]}_bf16": 2}, launched
        assert torch.isfinite(ys[0]).all()
        torch.testing.assert_close(ys[0], ys[1], atol=5e-2, rtol=0)


@pytest.mark.parametrize("m_len", [1500, 1, 20, 333])
@pytest.mark.parametrize("heads,width", [(1, 256), (8, 32), (1, 128), (8, 16), (1, 512), (8, 64)])
def test_bf16_flash_instances_match_plain_on_card(dev, heads, width, m_len):
    """The flash kernels' bfloat16 instances against their bfloat16 plain
    versions (which test_torch_port_flash_bf16.py holds to JAX's library TPU
    kernel), q, k, v read in place from a packed bfloat16 projection. At
    1500 keys: a ragged bag, a bag with whole masked key tiles, a bag of one
    valid key and one without a valid key; at 1 key, 20 (fewer than the
    smallest key tile) and 333 (a multiple of no tile or query block): a
    ragged bag, a bag whose one valid key is the last, one without. o within
    one bfloat16 unit (2^-7) of the magnitude of its terms, sum_j w_j |v_j|
    (a p on the other side of a rounding in the two versions moves o by 2^-8
    of its term; where the terms cancel that is many units of o itself), m
    and l within 1e-4 relative (m also 1e-5 absolute: a one-key row's m may
    sit near 0), dq, dk, dv within 2e-2 of each one's largest magnitude (a
    bag with one valid key has no score gradient: its dq and dk, float32
    noise in both versions, are held to 2e-2 of the terms that cancel, as
    ``_close_flash_grads`` holds float32's; alone where no bag has two valid
    keys); two runs bitwise equal; dq and dk exactly 0 through masked keys;
    one ``_bf16`` launch each way a call, no float32 launch."""
    b = 4 if m_len == 1500 else 3
    seed = width + 2 if m_len == 1500 else width + m_len + 2
    q, k, v, _ = _flash_inputs(dev, b, heads, width, m_len, seed, True, BF16)
    mask = torch.zeros(b, m_len, dtype=torch.bool)
    if m_len == 1500:
        mask[0, :1000] = True
        mask[1, 5:60] = True
        mask[1, 700:790] = True
        mask[2, 1337] = True
    else:
        mask[0, :max(1, m_len * 2 // 3)] = True
        mask[1, m_len - 1] = True
    mask = mask.to(dev)
    before = dict(flash.LAUNCH_COUNTS)
    out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
    ref_out, ref_m, ref_l = flash.flash_attention_plain(q, k, v, mask, return_stats=True)
    assert out.dtype == BF16 and m.dtype == l.dtype == torch.float32
    terms = flash.flash_attention_plain(q, k, v.abs(), mask).float()
    assert torch.isfinite(out).all()
    assert bool(((out.float() - ref_out.float()).abs() <= 2.0 ** -7 * terms).all())
    _close(m, ref_m, 1e-4, atol=1e-5)
    _close(l, ref_l, 1e-4, atol=0.0)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev).to(BF16)
    grads = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
    again = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    one, multi = mask.sum(-1) == 1, bool((mask.sum(-1) > 1).any())
    delta = (dout.float() * out.float()).sum(-1).abs()  # [B, H, L]
    scale = width ** -0.5
    floors = (scale * delta.amax(-1) * k.float().abs().amax((-2, -1)),
              scale * (delta[..., None] * q.float().abs()).sum(-2).amax(-1), None)
    for a, r, floor in zip(grads, flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout),
                           floors):
        assert a.dtype == BF16
        a, r = a.float(), r.float()
        if floor is not None and bool(one.any()):
            limit = 2e-2 * floor[one][..., None, None]
            assert bool((a[one].abs() <= limit).all()) and bool((r[one].abs() <= limit).all())
            if not multi:
                a, r = a[~one], r[~one]
        assert float((a - r).abs().max()) <= 2e-2 * float(r.abs().max())
    dq, dk, _ = grads
    assert float(dk[~mask[:, None, :, None].expand_as(dk)].float().abs().max()) == 0.0
    assert float(dq[-1].float().abs().max()) == 0.0
    torch.cuda.synchronize()
    launched = {k_: v_ - before[k_] for k_, v_ in flash.LAUNCH_COUNTS.items() if v_ != before[k_]}
    assert launched == {f"flash_fwd_d{width}_bf16": 1, f"flash_bwd_d{width}_bf16": 2}


# ---------------------------------------------------------------- the plain-K pair, every width
# The plain-K forward with values and its backward at every shipped width in
# both types: the bfloat16 instances at D 128, 256 and 512 and the float32
# one at D = 512 (``lean=False`` at every size). bfloat16 o within one
# bfloat16 unit of its terms' magnitude, sum_j w_j |v_j| (the attention over
# |v|: a tanh that rounds to the other bfloat16 neighbour in the two
# versions moves a key's weight, and o by that share of its term, which is
# many units of o itself where the terms cancel); l 1e-4 relative, m, ssq
# and sumw 1e-4 absolute (float32 sums of bfloat16 products); dq, dk, dv
# within 2e-2 of each one's largest magnitude (as the fuse-K bfloat16
# instances'); the float32 instance at the float32 bars. Two runs bitwise
# equal; dk and dv exactly 0 at masked keys (dk at every masked key, dv in
# bags with a valid key); each launch counted under its instance's name.
PLAIN_INSTANCES = [(128, BF16), (256, BF16), (512, BF16), (512, torch.float32)]


@pytest.mark.parametrize("pre_gate", [False, True])
@pytest.mark.parametrize("kind", ["holes", "one", "prefix"])
@pytest.mark.parametrize("d,dtype", PLAIN_INSTANCES,
                         ids=["bf16-d128", "bf16-d256", "bf16-d512", "f32-d512"])
def test_plain_k_instances_match_plain_on_card(dev, d, dtype, kind, pre_gate):
    b, n = 3, 6
    m_len = {"holes": 4000, "one": 1500, "prefix": 4096}[kind]
    q, _, _, _, k, _ = _inputs(dev, b, n, d, m_len, d, m_len + d)
    mask = _training_mask(dev, b, m_len, kind, m_len + d + 1)
    g = torch.Generator().manual_seed(d + m_len)
    v = torch.randn(b, m_len, d, generator=g).to(dev)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    dout = torch.randn(b, n, d, generator=g).to(dev).to(dtype)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    seed = torch.tensor([d + m_len], dtype=torch.int32, device=dev)
    bf = dtype == BF16
    before = dict(coattn.LAUNCH_COUNTS)

    def check_fwd(got, ref, rate):
        assert got[0].dtype == dtype
        assert all(t.dtype == torch.float32 for t in got[1:] if t is not None)
        if bf:
            terms = coattn.coattn_fwd_plain_k_plain(q, k, v.abs(), mask, seed, rate,
                                                    pre_gate=pre_gate)[0].float()
            assert bool(((got[0].float() - ref[0].float()).abs() <= BF16_RTOL * terms).all())
        else:
            _close(got[0], ref[0])
        _close(got[1], ref[1], rtol=1e-4 if bf else L_RTOL)
        for a, r in zip(got[2:], ref[2:]):
            if a is not None:
                _close(a, r)

    ev = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
    check_fwd(ev, coattn.coattn_fwd_plain_k_plain(q, k, v, mask, None, 0.0, pre_gate=pre_gate),
              0.0)
    again = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
    assert all(torch.equal(x, y) for x, y in zip(ev[:3], again[:3]))
    fwd = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, 0.25, pre_gate=pre_gate)
    check_fwd(fwd, coattn.coattn_fwd_plain_k_plain(q, k, v, mask, seed, 0.25, pre_gate=pre_gate),
              0.25)
    again = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, 0.25, pre_gate=pre_gate)
    assert all(torch.equal(x, y) for x, y in zip(fwd, again))
    o, l, m, ssq, sumw = fwd
    di = (o.float() * dout.float()).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, k, v, mask, seed, 0.25, dout, l, m, di, dssq, dsumw)
    grads = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
    again = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    ref = coattn.coattn_bwd_plain_k_plain(q, k, v, mask, seed, 0.25, dout, dssq, dsumw,
                                          pre_gate=pre_gate)
    many = mask.sum(-1) != 1  # a one-key bag's dq and dk: noise on both sides
    for i, (a, r) in enumerate(zip(grads, ref)):
        assert a.dtype == dtype
        a, r = a.float(), r.float()
        if i < 2:
            a, r = a[many], r[many]
        _close_rel(a, r, BF16_GRAD_RTOL if bf else GRAD_RTOL)
    if not bf:
        _close_one_key_plain(grads, ref, q, k, mask, fwd, dout, dssq, dsumw, di)
    assert float(grads[1][~mask].float().abs().max()) == 0.0
    has = mask.any(-1)
    assert bool((grads[2][has][~mask[has]] == 0).all())
    torch.cuda.synchronize()
    sfx, other = ("_bf16", "") if bf else ("", "_bf16")
    for name, calls in (("coattn_plain" + sfx, 4), ("coattn_plain_bwd" + sfx, 2),
                        ("coattn_plain" + other, 0), ("coattn_plain_bwd" + other, 0)):
        assert coattn.LAUNCH_COUNTS[name] == before[name] + calls, name


@pytest.mark.parametrize("size,dtype", [("big", torch.float32), ("big", BF16), ("medium", BF16)],
                         ids=["big-f32", "big-bf16", "medium-bf16"])
@pytest.mark.parametrize("model_name", ["MCAT", "NaCAGaT"])
def test_lean_false_every_size_on_card(dev, model_name, size, dtype):
    """``lean=False`` at ``big`` (D = 512) in both types and at ``medium``
    under bfloat16, once ``attention_core`` or a refusal: the Predictor
    launches one plain-K forward of the instance a batch and no other
    kernel, within 1e-4 (float32) or 5e-2 of the largest hazard (bfloat16:
    cuBLAS and the CPU round the projections at other places) of the CPU's;
    a training step launches one forward and one backward."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    rng = np.random.default_rng(1)
    sizes = (10, 20, 30)
    bags = [rng.standard_normal((n, 64), dtype=np.float32) for n in (300, 900, 450)]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in sizes] for _ in bags]
    kw = dict(omic_sizes=sizes, model_size=size, wsi_dim=64, buckets=(512, 1024),
              batch_size=2, loss="ces", seed=3, lean=False,
              dtype=None if dtype == torch.float32 else dtype)
    ref = Predictor(model_name, device="cpu", **kw).predict_bags(bags, omics)
    coattn.reset_launch_counts()
    got = Predictor(model_name, device=dev, **kw).predict_bags(bags, omics)
    torch.cuda.synchronize()
    sfx = "_bf16" if dtype == BF16 else ""
    assert {k_: v_ for k_, v_ in coattn.LAUNCH_COUNTS.items() if v_} == {"coattn_plain" + sfx: 2}
    if dtype == BF16:
        top = float(np.abs(ref["hazards"]).max())
        assert float(np.abs(got["hazards"] - ref["hazards"]).max()) <= 5e-2 * top
    else:
        np.testing.assert_allclose(got["hazards"], ref["hazards"], atol=ATOL, rtol=0)
    model = seeded_init_(build_model(model_name, omic_sizes=sizes, model_size=size, wsi_dim=64,
                                     lean=False, dropout=0.25, dtype=dtype), 0).to(dev).train()
    wsi = torch.from_numpy(rng.standard_normal((2, 512, 64), dtype=np.float32)).to(dev)
    mask = (torch.arange(512)[None] < torch.tensor([[512], [200]])).to(dev)
    om = [torch.from_numpy(rng.standard_normal((2, s), dtype=np.float32)).to(dev) for s in sizes]
    coattn.reset_launch_counts()
    out = model(wsi, om, mask, need_attention=False,
                generator=torch.Generator(device=dev).manual_seed(0))
    out.hazards.sum().backward()
    torch.cuda.synchronize()
    assert {k_: v_ for k_, v_ in coattn.LAUNCH_COUNTS.items() if v_} == {
        "coattn_plain" + sfx: 1, "coattn_plain_bwd" + sfx: 1}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


# float32 l of the slab instances: within SLAB_L_RTOL relative of the plain
# version, which itself sits up to 2.5e-5 from the float64 l (chip_smoke.py
# phase 31's readings: the kernels 8.8e-6 from it; a TF32 control 5.7e-3);
# and within L_RTOL of the float64 l (_l_witness)
SLAB_L_RTOL = 5e-5


def _l_witness(kernel_ls, q, k, mask, pre_gate):
    """The kernels' float32 l (the forward's, export pass 1's) within L_RTOL
    relative of the float64 plain version's."""
    l64 = coattn.coattn_fwd_plain_k_plain(q.double(), k.double(), k[..., :1].double(), mask,
                                          None, 0.0, pre_gate=pre_gate)[1]
    for lk in kernel_ls:
        torch.testing.assert_close(lk.double(), l64, rtol=L_RTOL, atol=0.0)


# (N, M) of the slab-instance test: 9, 50 and 256 queries over 2000 keys, and
# the edges of the query tiles (csrc/plain_k_tiles.cuh: 16, 32 and 64
# queries a block) on ragged M, past one 64-key tile (1077) and below one (45)
SLAB_SHAPES = [(9, 2000), (50, 2000), (256, 2000)] + [
    (n, 1077) for n in (15, 16, 17, 31, 32, 33, 63, 64, 65)] + [
    (n, 45) for n in (17, 33, 65)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [128, 256, 512])
@pytest.mark.parametrize("n,m_len", SLAB_SHAPES)
def test_slab_instances_match_plain_on_card(dev, n, m_len, d, dtype):
    """The plain-K kernels past eight queries (the forward with values and
    its backward in query tiles, the export passes in slabs of eight) against
    their plain versions, with and without the pre-gate, on masks with whole
    masked tiles mid-bag and a bag without a valid key: the forward with
    values (eval form, training form at dropout 0.25), its backward, export
    passes 1 and 2; two runs bitwise equal, dk, dv and w exactly 0 at the
    masked keys of bags with a valid key; one launch of each slab instance a
    call (export pass 1 three: its own call and two coattention_weights).
    Float32 l within SLAB_L_RTOL relative of the plain version and within
    L_RTOL of the float64 l (:func:`_l_witness`). A bag with one valid key
    (the ragged lengths draw one at some shapes) holds dq and dk to the
    terms that cancel (:func:`_close_one_key_plain`; in bfloat16 its dq and
    dk are left out, as the plain-K test at up to eight queries does)."""
    b = 3
    q, _, _, _, k, _ = _inputs(dev, b, n, d, m_len, d, 31 * n + d)
    mask = _training_mask(dev, b, m_len, "holes", n + d)
    g = torch.Generator().manual_seed(n + d)
    v = torch.randn(b, m_len, d, generator=g).to(dev)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    dout = torch.randn(b, n, d, generator=g).to(dev).to(dtype)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    seed = torch.tensor([n + d], dtype=torch.int32, device=dev)
    bf = dtype == BF16
    has = mask.any(-1)
    for pre_gate in (False, True):
        before = dict(coattn.LAUNCH_COUNTS)
        for rate in (0.0, 0.25):
            got = (coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
                   if rate == 0.0 else coattn.coattn_fwd_plain_k(q, k, v, mask, seed, rate,
                                                                 pre_gate=pre_gate))
            ref = coattn.coattn_fwd_plain_k_plain(q, k, v, mask, seed, rate, pre_gate=pre_gate)
            if bf:
                terms = coattn.coattn_fwd_plain_k_plain(q, k, v.abs(), mask, seed, rate,
                                                        pre_gate=pre_gate)[0].float()
                assert bool(((got[0].float() - ref[0].float()).abs() <= BF16_RTOL * terms).all())
            else:
                _close(got[0], ref[0])
            _close(got[1], ref[1], rtol=SLAB_L_RTOL, atol=0.0)
            if rate == 0.0:
                eval_l = got[1]
            for a, r in zip(got[2:], ref[2:]):
                if a is not None:
                    _close(a, r, atol=1e-2 if bf else ATOL)
        fwd = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, 0.25, pre_gate=pre_gate)
        assert all(torch.equal(x, y) for x, y in zip(fwd, coattn.coattn_fwd_plain_k(
            q, k, v, mask, seed, 0.25, pre_gate=pre_gate)))
        o, l, m, ssq, sumw = fwd
        di = (o.float() * dout.float()).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
        args = (q, k, v, mask, seed, 0.25, dout, l, m, di, dssq, dsumw)
        grads = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
        assert all(torch.equal(x, y) for x, y in zip(
            grads, coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)))
        ref = coattn.coattn_bwd_plain_k_plain(q, k, v, mask, seed, 0.25, dout, dssq, dsumw,
                                              pre_gate=pre_gate)
        many = mask.sum(-1) != 1  # a one-key bag's dq and dk: noise on both sides
        for i, (a, r) in enumerate(zip(grads, ref)):
            assert a.dtype == dtype
            a, r = a.float(), r.float()
            if i < 2:
                a, r = a[many], r[many]
            _close_rel(a, r, BF16_GRAD_RTOL if bf else GRAD_RTOL)
        if not bf:
            _close_one_key_plain(grads, ref, q, k, mask, fwd, dout, dssq, dsumw, di)
        assert float(grads[1][~mask].float().abs().max()) == 0.0
        assert bool((grads[2][has][~mask[has]] == 0).all())
        lk, mk = coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)
        lp, mp = coattn.coattn_stats_plain(q, k, mask, pre_gate=pre_gate)
        _close(lk, lp, rtol=BF16_STAT_TOL if bf else SLAB_L_RTOL, atol=0.0)
        if not bf:
            _l_witness((eval_l, lk), q, k, mask, pre_gate)
        _close(mk, mp, atol=BF16_STAT_TOL if bf else ATOL)
        w = coattn.coattention_weights(q, k, mask, pre_gate=pre_gate)
        wp = coattn.coattn_weights_plain(q, k, mask, lp, mp, pre_gate=pre_gate)
        _close(w, wp, rtol=BF16_STAT_TOL if bf else W_RTOL, atol=W_ATOL)
        assert torch.equal(w, coattn.coattention_weights(q, k, mask, pre_gate=pre_gate))
        masked = (~mask & has[:, None])[:, None, :].expand_as(w)
        assert bool((w[masked] == 0).all()) and bool((w[~has] == 1.0 / m_len).all())
        torch.cuda.synchronize()
        sfx = "_bf16" if bf else ""
        for name, calls in (("coattn_plain_slabs", 4), ("coattn_plain_bwd_slabs", 2),
                            ("coattn_stats_slabs", 3), ("coattn_weights_slabs", 2),
                            ("coattn_plain", 0), ("coattn_stats", 0)):
            assert coattn.LAUNCH_COUNTS[name + sfx] == before[name + sfx] + calls, name
