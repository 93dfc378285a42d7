"""The port's MCAT slice against the JAX package on the CPU: the plain-K
co-attention with values (the plain versions, which the CUDA kernels are held
to on the card) against the Pallas kernels in interpret mode, forward and
VJP; the row gather; the lean single-head cross-attention; ``MultiheadAttention``
on its lean and fused branches; MCAT in eval and training, lean and
``lean=False``; SGD train steps; the ``Predictor`` in MCAT mode. Same numpy
inputs on both sides, weights carried by the port's weight bridge.

Tolerances: kernel forward 2e-5 absolute and gradients 5e-5 of each
gradient's largest magnitude (float32 in other summation orders); modules
2e-5; model outputs, loss and parameter gradients 5e-5 absolute (the per-op
noise carried through ~20 layers); SGD train steps 5e-6 on the parameters;
the gather exact.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import MCAT as JMCAT  # noqa: E402
from multimodal_path_omic_tpu.models import NaCAGaT as JNaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import attention as jattention  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.ops import gather as jgather  # noqa: E402
from multimodal_path_omic_tpu.ops import layers as jlayers  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu.train import optim as joptim  # noqa: E402
from multimodal_path_omic_tpu_torch.models import MCAT, NaCAGaT, build_model  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import attention as tattention  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import gather as tgather  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import layers as tlayers  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import losses as tlosses  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import (  # noqa: E402
    accumulation_chunks,
    init_train_state,
    make_train_step,
)
from multimodal_path_omic_tpu_torch.train.optim import make_optimizer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
    seeded_init_,
)

KERNEL_ATOL = 2e-5
MODULE_ATOL = 2e-5
GRAD_RTOL = 5e-5
MODEL_ATOL = 5e-5
STEP_ATOL = 5e-6
B, N, D = 2, 3, 128
SIZES = (10, 20, 30)
WSI = 64


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _close(got, ref, atol, rtol=0.0):
    got, ref = (x.detach() if isinstance(x, torch.Tensor) else x for x in (got, ref))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


def _close_rel(got, ref, rtol=GRAD_RTOL):
    got, ref = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(ref)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), np.abs(got - ref).max()


def _qkv(m_len, seed, lengths):
    rng = np.random.default_rng(seed)
    q = (0.7 * rng.normal(size=(B, N, D))).astype(np.float32)
    k = (0.7 * rng.normal(size=(B, m_len, D))).astype(np.float32)
    v = rng.normal(size=(B, m_len, D)).astype(np.float32)
    mask = None if lengths is None else np.arange(m_len)[None] < np.asarray(lengths)[:, None]
    cot = (rng.normal(size=(B, N, D)).astype(np.float32),
           rng.normal(size=(B, N)).astype(np.float32), rng.normal(size=(B, N)).astype(np.float32))
    return (q, k, v, mask), cot


# ---------------------------------------------------------------- kernel level

CASES = [
    pytest.param(300, (300, 0), id="one-tile-fully-masked-row"),
    pytest.param(700, (650, 333), id="two-tiles-ragged-mask"),
    pytest.param(512, None, id="no-mask"),
]


@pytest.mark.parametrize("pre_gate", [False, True], ids=["plain", "pre-gate"])
@pytest.mark.parametrize("m_len,lengths", CASES)
def test_plain_k_forward_matches_pallas(m_len, lengths, pre_gate):
    """o, ssq and sumw of the plain-K form with values against
    coattention(need_ssq, need_sumw) in interpret mode. M=700 is no multiple
    of the Pallas tile (512: padded to 1024 there, not here); M=300 is one
    tile, so the fully-masked row is uniform over the same 300 keys on both
    sides."""
    (q, k, v, mask), _ = _qkv(m_len, m_len + pre_gate, lengths)
    ref = jcoattn.coattention(*(jnp.asarray(x) for x in (q, k, v)),
                              None if mask is None else jnp.asarray(mask), pre_gate=pre_gate,
                              need_ssq=True, need_sumw=True, interpret=True)
    got = tcoattn.coattention(_t(q), _t(k), _t(v), _t(mask), pre_gate=pre_gate,
                              need_ssq=True, need_sumw=True)
    for a, r in zip(got, ref):
        _close(a, r, KERNEL_ATOL)
    alone = tcoattn.coattention(_t(q), _t(k), _t(v), _t(mask), pre_gate=pre_gate)
    _close(alone, ref[0], KERNEL_ATOL)  # the eval form: o alone
    if lengths is not None and lengths[-1] == 0:
        _close(got[0][-1], np.broadcast_to(v[-1].mean(0), (N, D)), KERNEL_ATOL)


@pytest.mark.parametrize("pre_gate", [False, True], ids=["plain", "pre-gate"])
@pytest.mark.parametrize("m_len,lengths", CASES)
def test_plain_k_backward_matches_pallas_vjp(m_len, lengths, pre_gate):
    """dq, dk, dv under cotangents on o, ssq and sumw: the port's
    PlainKAttention (its plain backward) against jax.vjp through
    coattention in interpret mode (its custom VJP: the backward Pallas
    kernel)."""
    (q, k, v, mask), cot = _qkv(m_len, 50 + m_len + pre_gate, lengths)
    mask_j = None if mask is None else jnp.asarray(mask)

    def fj(q_, k_, v_):
        return jcoattn.coattention(q_, k_, v_, mask_j, pre_gate=pre_gate, need_ssq=True,
                                   need_sumw=True, interpret=True)

    _, vjp = jax.vjp(fj, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    ins = [_t(x).requires_grad_(True) for x in (q, k, v)]
    outs = tcoattn.coattention(*ins, _t(mask), pre_gate=pre_gate, need_ssq=True, need_sumw=True)
    torch.autograd.backward(outs, [_t(c) for c in cot])
    for t, r in zip(ins, ref):
        _close_rel(t.grad, r)
    if mask is not None:  # the mask is a where: no gradient to a masked key
        assert float(ins[1].grad[~_t(mask)].abs().max()) == 0.0


@pytest.mark.parametrize("pre_gate", [False, True], ids=["plain", "pre-gate"])
def test_plain_k_dropout_is_torch_dropout_with_a_fixed_mask(pre_gate):
    """Rate 0.25: the plain training form equals normalize-then-drop-and-
    rescale with the keep mask of dropout_bits, l summing the undropped
    weights (a float64 numpy reference); its gradients equal autograd
    through that formula with the mask held fixed, i.e. the backward
    regenerates the forward's bits from the same seed."""
    (q, k, v, mask), (w_o, w_s, w_w) = _qkv(300, 5, (300, 120))
    seed, rate = torch.tensor([91], dtype=torch.int32), 0.25
    keep = (tcoattn.dropout_bits(seed, (B, N, 300), "cpu")
            >= tcoattn.dropout_threshold(rate)).numpy()
    s = np.einsum("bnd,bmd->bnm", q.astype(np.float64), k) / math.sqrt(D)
    if pre_gate:
        s = s * (np.einsum("bnd,bmd->bnm", np.tanh(q.astype(np.float64)), np.tanh(k)) + 1.0) / 2.0
    s = np.where(mask[:, None, :], s, tcoattn.NEG)
    p = np.exp(s - s.max(-1, keepdims=True))
    w = np.where(keep, p / p.sum(-1, keepdims=True) / (1.0 - rate), 0.0)
    o, l, m, ssq, sumw = tcoattn.coattn_fwd_plain_k(_t(q), _t(k), _t(v), _t(mask), seed, rate,
                                                    pre_gate=pre_gate)
    _close(o, w @ v, KERNEL_ATOL)
    _close(l, p.sum(-1), KERNEL_ATOL, rtol=1e-6)
    _close(m, s.max(-1), KERNEL_ATOL)
    _close(ssq, (w * w).sum(-1), KERNEL_ATOL)
    _close(sumw, w.sum(-1), KERNEL_ATOL)
    assert not np.allclose(sumw.numpy(), 1.0)

    def fixed_mask_form(q_, k_, v_):
        w_ = torch.where(_t(keep), torch.softmax(tcoattn._scores(q_, k_, _t(mask), pre_gate), -1)
                         / (1.0 - rate), torch.zeros(()))
        return w_ @ v_, (w_ * w_).sum(-1), w_.sum(-1)

    grads = []
    for form in ("kernel-route", "fixed"):
        ins = [_t(x).requires_grad_(True) for x in (q, k, v)]
        outs = (tcoattn.coattention(*ins, _t(mask), pre_gate=pre_gate, dropout_rate=rate,
                                    dropout_seed=seed, need_ssq=True, need_sumw=True)
                if form == "kernel-route" else fixed_mask_form(*ins))
        torch.autograd.backward(outs, [_t(w_o), _t(w_s), _t(w_w)])
        grads.append([t.grad for t in ins])
    for got, ref in zip(*grads):
        _close_rel(got, ref)


def test_coattention_dispatcher_forms_and_checks():
    """Without dropout, a side output or a gradient to take, coattention is
    the eval form (no ssq, no sumw computed); a dropout rate needs a seed; the
    eval form refuses a rate; fused_attention needs a generator for it."""
    (q, k, v, mask), _ = _qkv(300, 9, (300, 200))
    args = [_t(x) for x in (q, k, v, mask)]
    o = tcoattn.coattention(*args)
    o_tr, sumw = tcoattn.coattention(*args, need_sumw=True)
    _close(o_tr, o, 1e-6)
    _close(sumw, np.ones((B, N)), 1e-5)
    assert tcoattn.coattn_fwd_plain_k(*args, pre_gate=False, train=False)[3:] == (None, None)
    with pytest.raises(ValueError, match="seed"):
        tcoattn.coattention(*args, dropout_rate=0.25)
    with pytest.raises(ValueError, match="eval form"):
        tcoattn.coattn_fwd_plain_k(*args, None, 0.25, pre_gate=False, train=False)
    with pytest.raises(ValueError, match="Generator"):
        tcoattn.fused_attention(*(a[:, None] for a in args[:3]), args[3], dropout_rate=0.25)


@pytest.mark.parametrize("pre_gate", [False, True], ids=["plain", "pre-gate"])
def test_fused_attention_folds_heads(pre_gate):
    """Two heads: fused_attention (heads folded into the batch, the mask
    repeated per head) against the JAX attention_core on the same heads:
    out, ssq and sumw per head."""
    rng = np.random.default_rng(12)
    h, m_len = 2, 200
    q = (0.7 * rng.normal(size=(B, h, N, D))).astype(np.float32)
    k = (0.7 * rng.normal(size=(B, h, m_len, D))).astype(np.float32)
    v = rng.normal(size=(B, h, m_len, D)).astype(np.float32)
    mask = np.arange(m_len)[None] < np.array([200, 77])[:, None]
    out_j, w_j = jattention.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), pre_gate=pre_gate,
        dropout_rate=0.0, deterministic=True)
    out, ssq, sumw = tcoattn.fused_attention(_t(q), _t(k), _t(v), _t(mask), pre_gate=pre_gate,
                                             need_ssq=True, need_sumw=True)
    assert out.shape == (B, h, N, D) and ssq.shape == (B, h, N)
    _close(out, out_j, KERNEL_ATOL)
    _close(ssq, (np.asarray(w_j) ** 2).sum(-1), KERNEL_ATOL)
    _close(sumw, np.ones((B, h, N)), KERNEL_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gather_rows_matches_pallas_exactly(dtype):
    """gather_rows (on the CPU its plain version, index_select) against the
    Pallas copy kernel in interpret mode, bit for bit, with repeated
    indices, int32 and int64."""
    rng = np.random.default_rng(3)
    idx = np.array([4, 0, 4, 2, 1, 1], np.int32)
    if dtype == "int8":
        pool = rng.integers(-128, 128, size=(5, 64, 128)).astype(np.int8)
        pool_j, pool_t = jnp.asarray(pool), _t(pool)
    else:
        pool = rng.normal(size=(5, 64, 128)).astype(np.float32)
        pool_j = jnp.asarray(pool, getattr(jnp, dtype))
        pool_t = _t(pool).to(getattr(torch, dtype))
    ref = np.asarray(jgather.gather_rows(pool_j, jnp.asarray(idx), interpret=True)
                     .astype(jnp.float32))
    for ix in (_t(idx), _t(idx).long()):
        got = tgather.take_rows(pool_t, ix)
        assert got.dtype == pool_t.dtype and got.shape == (6, 64, 128)
        assert np.array_equal(got.float().numpy(), ref)
        assert torch.equal(got, tgather.gather_rows_plain(pool_t, ix))


def test_gather_rows_refuses_what_it_does_not_take():
    pool = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError, match="pool"):
        tgather.gather_rows(pool[0], torch.tensor([0]))
    with pytest.raises(TypeError, match="int32 or int64"):
        tgather.gather_rows(pool, torch.tensor([0.0]))
    with pytest.raises(ValueError, match="pool"):
        tgather.gather_rows(pool, torch.tensor([[0]]))


# ---------------------------------------------------------------- attention modules


@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["no-dropout", "injected-mask"])
def test_lean_single_head_cross_attention_matches_jax(rate, monkeypatch):
    """out and the (dropped) weights against the JAX function; with dropout,
    the same keep mask (drawn in attention_core's [B, 1, N, M] layout) is
    injected on both sides."""
    rng = np.random.default_rng(21)
    m_len, f = 90, 96
    q = rng.normal(size=(B, N, D)).astype(np.float32)
    kv = rng.normal(size=(B, m_len, f)).astype(np.float32)
    wk, wv = (rng.normal(size=(f, D)).astype(np.float32) / math.sqrt(f) for _ in range(2))
    bk, bv = (0.1 * rng.normal(size=(D,)).astype(np.float32) for _ in range(2))
    mask = np.arange(m_len)[None] < np.array([90, 41])[:, None]
    keep = rng.random((B, 1, N, m_len)) >= rate
    shapes = []

    def jfake(key, r, shape):
        shapes.append(tuple(shape))
        return jnp.asarray(keep), 1.0 - rate

    def tfake(generator, r, shape, device):
        shapes.append(tuple(shape))
        return _t(keep), 1.0 - rate

    monkeypatch.setattr(jattention, "fast_keep_mask", jfake)
    monkeypatch.setattr(tattention, "fast_keep_mask", tfake)
    out_j, w_j = jattention.lean_single_head_cross_attention(
        *(jnp.asarray(x) for x in (q, kv, wk, bk, wv, bv, mask)), dropout_rate=rate,
        dropout_rng=jax.random.key(0))
    out, w = tattention.lean_single_head_cross_attention(
        *(_t(x) for x in (q, kv, wk, bk, wv, bv, mask)), dropout_rate=rate,
        generator=torch.Generator())
    assert shapes == ([(B, 1, N, m_len)] * 2 if rate else [])
    _close(out, out_j, MODULE_ATOL)
    _close(w, w_j, MODULE_ATOL)


@pytest.fixture(scope="module")
def mha_world():
    """One JAX MultiheadAttention (one head, no pre-gate) parameter tree with
    every leaf perturbed, and co-attention inputs: 3 queries over 640 keys."""
    rng = np.random.default_rng(2)
    m_len = 640
    g = rng.normal(size=(B, N, D)).astype(np.float32)
    h = rng.normal(size=(B, m_len, D)).astype(np.float32)
    mask = np.arange(m_len)[None] < np.array([640, 301])[:, None]
    mod = jattention.MultiheadAttention(embed_dim=D, num_heads=1)
    params = mod.init(jax.random.key(0), jnp.asarray(g), jnp.asarray(h[:, :64]),
                      jnp.asarray(h[:, :64]), jnp.asarray(mask[:, :64]))["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    return dict(g=g, h=h, mask=mask, params=params)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "fused"])
@pytest.mark.parametrize("need_weights", [False, "ssq", True], ids=["none", "ssq", "weights"])
def test_multihead_attention_lean_and_fused_match_jax(mha_world, need_weights, lean,
                                                      monkeypatch):
    """MCAT's co-attention module on its lean branch and, with lean=False,
    on the fused branch (weights: the export branch). The JAX side with the
    lean route switched off runs its fused_attention, made to take the
    plain-K Pallas kernel at this small M (interpret mode)."""
    w = mha_world
    if not lean:
        monkeypatch.setenv("MPO_NO_LEAN_ATTENTION", "1")
        monkeypatch.setattr(jcoattn, "kernel_eligible", lambda n, m, d: True)
    before = jcoattn.DISPATCH_COUNTS["kernel"]
    hj = jnp.asarray(w["h"])
    out_j, second_j = jattention.MultiheadAttention(
        embed_dim=D, num_heads=1, use_pallas=not lean).apply(
            {"params": w["params"]}, jnp.asarray(w["g"]), hj, hj, jnp.asarray(w["mask"]),
            need_weights=need_weights, deterministic=True)
    assert (jcoattn.DISPATCH_COUNTS["kernel"] > before) == (not lean)
    module = load_jax_params(tattention.MultiheadAttention(D, 1, lean=lean), w["params"]).eval()
    ht = _t(w["h"])
    calls = []
    monkeypatch.setattr(tattention, "fused_attention",
                        lambda *a, **k: calls.append(1) or tcoattn.fused_attention(*a, **k))
    out, second = module(_t(w["g"]), ht, ht, _t(w["mask"]), need_weights=need_weights)
    assert len(calls) == (0 if lean or need_weights is True else 1)
    _close(out, out_j, MODULE_ATOL)
    if need_weights is False:
        assert second is None and second_j is None
    else:
        assert second.shape == ((B, N) if need_weights == "ssq" else (B, N, 640))
        _close(second, second_j, MODULE_ATOL)


# ---------------------------------------------------------------- model


@pytest.fixture(scope="module")
def jparams():
    """A JAX MCAT small parameter tree, every leaf perturbed with noise
    (zero biases and unit LayerNorm scales cannot hide a bridge fault)."""
    rng = np.random.default_rng(0)
    model = JMCAT(n_signatures=len(SIZES), model_size="small", dropout_rate=0.0)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, WSI)), [jnp.zeros((1, s)) for s in SIZES],
        jnp.ones((1, 64), bool), deterministic=True,
    ))(jax.random.key(0))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _batch(b, m_len, lengths, seed):
    rng = np.random.default_rng(seed)
    return {
        "wsi": rng.normal(size=(b, m_len, WSI)).astype(np.float32),
        "mask": np.arange(m_len)[None] < np.asarray(lengths)[:, None],
        "omics": [rng.normal(size=(b, s)).astype(np.float32) for s in SIZES],
        "label": rng.integers(0, 4, b).astype(np.int32),
        "censorship": rng.integers(0, 2, b).astype(np.float32),
        "survival_months": rng.uniform(1, 100, b).astype(np.float32),
        "weight": np.ones(b, np.float32),
    }


def _port_model(jparams, lean=True, rate=0.0):
    return load_jax_params(MCAT(SIZES, model_size="small", dropout_rate=rate, wsi_dim=WSI,
                                lean=lean), jparams)


def _jax_apply(jparams, batch, need_attention, deterministic=True, rate=0.0):
    return JMCAT(n_signatures=len(SIZES), model_size="small", dropout_rate=rate).apply(
        {"params": jparams}, jnp.asarray(batch["wsi"]), [jnp.asarray(o) for o in batch["omics"]],
        jnp.asarray(batch["mask"]), deterministic=deterministic, need_attention=need_attention,
        **({} if deterministic else {"rngs": {"dropout": jax.random.key(0)}}))


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "fused"])
@pytest.mark.parametrize("need_attention", [False, "ssq", True], ids=["none", "ssq", "map"])
def test_mcat_eval_matches_jax(jparams, need_attention, lean, monkeypatch):
    """hazards, survs, y, the path / omic MIL scores, the co-attention map
    and coattn_ssq, on the lean route and with the lean routes off on both
    sides."""
    if not lean:
        monkeypatch.setenv("MPO_NO_LEAN_ATTENTION", "1")
    batch = _batch(2, 400, (400, 150), 1)
    out_j = _jax_apply(jparams, batch, need_attention)
    model = _port_model(jparams, lean).eval()
    with torch.inference_mode():
        out = model(_t(batch["wsi"]), [_t(o) for o in batch["omics"]], _t(batch["mask"]),
                    need_attention=need_attention)
    for name in ("hazards", "survs", "y"):
        _close(getattr(out, name), getattr(out_j, name), MODEL_ATOL)
    for key in ("path", "omic"):
        _close(out.attention[key], out_j.attention[key], MODEL_ATOL)
    if need_attention == "ssq":
        assert out.attention["coattn"] is None
        _close(out.attention["coattn_ssq"], out_j.attention["coattn_ssq"], MODEL_ATOL)
    elif need_attention:
        assert out.attention["coattn"].shape == (2, len(SIZES), 400)
        _close(out.attention["coattn"], out_j.attention["coattn"], MODEL_ATOL)
    else:
        assert out.attention["coattn"] is None and out_j.attention["coattn"] is None


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "fused"])
def test_mcat_is_padding_invariant(jparams, lean):
    """A bag padded to 200 or to 512 positions gives the same outputs: pad
    patches are masked out of the co-attention (the only place the patch
    axis is reduced)."""
    batch = _batch(2, 200, (200, 90), 4)
    model = _port_model(jparams, lean).eval()
    outs = []
    for m_len in (200, 512):
        wsi = np.zeros((2, m_len, WSI), np.float32)
        wsi[:, :200] = batch["wsi"]
        wsi[1, 90:] = 7.0  # junk under the mask
        mask = np.arange(m_len)[None] < np.array([200, 90])[:, None]
        with torch.inference_mode():
            outs.append(model(_t(wsi), [_t(o) for o in batch["omics"]], _t(mask),
                              need_attention="ssq"))
    _close(outs[1].hazards, outs[0].hazards, 1e-6)
    _close(outs[1].attention["coattn_ssq"], outs[0].attention["coattn_ssq"], 1e-6)


def _inject_keep_masks(monkeypatch, model, rate):
    """Both packages draw their dropout keep masks through one function
    each; replace both with the same sequence of numpy masks, the n-th call
    getting the n-th mask at the shape it asks for. The JAX model runs its
    two branches as one vmapped module, whose sites draw once for both
    slots; the port's slot 1 therefore replays the masks of slot 0 (its
    counter is set back when branch_transformer[1] starts). A site missing,
    added or out of order on one side gives it other masks."""
    keep_prob = 1.0 - round(rate * 65536) / 65536
    counters = {"jax": 0, "torch": 0, "slot0": None}

    def mask_for(side, shape):
        keep = np.random.default_rng(1000 + counters[side]).random(tuple(shape)) >= rate
        counters[side] += 1
        return keep

    def jfake(rng, r, shape):
        assert r == rate
        return jnp.asarray(mask_for("jax", shape)), keep_prob

    def tfake(generator, r, shape, device):
        assert r == rate and generator is not None
        return torch.from_numpy(mask_for("torch", shape)), keep_prob

    monkeypatch.setattr(jlayers, "fast_keep_mask", jfake)
    monkeypatch.setattr(jattention, "fast_keep_mask", jfake)
    monkeypatch.setattr(tlayers, "fast_keep_mask", tfake)
    monkeypatch.setattr(tattention, "fast_keep_mask", tfake)
    model.branch_transformer[0].register_forward_pre_hook(
        lambda *a: counters.update(slot0=counters["torch"]))
    model.branch_transformer[1].register_forward_pre_hook(
        lambda *a: counters.update(torch=counters["slot0"]))
    return counters


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "fused"])
@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["dropout-off", "injected-masks"])
def test_mcat_training_gradients_match_jax(jparams, rate, lean, monkeypatch):
    """Training mode, ces with a zero-weight filler row: hazards, the loss and
    every parameter's gradient against jax.value_and_grad of the same
    forward, without dropout and with the same keep masks on both sides.
    With lean=False the port's gradients come through PlainKAttention."""
    if not lean:
        monkeypatch.setenv("MPO_NO_LEAN_ATTENTION", "1")
    batch = _batch(3, 300, (300, 140, 0), 2)
    batch["weight"][2] = 0.0
    model = _port_model(jparams, lean, rate).train()
    counters = _inject_keep_masks(monkeypatch, model, rate) if rate else None

    def jloss(params):
        out = _jax_apply(params, batch, False, deterministic=False, rate=rate)
        loss, _ = jloop._survival_loss("ces", out, jnp.asarray(batch["label"]),
                                       jnp.asarray(batch["censorship"]), None, 0.75,
                                       jnp.asarray(batch["weight"]))
        return loss, out

    (loss_j, out_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    bwd_calls = []
    monkeypatch.setattr(tcoattn, "coattn_bwd_plain_k",
                        lambda *a, _f=tcoattn.coattn_bwd_plain_k, **k:
                        bwd_calls.append(1) or _f(*a, **k))
    out = model(_t(batch["wsi"]), [_t(o) for o in batch["omics"]], _t(batch["mask"]),
                need_attention=False, generator=torch.Generator().manual_seed(0))
    loss, _ = tlosses.survival_loss("ces", out, _t(batch["label"]).long(),
                                    _t(batch["censorship"]), 0.75, _t(batch["weight"]))
    loss.backward()
    assert len(bwd_calls) == (0 if lean else 1)
    if rate:
        assert counters["jax"] == counters["torch"] > 3
    _close(out.hazards, out_j.hazards, MODEL_ATOL)
    _close(loss, loss_j, MODEL_ATOL)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(ref) == set(grads)
    for name, g in grads.items():
        _close(g, ref[name], MODEL_ATOL)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3  # not a comparison of zeros


@pytest.mark.parametrize("need_attention", [False, "ssq"])
def test_nacagat_lean_false_equals_its_lean_v_route(need_attention):
    """NaCAGaT with lean=False (k and v projected, the pre-gated plain-K
    route) gives the lean-V route's outputs and parameter gradients."""
    batch = _batch(2, 300, (300, 120), 5)
    res = []
    for lean in (True, False):
        model = seeded_init_(NaCAGaT(SIZES, model_size="small", dropout_rate=0.0, wsi_dim=WSI,
                                     lean=lean), 3).train()
        out = model(_t(batch["wsi"]), [_t(o) for o in batch["omics"]], _t(batch["mask"]),
                    need_attention=need_attention, generator=torch.Generator().manual_seed(0))
        loss, _ = tlosses.survival_loss("cesar" if need_attention else "ces", out,
                                        _t(batch["label"]).long(), _t(batch["censorship"]), 0.75,
                                        _t(batch["weight"]))
        loss.backward()
        res.append((out, {k: p.grad for k, p in model.named_parameters()}))
    (out_a, g_a), (out_b, g_b) = res
    _close(out_b.hazards, out_a.hazards, MODULE_ATOL)
    if need_attention:
        _close(out_b.attention["coattn_ssq"], out_a.attention["coattn_ssq"], MODULE_ATOL)
    for name, g in g_a.items():
        _close(g_b[name], g, MODEL_ATOL)


def test_strict_bridge_raises_on_a_wrong_tree(jparams):
    """A NaCAGaT tree does not load into MCAT (nor MCAT's into NaCAGaT), and
    a tree with a leaf missing or added raises."""
    nacagat = JNaCAGaT(n_signatures=len(SIZES), model_size="small").init(
        jax.random.key(0), jnp.zeros((1, 64, WSI)), [jnp.zeros((1, s)) for s in SIZES],
        jnp.ones((1, 64), bool), deterministic=True)["params"]
    with pytest.raises(RuntimeError, match="co_attention"):
        load_jax_params(MCAT(SIZES, model_size="small", wsi_dim=WSI), nacagat)
    with pytest.raises(RuntimeError, match="co_attention"):
        load_jax_params(NaCAGaT(SIZES, model_size="small", wsi_dim=WSI), jparams)
    missing = {k: v for k, v in jparams.items() if k != "classifier"}
    with pytest.raises(RuntimeError, match="classifier"):
        load_jax_params(MCAT(SIZES, model_size="small", wsi_dim=WSI), missing)
    extra = dict(jparams, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="extra"):
        load_jax_params(MCAT(SIZES, model_size="small", wsi_dim=WSI), extra)


def test_build_model_knows_mcat():
    model = build_model("MCAT", omic_sizes=SIZES, model_size="small", wsi_dim=WSI, lean=False)
    assert isinstance(model, MCAT) and model.co_attention.lean is False
    assert build_model("nacagat", omic_sizes=SIZES, model_size="small").co_attention.mha.lean
    with pytest.raises(ValueError, match="Unknown model"):
        build_model("no-such-model", omic_sizes=SIZES)


# ---------------------------------------------------------------- train step


def _jax_train(jparams, batch, steps, lr, patch_budget):
    model = JMCAT(n_signatures=len(SIZES), model_size="small", dropout_rate=0.0)
    tx = joptim.make_optimizer("sgd", lr)
    step = jloop.make_train_step(model, "ces", tx, patch_budget=patch_budget)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state = jloop.TrainState(params, tx.init(params), jax.random.key(1), jnp.zeros((), jnp.int32))
    jb = {k: ([jnp.asarray(o) for o in v] if k == "omics" else jnp.asarray(v))
          for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, jb)
        losses.append(float(metrics.loss))
    return jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params)), losses


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "fused"])
@pytest.mark.parametrize(
    "steps,patch_budget",
    [pytest.param(1, 262_144, id="one-step"), pytest.param(3, 600, id="three-steps-two-chunks")],
)
def test_mcat_sgd_train_steps_match_jax(jparams, steps, patch_budget, lean):
    """SGD at dropout 0, ces: the parameters after 1 or 3 steps of
    make_train_step against the JAX step (its lean route; the port's two
    routes give the same numbers); a patch budget of 600 at B=4, M=300 runs
    2 accumulation chunks."""
    batch = _batch(4, 300, (300, 170, 60, 0), 6)
    batch["weight"][3] = 0.0
    assert accumulation_chunks(4, 300, patch_budget, "ces") == (2 if patch_budget == 600 else 1)
    ref, losses_j = _jax_train(jparams, batch, steps, 0.05, patch_budget)
    model = _port_model(jparams, lean)
    spec = make_optimizer("sgd", 0.05)
    state = init_train_state(model, spec, seed=0)
    step = make_train_step(model, "ces", spec, patch_budget=patch_budget)
    tb = {k: ([_t(o) for o in v] if k == "omics" else _t(v)) for k, v in batch.items()}
    tb["label"] = tb["label"].long()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, tb)
        losses.append(float(metrics.loss))
    _close(losses, losses_j, MODEL_ATOL)
    for name, v in model.state_dict().items():
        _close(v, ref[name], STEP_ATOL)


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "fused"])
@pytest.mark.parametrize("loss_name", ["ces", "cesar"])
def test_mcat_predict_bags_matches_jax_semantics(jparams, loss_name, lean):
    """Mixed buckets (256, 512), batch_size 2, three bags: outputs come back
    in input order with the filler dropped, and each row equals the JAX
    model on that bag alone, padded to its bucket."""
    rng = np.random.default_rng(1)
    lengths = (200, 400, 250)
    bags = [rng.normal(size=(n, WSI)).astype(np.float32) for n in lengths]
    omics = [[rng.normal(size=s).astype(np.float32) for s in SIZES] for _ in bags]
    pred = Predictor("MCAT", omic_sizes=SIZES, model_size="small", wsi_dim=WSI,
                     buckets=(256, 512), batch_size=2, loss=loss_name, params=jparams,
                     device="cpu", lean=lean)
    got = pred.predict_bags(bags, omics)
    assert set(got) == {"y", "risk", "hazards", "survs"}
    for i, (bag, n) in enumerate(zip(bags, lengths)):
        bucket = 256 if n <= 256 else 512
        wsi = np.zeros((1, bucket, WSI), np.float32)
        wsi[0, :n] = bag
        one = {"wsi": wsi, "omics": [np.asarray(o)[None] for o in omics[i]],
               "mask": np.arange(bucket)[None] < n}
        out = _jax_apply(jparams, one, loss_name == "cesar")
        _close(got["hazards"][i], out.hazards[0], MODEL_ATOL)
        _close(got["survs"][i], out.survs[0], MODEL_ATOL)
        _close(got["y"][i], out.y[0], MODEL_ATOL)
        _close(got["risk"][i], -np.asarray(out.survs[0]).sum(), MODEL_ATOL)
    single = pred.predict_bag(bags[1], omics[1])
    _close(single["risk"], got["risk"][1:2], MODEL_ATOL)


@pytest.mark.parametrize("loss_name", ["ces", "cesar"])
def test_mcat_eval_step_exports_the_map_as_jax(jparams, loss_name):
    """The Predictor's eval step with need_attention=True against the JAX
    eval step: loss, attn_loss, risk and the [B, N, M] co-attention map."""
    batch = _batch(2, 256, (256, 100), 8)
    step_j = jloop.make_eval_step(
        JMCAT(n_signatures=len(SIZES), model_size="small"), loss_name, need_attention=True)
    ref = step_j(jparams, {k: ([jnp.asarray(o) for o in v] if k == "omics" else jnp.asarray(v))
                           for k, v in batch.items()})
    pred = Predictor("MCAT", omic_sizes=SIZES, model_size="small", wsi_dim=WSI, loss=loss_name,
                     params=jparams, device="cpu", need_attention=True)
    tb = {k: ([_t(o) for o in v] if k == "omics" else _t(v)) for k, v in batch.items()}
    tb["label"] = tb["label"].long()
    got = pred.eval_step(tb)
    for key in ("loss", "attn_loss", "risk", "hazards"):
        _close(got[key], ref[key], MODEL_ATOL)
    assert got["attention"]["coattn"].shape == (2, len(SIZES), 256)
    _close(got["attention"]["coattn"], ref["attention"]["coattn"], MODEL_ATOL)
    plain = Predictor("MCAT", omic_sizes=SIZES, model_size="small", wsi_dim=WSI, loss="ces",
                      params=jparams, device="cpu")
    assert plain.eval_step(tb)["attention"] is None
