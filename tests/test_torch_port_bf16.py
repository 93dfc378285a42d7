"""The port's bfloat16 compute (``tpu.compute_dtype: bfloat16``) against the
JAX package on the CPU: the plain versions of the four bfloat16 kernel
instances (the fuse-K forward in both forms, its backward, the export
passes' stats and weights) against the Pallas kernels in interpret mode at
bfloat16, on the masks their tile skipping depends on, pre-gate on and off;
NaCAGaT, MCAT and GE-NaCAGaT ``small`` built with ``dtype=torch.bfloat16``
against the JAX models with ``dtype=jnp.bfloat16`` on the same parameters
(outputs, and every parameter's gradient of one training forward); the
survival and class heads stay float32.

Tolerances, each with its reason:

* kernel forward: o within one bfloat16 unit in the last place at o's
  largest magnitude (2^-7 of it): both sides round the same float32 value
  to bfloat16, and a float32 sum in another order can land on the other
  side of a rounding boundary; l, m, ssq, sumw and the weights (float32 on
  both sides, from bfloat16 inputs, k rounded at the same place) 1e-5 of
  their largest magnitude, as the float32 kernels;
* kernel backward: 3e-2 of each gradient's largest magnitude. The JAX
  kernel takes 1 - tanh^2 and the products of bfloat16 operands in
  bfloat16 (``coattn.py:455-477``, ``tq * tq`` of bfloat16 values), where
  the port's instance keeps every sum after the inputs in float32; 1 -
  tanh^2 near |tanh| = 1 loses most of its bits in bfloat16;
* models: hazards and the loss 5e-3 (measured ~7e-4: bfloat16's 2^-8
  relative rounding at other places in the two frameworks, carried through
  ~20 layers to outputs of order 1; the JAX package's own bfloat16 bar
  against float32 is 0.04, ``tests/test_train.py:684``); each parameter's
  gradient, leaf by leaf, within 2e-2 of that leaf's largest magnitude or
  within twice the distance bfloat16 moves the leaf in JAX, the reference:
  the farthest of JAX's float32 gradient of the same weights and JAX's
  bfloat16 gradients at weights nudged by 1e-6 and 1e-4 of themselves
  (``_nudged``) from its bfloat16 one. The nudge stands for rounding at other places: it
  barely moves a float32 gradient, yet a ReLU gate whose
  pre-activation lies within bfloat16's resolution of 0 flips under it, and
  a leaf fed by such a gate (the branch transformers' feed-forward layers,
  MCAT's ``branch_pool.0``) moves by up to its whole size. Measured: the
  port's bfloat16 gradient lies at most 1.132 such distances from JAX's
  (MCAT ``G.fc2_kernel``; NaCAGaT 0.995, GE-NaCAGaT 1.080);
  its largest errors, near a leaf's whole size, sit on leaves JAX's own
  distance exceeds (GE-NaCAGaT's path pool; a softmax bias, whose true
  gradient is 0).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import GENaCAGaT as JGE  # noqa: E402
from multimodal_path_omic_tpu.models import MCAT as JMCAT  # noqa: E402
from multimodal_path_omic_tpu.models import NaCAGaT as JNaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu_torch.models import build_model  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import losses as tlosses  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
)

BF16 = torch.bfloat16
B, N = 2, 3
STAT_RTOL = 1e-5
GRAD_RTOL = 3e-2
MODEL_ATOL = 5e-3
MODEL_GRAD_RTOL = 2e-2
WITNESS_SHARE = 2.0
SIZES = (10, 20, 30)
WSI = 64


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's six workers on
    eight cores, each with a thread a core, oversubscribe them (the host-fed
    Trainers here then run several times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bf(x):
    """float32 values exactly representable in bfloat16 (both sides then
    start from the same inputs)."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _tb(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16)


def _f32(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x).astype(jnp.float32))


def _mask(m_len, case):
    """[B, M] bool, as ``test_torch_port_coattn_fwd.py``'s: whole masked
    64-key tiles mid-bag, a bag with a single valid key, a bag without one,
    M not a multiple of the 64-key tile."""
    mask = np.zeros((B, m_len), bool)
    if case == "holes":
        mask[0, :601] = True
        mask[0, 64:256] = False
        mask[1] = True
        mask[1, 128:192] = False
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


MASKS = [
    pytest.param(640, "holes", id="masked-tiles-mid-bag"),
    pytest.param(500, "single-key", id="single-valid-key"),
    pytest.param(300, "no-valid-key", id="no-valid-key"),
    pytest.param(1000, "ragged-m", id="m-not-tile-multiple"),
]


def _data(e, m_len, seed):
    rng = np.random.default_rng(seed)
    q = _bf(0.7 * rng.normal(size=(B, N, e)))
    kv = _bf(np.maximum(rng.normal(size=(B, m_len, e)), 0))
    wk = _bf(0.7 * rng.normal(size=(e, e)) / math.sqrt(e))
    bk = _bf(0.1 * rng.normal(size=(e,)))
    return q, kv, wk, bk


def _close_max(got, ref, rtol, name):
    got, ref = _f32(got), _f32(ref)
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max(), (name, err, np.abs(ref).max())


# ---------------------------------------------------------------- the kernels


@pytest.mark.parametrize("m_len,case", MASKS)
@pytest.mark.parametrize("e", [128, 256])
@pytest.mark.parametrize("form", ["eval", "train"])
def test_bf16_fused_k_forward_matches_pallas(form, e, m_len, case):
    """The bfloat16 plain version of the fuse-K forward (eval form and
    training form at dropout 0) against the Pallas forward on bfloat16 tiles
    (one tile of M keys): o in bfloat16, l, m, ssq, sumw float32."""
    check_fused_k_forward(form, e, m_len, case, STAT_RTOL)


def check_fused_k_forward(form, e, m_len, case, stat_rtol):
    """:func:`test_bf16_fused_k_forward_matches_pallas`, the statistics
    within ``stat_rtol`` of their largest magnitude."""
    q, kv, wk, bk = _data(e, m_len, e + m_len)
    mask = _mask(m_len, case)
    outs = jcoattn._coattn_fwd_impl(
        _jb(q), _jb(kv), None, jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=True, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=True,
        emit_sumw=True, wk=_jb(wk), bk=_jb(bk).reshape(1, -1))
    ref = [outs[0]] + [np.asarray(x)[:, 0] for x in outs[1:]]
    assert outs[0].dtype == jnp.bfloat16
    args = [_tb(x) for x in (q, kv, wk, bk)] + [torch.from_numpy(mask)]
    if form == "eval":
        o, l, m, sumw = tcoattn.coattn_fwd_fused_k(*args)
        got = [o, l, m, None, sumw]
    else:
        got = list(tcoattn.coattn_fwd_fused_k_train(*args, torch.zeros((1,), dtype=torch.int32),
                                                    0.0))
    assert got[0].dtype == BF16 and got[1].dtype == torch.float32
    _close_max(got[0], ref[0], 2.0 ** -7, "o")
    for name, a, r in zip(("l", "m", "ssq", "sumw"), got[1:], ref[1:]):
        if a is not None:
            _close_max(a, r, stat_rtol, name)


def _grads_jax(q, kv, wk, bk, mask, cot):
    w_o, w_s, w_w = cot

    def loss(q_, kv_, wk_, bk_):
        o, ssq, sumw = jcoattn.coattention_fused_k(
            q_, kv_, wk_, bk_, jnp.asarray(mask), need_ssq=True, need_sumw=True, interpret=True)
        return (jnp.sum(o.astype(jnp.float32) * w_o) + jnp.sum(ssq * w_s)
                + jnp.sum(sumw * w_w))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(*(_jb(x) for x in (q, kv, wk, bk)))


def _grads_port(q, kv, wk, bk, mask, cot):
    """Autograd through ``FusedKTrain`` at bfloat16, and the backward
    wrapper called directly with the forward's l, m and di: both alike."""
    w_o, w_s, w_w = (torch.from_numpy(x) for x in cot)
    mask_t = torch.from_numpy(mask)
    ins = [_tb(x).requires_grad_(True) for x in (q, kv, wk, bk)]
    o, ssq, sumw = tcoattn.fused_attention_leank(*ins, mask_t, need_ssq=True, need_sumw=True)
    assert o.dtype == BF16 and ssq.dtype == torch.float32
    ((o.float() * w_o).sum() + (ssq * w_s).sum() + (sumw * w_w).sum()).backward()
    raw = [t.detach() for t in ins]
    seed = torch.zeros((1,), dtype=torch.int32)
    o, l, m, ssq, sumw = tcoattn.coattn_fwd_fused_k_train(*raw, mask_t, seed, 0.0)
    di = (o.float() * w_o).sum(-1) + 2.0 * w_s * ssq + w_w * sumw
    direct = tcoattn.coattn_bwd_fused_k(*raw, mask_t, seed, 0.0, w_o.to(BF16), l, m, di, w_s,
                                        w_w)
    for a, t in zip(direct, ins):
        assert a.dtype == BF16
        torch.testing.assert_close(a, t.grad, atol=0.0, rtol=0.0)
    return [t.grad for t in ins]


@pytest.mark.parametrize("m_len,case", MASKS[:3])
@pytest.mark.parametrize("e", [128, 256])
def test_bf16_fused_k_backward_matches_pallas(e, m_len, case):
    """dq, dkv, dwk, dbk of the bfloat16 training form against jax.grad
    through the Pallas kernels at bfloat16; dkv exactly 0 at the masked keys
    of a bag with a valid key."""
    check_fused_k_backward(e, m_len, case)


def check_fused_k_backward(e, m_len, case):
    """:func:`test_bf16_fused_k_backward_matches_pallas` at width ``e``."""
    q, kv, wk, bk = _data(e, m_len, e + m_len + 1)
    rng = np.random.default_rng(m_len)
    cot = (_bf(rng.normal(size=(B, N, e))), rng.normal(size=(B, N)).astype(np.float32),
           rng.normal(size=(B, N)).astype(np.float32))
    mask = _mask(m_len, case)
    grads_j = _grads_jax(q, kv, wk, bk, mask, cot)
    grads_t = _grads_port(q, kv, wk, bk, mask, cot)
    for name, got, ref in zip(("dq", "dkv", "dwk", "dbk"), grads_t, grads_j):
        _close_max(got, ref, GRAD_RTOL, name)
    has = mask.any(-1)
    dkv = _f32(grads_t[1])
    assert not np.any(dkv[has][~mask[has]])


@pytest.mark.parametrize("m_len,case", MASKS)
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("pre_gate", [True, False], ids=["pre-gate", "no-pre-gate"])
def test_bf16_export_passes_match_pallas(pre_gate, d, m_len, case):
    """The bfloat16 plain versions of the export passes: (l, m) against the
    Pallas forward's statistics on bfloat16 q, k, and the weights against
    ``coattention_weights`` (both passes) on them; float32 out."""
    check_export_passes(pre_gate, d, m_len, case)


def check_export_passes(pre_gate, d, m_len, case):
    """:func:`test_bf16_export_passes_match_pallas` at width ``d``."""
    rng = np.random.default_rng(d + m_len)
    q = _bf(0.7 * rng.normal(size=(B, N, d)))
    k = _bf(rng.normal(size=(B, m_len, d)) / math.sqrt(d) * 4)
    mask = _mask(m_len, case)
    _, lj, mj, _, _ = jcoattn._coattn_fwd_impl(
        _jb(q), _jb(k), jnp.zeros_like(_jb(k)), jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=pre_gate, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=False)
    l, m = tcoattn.coattn_stats(_tb(q), _tb(k), torch.from_numpy(mask), pre_gate=pre_gate)
    assert l.dtype == torch.float32
    _close_max(l, np.asarray(lj)[:, 0], STAT_RTOL, "l")
    _close_max(m, np.asarray(mj)[:, 0], STAT_RTOL, "m")
    wj = jcoattn.coattention_weights(_jb(q), _jb(k), jnp.asarray(mask), pre_gate=pre_gate,
                                     interpret=True)
    w = tcoattn.coattention_weights(_tb(q), _tb(k), torch.from_numpy(mask), pre_gate=pre_gate)
    assert w.dtype == torch.float32
    _close_max(w, wj, STAT_RTOL, "w")


def test_bf16_plain_versions_round_k_and_tanh():
    """What the bfloat16 instances compute, in float32 terms: the fuse-K
    forward on bfloat16 inputs equals the float32 forward with k = kv wk + bk
    rounded to bfloat16 and tanh(q), tanh(k) rounded to bfloat16, o rounded
    once at the end."""
    q, kv, wk, bk = _data(128, 200, 3)
    mask = torch.from_numpy(_mask(300, "holes")[:, :200])
    seed = torch.zeros((1,), dtype=torch.int32)
    got = tcoattn.coattn_fwd_fused_k_train(*(_tb(x) for x in (q, kv, wk, bk)), mask, seed, 0.0)
    qf, kvf = torch.from_numpy(q), torch.from_numpy(kv)
    k = (kvf @ torch.from_numpy(wk) + torch.from_numpy(bk)).to(BF16).float()
    s = (qf @ k.transpose(-1, -2)) / math.sqrt(128)
    g = torch.tanh(qf).to(BF16).float() @ torch.tanh(k).to(BF16).float().transpose(-1, -2)
    s = torch.where(mask[:, None, :], s * (g + 1.0) * 0.5, torch.full_like(s, tcoattn.NEG))
    w = torch.softmax(s, dim=-1)
    torch.testing.assert_close(got[0], (w @ kvf).to(BF16), atol=0, rtol=2.0 ** -7)
    torch.testing.assert_close(got[4], w.sum(-1), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- the models


def _jax_params(cls, model_size="small", impl="threefry2x32", **kw):
    """A JAX parameter tree, every leaf perturbed with noise. The key names
    its PRNG (``impl``): a JAX ``Trainer`` built earlier in the process sets
    the default to ``rbg`` (its ``tpu.prng_impl``), which would draw other
    weights."""
    rng = np.random.default_rng(0)
    model = cls(model_size=model_size, dropout_rate=0.0, **kw)
    args = ((jnp.zeros((1, 64, WSI)),) if cls is JGE else
            (jnp.zeros((1, 64, WSI)), [jnp.zeros((1, s)) for s in SIZES]))
    params = jax.jit(lambda key: model.init(key, *args, jnp.ones((1, 64), bool),
                                            deterministic=True))(jax.random.key(0, impl=impl))
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
        params["params"])


def _batch(m_len, lengths, seed, classes=4):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    return {
        "wsi": rng.normal(size=(b, m_len, WSI)).astype(np.float32),
        "mask": np.arange(m_len)[None] < np.asarray(lengths)[:, None],
        "omics": [rng.normal(size=(b, s)).astype(np.float32) for s in SIZES],
        "label": rng.integers(0, classes, b).astype(np.int32),
        "censorship": np.array([0.0, 1.0][:b], np.float32),
        "weight": np.ones(b, np.float32),
    }


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _nudged(params, scale):
    """The parameters, each scaled by 1 + ``scale`` noise, ``scale`` far below
    bfloat16's resolution (2^-8): a leaf this moves by much is one whose
    bfloat16 gradient turns on a rounding (a ReLU gate, a near-zero
    pre-activation), not on the weights."""
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: (x * (1.0 + scale * rng.normal(size=x.shape))).astype(np.float32), params)


NUDGES = (1e-6, 1e-4)


def _check_grads(grads, grads_j, witnesses):
    """Each parameter's gradient (float32, as the parameters) against JAX's
    bfloat16 one, leaf by leaf: within MODEL_GRAD_RTOL of that leaf's
    largest magnitude, or within WITNESS_SHARE times the distance bfloat16
    moves the leaf in JAX, the reference: the farthest of ``witnesses``
    (JAX's float32 gradient, its bfloat16 gradients at the ``NUDGES``) from
    its bfloat16 gradient."""
    ref, *others = (jax_params_to_state_dict(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), g)) for g in (grads_j, *witnesses))
    assert all(set(ref) == set(grads) == set(o) for o in others)
    shares = {}
    for name, g in grads.items():
        assert g.dtype == torch.float32, name  # parameters (and their gradients) stay float32
        err = float((g - ref[name]).abs().max())
        top = float(ref[name].abs().max())
        moved = max(float((o[name] - ref[name]).abs().max()) for o in others)
        assert err <= max(MODEL_GRAD_RTOL * top, WITNESS_SHARE * moved), (name, err, top, moved)
        shares[name] = (err / moved if moved else 0.0, err / top if top else 0.0,
                        moved / top if top else 0.0)
    worst = max(shares, key=lambda k: shares[k][0])
    far = max(shares, key=lambda k: shares[k][1])
    print(f"largest share of JAX's bfloat16 distance: {shares[worst][0]:.3f} ({worst}); largest "
          f"error {shares[far][1]:.3f} of the leaf ({far}: JAX's distance {shares[far][2]:.3f})")


def _close_or_witnessed(name, got, ref, witnesses):
    """``got`` against JAX's bfloat16 ``ref``: within MODEL_ATOL, or within
    WITNESS_SHARE times the distance bfloat16 moves it in JAX (the farthest
    of ``witnesses``, as for the gradients)."""
    def dist(a):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(ref, np.float64)).max())

    err, moved = dist(got), max(dist(w) for w in witnesses)
    assert err <= max(MODEL_ATOL, WITNESS_SHARE * moved), (name, err, moved)
    print(f"{name}: {err:.3e}, {err / moved:.3f} of JAX's bfloat16 distance {moved:.3e}")


def _grads(model, fn):
    """The parameters' gradients of ``fn(model)``'s loss."""
    model.zero_grad()
    fn(model).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("name,loss_name", [("NaCAGaT", "cesar"), ("MCAT", "ces")])
def test_survival_models_bf16_match_jax(name, loss_name, monkeypatch):
    """NaCAGaT (the lean-V branch: the fuse-K kernels' bfloat16 plain
    versions; JAX: the Pallas kernels in interpret mode at bfloat16) and
    MCAT (its lean branch) at bfloat16 compute against the JAX models with
    dtype=bfloat16 on the same parameters: eval hazards (and NaCAGaT's
    export map through the export passes), and a training forward's hazards,
    loss and every parameter's gradient (dropout 0)."""
    check_survival_model_bf16(name, loss_name, "small", monkeypatch)


def check_survival_model_bf16(name, loss_name, size, monkeypatch, witnessed=False):
    """:func:`test_survival_models_bf16_match_jax` at model size ``size``
    (M = 512). The gradients leaf by leaf (:func:`_check_grads`); the
    hazards, the map and the loss within MODEL_ATOL, or with ``witnessed``
    by :func:`_close_or_witnessed` (JAX's float32 outputs and its bfloat16
    ones at the ``NUDGES`` the witnesses)."""
    monkeypatch.setenv("MPO_LEANK_MIN_M", "512")
    jcls = JNaCAGaT if name == "NaCAGaT" else JMCAT
    params = _jax_params(jcls, size, n_signatures=len(SIZES))
    batch = _batch(512, (500, 200), 1)
    model_j = jcls(n_signatures=len(SIZES), model_size=size, dropout_rate=0.0,
                   use_pallas=True, dtype=jnp.bfloat16)
    model_j32 = jcls(n_signatures=len(SIZES), model_size=size, dropout_rate=0.0,
                     use_pallas=True)
    wsi, omics, mask = (jnp.asarray(batch["wsi"]), [jnp.asarray(o) for o in batch["omics"]],
                        jnp.asarray(batch["mask"]))
    model = load_jax_params(build_model(name, omic_sizes=SIZES, model_size=size, dropout=0.0,
                                        wsi_dim=WSI, dtype=BF16), params)
    args = (_t(batch["wsi"]), [_t(o) for o in batch["omics"]], _t(batch["mask"]))
    nudged_params = [_nudged(params, scale) for scale in NUDGES]

    def evaluated(m, p):
        o = m.apply({"params": p}, wsi, omics, mask, need_attention=True)
        return np.asarray(o.hazards), _f32(o.attention["coattn"])

    hazards_j, map_j = evaluated(model_j, params)
    model.eval()
    with torch.no_grad():
        out = model(*args, need_attention=True)
    assert out.hazards.dtype == torch.float32  # the survival head stays float32
    got = {"eval hazards": (out.hazards.numpy(), hazards_j),
           "map": (_f32(out.attention["coattn"]), map_j)}
    if witnessed:
        eval_witnesses = [evaluated(model_j32, params)] + [
            evaluated(model_j, p) for p in nudged_params]
        for i, key in enumerate(got):
            _close_or_witnessed(key, *got[key], [w[i] for w in eval_witnesses])
    else:
        for a, r in got.values():
            np.testing.assert_allclose(a, r, atol=MODEL_ATOL)

    need = "ssq" if loss_name == "cesar" else False

    def jloss(p, m=model_j):
        o = m.apply({"params": p}, wsi, omics, mask, deterministic=False, need_attention=need)
        loss, _ = jloop._survival_loss(loss_name, o, jnp.asarray(batch["label"]),
                                       jnp.asarray(batch["censorship"]), None, 0.75,
                                       jnp.asarray(batch["weight"]))
        return loss, o

    value_and_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (loss_j, out_j), grads_j = value_and_grad(params)
    nudged = [value_and_grad(p) for p in nudged_params]
    f32 = jax.jit(jax.value_and_grad(lambda p: jloss(p, model_j32), has_aux=True))(params)
    seen = {}

    def loss_of(m):
        out = m.train()(*args, need_attention=need, generator=torch.Generator().manual_seed(0))
        loss, _ = tlosses.survival_loss(loss_name, out, _t(batch["label"]),
                                        _t(batch["censorship"]), 0.75, _t(batch["weight"]))
        seen.setdefault("out", (out.hazards.detach(), float(loss.detach())))
        return loss

    grads = _grads(model, loss_of)
    hazards, loss = seen["out"]
    if witnessed:
        _close_or_witnessed("training hazards", hazards.numpy(), np.asarray(out_j.hazards),
                            [np.asarray(w[0][1].hazards) for w in (f32, *nudged)])
        _close_or_witnessed("loss", loss, float(loss_j), [float(w[0][0]) for w in (f32, *nudged)])
    else:
        np.testing.assert_allclose(hazards.numpy(), np.asarray(out_j.hazards), atol=MODEL_ATOL)
        np.testing.assert_allclose(loss, float(loss_j), atol=MODEL_ATOL)
    _check_grads(grads, grads_j, [w[1] for w in (f32, *nudged)])


def test_ge_nacagat_bf16_matches_jax():
    """GE-NaCAGaT at bfloat16 on the CPU (the plain versions: the
    self-attentions take the flash kernels' bfloat16 plain versions; no
    MIL-pool kernel takes bfloat16, so the pool takes its eager branch)
    against the JAX model with dtype=bfloat16: the class probabilities,
    float32, and a training forward's gradients."""
    params = _jax_params(JGE)
    batch = _batch(96, (90, 40), 2, classes=3)
    model_j = JGE(model_size="small", dropout_rate=0.0, dtype=jnp.bfloat16)
    wsi, mask = jnp.asarray(batch["wsi"]), jnp.asarray(batch["mask"])
    model = load_jax_params(build_model("GE-NaCAGaT", model_size="small", dropout=0.0,
                                        wsi_dim=WSI, dtype=BF16), params)
    y_j, _ = model_j.apply({"params": params}, wsi, mask)
    model.eval()
    with torch.no_grad():
        y, _ = model(_t(batch["wsi"]), _t(batch["mask"]))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=MODEL_ATOL)

    def jloss(p, m=model_j):
        yj, _ = m.apply({"params": p}, wsi, mask, deterministic=False)
        return -jnp.mean(jnp.log(yj[jnp.arange(2), jnp.asarray(batch["label"])]))

    grads_j = jax.grad(jloss)(params)
    witnesses = [jax.grad(jloss)(params, JGE(model_size="small", dropout_rate=0.0))] + [
        jax.grad(jloss)(_nudged(params, scale)) for scale in NUDGES]

    def loss_of(m):
        y, _ = m.train()(_t(batch["wsi"]), _t(batch["mask"]),
                         generator=torch.Generator().manual_seed(0))
        return -torch.log(y[torch.arange(2), _t(batch["label"]).long()]).mean()

    _check_grads(_grads(model, loss_of), grads_j, witnesses)


def test_bf16_model_tracks_its_float32_self():
    """The algorithm, in float32 terms: the port's bfloat16 NaCAGaT stays
    within the JAX package's own bfloat16 bar (0.04 on the hazards,
    ``tests/test_train.py:684``) of the same weights computing in float32,
    and its parameters stay float32."""
    params = _jax_params(JNaCAGaT, n_signatures=len(SIZES))
    batch = _batch(300, (300, 120), 5)
    args = (_t(batch["wsi"]), [_t(o) for o in batch["omics"]], _t(batch["mask"]))
    outs = []
    for dtype in (None, BF16):
        model = load_jax_params(build_model("NaCAGaT", omic_sizes=SIZES, model_size="small",
                                            dropout=0.0, wsi_dim=WSI, dtype=dtype), params).eval()
        assert all(p.dtype == torch.float32 for p in model.parameters())
        with torch.no_grad():
            outs.append(model(*args, need_attention=False).hazards)
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=0.04)
