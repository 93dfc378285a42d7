"""The port's NaCAGaT training slice against the JAX package on the CPU: the
training form of the fuse-K co-attention and its backward (the plain
versions, which the CUDA kernels are held to on the card) against the Pallas
kernels in interpret mode; dropout; the model's gradients; the losses; the
optimizers; the train step. Same numpy inputs on both sides, weights carried
by the port's weight bridge.

Tolerances: kernel forward 2e-5 absolute and gradients 5e-5 of each
gradient's largest magnitude (float32 in other summation orders); model
outputs, loss and parameter gradients 5e-5 absolute (the per-op noise
carried through ~20 layers); optimizer 1e-7 after 3 steps (the same update
formulas, updates of ~lr); SGD train steps 5e-6 on the parameters (each
update is linear in the gradient, lr times its 5e-5-scale noise); the loss
anchors 5e-5.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import NaCAGaT as JNaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.ops import layers as jlayers  # noqa: E402
from multimodal_path_omic_tpu.ops import losses as jlosses  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu.train import optim as joptim  # noqa: E402
from multimodal_path_omic_tpu_torch.models import NaCAGaT  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import layers as tlayers  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import losses as tlosses  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import (  # noqa: E402
    accumulation_chunks,
    init_train_state,
    make_train_step,
)
from multimodal_path_omic_tpu_torch.train.optim import (  # noqa: E402
    current_lr,
    make_optimizer,
    set_lr,
)
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
    seeded_init_,
)

KERNEL_ATOL = 2e-5
GRAD_RTOL = 5e-5
MODEL_ATOL = 5e-5
OPT_ATOL = 1e-7
STEP_ATOL = 5e-6
B, N, E, F = 2, 3, 128, 256
SIZES = (10, 20, 30)
WSI = 64


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _close(got, ref, atol, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


def _close_rel(got, ref, rtol=GRAD_RTOL):
    got, ref = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(ref)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), np.abs(got - ref).max()


def _coattn_data(m_len, seed, lengths):
    rng = np.random.default_rng(seed)
    q = (0.7 * rng.normal(size=(B, N, E))).astype(np.float32)
    kv = np.maximum(rng.normal(size=(B, m_len, F)), 0).astype(np.float32)
    wk = (0.7 * rng.normal(size=(F, E)) / math.sqrt(F)).astype(np.float32)
    bk = (0.1 * rng.normal(size=(E,))).astype(np.float32)
    mask = None if lengths is None else np.arange(m_len)[None] < np.asarray(lengths)[:, None]
    cot = (rng.normal(size=(B, N, F)).astype(np.float32),
           rng.normal(size=(B, N)).astype(np.float32), rng.normal(size=(B, N)).astype(np.float32))
    return (q, kv, wk, bk, mask), cot


# ---------------------------------------------------------------- kernel level


@pytest.mark.parametrize(
    "m_len,lengths",
    [
        pytest.param(300, (300, 0), id="ragged-m-fully-masked-row"),
        pytest.param(700, (650, 333), id="two-tiles-ragged-mask"),
        pytest.param(512, None, id="no-mask"),
    ],
)
def test_training_form_matches_pallas_with_gradients(m_len, lengths):
    """Dropout 0: o, ssq, sumw and the gradients dq, dkv, dwk, dbk of a loss
    weighting all three outputs, against jax.grad through
    coattention_fused_k(need_ssq, need_sumw) in interpret mode (its custom
    VJP: the backward Pallas kernel)."""
    (q, kv, wk, bk, mask), (w_o, w_s, w_w) = _coattn_data(m_len, m_len, lengths)

    def jloss(q_, kv_, wk_, bk_):
        o, ssq, sumw = jcoattn.coattention_fused_k(
            q_, kv_, wk_, bk_, None if mask is None else jnp.asarray(mask),
            need_ssq=True, need_sumw=True, interpret=True)
        return jnp.sum(o * w_o) + jnp.sum(ssq * w_s) + jnp.sum(sumw * w_w), (o, ssq, sumw)

    (_, outs_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (q, kv, wk, bk)))
    ins = [_t(x).requires_grad_(True) for x in (q, kv, wk, bk)]
    outs = tcoattn.fused_attention_leank(*ins, _t(mask), need_ssq=True, need_sumw=True)
    ((outs[0] * _t(w_o)).sum() + (outs[1] * _t(w_s)).sum() + (outs[2] * _t(w_w)).sum()).backward()
    for got, ref in zip(outs, outs_j):
        _close(got, ref, KERNEL_ATOL)
    for t, ref in zip(ins, grads_j):
        _close_rel(t.grad, ref)


def test_philox_known_answer_vectors():
    """Philox4x32-10 against the known-answer vectors of its authors
    (Random123 kat_vectors)."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for counter, key, want in cases:
        got = tcoattn.philox4x32_10(tuple(torch.tensor(c) for c in counter), key)
        assert [int(x) for x in got] == list(want)


def test_dropout_bits_are_per_element_and_keep_the_rate():
    """The bits of element (b, n, key) do not depend on the shape asked for
    (so not on a kernel's tiles or splits) and differ by seed; over 196,608
    draws the drop share lies within 0.25 +- 0.01."""
    seed = torch.tensor([1234], dtype=torch.int32)
    big = tcoattn.dropout_bits(seed, (4, 6, 8192), "cpu")
    assert torch.equal(tcoattn.dropout_bits(seed, (2, 3, 777), "cpu"), big[:2, :3, :777])
    other = tcoattn.dropout_bits(torch.tensor([1235], dtype=torch.int32), (4, 6, 8192), "cpu")
    assert (other != big).float().mean() > 0.99
    assert int(big.min()) >= 0 and int(big.max()) <= 0xFFFFFFFF
    drop = float((big < tcoattn.dropout_threshold(0.25)).double().mean())
    assert abs(drop - 0.25) < 0.01


def test_training_form_is_torch_dropout_with_a_fixed_mask():
    """Rate 0.25: the plain training form equals normalize-then-drop-and-
    rescale with the keep mask of dropout_bits, l summing the undropped
    weights (a float64 numpy reference); its gradients equal autograd
    through that formula with the mask held fixed, i.e. the backward
    regenerates the forward's bits from the same seed."""
    (q, kv, wk, bk, mask), (w_o, w_s, w_w) = _coattn_data(300, 5, (300, 120))
    seed, rate = torch.tensor([77], dtype=torch.int32), 0.25
    keep = (tcoattn.dropout_bits(seed, (B, N, 300), "cpu")
            >= tcoattn.dropout_threshold(rate)).numpy()
    k = kv.astype(np.float64) @ wk + bk
    s = np.einsum("bne,bme->bnm", q, k) / math.sqrt(E)
    s = s * (np.einsum("bne,bme->bnm", np.tanh(q), np.tanh(k)) + 1.0) / 2.0
    s = np.where(mask[:, None, :], s, tcoattn.NEG)
    p = np.exp(s - s.max(-1, keepdims=True))
    w = np.where(keep, p / p.sum(-1, keepdims=True) / (1.0 - rate), 0.0)
    o, l, m, ssq, sumw = tcoattn.coattn_fwd_fused_k_train_plain(
        *(_t(x) for x in (q, kv, wk, bk, mask)), seed, rate)
    _close(o, w @ kv, KERNEL_ATOL)
    _close(l, p.sum(-1), KERNEL_ATOL, rtol=1e-6)
    _close(ssq, (w * w).sum(-1), KERNEL_ATOL)
    _close(sumw, w.sum(-1), KERNEL_ATOL)
    assert not np.allclose(sumw.numpy(), 1.0)

    def fixed_mask_form(q_, kv_, wk_, bk_):
        k_ = kv_ @ wk_ + bk_
        s_ = torch.matmul(q_, k_.transpose(1, 2)) / math.sqrt(E)
        s_ = s_ * (torch.matmul(torch.tanh(q_), torch.tanh(k_).transpose(1, 2)) + 1.0) / 2.0
        s_ = torch.where(_t(mask)[:, None, :], s_, torch.full_like(s_, tcoattn.NEG))
        w_ = torch.where(_t(keep), torch.softmax(s_, -1) / (1.0 - rate), torch.zeros_like(s_))
        return w_ @ kv_, (w_ * w_).sum(-1), w_.sum(-1)

    grads = []
    for form in ("leank", "fixed"):
        ins = [_t(x).requires_grad_(True) for x in (q, kv, wk, bk)]
        if form == "leank":
            outs = tcoattn.fused_attention_leank(*ins, _t(mask), dropout_rate=rate,
                                                 dropout_seed=seed, need_ssq=True,
                                                 need_sumw=True)
        else:
            outs = fixed_mask_form(*ins)
        ((outs[0] * _t(w_o)).sum() + (outs[1] * _t(w_s)).sum()
         + (outs[2] * _t(w_w)).sum()).backward()
        grads.append([t.grad for t in ins])
    for got, ref in zip(*grads):
        _close_rel(got, ref)


def test_leank_dispatcher_forms():
    """Without dropout, ssq or a gradient to take, fused_attention_leank is
    the eval form; with any of them, the training form. A dropout rate
    needs a seed."""
    (q, kv, wk, bk, mask), _ = _coattn_data(300, 9, (300, 200))
    args = [_t(x) for x in (q, kv, wk, bk, mask)]
    o_eval, sumw = tcoattn.fused_attention_leank(*args, need_sumw=True)
    o_tr, ssq, sumw_tr = tcoattn.fused_attention_leank(*args, need_ssq=True, need_sumw=True)
    _close(o_tr, o_eval, 1e-6)
    _close(sumw_tr, sumw, 1e-6)
    assert ssq.shape == (B, N)
    with pytest.raises(ValueError, match="seed"):
        tcoattn.fused_attention_leank(*args, dropout_rate=0.25)


# ---------------------------------------------------------------- dropout layers


def test_fast_dropout_keep_rule_and_rate():
    """keep_prob is exactly 1 - round(rate * 65536) / 65536; the keep share
    follows it; rate 0 and eval mode are the identity; rate 1 drops all."""
    g = torch.Generator().manual_seed(0)
    for rate in (0.25, 0.3, 0.1):
        keep, keep_prob = tlayers.fast_keep_mask(g, rate, (1000, 1000), "cpu")
        assert keep_prob == 1.0 - round(rate * 65536) / 65536
        assert abs(float(keep.float().mean()) - keep_prob) < 0.003
    x = torch.randn(50, 40, generator=g)
    for drop in (tlayers.FastDropout(0.0), tlayers.AlphaDropout(0.0), tlayers.FastDropout(0.25).eval()):
        assert torch.equal(drop.train(drop.training)(x), x)
    full = tlayers.FastDropout(1.0).train()
    assert torch.equal(full(x, g), torch.zeros_like(x))
    with pytest.raises(ValueError, match="Generator"):
        tlayers.FastDropout(0.25).train()(x)


@pytest.mark.parametrize("cls", ["FastDropout", "AlphaDropout"])
def test_dropout_matches_jax_with_injected_mask(cls, monkeypatch):
    """The port's module, run from a generator, against the JAX module with
    the same keep mask injected into its fast_keep_mask."""
    rate = 0.25
    x = np.random.default_rng(3).normal(size=(4, 6, 32)).astype(np.float32)
    g = torch.Generator().manual_seed(11)
    replay = torch.Generator().manual_seed(11)
    keep, keep_prob = tlayers.fast_keep_mask(replay, rate, x.shape, "cpu")
    got = getattr(tlayers, cls)(rate).train()(_t(x), g)
    monkeypatch.setattr(jlayers, "fast_keep_mask",
                        lambda rng, r, shape: (jnp.asarray(keep.numpy()), keep_prob))
    ref = getattr(jlayers, cls)(rate).apply({}, jnp.asarray(x), deterministic=False,
                                            rngs={"dropout": jax.random.key(0)})
    _close(got, ref, 1e-6)
    assert not keep.all() and keep.any()


# ---------------------------------------------------------------- model


def _jax_params(model_size):
    """A JAX NaCAGaT parameter tree, every leaf perturbed with noise (zero
    biases and unit LayerNorm scales cannot hide a bridge fault)."""
    rng = np.random.default_rng(0)
    model = JNaCAGaT(n_signatures=len(SIZES), model_size=model_size, dropout_rate=0.0)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, WSI)), [jnp.zeros((1, s)) for s in SIZES],
        jnp.ones((1, 64), bool), deterministic=True,
    ))(jax.random.key(0))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def jparams():
    return _jax_params("small")


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


def _port_model(jparams, model_size="small"):
    return load_jax_params(NaCAGaT(SIZES, model_size=model_size, dropout_rate=0.0, wsi_dim=WSI),
                           jparams)


def _port_forward_grads(model, batch):
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(_t(batch["wsi"]), [_t(o) for o in batch["omics"]], _t(batch["mask"]),
                need_attention="ssq", generator=torch.Generator().manual_seed(0))
    loss, _ = tlosses.survival_loss("cesar", out, _t(batch["label"]), _t(batch["censorship"]),
                                    0.75, _t(batch["weight"]))
    loss.backward()
    return out, loss, {k: p.grad.clone() for k, p in model.named_parameters()}


def test_nacagat_training_forward_and_gradients_match_jax(jparams, monkeypatch):
    """Training mode at dropout 0 with need_attention="ssq" (the lean-V
    branch; JAX runs the fuse-K Pallas kernels in interpret mode, forward
    and backward): hazards, coattn_ssq, the cesar loss and every parameter's
    gradient against jax.value_and_grad of the same forward."""
    monkeypatch.setenv("MPO_LEANK_MIN_M", "512")
    _check_training_forward_and_gradients(jparams, "small", _batch(2, 512, (500, 200), 1))


def test_nacagat_big_training_forward_and_gradients_match_jax(monkeypatch):
    """The same at NaCAGaT big (E = F = 512), the slice the fuse-K training
    forward's and backward's E = F = 512 instances serve on the card: the
    port's lean-V gate takes the training form at this width, as JAX's
    leank_eligible does."""
    monkeypatch.setenv("MPO_LEANK_MIN_M", "512")
    calls = []
    for name in ("coattn_fwd_fused_k_train", "coattn_bwd_fused_k"):
        monkeypatch.setattr(tcoattn, name, lambda *a, _fn=getattr(tcoattn, name), _name=name:
                            calls.append(_name) or _fn(*a))
    _check_training_forward_and_gradients(_jax_params("big"), "big",
                                          _batch(2, 512, (500, 130), 4))
    assert calls == ["coattn_fwd_fused_k_train", "coattn_bwd_fused_k"]


def _check_training_forward_and_gradients(jparams, model_size, batch):
    model_j = JNaCAGaT(n_signatures=len(SIZES), model_size=model_size, dropout_rate=0.0,
                       use_pallas=True)

    def jloss(params):
        out = model_j.apply({"params": params}, jnp.asarray(batch["wsi"]),
                            [jnp.asarray(o) for o in batch["omics"]], jnp.asarray(batch["mask"]),
                            deterministic=False, need_attention="ssq")
        loss, _ = jloop._survival_loss("cesar", out, jnp.asarray(batch["label"]),
                                       jnp.asarray(batch["censorship"]), None, 0.75,
                                       jnp.asarray(batch["weight"]))
        return loss, out

    before = jcoattn.DISPATCH_COUNTS["kernel"]
    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    assert jcoattn.DISPATCH_COUNTS["kernel"] > before  # the Pallas kernels ran
    out, loss, grads = _port_forward_grads(_port_model(jparams, model_size), batch)
    _close(out.hazards, out_j.hazards, MODEL_ATOL)
    _close(out.attention["coattn_ssq"], out_j.attention["coattn_ssq"], MODEL_ATOL)
    assert out.attention["coattn"] is None
    _close(loss, loss_j, MODEL_ATOL)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    assert set(ref) == set(grads)
    for name, g in grads.items():
        _close(g, ref[name], MODEL_ATOL)


def test_zero_weight_filler_rows_are_gradient_inert(jparams):
    """A fully-masked weight-0 filler row changes no gradient."""
    batch = _batch(3, 300, (280, 150, 0), 2)
    batch["weight"][2] = 0.0
    model = _port_model(jparams)
    _, _, with_filler = _port_forward_grads(model, batch)
    two = {k: (v[:2] if k != "omics" else [o[:2] for o in v]) for k, v in batch.items()}
    _, _, without = _port_forward_grads(model, two)
    for name, g in with_filler.items():
        _close(g, without[name], 1e-6)


# ---------------------------------------------------------------- losses


HAZARDS = np.array([[0.51, 0.52, 0.49, 0.48]], dtype=np.float32)
SURVS = np.array([[0.5, 0.4, 0.2, 0.1]], dtype=np.float32)


@pytest.mark.parametrize("c,want", [(0.0, 0.6782951951026917), (1.0, 0.1732867956161499)])
def test_ces_golden_anchors(c, want):
    loss = tlosses.cross_entropy_survival(_t(HAZARDS), _t(SURVS), torch.tensor([0]),
                                          torch.tensor([c]))
    assert abs(float(loss) - want) < 5e-5


def test_losses_match_jax():
    """The five losses (and the standalone cesar form) with sample weights,
    l1_reg, and the train step's loss dispatch, against the JAX package."""
    rng = np.random.default_rng(4)
    b = 6
    hz = rng.uniform(0.05, 0.95, (b, 4)).astype(np.float32)
    sv = np.cumprod(1.0 - hz, axis=1).astype(np.float32)
    y = rng.integers(0, 4, b).astype(np.int32)
    c = rng.integers(0, 2, b).astype(np.float32)
    w = np.array([1, 1, 0, 1, 1, 0], np.float32)
    probs = np.exp(rng.normal(size=(b, 4))).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    months = rng.uniform(1, 50, b).astype(np.float32)
    attn = rng.uniform(0, 0.1, (b, 3, 40)).astype(np.float32)
    J, T = jnp.asarray, _t
    pairs = [
        (tlosses.cross_entropy_survival(T(hz), T(sv), T(y), T(c), sample_weight=T(w)),
         jlosses.cross_entropy_survival(J(hz), J(sv), J(y), J(c), sample_weight=J(w))),
        (tlosses.negative_log_likelihood_survival(T(hz), T(sv), T(y), T(c), sample_weight=T(w)),
         jlosses.negative_log_likelihood_survival(J(hz), J(sv), J(y), J(c), sample_weight=J(w))),
        (tlosses.cox_survival(T(-sv.sum(1)), T(months), T(c), sample_weight=T(w)),
         jlosses.cox_survival(J(-sv.sum(1)), J(months), J(c), sample_weight=J(w))),
        (tlosses.survival_classification_tobit(T(probs), T(y), T(c), sample_weight=T(w)),
         jlosses.survival_classification_tobit(J(probs), J(y), J(c), sample_weight=J(w))),
        (tlosses.cross_entropy_on_probs(T(probs), T(y), sample_weight=T(w)),
         jlosses.cross_entropy_on_probs(J(probs), J(y), sample_weight=J(w))),
        (tlosses.l1_reg([T(hz), T(attn)]), jlosses.l1_reg({"a": J(hz), "b": J(attn)})),
    ]
    pairs += list(zip(
        tlosses.cross_entropy_survival_attn_reg(T(hz), T(sv), T(y), T(c), T(attn),
                                                sample_weight=T(w)),
        jlosses.cross_entropy_survival_attn_reg(J(hz), J(sv), J(y), J(c), J(attn),
                                                sample_weight=J(w))))

    class Out:
        hazards, survs, y = T(hz), T(sv), T(probs)
        attention = {"coattn": T(attn)}

    class JOut:
        hazards, survs, y = J(hz), J(sv), J(probs)
        attention = {"coattn": J(attn)}

    for name in ("ce", "ces", "sct", "cesar", "nll", "cox"):
        got = tlosses.survival_loss(name, Out, T(y), T(c), 0.75, T(w), T(months))
        ref = jloop._survival_loss(name, JOut, J(y), J(c), J(months), 0.75, J(w))
        pairs += list(zip(got, ref))
    for got, ref in pairs:
        _close(got, ref, 5e-5, rtol=1e-6)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("name,lr,wd,clip", [("adam", 2e-4, 1e-5, 0.0), ("sgd", 0.05, 0.0, 0.0),
                                             ("adam", 1e-3, 1e-4, 0.5)])
def test_optimizer_matches_optax(name, lr, wd, clip):
    """The same fixed gradients through make_optimizer and the JAX optax
    chain: parameters within 1e-7 after 3 steps. The parameters are of a
    network weight's magnitude (~0.1, where a float32 ulp is ~1e-8; at 1 it
    is 1.2e-7, coarser than the limit)."""
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    p0 = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = joptim.make_optimizer(name, lr, wd, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(_t(v).clone()) for k, v in p0.items()}
    spec = make_optimizer(name, lr, wd, grad_clip=clip)
    opt = spec.init(params.values())
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in params.items():
            p.grad = _t(g[k]).clone()
        spec.update(opt)
    for k, p in params.items():
        _close(p, jp[k], OPT_ATOL)
    assert current_lr(set_lr(opt, 1e-2)) == 1e-2


# ---------------------------------------------------------------- train step


def _jax_train(jparams, batch, steps, lr, patch_budget, l1_lambda):
    model = JNaCAGaT(n_signatures=len(SIZES), model_size="small", dropout_rate=0.0)
    tx = joptim.make_optimizer("sgd", lr)
    step = jloop.make_train_step(model, "cesar", tx, patch_budget=patch_budget,
                                 l1_lambda=l1_lambda)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state = jloop.TrainState(params, tx.init(params), jax.random.key(1), jnp.zeros((), jnp.int32))
    jb = {k: ([jnp.asarray(o) for o in v] if k == "omics" else jnp.asarray(v))
          for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, jb)
        losses.append(float(metrics.loss))
    return jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params)), losses


def _port_train(jparams, batch, steps, lr, patch_budget, l1_lambda):
    model = _port_model(jparams)
    spec = make_optimizer("sgd", lr)
    state = init_train_state(model, spec, seed=0)
    step = make_train_step(model, "cesar", spec, patch_budget=patch_budget, l1_lambda=l1_lambda)
    tb = {k: ([_t(o) for o in v] if k == "omics" else _t(v)) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, tb)
        losses.append(float(metrics.loss))
    assert state.step == steps and metrics.risk.shape == (len(batch["weight"]),)
    return {k: v.detach() for k, v in model.state_dict().items()}, losses


@pytest.mark.parametrize(
    "steps,patch_budget,l1_lambda",
    [pytest.param(1, 262_144, 0.0, id="one-step"),
     pytest.param(3, 262_144, 1e-4, id="three-steps-l1"),
     pytest.param(3, 600, 0.0, id="three-steps-two-chunks")],
)
def test_sgd_train_steps_match_jax(jparams, steps, patch_budget, l1_lambda):
    """SGD (an update linear in the gradient) at dropout 0, cesar: the
    parameters after 1 or 3 steps of make_train_step against the JAX step;
    a patch budget of 600 at B=4, M=300 runs 2 accumulation chunks."""
    batch = _batch(4, 300, (300, 170, 60, 0), 6)
    batch["weight"][3] = 0.0
    assert accumulation_chunks(4, 300, patch_budget, "cesar") == (2 if patch_budget == 600 else 1)
    ref, losses_j = _jax_train(jparams, batch, steps, 0.05, patch_budget, l1_lambda)
    got, losses = _port_train(jparams, batch, steps, 0.05, patch_budget, l1_lambda)
    _close(losses, losses_j, MODEL_ATOL)
    for name, v in got.items():
        _close(v, ref[name], STEP_ATOL)


def test_accumulated_step_equals_one_chunk_step(jparams):
    """Two accumulation chunks give the one-chunk step's parameters."""
    batch = _batch(4, 300, (300, 170, 60, 0), 6)
    batch["weight"][3] = 0.0
    one, _ = _port_train(jparams, batch, 1, 0.05, 262_144, 0.0)
    two, _ = _port_train(jparams, batch, 1, 0.05, 600, 0.0)
    for name, v in one.items():
        _close(two[name], v, 1e-6)


def test_train_step_dropout_is_seeded_by_the_state():
    """With dropout on, two trainers from the same seed take identical steps
    and a different seed another one; no global RNG is read, and a training
    forward without a generator raises."""
    rng = np.random.default_rng(8)
    tb = {k: ([_t(o) for o in v] if k == "omics" else _t(v))
          for k, v in _batch(2, 200, (200, 90), 7).items()}
    losses = []
    for seed in (0, 0, 1):
        torch.manual_seed(int(rng.integers(1 << 30)))  # the global RNG must not matter
        model = seeded_init_(NaCAGaT(SIZES, model_size="small", dropout_rate=0.25,
                                     wsi_dim=WSI), 3)
        spec = make_optimizer("adam", 2e-4, 1e-5)
        state = init_train_state(model, spec, seed)
        state, metrics = make_train_step(model, "cesar", spec)(state, tb)
        losses.append(float(metrics.loss))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    with pytest.raises(ValueError, match="Generator"):  # no generator, no dropout draws
        model.train()(tb["wsi"], tb["omics"], tb["mask"], need_attention="ssq")
