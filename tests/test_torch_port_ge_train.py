"""The port's GE-NaCAGaT training slice against the JAX package on the CPU:
the flash backward's plain version (which the CUDA kernel is held to on the
card) against ``jax.vjp`` of the attention the JAX model reaches, the
``torch.autograd.Function`` around it, ``MultiheadAttention``'s choice of
branch in training, the model's parameter gradients (dropout off, and on with
the same keep masks injected on both sides) and SGD train steps in GE mode.
Same numpy inputs on both sides, weights carried by the port's weight bridge.

Size: GE-NaCAGaT ``small`` (d = 128; one head of width 128 and eight of width
16), 64-wide patch features, bags of 64-512 patches with ragged masks. The
JAX side runs on the CPU under ``highest`` matmul precision; its long
self-attention goes through ``fused_attention``, which off the TPU takes the
plain key-masked attention, differentiated by ``jax.vjp``/``jax.grad``.

Tolerances: the plain versions 2e-5 absolute (float32 on both sides, other
summation orders, values of magnitude ~1); the model's outputs and parameter
gradients 5e-5 (the per-op noise carried through the layers); SGD train
steps 5e-6 on the parameters (each update is lr times a gradient's noise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import GENaCAGaT as JGENaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import attention as jattention  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.ops import layers as jlayers  # noqa: E402
from multimodal_path_omic_tpu.ops import losses as jlosses  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu.train import optim as joptim  # noqa: E402
from multimodal_path_omic_tpu_torch.models import GENaCAGaT  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import attention as tattention  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import flash as tflash  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import layers as tlayers  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import losses as tlosses  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import (  # noqa: E402
    accumulation_chunks,
    init_train_state,
    make_train_step,
)
from multimodal_path_omic_tpu_torch.train.optim import make_optimizer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
)

KERNEL_ATOL = 2e-5
MODEL_ATOL = 5e-5
STEP_ATOL = 5e-6
WSI, D = 64, 128


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _close(got, ref, atol):
    got, ref = (x.detach() if isinstance(x, torch.Tensor) else x for x in (got, ref))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def _mask(kind, b, m, rng):
    """ragged: every bag keeps a prefix, the last bag nothing (no valid
    key); scattered: random holes; none: no mask."""
    if kind == "none":
        return None
    if kind == "scattered":
        return rng.random((b, m)) > 0.3
    lengths = rng.integers(m // 4, m + 1, size=b)
    lengths[-1] = 0
    return np.arange(m)[None, :] < lengths[:, None]


def _attn_data(heads, width, mask_kind, b=3, m=320):
    rng = np.random.default_rng(heads + len(mask_kind))
    q, k, v, dout = (rng.normal(size=(b, heads, m, width)).astype(np.float32) for _ in range(4))
    return q, k, v, _mask(mask_kind, b, m, rng), dout


# ---------------------------------------------------------------------------
# K6 backward: the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [96, 160])  # 320 rows: a ragged last chunk, and none
@pytest.mark.parametrize("mask_kind", ["ragged", "scattered", "none"])
@pytest.mark.parametrize("heads,width", [(1, 64), (8, 8)])
def test_flash_bwd_plain_matches_jax_vjp_and_autograd(heads, width, mask_kind, chunk):
    """dq, dk, dv of the explicit formulas against jax.vjp of the dispatcher
    the JAX GE model reaches and against autograd through the plain forward;
    the ragged case holds a bag without a valid key."""
    q, k, v, mask, dout = _attn_data(heads, width, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, vjp = jax.vjp(lambda a, b, c: jcoattn.fused_attention(a, b, c, jmask),
                         *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(dout))
    tq, tk, tv = (_t(x) for x in (q, k, v))
    out, m, l = tflash.flash_attention_plain(tq, tk, tv, _t(mask), chunk=chunk,
                                             return_stats=True)
    _close(out, out_j, KERNEL_ATOL)
    grads = tflash.flash_attention_bwd_plain(tq, tk, tv, _t(mask), out, m, l, _t(dout),
                                             chunk=chunk)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tflash.flash_attention_plain(*leaves, _t(mask), chunk=chunk).backward(_t(dout))
    for got, ref, leaf in zip(grads, grads_j, leaves):
        assert got.shape == leaf.shape
        _close(got, ref, KERNEL_ATOL)
        _close(got, leaf.grad, KERNEL_ATOL)


@pytest.mark.parametrize("chunk", [1, 37, 200, 4096])
def test_flash_bwd_plain_chunking_changes_no_value(chunk):
    q, k, v, mask, dout = (_t(x) for x in _attn_data(2, 16, "ragged", b=2, m=200))
    out, m, l = tflash.flash_attention_plain(q, k, v, mask, return_stats=True)
    whole = tflash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout, chunk=200)
    for got, ref in zip(tflash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout,
                                                         chunk=chunk), whole):
        _close(got, ref, 2e-6)


@pytest.mark.parametrize("mask_kind", ["ragged", "scattered", "none"])
def test_flash_plain_statistics_reproduce_out(mask_kind):
    """out = (exp(s - m) / l) v from the returned (m, l); asking for them
    changes no value of out; the bag without a valid key has m = -1e9 and
    l = L (one log-sum-exp could not say so in float32)."""
    q, k, v, mask, _ = (_t(x) for x in _attn_data(2, 16, mask_kind))
    out, m, l = tflash.flash_attention_plain(q, k, v, mask, chunk=96, return_stats=True)
    assert m.shape == l.shape == (3, 2, 320)
    _close(out, tflash.flash_attention_plain(q, k, v, mask, chunk=96), 1e-6)
    s = torch.matmul(q * 0.25, k.transpose(-1, -2))
    if mask is not None:
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e9))
    _close(torch.matmul(torch.exp(s - m[..., None]) / l[..., None], v), out, 1e-6)
    if mask_kind == "ragged":
        assert bool((m[-1] == -1e9).all()) and bool((l[-1] == 320.0).all())
        assert float(np.float32(-1e9) + np.float32(np.log(320.0))) == -1e9


def test_masked_keys_pass_no_gradient_to_q_or_k_but_feed_v():
    """The mask is a where: dk is exactly 0 at every masked key and dq gets
    nothing through one; in the bag without a valid key dq and dk vanish
    altogether, yet its weights 1/L still feed dv: the summed cotangent over
    L, for every key."""
    q, k, v, mask, dout = (_t(x) for x in _attn_data(2, 16, "ragged"))
    out, m, l = tflash.flash_attention_plain(q, k, v, mask, return_stats=True)
    dq, dk, dv = tflash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout)
    pad = ~mask[:, None, :, None].expand_as(dk)
    assert float(dk[pad].abs().max()) == 0.0
    assert float(dq[-1].abs().max()) == 0.0 and float(dk[-1].abs().max()) == 0.0
    _close(dv[-1], (dout[-1].sum(dim=1, keepdim=True) / 320.0).expand_as(dv[-1]), 1e-6)
    # dq of a bag with valid keys does not see its masked keys: scrambling
    # them changes nothing
    k2 = torch.where(pad, torch.randn(k.shape, generator=torch.Generator().manual_seed(0)), k)
    dq2, _, _ = tflash.flash_attention_bwd_plain(q, k2, v, mask, out, m, l, dout)
    _close(dq2[:-1], dq[:-1], 1e-6)


# ---------------------------------------------------------------------------
# The autograd Function and the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_kind", ["ragged", "none"])
def test_flash_function_on_cpu_equals_autograd_through_the_plain_forward(mask_kind):
    q, k, v, mask, dout = (_t(x) for x in _attn_data(8, 8, mask_kind))
    grads = []
    for fn in (lambda a, b, c: tflash.FlashAttention.apply(a, b, c, mask, None),
               lambda a, b, c: tflash.flash_attention(a, b, c, mask),
               lambda a, b, c: tflash.flash_attention_plain(a, b, c, mask)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(dout)
        grads.append([out] + [t.grad for t in leaves])
    for got in grads[:2]:
        for a, ref in zip(got, grads[2]):
            _close(a, ref, KERNEL_ATOL)
    assert tflash.flash_attention(q, k, v, mask).grad_fn is None  # nothing to differentiate


def test_flash_function_gradcheck_in_float64():
    """The plain versions are dtype-generic: numerical against analytical
    Jacobians on a tiny shape with a ragged mask and a bag without a valid
    key, and with a scale other than 1/sqrt(D)."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.normal(size=(2, 2, 7, 4))).requires_grad_(True) for _ in range(3))
    mask = _t(np.arange(7)[None, :] < np.array([5, 0])[:, None])
    assert torch.autograd.gradcheck(
        lambda a, b, c: tflash.FlashAttention.apply(a, b, c, mask, None), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tflash.FlashAttention.apply(a, b, c, None, 0.3), (q, k, v))


def test_flash_counts_no_launch_on_cpu():
    q, k, v, mask, dout = (_t(x) for x in _attn_data(1, 64, "ragged"))
    before = dict(tflash.LAUNCH_COUNTS)
    assert set(before) == {f"flash_{way}_d{w}{sfx}" for way in ("fwd", "bwd")
                           for w in (16, 32, 64, 128, 256, 512) for sfx in ("", "_bf16")}
    tflash.flash_attention(q.requires_grad_(True), k, v, mask).backward(dout)
    assert tflash.LAUNCH_COUNTS == before  # launches are counted on CUDA only


# ---------------------------------------------------------------------------
# MultiheadAttention in training
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append(args)
        return inner(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def _mha_params(d, rng):
    return {
        "in_proj_kernel": rng.normal(size=(d, 3 * d), scale=d ** -0.5).astype(np.float32),
        "in_proj_bias": rng.normal(size=(3 * d,), scale=0.1).astype(np.float32),
        "out_proj": {"kernel": rng.normal(size=(d, d), scale=d ** -0.5).astype(np.float32),
                     "bias": rng.normal(size=(d,), scale=0.1).astype(np.float32)},
    }


@pytest.mark.parametrize(
    "rate,m_len,heads,want",
    [pytest.param(0.0, 64, 1, "flash", id="no-dropout-64"),
     pytest.param(0.0, 33, 8, "flash", id="no-dropout-33-8heads"),
     pytest.param(0.25, 128, 8, "core", id="dropout-128-keeps-the-site"),
     pytest.param(0.25, 4095, 1, "core", id="dropout-4095-keeps-the-site"),
     pytest.param(0.25, 4096, 2, "flash", id="dropout-4096-drops-the-site"),
     pytest.param(0.0, 32, 8, "tiny", id="32-positions-tiny")],
)
def test_training_self_attention_branch_choice(rate, m_len, heads, want, monkeypatch):
    """The JAX module's semantic rule in training mode: flash without active
    attention dropout and from 4096 positions up (the attention-probability
    dropout site dropped: no keep mask is drawn); attention_core with its
    dropout site in between. d = 128: every head width here (128, 64, 16)
    has a kernel instance; widths without one are pinned in
    tests/test_torch_port_dispatch.py."""
    d = 128
    rng = np.random.default_rng(m_len)
    module = load_jax_params(tattention.MultiheadAttention(d, heads, dropout_rate=rate),
                             _mha_params(d, rng)).train()
    flash_calls = _spy(monkeypatch, tattention, "flash_attention")
    core_calls = _spy(monkeypatch, tattention, "attention_core")
    tiny_calls = _spy(monkeypatch, tattention, "tiny_attention")
    draws = _spy(monkeypatch, tlayers, "fast_keep_mask")
    x = _t(rng.normal(size=(1, m_len, d)).astype(np.float32)).requires_grad_(True)
    mask = _t(np.arange(m_len)[None, :] < m_len - 5)
    out, w = module(x, x, x, mask, need_weights=False,
                    generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    assert w is None and x.grad is not None
    assert (len(flash_calls), len(core_calls), len(tiny_calls)) == (
        int(want == "flash"), int(want == "core"), int(want == "tiny"))
    assert len(draws) == (1 if want == "core" else 0)
    # the map on request, cross-attention and pre-gating never take flash
    module(x, x, x, mask, need_weights=True, generator=torch.Generator().manual_seed(0))
    module(x, x.clone(), x, mask, need_weights=False,
           generator=torch.Generator().manual_seed(0))
    assert len(flash_calls) == int(want == "flash")


def test_training_self_attention_at_4096_matches_jax_with_the_site_dropped():
    """L = 4096 with dropout 0.25 live on both sides: the JAX module (with
    use_pallas, deterministic=False) and the port both drop the
    attention-probability dropout site, so the outputs and the input
    gradients agree with no mask shared at all."""
    d, heads, m_len = 16, 2, 4096
    rng = np.random.default_rng(7)
    p = _mha_params(d, rng)
    x = rng.normal(size=(1, m_len, d)).astype(np.float32)
    mask = np.arange(m_len)[None, :] < 3000
    w_out = rng.normal(size=(1, m_len, d)).astype(np.float32)
    jmodule = jattention.MultiheadAttention(embed_dim=d, num_heads=heads, dropout_rate=0.25,
                                            use_pallas=True)

    def jloss(xj):
        out, _ = jmodule.apply({"params": p}, xj, xj, xj, jnp.asarray(mask), need_weights=False,
                               deterministic=False, rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * w_out), out

    (_, out_j), dx_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    module = load_jax_params(tattention.MultiheadAttention(d, heads, dropout_rate=0.25), p)
    xt = _t(x).requires_grad_(True)
    out, _ = module.train()(xt, xt, xt, _t(mask), need_weights=False,
                            generator=torch.Generator().manual_seed(0))
    (out * _t(w_out)).sum().backward()
    _close(out, out_j, MODEL_ATOL)
    _close(xt.grad, dx_j, MODEL_ATOL)


# ---------------------------------------------------------------------------
# The model's gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    """A JAX GE-NaCAGaT small parameter tree, every leaf perturbed with noise
    (zero biases and unit LayerNorm scales cannot hide a bridge fault)."""
    rng = np.random.default_rng(0)
    params = JGENaCAGaT(model_size="small").init(
        jax.random.key(0), jnp.zeros((1, 64, WSI)), jnp.ones((1, 64), bool))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _batch(b, m_len, lengths, seed):
    rng = np.random.default_rng(seed)
    return {
        "wsi": rng.normal(size=(b, m_len, WSI)).astype(np.float32),
        "mask": np.arange(m_len)[None] < np.asarray(lengths)[:, None],
        "label": rng.integers(0, 3, b).astype(np.int32),
        "weight": np.ones(b, np.float32),
    }


def _inject_keep_masks(monkeypatch, rate):
    """Both packages draw their dropout keep masks through one function
    each; replace both with the same sequence of numpy masks, the n-th call
    of either side getting the n-th mask at the shape it asks for. A site
    missing, added or out of order on one side gives it other masks."""
    keep_prob = 1.0 - round(rate * 65536) / 65536
    counters = {"jax": 0, "torch": 0}

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
    return counters


@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["dropout-off", "injected-masks"])
def test_ge_nacagat_training_gradients_match_jax(jparams, rate, monkeypatch):
    """Training mode, B=2 bags over 320 patches with ragged masks, loss ce
    with a zero-weight row: y, the loss and every parameter's gradient
    against jax.value_and_grad of the same forward. Without dropout all
    three self-attentions go through FlashAttention (the plain forward and
    the explicit backward); with dropout 0.25 the model's own does, and the
    two transformer layers keep their attention-probability dropout site
    (320 < 4096), fed the same keep masks as the JAX model's."""
    batch = _batch(3, 320, (320, 130, 0), 1)
    batch["weight"][2] = 0.0
    counters = _inject_keep_masks(monkeypatch, rate) if rate else None
    model_j = JGENaCAGaT(model_size="small", dropout_rate=rate)

    def jloss(params):
        y, _ = model_j.apply({"params": params}, jnp.asarray(batch["wsi"]),
                             jnp.asarray(batch["mask"]), deterministic=False,
                             rngs={"dropout": jax.random.key(0)})
        return jlosses.cross_entropy_on_probs(y, jnp.asarray(batch["label"]),
                                              sample_weight=jnp.asarray(batch["weight"])), y

    (loss_j, y_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    flash_calls = _spy(monkeypatch, tattention, "flash_attention")
    model = load_jax_params(GENaCAGaT("small", dropout_rate=rate, wsi_dim=WSI), jparams).train()
    y, attn = model(_t(batch["wsi"]), _t(batch["mask"]),
                    generator=torch.Generator().manual_seed(0))
    loss = tlosses.cross_entropy_on_probs(y, _t(batch["label"]).long(),
                                          sample_weight=_t(batch["weight"]))
    loss.backward()
    assert len(flash_calls) == (1 if rate else 3) and attn["attn"] is None
    if rate:  # encoder, 2 x (attention weights, 3 layer sites), 3 pool sites
        assert counters["torch"] == counters["jax"] == 12
    _close(y, y_j, MODEL_ATOL)
    _close(loss, loss_j, MODEL_ATOL)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(ref) == set(grads)
    for name, g in grads.items():
        _close(g, ref[name], MODEL_ATOL)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3  # not a comparison of zeros


def test_ge_pad_patches_get_no_input_gradient(jparams):
    """Training inertness: every attention masks the pad patches as keys and
    the pool gives them weight 0, so the loss's gradient with respect to a
    pad patch's features is 0, while the valid patches' is not."""
    batch = _batch(2, 320, (300, 90), 2)
    model = load_jax_params(GENaCAGaT("small", dropout_rate=0.0, wsi_dim=WSI), jparams).train()
    wsi = _t(batch["wsi"]).requires_grad_(True)
    y, _ = model(wsi, _t(batch["mask"]), generator=torch.Generator().manual_seed(0))
    tlosses.cross_entropy_on_probs(y, _t(batch["label"]).long()).backward()
    mask = _t(batch["mask"])
    assert float(wsi.grad[~mask].abs().max()) == 0.0
    assert float(wsi.grad[mask].abs().max()) > 1e-6


# ---------------------------------------------------------------------------
# The train step in GE mode
# ---------------------------------------------------------------------------


def _jax_train(jparams, batch, steps, lr, patch_budget, l1_lambda):
    model = JGENaCAGaT(model_size="small", dropout_rate=0.0)
    tx = joptim.make_optimizer("sgd", lr)
    step = jloop.make_train_step(model, "ce", tx, patch_budget=patch_budget,
                                 l1_lambda=l1_lambda, ge_mode=True)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state = jloop.TrainState(params, tx.init(params), jax.random.key(1), jnp.zeros((), jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, jb)
        losses.append(float(metrics.loss))
    return jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params)), losses


def _port_train(jparams, batch, steps, lr, patch_budget, l1_lambda):
    model = load_jax_params(GENaCAGaT("small", dropout_rate=0.0, wsi_dim=WSI), jparams)
    spec = make_optimizer("sgd", lr)
    state = init_train_state(model, spec, seed=0)
    step = make_train_step(model, "ce", spec, patch_budget=patch_budget, l1_lambda=l1_lambda,
                           ge_mode=True)
    tb = {k: _t(v) for k, v in batch.items()}
    tb["label"] = tb["label"].long()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, tb)
        losses.append(float(metrics.loss))
    b = len(batch["weight"])
    assert state.step == steps and float(metrics.attn_loss) == 0.0
    assert metrics.risk.shape == (b,) and float(metrics.risk.abs().max()) == 0.0
    assert float(metrics.n_real) == float(batch["weight"].sum())
    return {k: v.detach() for k, v in model.state_dict().items()}, losses


@pytest.mark.parametrize(
    "steps,patch_budget,l1_lambda",
    [pytest.param(1, 262_144, 0.0, id="one-step"),
     pytest.param(2, 400, 0.0, id="two-steps-two-chunks"),
     pytest.param(2, 262_144, 1e-4, id="two-steps-l1")],
)
def test_ge_sgd_train_steps_match_jax(jparams, steps, patch_budget, l1_lambda):
    """SGD at dropout 0, loss ce, a zero-weight filler row without a valid
    patch: the parameters after 1 or 2 steps of make_train_step(...,
    ge_mode=True) against the JAX step; a patch budget of 400 at B=4, M=200
    runs 2 accumulation chunks."""
    batch = _batch(4, 200, (200, 120, 50, 0), 6)
    batch["weight"][3] = 0.0
    assert accumulation_chunks(4, 200, patch_budget, "ce") == (2 if patch_budget == 400 else 1)
    ref, losses_j = _jax_train(jparams, batch, steps, 0.05, patch_budget, l1_lambda)
    got, losses = _port_train(jparams, batch, steps, 0.05, patch_budget, l1_lambda)
    _close(losses, losses_j, MODEL_ATOL)
    assert set(got) == set(ref)
    for name, v in got.items():
        _close(v, ref[name], STEP_ATOL)


def test_ge_accumulated_step_equals_one_chunk_step(jparams):
    batch = _batch(4, 200, (200, 120, 50, 0), 6)
    batch["weight"][3] = 0.0
    one, _ = _port_train(jparams, batch, 1, 0.05, 262_144, 0.0)
    two, _ = _port_train(jparams, batch, 1, 0.05, 400, 0.0)
    for name, v in one.items():
        _close(two[name], v, 1e-6)


@pytest.mark.parametrize("loss_name", ["ces", "cesar", "nll", "cox", "sct"])
def test_ge_mode_takes_the_ce_loss_only(loss_name):
    model = GENaCAGaT("small", wsi_dim=WSI)
    with pytest.raises(NotImplementedError, match="ce loss"):
        make_train_step(model, loss_name, make_optimizer("sgd", 0.1), ge_mode=True)


def test_ge_train_step_dropout_is_seeded_by_the_state(jparams):
    """With dropout on, two GE trainers from the same seed take identical
    steps and another seed another one; a training forward without a
    generator raises."""
    tb = {k: _t(v) for k, v in _batch(2, 96, (96, 40), 7).items()}
    tb["label"] = tb["label"].long()
    losses = []
    for seed in (0, 0, 1):
        model = load_jax_params(GENaCAGaT("small", dropout_rate=0.25, wsi_dim=WSI), jparams)
        spec = make_optimizer("adam", 2e-4, 1e-5)
        state = init_train_state(model, spec, seed)
        _, metrics = make_train_step(model, "ce", spec, ge_mode=True)(state, tb)
        losses.append(float(metrics.loss))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    with pytest.raises(ValueError, match="Generator"):
        model.train()(tb["wsi"], tb["mask"])
