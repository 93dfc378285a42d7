"""The port's fusion heads (``ops/fusion.py``: ``gated_concat`` with and
without ``bug_compat``, ``bilinear``) against the JAX package's, on the same
weights (carried by the port's weight bridge) and the same numpy inputs;
then MCAT and NaCAGaT with each fusion end to end.

Size: ``small`` width (d = 128), B=3 rows; the models with 64-wide patch
features, three signatures, M=48 patches. Bilinear fusion's five dropout
sites in training mode get the same keep masks on both sides (each
package's ``fast_keep_mask`` replaced by one sequence of numpy masks).

Tolerance: outputs and gradients 5e-5 absolute (float32 on both sides in
other summation orders, magnitudes ~1); three Adam steps with weight decay
5e-5 on the parameters. ``bug_compat`` gate gradients are exactly zero.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import MCAT as JMCAT  # noqa: E402
from multimodal_path_omic_tpu.models import NaCAGaT as JNaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import fusion as jfusion  # noqa: E402
from multimodal_path_omic_tpu.ops import layers as jlayers  # noqa: E402
from multimodal_path_omic_tpu.train.optim import make_optimizer as jmake_optimizer  # noqa: E402
from multimodal_path_omic_tpu_torch.models import build_model  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import fusion as tfusion  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import layers as tlayers  # noqa: E402
from multimodal_path_omic_tpu_torch.train.optim import make_optimizer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
    seeded_init_,
)

ATOL = 5e-5
B, D, WSI, M = 3, 128, 64, 48
SIZES = (5, 7, 9)
RATE = 0.25
FUSIONS = [("gated_concat", False), ("gated_concat", True), ("bilinear", False)]
IDS = ["gated_concat", "gated_concat-bug_compat", "bilinear"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, ref, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def _jax_fusion(kind, bug_compat):
    return jfusion.make_fusion(kind, hidden=D, output=D, bug_compat=bug_compat)


def _port_fusion(kind, bug_compat):
    return tfusion.make_fusion(kind, (D, D), D, D, bug_compat=bug_compat)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, D)).astype(np.float32) for _ in range(2)]


def _perturbed(params, seed):
    """Every leaf moved by noise: zero biases cannot hide a dropped leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _fusion_params(kind, bug_compat, x1, x2):
    params = _jax_fusion(kind, bug_compat).init(
        jax.random.key(1), jnp.asarray(x1), jnp.asarray(x2))["params"]
    return _perturbed(params, 2)


def _inject_keep_masks(monkeypatch):
    """The n-th keep-mask draw of each package gets the n-th numpy mask."""
    keep_prob = 1.0 - round(RATE * 65536) / 65536
    counters = {"jax": 0, "torch": 0}

    def mask_for(side, shape):
        keep = np.random.default_rng(500 + counters[side]).random(tuple(shape)) >= RATE
        counters[side] += 1
        return keep

    monkeypatch.setattr(jlayers, "fast_keep_mask",
                        lambda rng, r, shape: (jnp.asarray(mask_for("jax", shape)), keep_prob))
    monkeypatch.setattr(tlayers, "fast_keep_mask",
                        lambda gen, r, shape, device: (_t(mask_for("torch", shape)), keep_prob))
    return counters


@pytest.mark.parametrize("kind,bug_compat", FUSIONS, ids=IDS)
def test_fusion_eval_matches_jax(inputs, kind, bug_compat):
    x1, x2 = inputs
    params = _fusion_params(kind, bug_compat, x1, x2)
    ref = _jax_fusion(kind, bug_compat).apply({"params": params}, jnp.asarray(x1),
                                               jnp.asarray(x2))
    got = load_jax_params(_port_fusion(kind, bug_compat), params).eval()(_t(x1), _t(x2))
    assert got.shape == (B, D)
    _close(got, ref)


@pytest.mark.parametrize("kind,bug_compat", FUSIONS, ids=IDS)
def test_fusion_gradients_match_jax(inputs, kind, bug_compat, monkeypatch):
    """Parameter and input gradients of sum(out * cotangent) in training
    mode; bilinear's five dropout sites draw the same masks on both sides."""
    x1, x2 = inputs
    params = _fusion_params(kind, bug_compat, x1, x2)
    cot = np.random.default_rng(3).normal(size=(B, D)).astype(np.float32)
    counters = _inject_keep_masks(monkeypatch) if kind == "bilinear" else None
    module = _jax_fusion(kind, bug_compat)

    def jloss(p, a, b):
        out = module.apply({"params": p}, a, b, deterministic=False,
                           rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * cot)

    gp, g1, g2 = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(x1), jnp.asarray(x2))
    port = load_jax_params(_port_fusion(kind, bug_compat), params).train()
    a, b = _t(x1).requires_grad_(), _t(x2).requires_grad_()
    (port(a, b, generator=torch.Generator().manual_seed(0)) * _t(cot)).sum().backward()
    if counters is not None:
        assert counters["jax"] == counters["torch"] == 5
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, gp))
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        _close(g, ref[name])
    _close(a.grad, g1)
    _close(b.grad, g2)
    assert float(a.grad.abs().max()) > 1e-3  # not a comparison of zeros


def test_bug_compat_gates_get_zero_gradients(inputs):
    """Under bug_compat the gates get zero gradients (tensors, not None: an
    optimizer still applies weight decay to them, as optax does), while the
    inputs and the MLP get gradients through the gated data path."""
    x1, x2 = inputs
    port = seeded_init_(_port_fusion("gated_concat", True), 0)
    a, b = _t(x1).requires_grad_(), _t(x2).requires_grad_()
    port(a, b).sum().backward()
    gates = {k: p.grad for k, p in port.named_parameters() if k.startswith("gate_")}
    assert sorted(gates) == ["gate_0_bias", "gate_0_kernel", "gate_1_bias", "gate_1_kernel"]
    for name, g in gates.items():
        assert g is not None and torch.count_nonzero(g) == 0, name
    assert float(a.grad.abs().max()) > 1e-3 and float(b.grad.abs().max()) > 1e-3
    assert float(port.fc1.weight.grad.abs().max()) > 1e-3


@pytest.mark.parametrize("kind,bug_compat", FUSIONS, ids=IDS)
def test_seeded_init_draws_the_jax_distributions(kind, bug_compat):
    """``seeded_init_``'s draws follow the JAX inits: the bilinear head's
    Linears N(0, 1/sqrt(fan_in)) with zero biases and its nn.Bilinear
    weights U(+-1/sqrt(in1)); the gates (frozen or not) U(+-1/sqrt(fan_in));
    the same seed gives the same weights."""
    a = seeded_init_(_port_fusion(kind, bug_compat), 3)
    b = seeded_init_(_port_fusion(kind, bug_compat), 3)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    bound = 1.0 / np.sqrt(D)
    for name, p in a.named_parameters():
        if kind == "bilinear" and name.endswith(".bias") and "linear_z" not in name:
            assert torch.count_nonzero(p) == 0, name
        elif kind == "bilinear" and "linear_z" not in name:
            fan_in = p.shape[1]
            assert abs(float(p.std()) * np.sqrt(fan_in) - 1.0) < 0.1, name
        elif kind == "bilinear" or name.startswith("gate_"):
            assert float(p.abs().max()) <= bound + 1e-7, name
            assert p.numel() < 16 or float(p.abs().max()) > 0.5 * bound, name


def test_bug_compat_adam_steps_match_jax(inputs):
    """Three Adam steps (weight decay 1e-2) on the bug_compat head: the
    frozen gates move by weight decay alone, on both sides alike."""
    x1, x2 = inputs
    params = _fusion_params("gated_concat", True, x1, x2)
    module = _jax_fusion("gated_concat", True)
    cot = np.random.default_rng(4).normal(size=(B, D)).astype(np.float32)

    def jloss(p):
        return jnp.sum(module.apply({"params": p}, jnp.asarray(x1), jnp.asarray(x2)) * cot)

    tx = jmake_optimizer("adam", 1e-2, 1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    port = load_jax_params(_port_fusion("gated_concat", True), params)
    spec = make_optimizer("adam", 1e-2, 1e-2)
    opt = spec.init(port.parameters())
    for _ in range(3):
        updates, state = tx.update(jax.grad(jloss)(jp), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt.zero_grad()
        (port(_t(x1), _t(x2)) * _t(cot)).sum().backward()
        spec.update(opt)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in port.named_parameters():
        _close(p, ref[name])
    start = jax_params_to_state_dict(params)
    assert float((port.gate_0_kernel.detach() - start["gate_0_kernel"]).abs().max()) > 1e-4


@pytest.fixture(scope="module")
def model_inputs():
    rng = np.random.default_rng(5)
    wsi = rng.normal(size=(2, M, WSI)).astype(np.float32)
    omics = [rng.normal(size=(2, s)).astype(np.float32) for s in SIZES]
    mask = np.arange(M)[None, :] < np.array([M, 30])[:, None]
    return wsi, omics, mask


@pytest.mark.parametrize("model", ["MCAT", "NaCAGaT"])
@pytest.mark.parametrize("kind,bug_compat", FUSIONS, ids=IDS)
def test_models_with_each_fusion_match_jax(model_inputs, model, kind, bug_compat):
    """The whole model in eval with each fusion: hazards, survs and y, and
    (NaCAGaT with gated_concat) every parameter's gradient of the summed
    hazards."""
    wsi, omics, mask = model_inputs
    jcls = JMCAT if model == "MCAT" else JNaCAGaT
    jmodel = jcls(n_signatures=len(SIZES), model_size="small", fusion=kind,
                  bug_compat=bug_compat)
    args = (jnp.asarray(wsi), [jnp.asarray(o) for o in omics], jnp.asarray(mask))
    params = _perturbed(jmodel.init(jax.random.key(0), *args, deterministic=True)["params"], 6)
    with_grads = model == "NaCAGaT" and kind == "gated_concat"

    def jhaz(p):
        out = jmodel.apply({"params": p}, *args, deterministic=True, need_attention=False)
        return jnp.sum(out.hazards), out

    if with_grads:
        (_, ref), grads_j = jax.jit(jax.value_and_grad(jhaz, has_aux=True))(params)
    else:
        ref = jax.jit(jhaz)(params)[1]
    port = build_model(model, omic_sizes=SIZES, model_size="small", fusion=kind,
                       wsi_dim=WSI, bug_compat=bug_compat)
    port = load_jax_params(port, params).eval()
    out = port(_t(wsi), [_t(o) for o in omics], _t(mask), need_attention=False)
    for k in ("hazards", "survs", "y"):
        _close(getattr(out, k), getattr(ref, k))
    if not with_grads:
        return
    out.hazards.sum().backward()
    ref_g = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    for name, p in port.named_parameters():
        _close(p.grad, ref_g[name])
