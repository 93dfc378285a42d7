"""The port's NaCAGaT serving slice against the JAX package, on the same
weights (carried by the port's weight bridge) and the same numpy inputs.

Size: NaCAGaT ``small`` (d = 128), 256-wide patch features, three
signatures, B=2 bags over M=1024 keys (the JAX fuse-K kernel runs two
512-key tiles in interpret mode, engaged by lowering MPO_LEANK_MIN_M).

Tolerances: modules 2e-5 absolute (float32 on both sides, other summation
orders, outputs of magnitude ~1); the whole model 5e-5 on hazards, survs,
y, risk and the loss (the same per-op noise carried through ~20 layers).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import NaCAGaT as JNaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import attention as jattention  # noqa: E402
from multimodal_path_omic_tpu.ops import blocks as jblocks  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.ops import fusion as jfusion  # noqa: E402
from multimodal_path_omic_tpu.ops import transformer as jtransformer  # noqa: E402
from multimodal_path_omic_tpu_torch.models import NaCAGaT  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import attention as tattention  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import blocks as tblocks  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import fusion as tfusion  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import transformer as ttransformer  # noqa: E402
from multimodal_path_omic_tpu_torch.ops.losses import survival_loss  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

MODULE_ATOL = 2e-5
MODEL_ATOL = 5e-5
B, M, WSI, D = 2, 1024, 256, 128
SIZES = (10, 20, 30)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every module of the port, the training and serving entry points' included
PORT_MODULES = [
    "ops.milpool", "ops.flash", "ops.kernels", "models.ge_nacagat", "serve", "train.loop",
    "train.optim", "ops.gather", "models.mcat", "data.device_cache", "data.pipeline",
    "config", "data.bags", "data.tables", "data.dataset", "data.synthetic", "train.metrics",
    "train.checkpoint", "train.logging", "train.trainer", "utils.hdf5",
    "ops.fusion", "utils.transplant", "utils.visualize", "train.analysis", "data.check",
    "server", "cli", "train.graphs", "train.benchmark",
]


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _close(got, ref, atol=MODULE_ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def world():
    """Inputs and one JAX NaCAGaT parameter tree. Every leaf is perturbed
    with noise, so zero-initialized biases and unit LayerNorm scales cannot
    hide a bridge that drops or swaps them, and the omic stack's zero-padded
    rows become nonzero (they must stay inert: their inputs are zero)."""
    rng = np.random.default_rng(0)
    wsi = rng.normal(size=(B, M, WSI)).astype(np.float32)
    omics = [rng.normal(size=(B, s)).astype(np.float32) for s in SIZES]
    mask = np.arange(M)[None, :] < np.array([1000, 600])[:, None]
    model = JNaCAGaT(n_signatures=len(SIZES), model_size="small", use_pallas=True)
    params = model.init(  # parameter shapes do not depend on M
        jax.random.key(0), jnp.asarray(wsi[:, :64]), [jnp.asarray(o) for o in omics],
        jnp.asarray(mask[:, :64]), deterministic=True,
    )["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
        params,
    )
    return dict(wsi=wsi, omics=omics, mask=mask, params=params, rng=rng)


def _slot(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _japply(module, params, *args, **kw):
    return module.apply({"params": params}, *args, **kw)


def test_encoders_match_jax(world):
    p, wsi, omics = world["params"], world["wsi"], world["omics"]
    h_j = _japply(jblocks.WSIEncoder(dim=D), p["H"], wsi, deterministic=True)
    h = load_jax_params(tblocks.WSIEncoder(WSI, D), p["H"]).eval()(_t(wsi))
    _close(h, h_j)
    g_j = _japply(jblocks.OmicEncoderStack(n_signatures=3, dim1=D, dim2=D), p["G"],
                  omics, deterministic=True)
    g = load_jax_params(tblocks.OmicEncoderStack(SIZES, D, D), p["G"]).eval()(
        [_t(o) for o in omics])
    _close(g, g_j)


@pytest.mark.parametrize("slot", [0, 1])
def test_branch_transformer_and_pool_match_jax(world, slot):
    """Each branch module against its slot of the JAX vmapped pair."""
    x = world["rng"].normal(size=(B, 3, D)).astype(np.float32)
    ptr = _slot(world["params"]["branch_transformer"], slot)
    y_j = _japply(jtransformer.TransformerEncoder(d_model=D, num_layers=2), ptr, x,
                  None, True)
    y = load_jax_params(ttransformer.TransformerEncoder(D, 2), ptr).eval()(_t(x))
    _close(y, y_j)
    ppo = _slot(world["params"]["branch_pool"], slot)
    mask = np.array([[True, True, True], [True, False, True]])
    pooled_j, a_j = _japply(jblocks.GatedMILPool(dim=D), ppo, x, mask, True)
    pooled, a = load_jax_params(tblocks.GatedMILPool(D), ppo).eval()(_t(x), _t(mask))
    _close(pooled, pooled_j)
    _close(a, a_j)


def test_cag_and_concat_fusion_match_jax(world):
    p, rng = world["params"], world["rng"]
    q, q_hat = (rng.normal(size=(B, 3, D)).astype(np.float32) for _ in range(2))
    pc = p["co_attention"]["cag"]
    c_j = _japply(jattention.ContextualAttentionGate(dim=D, hidden_dim=D), pc, q, q_hat)
    c = load_jax_params(tattention.ContextualAttentionGate(D, D), pc)(_t(q), _t(q_hat))
    _close(c, c_j)
    x1, x2 = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    pf = p["fusion_layer"]
    h_j = _japply(jfusion.ConcatFusion(hidden_size=D, output_size=D), pf, x1, x2)
    h = load_jax_params(tfusion.ConcatFusion(2 * D, D, D), pf)(_t(x1), _t(x2))
    _close(h, h_j)


@pytest.mark.parametrize("need_weights", [False, True], ids=["lean-v", "export"])
def test_pregating_contextual_attention_matches_jax(world, need_weights, monkeypatch):
    """The co-attention in both serving branches: lean-V (JAX: the fuse-K
    Pallas kernel in interpret mode) and the weights export."""
    monkeypatch.setenv("MPO_LEANK_MIN_M", "512")
    p, rng, mask = world["params"]["co_attention"], world["rng"], world["mask"]
    g = rng.normal(size=(B, 3, D)).astype(np.float32)
    h = rng.normal(size=(B, M, D)).astype(np.float32)
    before = jcoattn.DISPATCH_COUNTS["kernel"]
    hj = jnp.asarray(h)
    out_j, w_j = _japply(
        jattention.PreGatingContextualAttention(embed_dim=D, num_heads=1, use_pallas=True),
        p, g, hj, hj, jnp.asarray(mask), deterministic=True, need_weights=need_weights,
    )
    if not need_weights:
        assert jcoattn.DISPATCH_COUNTS["kernel"] > before  # the Pallas kernel ran
    module = load_jax_params(tattention.PreGatingContextualAttention(D), p).eval()
    ht = _t(h)
    out, w = module(_t(g), ht, ht, _t(mask), need_weights=need_weights)
    _close(out, out_j)
    if need_weights:
        _close(w, w_j)
    else:
        assert w is None and w_j is None


def _jax_eval(world, loss_name, monkeypatch):
    """JAX NaCAGaT eval outputs and loss as train/loop.py's eval step
    computes them (ces: lean-V fuse-K kernel; cesar: the weights export)."""
    from multimodal_path_omic_tpu.train.loop import _survival_loss

    monkeypatch.setenv("MPO_LEANK_MIN_M", "512")
    model = JNaCAGaT(n_signatures=len(SIZES), model_size="small", use_pallas=True)
    out = model.apply(
        {"params": world["params"]}, jnp.asarray(world["wsi"]),
        [jnp.asarray(o) for o in world["omics"]], jnp.asarray(world["mask"]),
        deterministic=True, need_attention=loss_name == "cesar",
    )
    label, cens, weight = np.array([1, 3]), np.array([0.0, 1.0]), np.array([1.0, 1.0])
    loss, attn_loss = _survival_loss(
        loss_name, out, jnp.asarray(label), jnp.asarray(cens), jnp.zeros(2), 0.75,
        jnp.asarray(weight, jnp.float32),
    )
    return out, float(loss), float(attn_loss), (label, cens, weight)


@pytest.mark.parametrize("loss_name", ["ces", "cesar"])
def test_nacagat_eval_matches_jax(world, loss_name, monkeypatch):
    out_j, loss_j, attn_loss_j, (label, cens, weight) = _jax_eval(
        world, loss_name, monkeypatch)
    model = load_jax_params(NaCAGaT(SIZES, model_size="small", wsi_dim=WSI),
                            world["params"]).eval()
    with torch.inference_mode():
        out = model(_t(world["wsi"]), [_t(o) for o in world["omics"]],
                    _t(world["mask"]), need_attention=loss_name == "cesar")
        loss, attn_loss = survival_loss(loss_name, out, _t(label), _t(cens).float(),
                                        0.75, _t(weight).float())
    for name in ("hazards", "survs", "y"):
        _close(getattr(out, name), getattr(out_j, name), MODEL_ATOL)
    _close(-out.survs.sum(1), -np.asarray(out_j.survs).sum(1), MODEL_ATOL)
    _close(loss, loss_j, MODEL_ATOL)
    _close(attn_loss, attn_loss_j, MODEL_ATOL)
    if loss_name == "cesar":
        assert out.attention["coattn"].shape == (B, len(SIZES), M)
        _close(out.attention["coattn"], out_j.attention["coattn"], MODEL_ATOL)
        assert attn_loss_j > 0.0
    else:
        assert out.attention["coattn"] is None


@pytest.mark.parametrize("loss_name", ["ces", "cesar"])
def test_predict_bags_matches_jax_semantics(world, loss_name):
    """Mixed buckets (512, 1024), batch_size 2, three bags: bucket 512 holds
    bags 0 and 2, bucket 1024 holds bag 1 plus a zero-weight filler row.
    Outputs come back in input order with the filler dropped, and each row
    equals the JAX model on that bag alone, padded to its bucket."""
    rng = np.random.default_rng(1)
    lengths = (300, 900, 450)
    bags = [rng.normal(size=(n, WSI)).astype(np.float32) for n in lengths]
    omics = [[rng.normal(size=s).astype(np.float32) for s in SIZES] for _ in bags]
    pred = Predictor(omic_sizes=SIZES, model_size="small", wsi_dim=WSI,
                     buckets=(512, 1024), batch_size=2, loss=loss_name,
                     params=world["params"], device="cpu")
    got = pred.predict_bags(bags, omics)
    assert set(got) == {"y", "risk", "hazards", "survs"}
    assert got["risk"].shape == (3,) and got["hazards"].shape == (3, 4)
    model = JNaCAGaT(n_signatures=len(SIZES), model_size="small")
    for i, (bag, n) in enumerate(zip(bags, lengths)):
        bucket = 512 if n <= 512 else 1024
        wsi = np.zeros((1, bucket, WSI), np.float32)
        wsi[0, :n] = bag
        out = model.apply(
            {"params": world["params"]}, jnp.asarray(wsi),
            [jnp.asarray(o)[None] for o in omics[i]],
            jnp.asarray(np.arange(bucket)[None] < n), deterministic=True,
            need_attention=loss_name == "cesar",
        )
        _close(got["hazards"][i], out.hazards[0], MODEL_ATOL)
        _close(got["survs"][i], out.survs[0], MODEL_ATOL)
        _close(got["y"][i], out.y[0], MODEL_ATOL)
        _close(got["risk"][i], -np.asarray(out.survs[0]).sum(), MODEL_ATOL)
    single = pred.predict_bag(bags[1], omics[1])
    _close(single["risk"], got["risk"][1:2], MODEL_ATOL)


def test_entry_points_default_to_cuda():
    """Without a CUDA device the default device raises; it never drops to
    the CPU on its own. ``device="cpu"`` is the explicit opt-in."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(omic_sizes=SIZES, model_size="small", wsi_dim=WSI)
    Predictor(omic_sizes=SIZES, model_size="small", wsi_dim=WSI, device="cpu")


def test_port_imports_nothing_of_jax():
    """The port package and chip_smoke.py import with jax, flax and the JAX
    package blocked (a blocked module raises ImportError on import)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'multimodal_path_omic_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import multimodal_path_omic_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        f"want = {PORT_MODULES!r}\n"
        "missing = [w for w in want if pkg.__name__ + '.' + w not in mods]\n"
        "assert not missing, missing\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= len(PORT_MODULES)


def test_port_modules_leave_jax_unimported():
    """A fresh interpreter that imports every port module, nothing blocked,
    has neither jax nor the JAX package in ``sys.modules`` (an import
    guarded by try/except would pass the blocked test above)."""
    code = (
        "import sys, importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module('multimodal_path_omic_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'multimodal_path_omic_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
