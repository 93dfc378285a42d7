"""The port's GE-NaCAGaT serving slice against the JAX package, on the same
weights (carried by the port's weight bridge) and the same numpy inputs.

Size: GE-NaCAGaT ``small`` (d = 128; one head of width 128 and eight of
width 16), 64-wide patch features, B=2 bags over M=512 patches with ragged
masks. The JAX side runs on the CPU under ``highest`` matmul precision: its
MIL-pool Pallas kernel in interpret mode (directly, and inside the model by
setting ``milpool._FORCE_KERNEL``), its long self-attention through
``fused_attention``, which off the TPU takes the plain key-masked
attention. On the CPU the port's wrappers take their kernels' plain
versions, so these tests hold the plain versions, the dispatch and the
layouts around the kernels; the kernels themselves are held against the
plain versions on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py``).

Tolerances: kernels' plain versions 2e-5 absolute (the bar of the JAX
package's own kernel tests: float32 on both sides, other summation orders,
outputs of magnitude ~1); modules and the whole model 5e-5 (the same per-op
noise carried through the layers).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import GENaCAGaT as JGENaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import attention as jattention  # noqa: E402
from multimodal_path_omic_tpu.ops import blocks as jblocks  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.ops import milpool as jmilpool  # noqa: E402
from multimodal_path_omic_tpu.ops import transformer as jtransformer  # noqa: E402
from multimodal_path_omic_tpu.train.loop import make_eval_step  # noqa: E402
from multimodal_path_omic_tpu_torch.models import GENaCAGaT, build_model, is_ge_model  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import attention as tattention  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import blocks as tblocks  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import flash as tflash  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import kernels as tkernels  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import milpool as tmilpool  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import transformer as ttransformer  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
)

KERNEL_ATOL = 2e-5
MODEL_ATOL = 5e-5
B, M, WSI, D = 2, 512, 64, 128
LENGTHS = (470, 200)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _close(got, ref, atol):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def _mask(kind, b, m, rng):
    """ragged: every bag keeps a prefix, the last bag nothing (a filler
    row); scattered: random holes; none: no mask."""
    if kind == "none":
        return None
    if kind == "scattered":
        return rng.random((b, m)) > 0.3
    lengths = rng.integers(m // 4, m + 1, size=b)
    lengths[-1] = 0
    return np.arange(m)[None, :] < lengths[:, None]


@pytest.fixture(scope="module")
def world():
    """Inputs and one JAX GE-NaCAGaT parameter tree, every leaf perturbed
    with noise so that zero biases and unit LayerNorm scales cannot hide a
    bridge that drops or swaps them."""
    rng = np.random.default_rng(0)
    wsi = rng.normal(size=(B, M, WSI)).astype(np.float32)
    mask = np.arange(M)[None, :] < np.array(LENGTHS)[:, None]
    model = JGENaCAGaT(model_size="small")
    params = model.init(jax.random.key(0), jnp.asarray(wsi[:, :64]),
                        jnp.asarray(mask[:, :64]))["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    return dict(wsi=wsi, mask=mask, params=params, rng=rng)


@pytest.fixture
def force_jax_pool_kernel():
    """Let the JAX GatedMILPool dispatch its Pallas kernel (interpret mode)
    on the CPU, as the JAX package's own tests do."""
    old = jmilpool._FORCE_KERNEL
    jmilpool._FORCE_KERNEL = True
    yield
    jmilpool._FORCE_KERNEL = old


def _japply(module, params, *args, **kw):
    return module.apply({"params": params}, *args, **kw)


# ---------------------------------------------------------------------------
# K5: the gated-MIL pool's plain version
# ---------------------------------------------------------------------------


def _pool_inputs(mask_kind, b=3, m=512, d=128, h=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, m, d)).astype(np.float32)
    w = lambda *s: rng.normal(size=s, scale=0.1).astype(np.float32)  # noqa: E731
    return [x, _mask(mask_kind, b, m, rng), w(d, h), w(h), w(d, h), w(h), w(h, 1), w(1)]


@pytest.mark.parametrize("mask_kind", ["ragged", "scattered", "none"])
def test_mil_pool_plain_matches_jax_kernel_and_reference(mask_kind):
    args = _pool_inputs(mask_kind)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    pooled, scores = tmilpool.gated_mil_pool_plain(*[_t(a) for a in args])
    for ref in (jmilpool.fused_gated_mil_pool(*jargs, block_m=256, interpret=True),
                jmilpool.reference_gated_mil_pool(*jargs)):
        _close(pooled, ref[0], KERNEL_ATOL)
        _close(scores, ref[1], KERNEL_ATOL)
    assert pooled.shape == (3, 128) and scores.shape == (3, 512)
    if mask_kind == "ragged":  # the fully-masked bag pools uniformly, never NaN
        _close(pooled[-1], args[0][-1].mean(axis=0), KERNEL_ATOL)


def test_mil_pool_wrapper_takes_the_plain_version_on_cpu():
    args = [_t(a) for a in _pool_inputs("ragged")]
    before = dict(tmilpool.LAUNCH_COUNTS)
    got = tmilpool.fused_gated_mil_pool(*args)
    ref = tmilpool.gated_mil_pool_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tmilpool.LAUNCH_COUNTS == before  # launches are counted on CUDA only


@pytest.mark.parametrize("d,h", [(128, 128), (256, 256), (64, 384)])
def test_packed_gate_weights_reproduce_both_products(d, h):
    """The kernel's weight layout, walked as the kernel walks it: pack c
    gives a and g of hidden units 128c .. 128c+127 from one product."""
    x, _, wa, ba, wb, bb, wc, bc = (_t(a) for a in _pool_inputs("none", 2, 40, d, h, seed=d + h))
    w, bias = tmilpool.pack_gate_weights(wa, ba, wb, bb)
    assert w.shape == (h // 128, d, 256) and bias.shape == (h // 128, 256)
    assert w.is_contiguous() and bias.is_contiguous()
    s = torch.zeros(x.shape[:2]) + bc
    for c in range(h // 128):
        acc = x @ w[c] + bias[c]
        s = s + (torch.tanh(acc[..., :128]) * torch.sigmoid(acc[..., 128:])) @ wc[
            128 * c:128 * (c + 1), 0]
    _close(s, tmilpool.gated_mil_pool_plain(x, None, wa, ba, wb, bb, wc, bc)[1], 1e-6)
    # strided views (the module hands over transposed torch weights) pack alike
    w2, _ = tmilpool.pack_gate_weights(wa.t().contiguous().t(), ba, wb.t().contiguous().t(), bb)
    assert torch.equal(w, w2)


@pytest.mark.parametrize("n_tiles,per_bag", [(256, 16), (79, 16), (384, 132), (1, 16), (5, 0),
                                             (3000, 2000)])
def test_tile_splits_leaves_no_split_without_a_tile(n_tiles, per_bag):
    splits = tkernels.tile_splits(n_tiles, per_bag)
    per = -(-n_tiles // splits)
    assert 1 <= splits <= min(n_tiles, max(per_bag, 1), 1024)
    assert (splits - 1) * per < n_tiles <= splits * per


# ---------------------------------------------------------------------------
# K6: the flash forward's plain version
# ---------------------------------------------------------------------------


def _qkv(b, heads, m, width, rng):
    return [rng.normal(size=(b, heads, m, width)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("mask_kind", ["ragged", "scattered", "none"])
@pytest.mark.parametrize("heads,width", [(1, 64), (8, 8)])
def test_flash_plain_matches_jax_fused_attention(heads, width, mask_kind):
    """Against the JAX dispatcher the GE model reaches (on the CPU: the
    plain key-masked attention), with the scores formed 96 rows at a time
    over M = 320 (a ragged last chunk)."""
    rng = np.random.default_rng(heads + len(mask_kind))
    q, k, v = _qkv(3, heads, 320, width, rng)
    mask = _mask(mask_kind, 3, 320, rng)
    ref = jcoattn.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if mask is None else jnp.asarray(mask))
    out = tflash.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), chunk=96)
    assert out.shape == (3, heads, 320, width)
    _close(out, ref, KERNEL_ATOL)  # valid rows and pad rows alike
    if mask_kind == "ragged":  # no valid key: the uniform mean of v, never NaN
        _close(out[-1], np.broadcast_to(v[-1].mean(axis=1, keepdims=True), v[-1].shape),
               KERNEL_ATOL)


@pytest.mark.parametrize("chunk", [1, 37, 200, 4096])
def test_flash_plain_chunking_changes_no_value(chunk):
    rng = np.random.default_rng(chunk)
    q, k, v = (_t(a) for a in _qkv(2, 2, 200, 16, rng))
    mask = _t(_mask("ragged", 2, 200, rng))
    whole = tflash.flash_attention_plain(q, k, v, mask, chunk=200)
    _close(tflash.flash_attention_plain(q, k, v, mask, chunk=chunk), whole, 1e-6)


def test_flash_plain_scale_and_strided_views():
    """sm_scale overrides 1/sqrt(D); the head views of a packed projection
    (what MultiheadAttention hands over) give what contiguous copies give."""
    rng = np.random.default_rng(5)
    qkv = _t(rng.normal(size=(2, 100, 3 * 64)).astype(np.float32))
    q, k, v = (t.reshape(2, 100, 4, 16).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    mask = _t(_mask("scattered", 2, 100, rng))
    out = tflash.flash_attention(q, k, v, mask, sm_scale=0.5)
    ref, _ = tattention.attention_core(q.contiguous() * 0.5 * 4.0, k.contiguous(),
                                       v.contiguous(), mask, pre_gate=False, need_weights=False)
    _close(out, ref, 1e-6)


def test_forward_only_kernels_refuse_a_call_autograd_would_differentiate():
    """The MIL pool has no backward kernel and refuses; the flash attention
    has one behind its autograd Function and differentiates."""
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        tkernels.refuse_grad("fused_gated_mil_pool", torch.zeros(2), x)
    with torch.no_grad():
        tkernels.refuse_grad("fused_gated_mil_pool", x)
    tkernels.refuse_grad("fused_gated_mil_pool", x.detach())
    rng = np.random.default_rng(0)
    q, k, v = (_t(a).requires_grad_(True) for a in _qkv(2, 2, 40, 8, rng))
    out = tflash.flash_attention(q, k, v, _t(_mask("ragged", 2, 40, rng)))
    assert isinstance(out.grad_fn, tflash.FlashAttention._backward_cls)
    out.sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape for t in (q, k, v))


# ---------------------------------------------------------------------------
# The modules that hold the kernels
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def wrapper(*args, **kw):
        calls.append(args)
        return inner(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("mask_kind", ["ragged", "none"])
def test_gated_mil_pool_kernel_branch_matches_jax(world, mask_kind, monkeypatch,
                                                  force_jax_pool_kernel):
    """A 512-patch pool in eval: the port takes fused_gated_mil_pool, the JAX
    module its Pallas kernel (interpret mode); rho and ReLU follow."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, M, D)).astype(np.float32)
    mask = _mask(mask_kind, B, M, rng)
    p = world["params"]["path_pool"]
    before = jmilpool.DISPATCH_COUNTS["kernel"]
    pooled_j, a_j = _japply(jblocks.GatedMILPool(dim=D, use_pallas=True), p, jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask), True)
    assert jmilpool.DISPATCH_COUNTS["kernel"] == before + 1
    calls = _spy(monkeypatch, tblocks, "fused_gated_mil_pool")
    module = load_jax_params(tblocks.GatedMILPool(D), p).eval()
    pooled, a = module(_t(x), _t(mask))
    assert len(calls) == 1
    assert a.shape == (B, 1, M)  # raw scores, pad positions included
    _close(pooled, pooled_j, MODEL_ATOL)
    _close(a, a_j, MODEL_ATOL)
    # the eager branch (what training and few-token pools take) agrees
    eager_j = _japply(jblocks.GatedMILPool(dim=D), p, jnp.asarray(x),
                      None if mask is None else jnp.asarray(mask), True)
    _close(pooled, eager_j[0], MODEL_ATOL)
    _close(a, eager_j[1], MODEL_ATOL)


def test_gated_mil_pool_keeps_the_eager_branch_for_few_tokens_and_training(world, monkeypatch):
    calls = _spy(monkeypatch, tblocks, "fused_gated_mil_pool")
    module = load_jax_params(tblocks.GatedMILPool(D), world["params"]["path_pool"])
    x = _t(np.random.default_rng(0).normal(size=(B, 40, D)).astype(np.float32))
    module.eval()(x[:, :6])  # NaCAGaT's 6-token branch pools
    module.eval()(x[:, :32])
    gen = torch.Generator().manual_seed(0)
    module.train()(x, None, gen)  # two dropout sites, no backward kernel
    assert calls == []
    module.eval()(x[:, :33])
    assert len(calls) == 1


@pytest.mark.parametrize("heads", [1, 8])
def test_self_attention_flash_branch_matches_jax(world, heads, monkeypatch):
    """MultiheadAttention's long self-attention branch (GE's one head of the
    model width, and the path transformer's eight heads) against the JAX
    module with use_pallas, from bridged weights."""
    rng = np.random.default_rng(heads)
    x = rng.normal(size=(B, M, D)).astype(np.float32)
    mask = world["mask"]
    p = (world["params"]["self_attention"] if heads == 1
         else world["params"]["path_transformer"]["layer_0"]["self_attn"])
    xj = jnp.asarray(x)
    out_j, w_j = _japply(
        jattention.MultiheadAttention(embed_dim=D, num_heads=heads, use_pallas=True), p,
        xj, xj, xj, jnp.asarray(mask), need_weights=False, deterministic=True)
    calls = _spy(monkeypatch, tattention, "flash_attention")
    module = load_jax_params(tattention.MultiheadAttention(D, heads), p).eval()
    xt = _t(x)
    out, w = module(xt, xt, xt, _t(mask), need_weights=False)
    assert len(calls) == 1 and w is None and w_j is None
    q, k, v, key_mask = calls[0]
    assert q.shape == (B, heads, M, D // heads) and key_mask is not None
    # the heads are views of the packed projection: nothing was copied
    assert q.stride() == (M * 3 * D, D // heads, 3 * D, 1) and k.stride() == q.stride()
    _close(out, out_j, MODEL_ATOL)
    # with the weights requested the map comes from attention_core, same output
    out_w, w = module(xt, xt, xt, _t(mask), need_weights=True)
    assert len(calls) == 1 and w.shape == (B, M, M)
    _close(out_w, out_j, MODEL_ATOL)


def test_transformer_layers_take_the_flash_branch_with_the_mask(world, monkeypatch):
    """Each layer of a long path transformer hands the bag mask to
    self_attn and takes the flash branch in eval; in training with attention
    dropout live below 4096 positions, and at 6 tokens, it does not."""
    p = world["params"]["path_transformer"]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, M, D)).astype(np.float32)
    mask = world["mask"]
    y_j = _japply(jtransformer.TransformerEncoder(d_model=D, num_layers=2, use_pallas=True), p,
                  jnp.asarray(x), jnp.asarray(mask), True)
    calls = _spy(monkeypatch, tattention, "flash_attention")
    module = load_jax_params(ttransformer.TransformerEncoder(D, 2), p).eval()
    y = module(_t(x), _t(mask))
    assert len(calls) == 2
    assert all(torch.equal(c[3], _t(mask)) and c[0].shape == (B, 8, M, D // 8) for c in calls)
    valid = mask[:, :, None].repeat(D, axis=2)
    _close(y[_t(valid)], np.asarray(y_j)[valid], MODEL_ATOL)
    module(_t(x[:, :6]), _t(mask[:, :6]))
    module.train()(_t(x[:, :64]), _t(mask[:, :64]), torch.Generator().manual_seed(0))
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True], ids=["xla", "pallas-interpret"])
def test_ge_nacagat_matches_jax(world, use_kernels, monkeypatch, request):
    """GE-NaCAGaT small on [2, 512, 64] bags with ragged masks: y and the raw
    MIL scores, against the JAX model without its kernels and with them (the
    MIL-pool Pallas kernel in interpret mode)."""
    if use_kernels:
        request.getfixturevalue("force_jax_pool_kernel")
    before = jmilpool.DISPATCH_COUNTS["kernel"]
    y_j, attn_j = _japply(JGENaCAGaT(model_size="small", use_pallas=use_kernels),
                          world["params"], jnp.asarray(world["wsi"]),
                          jnp.asarray(world["mask"]), deterministic=True)
    assert (jmilpool.DISPATCH_COUNTS["kernel"] > before) == use_kernels
    flash_calls = _spy(monkeypatch, tattention, "flash_attention")
    pool_calls = _spy(monkeypatch, tblocks, "fused_gated_mil_pool")
    model = load_jax_params(GENaCAGaT("small", wsi_dim=WSI), world["params"]).eval()
    with torch.inference_mode():
        y, attn = model(_t(world["wsi"]), _t(world["mask"]))
    assert len(flash_calls) == 3 and len(pool_calls) == 1
    assert y.shape == (B, 3) and attn["path"].shape == (B, 1, M)
    assert attn["attn"] is None and attn_j["attn"] is None
    _close(y, y_j, MODEL_ATOL)
    _close(y.sum(dim=1), np.ones(B), 1e-6)
    _close(attn["path"], attn_j["path"], MODEL_ATOL)


def test_ge_nacagat_attention_map_on_request(world):
    """need_attention=True materializes the M x M map (usable at small M
    only): the same y, and the map of the JAX model."""
    wsi, mask = world["wsi"][:, :96], world["mask"][:, :96]
    y_j, attn_j = _japply(JGENaCAGaT(model_size="small"), world["params"], jnp.asarray(wsi),
                          jnp.asarray(mask), deterministic=True, need_attention=True)
    model = load_jax_params(GENaCAGaT("small", wsi_dim=WSI), world["params"]).eval()
    y, attn = model(_t(wsi), _t(mask), need_attention=True)
    assert attn["attn"].shape == (B, 96, 96)
    _close(y, y_j, MODEL_ATOL)
    _close(attn["attn"], attn_j["attn"], MODEL_ATOL)


def test_ge_pad_patches_are_inert(world):
    """Overwriting the pad patches with noise changes neither y nor the
    valid patches' MIL scores: every attention and the pool mask them."""
    model = load_jax_params(GENaCAGaT("small", wsi_dim=WSI), world["params"]).eval()
    wsi, mask = world["wsi"].copy(), world["mask"]
    with torch.inference_mode():
        y0, attn0 = model(_t(wsi), _t(mask))
        wsi[~mask] = 50.0 * np.random.default_rng(9).normal(size=wsi[~mask].shape)
        y1, attn1 = model(_t(wsi), _t(mask))
    _close(y1, y0, 1e-6)
    _close(attn1["path"][:, 0][_t(mask)], attn0["path"][:, 0][_t(mask)], 1e-5)


def _ge_predictor(world, **kw):
    return Predictor("GE-NaCAGaT", model_size="small", wsi_dim=WSI, buckets=(256, 512),
                     batch_size=2, params=world["params"], device="cpu", **kw)


def test_ge_predict_bags_matches_jax_eval_step(world):
    """Mixed buckets (256, 512), batch_size 2, three bags without omics:
    bucket 256 holds bags 0 and 2, bucket 512 bag 1 plus a zero-weight filler
    row. Rows come back in input order, y only, each equal to the JAX eval
    step's y on that bag alone."""
    rng = np.random.default_rng(1)
    lengths = (200, 430, 90)
    bags = [rng.normal(size=(n, WSI)).astype(np.float32) for n in lengths]
    pred = _ge_predictor(world)
    assert pred.ge_mode and pred.loss_name == "ce"
    got = pred.predict_bags(bags)
    assert set(got) == {"y"} and got["y"].shape == (3, 3)
    eval_step = make_eval_step(JGENaCAGaT(model_size="small"), "ce", ge_mode=True)
    for i, (bag, n) in enumerate(zip(bags, lengths)):
        bucket = 256 if n <= 256 else 512
        wsi = np.zeros((1, bucket, WSI), np.float32)
        wsi[0, :n] = bag
        out = eval_step(world["params"], {
            "wsi": jnp.asarray(wsi), "mask": jnp.asarray(np.arange(bucket)[None] < n),
            "label": jnp.zeros((1,), jnp.int32), "weight": jnp.ones((1,), jnp.float32)})
        _close(got["y"][i], out["y"][0], MODEL_ATOL)
    single = pred.predict_bag(bags[1])
    assert set(single) == {"y"}
    _close(single["y"], got["y"][1:2], MODEL_ATOL)
    assert pred.predict_bags([]) == {}


def test_ge_eval_step_matches_jax(world):
    """The eval step's outputs (loss ce on the class probabilities, y, the
    raw MIL scores, n_real) with a zero-weight filler row."""
    label, weight = np.array([2, 0]), np.array([1.0, 0.0], np.float32)
    out_j = make_eval_step(JGENaCAGaT(model_size="small"), "ce", ge_mode=True)(
        world["params"], {"wsi": jnp.asarray(world["wsi"]), "mask": jnp.asarray(world["mask"]),
                          "label": jnp.asarray(label, jnp.int32), "weight": jnp.asarray(weight)})
    out = _ge_predictor(world).eval_step({
        "wsi": _t(world["wsi"]), "mask": _t(world["mask"]), "label": _t(label),
        "weight": _t(weight)})
    assert set(out) == {"loss", "y", "attention", "n_real"}
    _close(out["loss"], out_j["loss"], MODEL_ATOL)
    _close(out["y"], out_j["y"], MODEL_ATOL)
    _close(out["attention"]["path"], out_j["attention"]["path"], MODEL_ATOL)
    assert out["attention"]["attn"] is None and float(out["n_real"]) == 1.0


def test_predictor_modes_refuse_what_they_do_not_take(world):
    with pytest.raises(NotImplementedError, match="ce"):
        _ge_predictor(world, loss="ces")
    with pytest.raises(NotImplementedError):
        Predictor("NaCAGaT", omic_sizes=(4, 5), model_size="small", loss="mse", device="cpu")
    with pytest.raises(ValueError, match="omic_sizes"):
        Predictor("NaCAGaT", model_size="small", device="cpu")
    surv = Predictor("NaCAGaT", omic_sizes=(4, 5), model_size="small", wsi_dim=WSI,
                     buckets=(64,), batch_size=2, device="cpu")
    bag = np.zeros((10, WSI), np.float32)
    with pytest.raises(ValueError, match="omics"):
        surv.predict_bag(bag)
    with pytest.raises(ValueError, match="omics"):
        surv.predict_bags([bag])


# ---------------------------------------------------------------------------
# The weight bridge and the factory
# ---------------------------------------------------------------------------


def test_ge_bridge_is_strict_and_round_trips(world):
    state = jax_params_to_state_dict(world["params"])
    model = GENaCAGaT("small", wsi_dim=WSI)
    assert set(state) == set(model.state_dict())  # every leaf lands, every parameter is fed
    load_jax_params(model, world["params"])
    p = world["params"]
    sd = model.state_dict()
    _close(sd["self_attention.in_proj_weight"], p["self_attention"]["in_proj_kernel"].T, 0)
    _close(sd["path_transformer.layers.1.linear2.weight"],
           p["path_transformer"]["layer_1"]["linear2"]["kernel"].T, 0)
    _close(sd["path_transformer.layers.0.norm1.weight"],
           p["path_transformer"]["layer_0"]["norm1"]["scale"], 0)
    _close(sd["path_pool.attention_head.attention_c.weight"],
           p["path_pool"]["attention_head"]["attention_c"]["kernel"].T, 0)
    _close(sd["classifier.bias"], p["classifier"]["bias"], 0)
    missing = {k: v for k, v in p.items() if k != "classifier"}
    with pytest.raises(RuntimeError, match="classifier"):
        load_jax_params(GENaCAGaT("small", wsi_dim=WSI), missing)
    extra = dict(p, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="stray"):
        load_jax_params(GENaCAGaT("small", wsi_dim=WSI), extra)


@pytest.mark.parametrize("name", ["GE-NaCAGaT", "ge_nacagat", "GeneExpr-NaCAGaT", "genacagat",
                                  "geneexprnacagat"])
def test_build_model_knows_the_ge_names(name):
    model = build_model(name, model_size="small", wsi_dim=WSI)
    assert isinstance(model, GENaCAGaT) and is_ge_model(name)
    assert model.classifier.out_features == 3
    assert [n for n, _ in model.named_children()] == [
        "H", "self_attention", "path_transformer", "path_pool", "classifier"]
    assert not is_ge_model("NaCAGaT")


def test_seeded_init_gives_a_device_independent_ge_model():
    a = Predictor("GE-NaCAGaT", model_size="small", wsi_dim=WSI, seed=4, device="cpu")
    b = Predictor("GE-NaCAGaT", model_size="small", wsi_dim=WSI, seed=4, device="cpu")
    c = Predictor("GE-NaCAGaT", model_size="small", wsi_dim=WSI, seed=5, device="cpu")
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert any(not torch.equal(sa[k], sc[k]) for k in sa)
    assert float(sa["self_attention.in_proj_bias"].abs().max()) == 0.0
