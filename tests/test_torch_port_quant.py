"""The port's int8 and bfloat16 bag stores and transfers, and the w8a8 first
layer (``tpu.cache_dtype``, ``tpu.transfer_dtype``, ``tpu.int8_matmul``),
against the JAX package on the CPU: ``quantize_bag_int8`` and the device
cache's int8 and bfloat16 arrays bit for bit, ``w8a8_linear`` value and
gradients, ``TorchLinear``'s int8 route, the stager's int8 and bfloat16
rows, and the Trainer: an int8 cached epoch bit for bit an int8 host-fed
one, ``int8_matmul`` tracking the dequant path, bfloat16 stores close to
float32, "auto" resolving to float32, the int8 budget fit.

Tolerances: quantization, cache contents and the cached-against-host-fed
runs exact (the same per-row quantization, a gather is a copy);
``w8a8_linear`` within the kernel's own per-column int8 bound (the JAX
test's, ``tests/test_quant.py:213``) and its gradients 1e-5 relative
(float32 products in another order); training closeness bars as the JAX
package's own (0.05 on the losses, ``tests/test_quant.py:146, 283``).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.data import device_cache as jcache  # noqa: E402
from multimodal_path_omic_tpu.data import pipeline as jpipeline  # noqa: E402
from multimodal_path_omic_tpu.data import quant as jquant  # noqa: E402
from multimodal_path_omic_tpu.ops import layers as jlayers  # noqa: E402
from multimodal_path_omic_tpu_torch import config as tconfig  # noqa: E402
from multimodal_path_omic_tpu_torch.data import device_cache as tcache  # noqa: E402
from multimodal_path_omic_tpu_torch.data import pipeline as tpipeline  # noqa: E402
from multimodal_path_omic_tpu_torch.data import quant as tquant  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.ops import layers as tlayers  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import dequant_wsi  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402

LENGTHS = (40, 100, 64, 200, 17, 128, 129, 90)
BUCKETS = (64, 128, 256)
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


def _bags(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(m, WSI)) * rng.uniform(0.1, 5.0, (m, 1))).astype(np.float32)
            for m in LENGTHS]


# ---------------------------------------------------------------- quantization


def test_quantize_bag_int8_is_the_jax_packages_bit_for_bit():
    """Per-row int8 quantization of padded batches (zero padding rows, a
    row of extremes, wide dynamic ranges) equals the JAX package's, bit for
    bit; padding rows are q = 0 with scale 1."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 64, 32)) * rng.uniform(1e-3, 1e3, (3, 64, 1))).astype(np.float32)
    x[1, 40:] = 0.0
    x[2, 0] = [-2.0, 0.0, 2.0, 1.0] * 8
    q, scale = tquant.quantize_bag_int8(x)
    qj, scale_j = jquant.quantize_bag_int8(x)
    assert q.dtype == np.int8 and scale.dtype == np.float32 and scale.shape == (3, 64)
    assert np.array_equal(q, qj) and np.array_equal(scale, scale_j)
    assert np.all(q[1, 40:] == 0) and np.all(scale[1, 40:] == 1.0)
    assert list(q[2, 0, :4]) == [-127, 0, 127, 64]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_jax_and_is_exact_on_padding(dtype):
    """``dequantize`` straight to the compute dtype equals JAX's (the cast
    of both factors, then one rounded product); padding rows dequantize to
    exactly 0, and the round trip error is at most half a step."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 24)).astype(np.float32)
    x[0, 10:] = 0.0
    q, scale = tquant.quantize_bag_int8(x)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                         jnp.bfloat16)
    got = tquant.dequantize(torch.from_numpy(q), torch.from_numpy(scale), tdt)
    ref = jquant.dequantize(jnp.asarray(q), jnp.asarray(scale), jdt)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert torch.all(got[0, 10:] == 0)
    if dtype == "float32":
        assert np.all(np.abs(got.numpy() - x) <= scale[..., None] / 2 + 1e-7)


def test_dequant_wsi_drops_the_scales_and_leaves_float_batches():
    q, scale = tquant.quantize_bag_int8(np.ones((1, 4, 8), np.float32))
    batch = {"wsi": torch.from_numpy(q), "wsi_scale": torch.from_numpy(scale), "mask": 1}
    out = dequant_wsi(batch, torch.bfloat16)
    assert set(out) == {"wsi", "mask"} and out["wsi"].dtype == torch.bfloat16
    assert "wsi_scale" in batch  # the caller's batch is left as it is
    plain = {"wsi": torch.ones(1, 4, 8)}
    assert dequant_wsi(plain) is plain


# ---------------------------------------------------------------- the device cache


class Cohort:
    """Eight seeded bags of 17..200 patches with the survival table columns."""

    def __init__(self):
        rng = np.random.default_rng(2)
        n = len(LENGTHS)
        self.bags = _bags(3)
        self.table = SimpleNamespace(
            survival_months=rng.uniform(1, 100, n).astype(np.float32),
            survival_class=rng.integers(0, 4, n).astype(np.int32),
            censorship=rng.integers(0, 2, n).astype(np.float32),
            signature_names=["a", "b"],
            signature_data={"a": rng.normal(size=(n, 5)).astype(np.float32),
                            "b": rng.normal(size=(n, 7)).astype(np.float32)},
        )

    def __len__(self):
        return len(self.bags)

    def bag(self, i):
        return self.bags[i]


@pytest.mark.parametrize("store_dtype", ["bfloat16", "int8"])
def test_device_cache_stores_equal_jax(store_dtype):
    """The int8 store (wsi int8, wsi_scale float32 [n_b, bucket]) and the
    bfloat16 store against the JAX package's cache arrays, every key, bit
    for bit; uploaded in chunks of 3 bags through one pinned-layout buffer."""
    ds = Cohort()
    port = tcache.DeviceBagCache(ds, tpipeline.survival_extras, BUCKETS, device="cpu",
                                 upload_chunk=3, store_dtype=store_dtype)
    ref = jcache.DeviceBagCache(ds, jpipeline.survival_extras, BUCKETS, upload_chunk=3,
                                store_dtype=store_dtype)
    assert port.cached_buckets == ref.cached_buckets
    want = torch.int8 if store_dtype == "int8" else torch.bfloat16
    for bucket in port.cached_buckets:
        assert set(port.caches[bucket]) == set(ref.caches[bucket])
        assert ("wsi_scale" in port.caches[bucket]) == (store_dtype == "int8")
        assert port.caches[bucket]["wsi"].dtype == want
        for key, value in ref.caches[bucket].items():
            got = port.caches[bucket][key]
            got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
            value = np.asarray(value.astype(jnp.float32) if value.dtype == jnp.bfloat16
                               else value)
            assert got.shape == value.shape and np.array_equal(got, value), key
        if store_dtype == "int8":  # padding rows: q = 0, scale 1
            mask = port.caches[bucket]["mask"]
            assert torch.all(port.caches[bucket]["wsi_scale"][~mask] == 1.0)
            assert torch.all(port.caches[bucket]["wsi"][~mask] == 0)


# ---------------------------------------------------------------- w8a8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_value_and_grads_match_jax(dtype):
    """``w8a8_linear`` against the JAX package's on the same int8 rows,
    kernel and bias: the value equals dequant(q) @ k + b within the kernel's
    per-column int8 bound and JAX's value within float32 (bfloat16: one
    rounding of the output); dW = dequant(q)^T dy and db = sum(dy) against
    JAX's custom VJP at the same cotangent."""
    rng = np.random.default_rng(0)
    b, m, f, e = 2, 16, 32, 8
    x = rng.normal(size=(b, m, f)).astype(np.float32)
    q, rs = tquant.quantize_bag_int8(x)
    k = (rng.normal(size=(f, e)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(e,)).astype(np.float32)
    dy = rng.normal(size=(b, m, e)).astype(np.float32)
    tdt, jdt = (None, None) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)

    w = torch.from_numpy(k.T.copy()).requires_grad_(True)  # torch layout [E, F]
    bt = torch.from_numpy(bias).requires_grad_(True)
    y = tlayers.w8a8_linear(torch.from_numpy(q), torch.from_numpy(rs), w, bt, tdt)
    (y.float() * torch.from_numpy(dy)).sum().backward()

    def jf(k_, b_):
        return jlayers.w8a8_linear(jnp.asarray(q), jnp.asarray(rs), k_, b_, jdt)

    yj, vjp = jax.vjp(jf, jnp.asarray(k), jnp.asarray(bias))
    dk_j, db_j = vjp(jnp.asarray(dy).astype(yj.dtype))
    assert y.dtype == (tdt or torch.float32)
    yf, yjf = y.detach().float().numpy(), np.asarray(yj.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(yjf).max()
    np.testing.assert_allclose(yf, yjf, atol=tol, rtol=0)
    xdq = q.astype(np.float32) * rs[..., None]
    col_scale = np.abs(k).max(0) / 127.0
    bound = np.abs(xdq).sum(-1)[..., None] * col_scale / 2.0 + 1e-5
    if dtype == "float32":
        assert np.all(np.abs(yf - (xdq @ k + bias)) <= bound)
    np.testing.assert_allclose(w.grad.numpy().T, np.asarray(dk_j, np.float32), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j, np.float32), rtol=1e-5,
                               atol=1e-5)


def test_int_mm_shape_rules():
    """``torch._int_mm``'s rules on the card: more than 16 rows, F and E
    multiples of 8 (a refused shape raises on the card; the CPU takes any)."""
    assert tlayers.int_mm_supports(17, 1024, 256)
    for rows, f, e in ((16, 1024, 256), (64, 1020, 256), (64, 1024, 252)):
        assert not tlayers.int_mm_supports(rows, f, e)
    q = torch.ones((1, 3, 5), dtype=torch.int8)
    y = tlayers.w8a8_linear(q, torch.ones(1, 3), torch.ones(2, 5), torch.zeros(2))
    assert torch.allclose(y, torch.full((1, 3, 2), 5.0 / 127.0 * 127.0))


def test_torch_linear_int8_route_matches_jax():
    """``TorchLinear(x_int8, row_scale)`` takes the w8a8 route (JAX
    ``TorchLinear``'s int8 route) with the float parameters, and
    approximates the float route within quantization error."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 8, 16)).astype(np.float32)
    q, rs = tquant.quantize_bag_int8(x)
    mod_j = jlayers.TorchLinear(4)
    params = mod_j.init(jax.random.key(0), jnp.asarray(x))
    y_j = np.asarray(mod_j.apply(params, jnp.asarray(q), jnp.asarray(rs)))
    lin = tlayers.TorchLinear(16, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
        y_q = lin(torch.from_numpy(q), torch.from_numpy(rs))
        y_f = lin(torch.from_numpy(x))
    np.testing.assert_allclose(y_q.numpy(), y_j, atol=1e-5, rtol=0)
    assert float((y_q - y_f).abs().mean() / y_f.abs().mean()) < 0.02


# ---------------------------------------------------------------- the stager


@pytest.mark.parametrize("transfer", ["int8", "bfloat16"])
def test_stager_rows_equal_the_jax_trainers_padded_transfer(transfer):
    """A rows batch staged in int8 (the real rows quantized before they
    cross; padding rows q = 0, scale 1, written on the device) or bfloat16
    lands as the JAX Trainer's ``_device_batch`` makes the padded batch:
    quantize_bag_int8 of it, or its bfloat16 cast; grouped staging too."""
    bags = _bags(4)[:3]
    rows = tpipeline.bag_rows(bags, 256, 4)
    batch = dict(rows, weight=np.ones(4, np.float32), label=np.zeros(4, np.int64))
    padded = np.zeros((4, 256, WSI), np.float32)
    for j, bag in enumerate(bags):
        padded[j, :len(bag)] = bag
    stager = tpipeline.Stager("cpu")
    for staged in (stager.stage_batch(batch, True, transfer),
                   stager.stage_group([batch, batch], True, transfer)):
        got = staged.take()
        wsi = got["wsi"].reshape(-1, 4, 256, WSI)
        for k in range(wsi.shape[0]):
            if transfer == "int8":
                qj, sj = jquant.quantize_bag_int8(padded)
                assert wsi.dtype == torch.int8
                assert np.array_equal(wsi[k].numpy(), qj)
                assert np.array_equal(got["wsi_scale"].reshape(-1, 4, 256)[k].numpy(), sj)
            else:
                ref = np.asarray(jnp.asarray(padded).astype(jnp.bfloat16).astype(jnp.float32))
                assert wsi.dtype == torch.bfloat16
                assert np.array_equal(wsi[k].float().numpy(), ref)


# ---------------------------------------------------------------- the Trainer


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant_cohort")
    return str(root), make_synthetic_cohort(str(root), n_patients=24, bag_lengths=(48, 80, 120),
                                            n_genes=36, n_signatures=4, seed=0,
                                            signal_strength=2.0)


def _cfg(cohort, label, epochs=2, **tpu):
    root, files = cohort
    raw = synthetic_config_dict(*files)
    raw["device"] = "cpu"
    raw["model"].update(name="NaCAGaT", model_size="small")
    raw["training"].update(loss="cesar", epochs=epochs, lr=1e-3)
    raw["tpu"] = dict({"bag_buckets": [64, 128], "batch_size": 8, "steps_per_dispatch": 2},
                      **tpu)
    cfg = tconfig.config_from_dict(raw)
    cfg.model.checkpoint_dir = os.path.join(root, f"ck_{label}")
    cfg.training.test_output_dir = os.path.join(root, f"o_{label}")
    return cfg


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_int8_cached_epochs_equal_int8_host_fed_epochs_bit_for_bit(cohort, compute):
    """cache_dtype int8 and transfer_dtype int8 quantize the same rows the
    same way, and the steps dequantize alike: two cached epochs equal two
    host-fed epochs bit for bit (losses, c-index, every parameter), in
    float32 and in bfloat16 compute."""
    runs = []
    for label, tpu in (("cache", dict(device_cache="on", cache_dtype="int8")),
                       ("host", dict(device_cache="off", transfer_dtype="int8"))):
        t = Trainer(_cfg(cohort, f"{label}-{compute}", compute_dtype=compute, **tpu),
                    verbose=False)
        out = t.fit()
        runs.append((out, _params(t), t))
    (out_c, p_c, t_c), (out_h, p_h, t_h) = runs
    assert t_c.device_cache is not None and t_c.device_cache.store_dtype == "int8"
    assert t_h.device_cache is None
    for key in ("train_loss", "val_loss", "train_c_index", "val_c_index"):
        assert out_c[key] == out_h[key], key
    for name, v in p_c.items():
        assert torch.equal(v, p_h[name]), name


def test_int8_matmul_training_tracks_the_dequant_path(cohort):
    """tpu.int8_matmul with an int8 cache: the WSI FC runs s8 x s8 -> s32;
    training stays finite and within 0.05 of the dequantizing run (the JAX
    package's bar); the cached and host-fed int8_matmul runs agree bit for
    bit."""
    outs = {}
    for label, tpu in (("deq", dict(device_cache="on", cache_dtype="int8")),
                       ("mm", dict(device_cache="on", cache_dtype="int8", int8_matmul=True)),
                       ("mm-host", dict(device_cache="off", transfer_dtype="int8",
                                        int8_matmul=True))):
        outs[label] = Trainer(_cfg(cohort, label, **tpu), verbose=False).fit()
    assert np.isfinite(outs["mm"]["train_loss"])
    assert abs(outs["mm"]["train_loss"] - outs["deq"]["train_loss"]) < 0.05
    assert outs["mm"]["train_loss"] != outs["deq"]["train_loss"]  # the int8 route ran
    assert outs["mm"]["train_loss"] == outs["mm-host"]["train_loss"]


def test_int8_matmul_first_layer_is_the_w8a8_route(cohort, monkeypatch):
    """The training step hands the int8 batch to the WSI FC's w8a8 route
    (and eval dequantizes: the route is training only)."""
    calls = []
    real = tlayers.W8A8Linear.apply
    monkeypatch.setattr(tlayers.W8A8Linear, "apply",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    t = Trainer(_cfg(cohort, "route", epochs=1, device_cache="on", cache_dtype="int8",
                     int8_matmul=True), verbose=False)
    t.train_epoch(0)
    n_train = len(calls)
    assert n_train > 0 and set(calls) == {torch.int8}
    t.validate(0)
    assert len(calls) == n_train


def test_bfloat16_stores_and_compute_train_close_to_float32(cohort):
    """cache_dtype / transfer_dtype bfloat16, and bfloat16 compute: finite,
    and within 0.05 of the float32 run (the JAX package's bar; the storage
    rounding of the inputs, and bfloat16 arithmetic)."""
    ref = Trainer(_cfg(cohort, "f32", device_cache="on"), verbose=False).fit()
    for label, tpu in (("bf16-cache", dict(device_cache="on", cache_dtype="bfloat16")),
                       ("bf16-host", dict(device_cache="off", transfer_dtype="bfloat16")),
                       ("bf16-compute", dict(device_cache="on", compute_dtype="bfloat16"))):
        t = Trainer(_cfg(cohort, label, **tpu), verbose=False)
        out = t.fit()
        assert np.isfinite(out["train_loss"]) and np.isfinite(out["val_loss"]), label
        assert abs(out["train_loss"] - ref["train_loss"]) < 0.05, label
        assert abs(out["val_loss"] - ref["val_loss"]) < 0.05, label
        if "cache" in label:
            assert t.device_cache.caches[64]["wsi"].dtype == torch.bfloat16


def test_auto_dtypes_resolve_to_float32(cohort):
    """"auto" is float32 for all three dtypes, as the JAX package resolves
    it off a TPU; the model computes in float32."""
    t = Trainer(_cfg(cohort, "auto", epochs=1), verbose=False)
    assert (t.compute_dtype, t.transfer_dtype, t.cache_dtype) == ("float32",) * 3
    assert tconfig.resolve_dtype("auto") == "float32"
    assert tconfig.resolve_dtype("int8") == "int8"
    assert all(getattr(m, "compute_dtype", None) is None for m in t.model.modules())
    t16 = Trainer(_cfg(cohort, "bf16", epochs=1, compute_dtype="bfloat16"), verbose=False)
    assert all(m.compute_dtype == torch.bfloat16 for m in t16.model.modules())
    assert all(p.dtype == torch.float32 for p in t16.model.parameters())


def test_int8_cache_budget_counts_int8_bytes(cohort):
    """A budget that fits the int8 cohort but not the float32 one engages
    the int8 cache (the budget fit counts the store's bytes)."""
    cfg = _cfg(cohort, "budget", epochs=1, device_cache="auto", cache_dtype="int8")
    t = Trainer(cfg, verbose=False)
    lengths = np.concatenate([t.train_batcher._bag_lengths(), t.val_batcher._bag_lengths()])
    f32 = tcache.DeviceBagCache.nbytes(lengths, t.buckets, t.wsi_dim)
    i8 = tcache.DeviceBagCache.nbytes(lengths, t.buckets, t.wsi_dim, store_dtype="int8")
    assert i8 < f32
    cfg.tpu.device_cache_budget_bytes = (f32 + i8) // 2
    assert t._ensure_device_cache() and t.device_cache.store_dtype == "int8"
    assert not t._cache_partial
