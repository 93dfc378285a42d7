"""The port's device-resident bag cache and cached train step against the JAX
package on the CPU: the cache's planning helpers and contents on one
synthetic dataset, the cached step against the host-fed step (bitwise: the
gather is a copy) and against the JAX package's cached step.

Tolerances: planning helpers and cache contents exact; SGD train steps 5e-6
on the parameters (each update is linear in the gradient, lr times its
5e-5-scale noise) and 5e-5 on the losses.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.data import device_cache as jcache  # noqa: E402
from multimodal_path_omic_tpu.data import pipeline as jpipeline  # noqa: E402
from multimodal_path_omic_tpu.models import MCAT as JMCAT  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu.train import optim as joptim  # noqa: E402
from multimodal_path_omic_tpu_torch.data import device_cache as tcache  # noqa: E402
from multimodal_path_omic_tpu_torch.data import pipeline as tpipeline  # noqa: E402
from multimodal_path_omic_tpu_torch.models import MCAT, GENaCAGaT  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import gather as tgather  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import (  # noqa: E402
    init_train_state,
    make_cached_train_step,
    make_train_step,
)
from multimodal_path_omic_tpu_torch.train.optim import make_optimizer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
)

MODEL_ATOL = 5e-5
STEP_ATOL = 5e-6
SIZES = (10, 20, 30)
WSI = 64
BUCKETS = (64, 128, 256)
LENGTHS = (40, 100, 64, 200, 17, 128, 129, 90, 250, 33)
BATCH = 4


def _t(x):
    return torch.from_numpy(np.asarray(x))


class Cohort:
    """Ten seeded bags of 17..250 patches with the table columns both
    packages' ``survival_extras`` / ``gene_expr_extras`` read."""

    def __init__(self):
        rng = np.random.default_rng(0)
        n = len(LENGTHS)
        self.bags = [rng.normal(size=(m, WSI)).astype(np.float32) for m in LENGTHS]
        names = [f"sig{j}" for j in range(len(SIZES))]
        self.table = SimpleNamespace(
            survival_months=rng.uniform(1, 100, n).astype(np.float32),
            survival_class=rng.integers(0, 4, n).astype(np.int32),
            censorship=rng.integers(0, 2, n).astype(np.float32),
            signature_names=names,
            signature_data={k: rng.normal(size=(n, s)).astype(np.float32)
                            for k, s in zip(names, SIZES)},
            gene_expr_class=rng.integers(0, 3, n).astype(np.int32),
        )

    def __len__(self):
        return len(self.bags)

    def bag(self, i):
        return self.bags[i]


@pytest.fixture(scope="module")
def world():
    ds = Cohort()
    return SimpleNamespace(
        ds=ds,
        port=tcache.DeviceBagCache(ds, tpipeline.survival_extras, BUCKETS, device="cpu",
                                   upload_chunk=2),
        ref=jcache.DeviceBagCache(ds, jpipeline.survival_extras, BUCKETS, upload_chunk=2),
    )


def test_extras_equal_the_jax_packages(world):
    idx = np.array([3, 0, 7])
    for fn in ("survival_extras", "gene_expr_extras"):
        got, ref = getattr(tpipeline, fn)(world.ds, idx), getattr(jpipeline, fn)(world.ds, idx)
        assert set(got) == set(ref)
        for key in ref:
            for a, r in zip(got[key] if key == "omics" else [got[key]],
                            ref[key] if key == "omics" else [ref[key]]):
                assert np.array_equal(a, r)


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16", "int8"])
def test_nbytes_and_bucket_bytes_equal_jax(store_dtype):
    lengths = np.array(LENGTHS)
    for only in (None, (64, 256)):
        assert tcache.DeviceBagCache.nbytes(lengths, BUCKETS, 1024, store_dtype, only) == \
            jcache.DeviceBagCache.nbytes(lengths, BUCKETS, 1024, store_dtype, only)
    assert tcache.DeviceBagCache.bucket_bytes(lengths, BUCKETS, 1024, store_dtype) == \
        jcache.DeviceBagCache.bucket_bytes(lengths, BUCKETS, 1024, store_dtype)


@pytest.mark.parametrize(
    "budget,forced,multi_host",
    [(10**9, False, False), (3_000_000, False, False), (3_000_000, False, True),
     (3_000_000, True, False), (10, False, False)],
    ids=["fits", "partial", "multi-host-never-partial", "forced", "nothing-fits"],
)
def test_plan_cache_fit_equals_jax(budget, forced, multi_host):
    lengths = np.array(LENGTHS)
    per_bucket = tcache.DeviceBagCache.bucket_bytes(lengths, BUCKETS, 1024)
    counts = {b: int(sum(1 for m in LENGTHS if tcache.bucket_for(m, BUCKETS) == b))
              for b in per_bucket}
    kw = dict(forced=forced, multi_host=multi_host)
    got = tcache.plan_cache_fit(per_bucket, counts, budget, **kw)
    assert got == jcache.plan_cache_fit(per_bucket, counts, budget, **kw)
    if budget == 3_000_000 and not forced and not multi_host:
        assert got[0] is not None and got[2]  # a partial cache


def test_cache_contents_positions_and_meta_equal_jax(world):
    """Every cached tensor, position() and build_meta (a full and a short
    batch) against the JAX package's cache on the same dataset."""
    port, ref = world.port, world.ref
    assert port.cached_buckets == ref.cached_buckets == [64, 128, 256]
    assert np.array_equal(port.bucket_of, ref.bucket_of)
    rows = np.arange(len(LENGTHS))
    assert np.array_equal(port.position(rows), ref.position(rows))
    for bucket in port.cached_buckets:
        assert set(port.caches[bucket]) == set(ref.caches[bucket])
        for key, value in ref.caches[bucket].items():
            got = port.caches[bucket][key]
            assert tuple(got.shape) == value.shape, key
            assert np.array_equal(got.numpy(), np.asarray(value)), key
    assert port.caches[64]["wsi"].shape == (4, 64, WSI) and port.omic_sizes == SIZES
    for indices in ([6, 3, 8, 6], [8, 3]):
        (got, real), (want, real_j) = (mod.build_meta(indices, BATCH, c)
                                       for mod, c in ((tcache, port), (jcache, ref)))
        assert real == real_j == len(indices) and set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


def test_partial_cache_and_ge_mode(world):
    part = tcache.DeviceBagCache(world.ds, tpipeline.gene_expr_extras, BUCKETS, device="cpu",
                                 ge_mode=True, only_buckets=(128,), lengths=np.array(LENGTHS))
    ref = jcache.DeviceBagCache(world.ds, jpipeline.gene_expr_extras, BUCKETS, ge_mode=True,
                                only_buckets=(128,))
    assert part.cached_buckets == ref.cached_buckets == [128]
    assert set(part.caches[128]) == set(ref.caches[128]) == {"wsi", "mask", "label"}
    for key, value in ref.caches[128].items():
        assert np.array_equal(part.caches[128][key].numpy(), np.asarray(value))


@pytest.mark.parametrize(
    "kwargs,exc,match",
    [(dict(store_dtype="bfloat16"), None, torch.bfloat16),
     (dict(store_dtype="int8"), None, torch.int8),
     (dict(store_dtype="float16"), ValueError, "store_dtype"),
     (dict(mesh=object()), TypeError, "parallel.mesh.Mesh")],
    ids=["bf16-store", "int8-store", "unknown-store", "mesh"],
)
def test_cache_refuses_what_is_not_ported(world, kwargs, exc, match):
    """An unknown store type and a mesh that is not a ``parallel.mesh.Mesh``
    raise; the bfloat16 and int8 stores are ported (their contents against
    JAX's: test_torch_port_quant.py) and store in their type (the sharded
    cache of a real mesh: test_torch_port_mesh_trainer.py)."""
    if exc is None:
        cache = tcache.DeviceBagCache(world.ds, tpipeline.survival_extras, BUCKETS,
                                      device="cpu", **kwargs)
        assert all(c["wsi"].dtype == match for c in cache.caches.values())
        return
    with pytest.raises(exc, match=match):
        tcache.DeviceBagCache(world.ds, tpipeline.survival_extras, BUCKETS, device="cpu", **kwargs)


def test_stale_length_probe_raises(world):
    with pytest.raises(ValueError, match="stale"):
        tcache.DeviceBagCache(world.ds, tpipeline.survival_extras, BUCKETS, device="cpu",
                              lengths=np.full(len(LENGTHS), 20))


def test_cache_defaults_to_cuda(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcache.DeviceBagCache(world.ds, tpipeline.survival_extras, BUCKETS)


@pytest.mark.parametrize("name,value", [("mesh", object()), ("int8_matmul", True)])
def test_cached_step_refuses_what_is_not_ported(name, value):
    """A mesh that is not a ``parallel.mesh.Mesh`` raises (the cached step
    on a real mesh: test_torch_port_mesh_trainer.py); int8_matmul is ported
    (its training: test_torch_port_quant.py) and builds the step; a survival
    step without omic_sizes raises."""
    model = MCAT(SIZES, model_size="small", wsi_dim=WSI)
    if name == "int8_matmul":
        assert callable(make_cached_train_step(model, "ces", make_optimizer("sgd", 0.1),
                                               omic_sizes=SIZES, int8_matmul=value))
    else:
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            make_cached_train_step(model, "ces", make_optimizer("sgd", 0.1), omic_sizes=SIZES,
                                   **{name: value})
    with pytest.raises(ValueError, match="omic_sizes"):
        make_cached_train_step(model, "ces", make_optimizer("sgd", 0.1))


# ---------------------------------------------------------------- the cached step

# (bucket-local batches: dataset rows of one bucket; the last is short)
BATCHES = ((256, [6, 3, 8, 6]), (128, [1, 5, 7]), (64, [4, 0]))


@pytest.fixture(scope="module")
def jparams():
    rng = np.random.default_rng(1)
    model = JMCAT(n_signatures=len(SIZES), model_size="small", dropout_rate=0.0)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, WSI)), [jnp.zeros((1, s)) for s in SIZES],
        jnp.ones((1, 64), bool), deterministic=True,
    ))(jax.random.key(0))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _host_batch(ds, bucket, meta, ge_mode=False):
    """The host-fed batch of a meta's rows, as a loader would stage it."""
    rows = meta["row"]
    wsi = np.zeros((len(rows), bucket, WSI), np.float32)
    mask = np.zeros((len(rows), bucket), bool)
    for j, r in enumerate(rows):
        bag = ds.bag(int(r))
        wsi[j, :len(bag)] = bag
        mask[j, :len(bag)] = True
    t = ds.table
    batch = {"wsi": _t(wsi), "mask": _t(mask), "weight": _t(meta["weight"])}
    if ge_mode:
        batch["label"] = _t(t.gene_expr_class[rows]).long()
        return batch
    batch.update(
        label=_t(t.survival_class[rows]).long(), censorship=_t(t.censorship[rows]),
        survival_months=_t(t.survival_months[rows]),
        omics=[_t(t.signature_data[n][rows]) for n in t.signature_names])
    return batch


def _port_run(model, cache, ds, loss, cached, ge_mode=False, dropout_seed=0):
    spec = make_optimizer("sgd", 0.05)
    state = init_train_state(model, spec, seed=dropout_seed)
    make = make_cached_train_step if cached else make_train_step
    step = make(model, loss, spec, ge_mode=ge_mode, omic_sizes=None if ge_mode else SIZES)
    losses = []
    for bucket, rows in BATCHES:
        meta, _ = tcache.build_meta(rows, BATCH, cache)
        if cached:
            state, metrics = step(state, cache.caches[bucket], meta)
        else:
            state, metrics = step(state, _host_batch(ds, bucket, meta, ge_mode))
        losses.append(float(metrics.loss))
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("rate", [0.0, 0.25], ids=["dropout-off", "dropout-on"])
def test_cached_step_equals_host_fed_step_bitwise(world, jparams, rate, monkeypatch):
    """Three SGD steps over three buckets (a full and two short batches, a
    repeated row): losses and parameters of the cached and the host-fed run
    are the same bits, with dropout too (the same generator seed); every
    cached step gathers its wsi through take_rows."""
    calls = []
    monkeypatch.setattr("multimodal_path_omic_tpu_torch.train.loop.take_rows",
                        lambda pool, idx: calls.append(tuple(idx.shape)) or
                        tgather.take_rows(pool, idx))
    runs = []
    for cached in (True, False):
        model = load_jax_params(MCAT(SIZES, model_size="small", dropout_rate=rate, wsi_dim=WSI),
                                jparams)
        runs.append(_port_run(model, world.port, world.ds, "ces", cached))
    assert calls == [(BATCH,)] * len(BATCHES)
    (losses_c, params_c), (losses_h, params_h) = runs
    assert losses_c == losses_h and all(np.isfinite(losses_c))
    for name, v in params_c.items():
        assert torch.equal(v, params_h[name]), name


def test_cached_step_matches_jax_cached_step(world, jparams):
    """The same three cached SGD steps (ces, dropout 0) against the JAX
    package's make_cached_train_step over its own cache."""
    model_j = JMCAT(n_signatures=len(SIZES), model_size="small", dropout_rate=0.0)
    tx = joptim.make_optimizer("sgd", 0.05)
    step = jloop.make_cached_train_step(model_j, "ces", tx, omic_sizes=SIZES)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state = jloop.TrainState(params, tx.init(params), jax.random.key(1), jnp.zeros((), jnp.int32))
    losses_j = []
    for bucket, rows in BATCHES:
        meta, _ = jcache.build_meta(rows, BATCH, world.ref)
        state, metrics = step(state, world.ref.caches[bucket], meta)
        losses_j.append(float(metrics.loss))
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    model = load_jax_params(MCAT(SIZES, model_size="small", dropout_rate=0.0, wsi_dim=WSI),
                            jparams)
    losses, got = _port_run(model, world.port, world.ds, "ces", cached=True)
    np.testing.assert_allclose(losses, losses_j, atol=MODEL_ATOL, rtol=0)
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), atol=STEP_ATOL, rtol=0)


def test_ge_mode_cached_step(world):
    """GE mode: the cache holds wsi, mask and label only, and the cached
    step equals the host-fed one bitwise (the host-fed GE step is held to
    the JAX package by test_torch_port_ge_train.py)."""
    cache = tcache.DeviceBagCache(world.ds, tpipeline.gene_expr_extras, BUCKETS, device="cpu",
                                  ge_mode=True)
    assert set(cache.caches[64]) == {"wsi", "mask", "label"}
    runs = []
    for cached in (True, False):
        torch.manual_seed(5)  # the same initial weights for both runs
        model = GENaCAGaT("small", dropout_rate=0.25, wsi_dim=WSI)
        runs.append(_port_run(model, cache, world.ds, "ce", cached, ge_mode=True))
    (losses_c, got), (losses_h, host) = runs
    assert losses_c == losses_h and all(np.isfinite(losses_c))
    for name, v in got.items():
        assert torch.equal(v, host[name]), name
