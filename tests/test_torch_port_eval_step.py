"""The port's eval step (``train/loop.py::make_eval_step``) and the
``Predictor`` that serves through it, against the JAX package's
``make_eval_step`` on the same weights (the port's weight bridge) and the
same numpy batches: NaCAGaT ``small`` under every survival loss (ce, ces,
sct, cesar, nll, cox) with the L1 term on and off, host-fed and from a
device cache; GE-NaCAGaT ``small`` under ce.

Size: 64-wide patch features, three signatures, B=4 bags over M=96 keys
(the last row a zero-weight filler repeating the third, as the batcher
fills a short batch).

Tolerance 5e-5 absolute on loss, attn_loss, risk, hazards, survs, y and the
co-attention map: float32 on both sides in other summation orders, carried
through ~20 layers (the bar of the port's model parity tests).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.data import device_cache as jcache  # noqa: E402
from multimodal_path_omic_tpu.data import pipeline as jpipeline  # noqa: E402
from multimodal_path_omic_tpu.models import GENaCAGaT as JGENaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.models import NaCAGaT as JNaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu_torch.data import device_cache as tcache  # noqa: E402
from multimodal_path_omic_tpu_torch.data import pipeline as tpipeline  # noqa: E402
from multimodal_path_omic_tpu_torch.models import GENaCAGaT, NaCAGaT  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import LOSSES, Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import make_eval_step  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

ATOL = 5e-5
WSI, M = 64, 96
SIZES = (10, 20, 30)
LENGTHS = (96, 60, 33, 33)
WEIGHT = np.array([1, 1, 1, 0], np.float32)
SURVIVAL_LOSSES = ("ce", "ces", "sct", "cesar", "nll", "cox")
L1 = 3e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's six workers on
    eight cores, each with a thread a core, oversubscribe them (the host-fed
    Trainers here then run several times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _perturbed(params, rng):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def world():
    """A NaCAGaT and a GE tree (every leaf perturbed, so zero biases and unit
    scales cannot hide a bridge fault) and one batch in numpy."""
    rng = np.random.default_rng(0)
    b = len(LENGTHS)
    batch = {
        "wsi": rng.normal(size=(b, M, WSI)).astype(np.float32),
        "mask": np.arange(M)[None] < np.array(LENGTHS)[:, None],
        "omics": [rng.normal(size=(b, s)).astype(np.float32) for s in SIZES],
        "label": rng.integers(0, 4, b).astype(np.int32),
        "censorship": np.array([0, 1, 0, 0], np.float32),
        "survival_months": rng.uniform(1, 60, b).astype(np.float32),
        "weight": WEIGHT,
    }
    for key in ("wsi", "label", "censorship", "survival_months"):
        batch[key][3] = batch[key][2]  # the filler row repeats the last real one
    for o in batch["omics"]:
        o[3] = o[2]
    wsi0, mask0 = jnp.asarray(batch["wsi"][:, :32]), jnp.asarray(batch["mask"][:, :32])
    params = JNaCAGaT(n_signatures=len(SIZES), model_size="small").init(
        jax.random.key(0), wsi0, [jnp.asarray(o) for o in batch["omics"]], mask0,
        deterministic=True)["params"]
    ge_params = JGENaCAGaT(model_size="small").init(
        jax.random.key(1), wsi0, mask0, deterministic=True)["params"]
    return SimpleNamespace(batch=batch, params=_perturbed(params, rng),
                           ge_params=_perturbed(ge_params, rng))


def _port_batch(batch):
    out = {k: _t(v) for k, v in batch.items() if k != "omics"}
    out["label"] = out["label"].long()
    if "omics" in batch:
        out["omics"] = [_t(o) for o in batch["omics"]]
    return out


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def _check_survival(got, ref, loss_name):
    assert set(got) == set(ref)
    for key in ("loss", "attn_loss", "risk", "hazards", "survs", "y", "n_real"):
        _close(got[key], ref[key])
    if loss_name == "cesar":
        assert got["attention"]["coattn"].shape == np.asarray(ref["attention"]["coattn"]).shape
        assert got["attention"]["coattn"].shape[:2] == (len(LENGTHS), len(SIZES))
        _close(got["attention"]["coattn"], ref["attention"]["coattn"])
        assert float(got["attn_loss"]) > 0.0
    else:
        assert got["attention"] is None and ref["attention"] is None


@pytest.mark.parametrize("l1", [0.0, L1], ids=["no-l1", "l1"])
@pytest.mark.parametrize("loss_name", SURVIVAL_LOSSES)
def test_eval_step_matches_jax(world, loss_name, l1):
    jmodel = JNaCAGaT(n_signatures=len(SIZES), model_size="small")
    ref = jloop.make_eval_step(jmodel, loss_name, l1_lambda=l1, omic_sizes=SIZES)(
        world.params, {k: (jnp.asarray(v) if k != "omics" else [jnp.asarray(o) for o in v])
                       for k, v in world.batch.items()})
    model = load_jax_params(NaCAGaT(SIZES, model_size="small", wsi_dim=WSI), world.params)
    got = make_eval_step(model, loss_name, l1_lambda=l1, omic_sizes=SIZES)(
        _port_batch(world.batch))
    _check_survival(got, ref, loss_name)
    if l1:  # the L1 term is in the loss, once
        base = make_eval_step(model, loss_name, omic_sizes=SIZES)(_port_batch(world.batch))
        reg = sum(float(np.abs(x).sum()) for x in jax.tree_util.tree_leaves(world.params))
        np.testing.assert_allclose(float(got["loss"]) - float(base["loss"]), l1 * reg,
                                   rtol=1e-4)


def test_eval_step_runs_under_inference_mode(world):
    model = load_jax_params(NaCAGaT(SIZES, model_size="small", wsi_dim=WSI), world.params)
    model.train()
    got = make_eval_step(model, "ces", omic_sizes=SIZES)(_port_batch(world.batch))
    assert got["loss"].is_inference() and not got["risk"].requires_grad
    assert not model.training  # a deterministic forward


class Cohort:
    """Six bags of the world's width with the table columns both packages'
    extras functions read."""

    def __init__(self):
        rng = np.random.default_rng(5)
        lengths = (96, 40, 120, 17, 70, 128)
        n = len(lengths)
        self.bags = [rng.normal(size=(m, WSI)).astype(np.float32) for m in lengths]
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


@pytest.mark.parametrize("loss_name", ["cesar", "cox"])
def test_cached_eval_step_matches_jax_and_host_fed(world, loss_name):
    """The cached form gathers the batch from a DeviceBagCache: equal to
    JAX's cached eval step, and bitwise to the port's host-fed step on the
    same rows (the gather is a copy)."""
    ds = Cohort()
    buckets = (64, 128)
    port = tcache.DeviceBagCache(ds, tpipeline.survival_extras, buckets, device="cpu")
    ref_cache = jcache.DeviceBagCache(ds, jpipeline.survival_extras, buckets)
    rows = [int(r) for r in np.flatnonzero(port.bucket_of == 128)]
    meta, _ = tcache.build_meta(rows, 4, port)
    jmeta, _ = jcache.build_meta(rows, 4, ref_cache)
    ref = jloop.make_eval_step(
        JNaCAGaT(n_signatures=len(SIZES), model_size="small"), loss_name, l1_lambda=L1,
        omic_sizes=SIZES, cached=True)(world.params, ref_cache.caches[128], jmeta)
    model = load_jax_params(NaCAGaT(SIZES, model_size="small", wsi_dim=WSI), world.params)
    got = make_eval_step(model, loss_name, l1_lambda=L1, omic_sizes=SIZES, cached=True)(
        port.caches[128], meta)
    _check_survival(got, ref, loss_name)
    host = {
        "wsi": port.caches[128]["wsi"][_t(meta["pos"]).long()],
        "mask": port.caches[128]["mask"][_t(meta["pos"]).long()],
        "omics": [_t(ds.table.signature_data[n][meta["row"]]) for n in ds.table.signature_names],
        "label": _t(ds.table.survival_class[meta["row"]]).long(),
        "censorship": _t(ds.table.censorship[meta["row"]]),
        "survival_months": _t(ds.table.survival_months[meta["row"]]),
        "weight": _t(meta["weight"]),
    }
    fed = make_eval_step(model, loss_name, l1_lambda=L1, omic_sizes=SIZES)(host)
    for key in ("loss", "risk", "hazards", "survs", "y"):
        assert torch.equal(got[key], fed[key]), key


@pytest.mark.parametrize("cached", [False, True], ids=["host-fed", "cached"])
@pytest.mark.parametrize("l1", [0.0, L1], ids=["no-l1", "l1"])
def test_ge_eval_step_matches_jax(world, l1, cached):
    b = world.batch
    jbatch = {k: jnp.asarray(b[k]) for k in ("wsi", "mask", "label", "weight")}
    jstep = jloop.make_eval_step(JGENaCAGaT(model_size="small"), "ce", ge_mode=True,
                                 l1_lambda=l1)
    model = load_jax_params(GENaCAGaT("small", wsi_dim=WSI), world.ge_params)
    if cached:
        ds = Cohort()
        port = tcache.DeviceBagCache(ds, tpipeline.gene_expr_extras, (128,), device="cpu",
                                     ge_mode=True)
        ref_cache = jcache.DeviceBagCache(ds, jpipeline.gene_expr_extras, (128,), ge_mode=True)
        meta, _ = tcache.build_meta([0, 2, 5], 4, port)
        ref = jloop.make_eval_step(JGENaCAGaT(model_size="small"), "ce", ge_mode=True,
                                   l1_lambda=l1, cached=True)(
            world.ge_params, ref_cache.caches[128], jcache.build_meta([0, 2, 5], 4, ref_cache)[0])
        got = make_eval_step(model, "ce", ge_mode=True, l1_lambda=l1, cached=True)(
            port.caches[128], meta)
    else:
        ref = jstep(world.ge_params, jbatch)
        got = make_eval_step(model, "ce", ge_mode=True, l1_lambda=l1)(_port_batch(
            {k: b[k] for k in ("wsi", "mask", "label", "weight")}))
    assert set(got) == set(ref) == {"loss", "y", "attention", "n_real"}
    for key in ("loss", "y", "n_real"):
        _close(got[key], ref[key])
    path = got["attention"]["path"]
    _close(path.reshape(np.asarray(ref["attention"]["path"]).shape), ref["attention"]["path"])
    with pytest.raises(NotImplementedError, match="ce loss"):
        make_eval_step(model, "ces", ge_mode=True)


def test_predictor_takes_every_survival_loss(world):
    assert LOSSES == SURVIVAL_LOSSES


@pytest.mark.parametrize("loss_name", ["nll", "cox", "sct"])
def test_predictor_eval_step_matches_jax(world, loss_name):
    """Predictor.eval_step is the new eval step: the losses it refused before
    (nll, cox with the batch's months, sct) against JAX's."""
    pred = Predictor(omic_sizes=SIZES, model_size="small", wsi_dim=WSI, loss=loss_name,
                     params=world.params, device="cpu")
    got = pred.eval_step(_port_batch(world.batch))
    ref = jloop.make_eval_step(JNaCAGaT(n_signatures=len(SIZES), model_size="small"),
                               loss_name, omic_sizes=SIZES)(
        world.params, {k: (jnp.asarray(v) if k != "omics" else [jnp.asarray(o) for o in v])
                       for k, v in world.batch.items()})
    _check_survival(got, ref, loss_name)
    bags = [world.batch["wsi"][i, :n] for i, n in enumerate(LENGTHS[:3])]
    omics = [[o[i] for o in world.batch["omics"]] for i in range(3)]
    scored = Predictor(omic_sizes=SIZES, model_size="small", wsi_dim=WSI, loss=loss_name,
                       params=world.params, device="cpu", buckets=(M,),
                       batch_size=4).predict_bags(bags, omics)
    _close(scored["risk"], np.asarray(ref["risk"])[:3])
