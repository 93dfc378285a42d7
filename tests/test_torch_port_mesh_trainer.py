"""The port's Trainer, steps and Predictor on a mesh of gloo ranks against
one rank and against the JAX package on the same mesh shape (JAX
``tests/test_parallel.py``, ``tests/test_serve_mesh.py``,
``tests/test_multihost.py``).

A world of 2 ranks runs data 2 and seq 2, a world of 4 the 2x2 mesh, each
spawned once (``torch_mesh_workers.run_world``, ``torch_mesh_jobs.
trainer_world``) over a 32-patient synthetic cohort (64-wide patches, bags
of 40-120 patches, buckets 64 and 128, batch 4, two epochs, dropout 0.25):
the Trainer host-fed, cached and partly cached, single- and multi-step
(``steps_per_dispatch`` 1 and auto), with ``patch_dropout``, then ``Predictor.
from_trainer``'s ``predict_dataset`` / ``predict_bags`` / ``predict_bag``
and ``evaluate``. The one-rank runs are the same configurations in this
process. The optimizer is SGD: Adam's first steps are the gradient's sign,
which turns the rounding noise of a gradient that is zero (a softmax bias)
into a full step, where SGD keeps it at the noise's size.

The settings the mesh first refused run in the same two spawns: the cox
loss at data 2 and 2x2 (three SGD steps host-fed and from the sharded
device cache, then the eval step, on batches whose months tie and
interleave across the data ranks with a zero-weight row on rank 1), the
attention maps of the eval step at seq 2 (NaCAGaT's and MCAT's co-attention
maps through the export passes on merged statistics, GE's MIL scores) and at
data 2, on a batch with a bag whose valid patches all lie in seq rank 0's
half and a bag without one, and ``Trainer.test`` (the leave-one-out export)
at seq 2 against the JAX Trainer on its seq-2 CPU mesh, and at data 2 and
2x2, where both raise.

Tolerances: epoch numbers, outputs and parameters 1e-5 of each quantity's
largest magnitude against one rank (other summation orders across ranks;
a gradient below 1e-2 of the model's largest is held to 1e-7 of that: it is
a cancellation, whose rounding follows its terms, as a softmax scoring
head's does); parameters bitwise equal across ranks; against JAX's
gradients, losses and maps on the same mesh (cox: the JAX step's loss on
the global batch) 5e-5 absolute (maps: weights at most 1; GE's raw scores
5e-5 of their largest magnitude). The cox
gradients are held to 1e-4 of the model's largest gradient: they are
~1e-3 of the per-row terms they sum (the partial likelihood is invariant
to a shift of every risk), so their rounding is the terms'; the one-rank
port's own distance from JAX is 7e-5 of it on this batch, two ranks' from
one rank 4.4e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.models import build_model as jbuild_model  # noqa: E402
from multimodal_path_omic_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train.analysis import evaluate  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import jax_params_to_state_dict  # noqa: E402

import torch_mesh_jobs as jobs  # noqa: E402
from torch_mesh_workers import run_world  # noqa: E402

JAX_ATOL = 5e-5
SGD = {"training.optimizer": "sgd", "training.lr": 0.05, "training.keep_best": True}
DROP = {"training.patch_dropout": 0.3}
FITS = {  # key: (world, model, mesh axes, settings)
    "data2-host": (2, "NaCAGaT", (2, 1), dict(DROP)),
    "data2-cached": (2, "NaCAGaT", (2, 1), dict(DROP, **{"tpu.device_cache": "on"})),
    # a budget that holds the 64 bucket only (per device on the mesh): partial caching
    "data2-partial": (2, "NaCAGaT", (2, 1), dict(DROP, **{"tpu.device_cache": "auto",
                                                          "tpu.device_cache_budget_bytes": None})),
    "seq2-ge-cached-multi": (2, "GE-NaCAGaT", (1, 2), {"tpu.device_cache": "on",
                                                       "tpu.steps_per_dispatch": 0}),
    "seq2-mcat": (2, "MCAT", (1, 2), dict(DROP)),
    "2x2-cached-multi": (4, "NaCAGaT", (2, 2), dict(DROP, **{"tpu.device_cache": "on",
                                                             "tpu.steps_per_dispatch": 0})),
}
# one-rank runs: cached and host-fed, single- and multi-step are the same
# numbers at one rank (test_torch_port_multistep.py), so one run a model
ONE_RANK = {"data2-host": "data2-host", "data2-cached": "data2-host",
            "data2-partial": "data2-host",
            "seq2-ge-cached-multi": "seq2-ge-cached-multi", "seq2-mcat": "seq2-mcat",
            "2x2-cached-multi": "data2-host"}
PREDICT = ("data2-host", "seq2-ge-cached-multi", "seq2-mcat", "2x2-cached-multi")
REFUSALS = {  # key: (settings, the message)
    "indivisible-batch": ({"tpu.data_axis": 2, "tpu.batch_size": 3},
                          "ValueError: tpu.batch_size=3 must be divisible by tpu.data_axis=2"),
    "ranks-without-mesh": ({}, "ValueError: 2 ranks but tpu.data_axis=1 x tpu.seq_axis=1 "
                               "defines no mesh"),
}
GRADS = {  # key: (world, model, loss, mesh axes)
    "nacagat-data2": (2, "NaCAGaT", "ces", (2, 1)),
    "mcat-seq2": (2, "MCAT", "ces", (1, 2)),
    "ge-seq2": (2, "GE-NaCAGaT", "ce", (1, 2)),
    "nacagat-2x2": (4, "NaCAGaT", "ces", (2, 2)),
}
GRAD_B, GRAD_M, WSI = 4, 128, 64
COX = {  # key: (world, mesh axes, cached)
    "cox-data2-host": (2, (2, 1), False), "cox-data2-cached": (2, (2, 1), True),
    "cox-2x2-host": (4, (2, 2), False), "cox-2x2-cached": (4, (2, 2), True),
}
EXPORTS = {  # key: (model, mesh axes); all on two ranks
    "export-seq2-NaCAGaT": ("NaCAGaT", (1, 2)), "export-seq2-MCAT": ("MCAT", (1, 2)),
    "export-seq2-GE": ("GE-NaCAGaT", (1, 2)), "export-data2-NaCAGaT": ("NaCAGaT", (2, 1)),
}
LOO = {  # key: (world, model, mesh axes); the JAX Trainer runs at seq 2, raises on data 2
    "loo-seq2-NaCAGaT": (2, "NaCAGaT", (1, 2)), "loo-seq2-GE": (2, "GE-NaCAGaT", (1, 2)),
    "loo-data2": (2, "NaCAGaT", (2, 1)), "loo-2x2": (4, "NaCAGaT", (2, 2)),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs (the one-rank references; the
    spawned ranks take one each): the suite's six workers on eight cores,
    each with a thread a core, oversubscribe them."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _sets(key, cohort, tag):
    world, name, (data, seq), extra = FITS[key]
    root, per_bucket = cohort
    sets = dict(SGD, **extra)
    sets["model.checkpoint_dir"] = f"{root}/ck-{key}-{tag}"
    if "tpu.device_cache_budget_bytes" in sets:  # the 64 bucket's bytes, per device
        ranks = data * seq if tag == "mesh" else 1
        sets["tpu.device_cache_budget_bytes"] = -(-(per_bucket[64] + 64) // ranks)
    if tag == "mesh":
        sets.update({"tpu.data_axis": data, "tpu.seq_axis": seq})
    return name, sets


def _jax_params(name):
    model = jbuild_model(name, omic_sizes=jobs.SIZES, model_size="small", dropout=0.0)
    batch = jobs.survival_batch(1, 64, WSI, 0)
    args = [jnp.asarray(batch["wsi"]), jnp.asarray(batch["mask"])]
    if not name.lower().startswith("ge"):
        omics = np.split(batch["omics_packed"], np.cumsum(jobs.SIZES)[:-1], axis=1)
        args.insert(1, [jnp.asarray(o) for o in omics])
    # the tree's shapes without compiling init; values from numpy
    shapes = jax.eval_shape(model.init, jax.random.key(3), *args)["params"]
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda s: rng.uniform(-1, 1, s.shape).astype(np.float32)
        / np.float32(np.sqrt(s.shape[-2] if len(s.shape) >= 2 else 16)), shapes)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """(root, the cohort's device-cache bytes a bucket): written once,
    before the ranks read it."""
    from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache

    root = str(tmp_path_factory.mktemp("mesh_cohort"))
    t = Trainer(config_from_dict(jobs.cohort_config(root)), verbose=False, device="cpu")
    lengths = np.concatenate([t.train_batcher._bag_lengths(), t.val_batcher._bag_lengths()])
    return root, DeviceBagCache.bucket_bytes(lengths, t.buckets, t.wsi_dim)


@pytest.fixture(scope="module")
def params():
    return {name: _jax_params(name) for name in ("NaCAGaT", "MCAT", "GE-NaCAGaT")}


def _jax_trainer(root, name, data, seq):
    raw = jobs.loo_config(root, name, data, seq)
    raw["training"]["test_output_dir"] = f"{root}/jax-loo-{name}-{data}x{seq}"
    from multimodal_path_omic_tpu.train.trainer import Trainer as JTrainer

    return JTrainer(jconfig_from_dict(raw), verbose=False)


@pytest.fixture(scope="module")
def loo_jax(cohort):
    """Per LOO case: the JAX Trainer's parameters and what its ``test(1,
    save=True)`` wrote (the map) or raised, on its mesh of the same shape."""
    import glob

    out = {}
    for key, (_, name, (data, seq)) in LOO.items():
        t = _jax_trainer(cohort[0], name, data, seq)
        res = {"params": jax.tree_util.tree_map(np.asarray, t.state.params)}
        try:
            t.test(1, save=True)
            (path,) = glob.glob(f"{t.config.training.test_output_dir}/ATTN_*.npy")
            res["map"], res["name"] = np.load(path), path.rsplit("/", 1)[1]
        except ValueError as exc:
            res["raised"] = str(exc)
        out[key] = res
    return out


@pytest.fixture(scope="module")
def worlds(cohort, params, loo_jax):
    """Per world size, every rank's results of every case, spawned once."""
    out = {}
    for world in (2, 4):
        specs = []
        for key, (w, name, _, _) in FITS.items():
            if w == world:
                specs.append((key, "fit", (name, _sets(key, cohort, "mesh")[1],
                                           key in PREDICT)))
        for key, (w, name, loss, (data, seq)) in GRADS.items():
            if w == world:
                specs.append((key, "steps", (name, data, seq, 1, 0.0, 0, GRAD_B, GRAD_M, loss,
                                             0.0, "small", WSI, params[name])))
        for key, (w, (data, seq), cached) in COX.items():
            if w == world:
                specs.append((key, "cox", ("NaCAGaT", data, seq, cached, params["NaCAGaT"])))
        for key, (w, name, (data, seq)) in LOO.items():
            if w == world:
                specs.append((key, "loo", (name, data, seq, loo_jax[key]["params"])))
        if world == 2:
            for key, (sets, _) in REFUSALS.items():
                specs.append((key, "raises", ("NaCAGaT", sets, False)))
            for key, (name, (data, seq)) in EXPORTS.items():
                specs.append((key, "export", (name, data, seq, params[name])))
        out[world] = run_world("trainer_world", world, cohort[0], specs)
    return out


@pytest.fixture(scope="module")
def one_rank(cohort):
    """The one-rank Trainer of each model (``ONE_RANK``), fitted in this
    process."""
    runs = {}
    for key in set(ONE_RANK.values()):
        name, sets = _sets(key, cohort, "one")
        runs[key] = jobs.trainer_fit(cohort[0], name, sets)
    return {key: runs[ref] for key, ref in ONE_RANK.items()}


def _near(got, ref, what, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    bound = 1e-5 * max(float(np.abs(ref).max()) if ref.size else 0.0, floor, 1e-30)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= bound, f"{what}: {err} > {bound}"


# ---------------------------------------------------------------------- Trainer


@pytest.mark.parametrize("key", list(FITS))
def test_trainer_on_a_mesh_equals_one_rank(worlds, one_rank, key):
    """Every epoch number of ``fit`` (losses, the c-index or accuracy, the
    best epoch) and the final parameters of each rank against one rank;
    the parameters bitwise equal across ranks."""
    res = [r[key] for r in worlds[FITS[key][0]]]
    ref = one_rank[key]
    assert set(res[0]["fit"]) == set(ref["fit"])
    for name, value in ref["fit"].items():
        if "seconds" in name:
            continue
        for r in res:
            _near(r["fit"][name], value, name)
    for name, p in ref["params"].items():
        for r in res:
            assert torch.equal(r["params"][name], res[0]["params"][name]), name
        _near(res[0]["params"][name], p, name)


@pytest.mark.parametrize("key", list(FITS))
def test_checkpoint_of_rank_0_equals_one_rank(worlds, one_rank, key):
    """``keep_best``: rank 0 writes the best checkpoint; its weights equal
    the one-rank run's checkpoint (every rank reads the same file)."""
    res = worlds[FITS[key][0]]
    ref = one_rank[key]["best"]
    for r in res:
        assert r[key]["best"] is not None
        for name, t in ref.items():
            assert torch.equal(r[key]["best"][name], res[0][key]["best"][name])
            _near(r[key]["best"][name], t, name)


@pytest.mark.parametrize("key", ["data2-cached", "data2-partial"])
def test_cached_equals_host_fed_on_a_mesh(worlds, key):
    """At data 2 with patch_dropout, the cached epochs (the sharded cache,
    its gather and all-to-all), and the partly cached ones (the 64 bucket
    cached, the 128 bucket host-fed), equal the host-fed ones bit for
    bit."""
    for r in worlds[2]:
        cached, host = r[key], r["data2-host"]
        assert cached["fit"].keys() == host["fit"].keys()
        for name, value in host["fit"].items():
            if "seconds" not in name:
                assert cached["fit"][name] == value or (np.isnan(value)
                                                        and np.isnan(cached["fit"][name])), name
        for name, p in host["params"].items():
            assert torch.equal(cached["params"][name], p), name


@pytest.mark.parametrize("key", [k for k in FITS if "cached" in k or "partial" in k])
def test_the_cache_splits_over_the_ranks(worlds, cohort, key):
    """Each rank holds its chunk of every cached bag's patches: its wsi
    bytes are the cached buckets' bytes over the mesh size (the budget is
    each device's; JAX ``trainer.py:526-548``); the partial run caches the
    64 bucket alone."""
    world, _, (data, seq), _ = FITS[key]
    per_bucket = cohort[1]
    for r in worlds[world]:
        cache = r[key]["cache"]
        assert cache is not None, "the cache must engage on a mesh"
        want = [64] if key == "data2-partial" else sorted(per_bucket)
        assert cache["buckets"] == want and cache["partial"] == (key == "data2-partial")
        assert cache["wsi_bytes"] == sum(per_bucket[b] for b in want) // (data * seq)


@pytest.mark.parametrize("key", list(REFUSALS))
def test_refusals(worlds, key):
    """A batch that does not split over the data axis, and several ranks
    without a mesh, raise as the JAX Trainer raises (``trainer.py:330-354``),
    on every rank."""
    for r in worlds[2]:
        assert r[key] is not None and r[key].startswith(REFUSALS[key][1]), r[key]


def test_one_rank_refuses_a_mesh_it_cannot_span(cohort):
    """data_axis 2 in a world of one rank: the world size is named."""
    name, sets = _sets("data2-host", cohort, "mesh")
    with pytest.raises(ValueError, match="world size is 1"):
        Trainer(config_from_dict(jobs.cohort_config(cohort[0], name, **sets)), verbose=False,
                device="cpu")


# ---------------------------------------------------------------------- serving


@pytest.mark.parametrize("key", PREDICT)
def test_predictor_on_a_mesh(worlds, cohort, key):
    """``predict_dataset``, ``predict_bags``, ``predict_bag`` (padded to the
    data axis' rows) and ``evaluate`` on every rank against a one-rank
    Predictor over the mesh run's final parameters."""
    res = [r[key] for r in worlds[FITS[key][0]]]
    name, sets = _sets(key, cohort, "one")
    t = Trainer(config_from_dict(jobs.cohort_config(cohort[0], name, **sets)), verbose=False,
                device="cpu")
    t.model.load_state_dict(res[0]["params"], strict=False)
    p = Predictor.from_trainer(t)
    ref = {"dataset": p.predict_dataset()}
    ds = t.val_ds
    bags = [np.asarray(ds.bag(i)) for i in range(min(len(ds), 5))]
    omics = None if t.ge_mode else [
        [ds.table.signature_data[n][i] for n in ds.table.signature_names]
        for i in range(len(bags))]
    ref["bags"] = p.predict_bags(bags, omics)
    ref["bag"] = p.predict_bag(bags[0], None if omics is None else omics[0])
    ref_eval = evaluate(t.config, trainer=t, verbose=False)
    for r in res:
        for part in ("dataset", "bags", "bag"):
            assert set(r[part]) == set(ref[part])
            for col, value in ref[part].items():
                if col == "slide_id":
                    assert (r[part][col] == value).all()
                else:
                    _near(r[part][col], value, f"{part}.{col}")
        for metric, value in ref_eval.items():
            if isinstance(value, float):
                _near(r["evaluate"][metric], value, metric)


# -------------------------------------------------------------------- gradients


def _jax_grads(name, loss_name, data, seq, params):
    """Loss and gradient of one global batch on JAX's mesh of the same shape
    (the batch sharded by ``shard_batch``, the model with ``ring_mesh``)."""
    mesh = jmesh.make_mesh(data=data, seq=seq)
    model = jbuild_model(name, omic_sizes=jobs.SIZES, model_size="small", dropout=0.0,
                         ring_mesh=mesh)
    batch = jobs.survival_batch(GRAD_B, GRAD_M, WSI, 0, n_real=GRAD_B)
    ge = name.lower().startswith("ge")
    if ge:
        batch = {k: batch[k] for k in ("wsi", "mask", "label", "weight")}
        batch["label"] = batch["label"] % 3
    else:
        batch["omics"] = np.split(batch.pop("omics_packed"), np.cumsum(jobs.SIZES)[:-1], axis=1)
    sharded = jmesh.shard_batch(batch, mesh)

    def jloss(p, b):
        if ge:
            y, _ = model.apply({"params": p}, b["wsi"], b["mask"], deterministic=True)
            logp = y - jnp.log(jnp.exp(y).sum(axis=1, keepdims=True))
            per = -jnp.take_along_axis(logp, b["label"][:, None], axis=1)[:, 0]
            return (per * b["weight"]).sum() / jnp.maximum(b["weight"].sum(), 1.0)
        out = model.apply({"params": p}, b["wsi"], b["omics"], b["mask"], deterministic=True,
                          need_attention=False)
        return jloop._survival_loss(loss_name, out, b["label"], b["censorship"], None, 0.75,
                                    b["weight"])[0]

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params, sharded)
    return float(loss), jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("key", list(GRADS))
def test_mesh_gradients_match_one_rank_and_jax(worlds, params, key):
    """One step's loss and every parameter's synchronized gradient (the same
    on every rank) against the one-rank port step and against JAX's
    gradient of the same batch on a mesh of the same shape: data 2 (the
    per-rank fuse-K route), seq 2 (MCAT's stat merge; GE's ring and merged
    pool) and 2x2."""
    world, name, loss, (data, seq) = GRADS[key]
    res = [r[key] for r in worlds[world]]
    ref = jobs.train_steps(name, 1, 1, 1, 0.0, 0, GRAD_B, GRAD_M, loss, 0.0, "small", WSI,
                           params[name])
    floor = 1e-2 * max(float(g.abs().max()) for g in ref["grads"].values())
    jl, jg = _jax_grads(name, loss, data, seq, params[name])
    assert set(jg) == set(ref["grads"])
    for r in res:
        _near(r["loss"][0], ref["loss"][0], "loss")
        assert abs(r["loss"][0] - jl) <= JAX_ATOL
        for pname, g in ref["grads"].items():
            assert torch.equal(r["grads"][pname], res[0]["grads"][pname]), pname
            _near(r["grads"][pname], g, pname, floor)
            np.testing.assert_allclose(r["grads"][pname].numpy(), jg[pname], atol=JAX_ATOL,
                                       rtol=0, err_msg=pname)


# ------------------------------------------------------------ cox on a mesh


@pytest.fixture(scope="module")
def jax_cox(params):
    """Loss and gradient of the cox loss on the first cox batch by the JAX
    step's loss on the global batch (what its mesh step computes: under
    GSPMD the risk sets span the global batch)."""
    model = jbuild_model("NaCAGaT", omic_sizes=jobs.SIZES, model_size="small", dropout=0.0)
    batch = jobs.cox_batch(jobs.TinyCohort(), jobs.COX_ROWS[0])
    batch["omics"] = np.split(batch.pop("omics_packed"), np.cumsum(jobs.SIZES)[:-1], axis=1)

    def jloss(p, b):
        out = model.apply({"params": p}, b["wsi"], b["omics"], b["mask"], deterministic=True,
                          need_attention=False)
        return jloop._survival_loss("cox", out, b["label"], b["censorship"],
                                    b["survival_months"], 0.75, b["weight"])[0]

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params["NaCAGaT"], batch)
    return float(loss), jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def cox_one_rank(params):
    return {cached: jobs.cox_steps("NaCAGaT", 1, 1, cached, params["NaCAGaT"])
            for cached in (False, True)}


@pytest.mark.parametrize("key", list(COX))
def test_cox_on_a_data_axis(worlds, jax_cox, cox_one_rank, key):
    """The cox loss with its risk sets over the global batch: each step's
    loss, the synchronized gradients after step 1, the parameters after
    three SGD steps and the eval step's loss and risks against one rank
    (host-fed and cached alike) and step 1's loss and gradients against
    the JAX step's on the global batch; the parameters bitwise equal
    across ranks. The batches' months tie and interleave across the data
    ranks, and rank 1 holds a zero-weight row."""
    world, _, cached = COX[key]
    res = [r[key] for r in worlds[world]]
    ref = cox_one_rank[cached]
    # the gradients are ~1e-3 of the per-row terms they sum (the partial
    # likelihood is invariant to a shift of every risk): their rounding is
    # the terms', 1e-4 of the model's largest gradient (one rank's own
    # distance from JAX on this batch: 7e-5 of it)
    floor = 10.0 * max(float(g.abs().max()) for g in ref["grads"].values())
    jl, jg = jax_cox
    for r in res:
        _near(r["loss"], ref["loss"], "losses")
        assert abs(r["loss"][0] - jl) <= JAX_ATOL
        _near(r["eval_loss"], ref["eval_loss"], "eval loss")
        _near(r["eval_risk"], ref["eval_risk"], "eval risk")
        for pname, g in ref["grads"].items():
            assert torch.equal(r["grads"][pname], res[0]["grads"][pname]), pname
            _near(r["grads"][pname], g, pname, floor)
            np.testing.assert_allclose(r["grads"][pname].numpy(), jg[pname], atol=JAX_ATOL,
                                       rtol=0, err_msg=pname)
        for pname, p in ref["params"].items():
            assert torch.equal(r["params"][pname], res[0]["params"][pname]), pname
            _near(r["params"][pname], p, pname)


# ------------------------------------------------------------ maps on a mesh


def _jax_maps(name, data, seq, params):
    """JAX's eval-mode maps of the export batch on its mesh of the same
    shape: the co-attention map (``need_attention=True``), GE's 'path'."""
    mesh = jmesh.make_mesh(data=data, seq=seq)
    model = jbuild_model(name, omic_sizes=jobs.SIZES, model_size="small", dropout=0.0,
                         ring_mesh=mesh)
    batch = jobs.export_batch(4, 128, 0, 2)
    if name.lower().startswith("ge"):
        sharded = jmesh.shard_batch({k: batch[k] for k in ("wsi", "mask")}, mesh)
        _, attn = jax.jit(lambda p, b: model.apply({"params": p}, b["wsi"], b["mask"],
                                                   deterministic=True))(params, sharded)
        return np.asarray(attn["path"])
    omics = np.split(batch["omics_packed"], np.cumsum(jobs.SIZES)[:-1], axis=1)
    sharded = jmesh.shard_batch({"wsi": batch["wsi"], "mask": batch["mask"],
                                 "omics": omics}, mesh)
    out = jax.jit(lambda p, b: model.apply({"params": p}, b["wsi"], b["omics"], b["mask"],
                                           deterministic=True, need_attention=True))(
        params, sharded)
    return np.asarray(out.attention["coattn"])


@pytest.mark.parametrize("key", list(EXPORTS))
def test_attention_maps_on_a_mesh(worlds, params, key):
    """The eval step's maps with ``need_attention`` on a mesh, the global
    batch's on every rank: at seq 2 the co-attention's export passes per
    rank on merged statistics (NaCAGaT pre-gated, MCAT without the
    pre-gate) and GE's MIL scores gathered over the seq group; at data 2
    the export passes on each rank's rows. Against one rank and JAX's mesh
    of the same shape; bag 0's valid patches all lie in seq rank 0's half
    (rank 1 holds none of them: its statistics drop out of the merge) and
    bag 1 has none (its row uniform over the global M)."""
    name, (data, seq) = EXPORTS[key]
    res = [r[key] for r in worlds[2]]
    ref = jobs.export_maps(name, 1, 1, params[name])
    jmap = _jax_maps(name, data, seq, params[name])
    ge = name.lower().startswith("ge")
    for r in res:
        assert r["map"].shape == ref["map"].shape == jmap.shape
        _near(r["map"], ref["map"], "map")
        _near(r["y"], ref["y"], "y")
        if ge:  # raw scores: 5e-5 of the largest
            err = float(np.abs(r["map"].numpy() - jmap).max())
            assert err <= JAX_ATOL * float(np.abs(jmap).max()), err
        else:
            np.testing.assert_allclose(r["map"].numpy(), jmap, atol=JAX_ATOL, rtol=0)
            m_len = r["map"].shape[-1]
            np.testing.assert_allclose(r["map"][1].numpy(), 1.0 / m_len, rtol=1e-6)
            assert float(r["map"][0, :, m_len // 2:].abs().max()) == 0.0


# ------------------------------------------------------- Trainer.test on a mesh


@pytest.mark.parametrize("key", list(LOO))
def test_leave_one_out_on_a_mesh(worlds, loo_jax, key):
    """``Trainer.test`` (``training.leave_one_out``, ``cli export-attn``):
    at seq 2, where the JAX Trainer exports, rank 0 writes the map the JAX
    Trainer writes on its seq-2 mesh (and no other rank writes); at data 2
    and 2x2 the port raises the ValueError the JAX Trainer raises (a batch
    of one bag does not split over the data axis)."""
    world, name, _ = LOO[key]
    res = [r[key] for r in worlds[world]]
    ref = loo_jax[key]
    if "raised" in ref:
        assert "divisible by 2" in ref["raised"]
        for r in res:
            assert r["raised"].startswith("ValueError: the leave-one-out export feeds batches "
                                          "of 1 bag, which do not split over "
                                          "tpu.data_axis=2"), r
        return
    assert "map" not in res[1]
    assert len(res[0]["names"]) == 1 and res[0]["names"] == res[1]["names"]
    got = res[0]["names"][0]
    assert got.startswith("ATTN_" + ("" if name.startswith("GE") else f"{name}_") + "P003_")
    assert got.endswith("_E1_0.npy") and ref["name"].endswith("_E1_0.npy")
    assert res[0]["map"].shape == ref["map"].shape
    np.testing.assert_allclose(res[0]["map"], ref["map"], atol=JAX_ATOL, rtol=0)
