"""The port's multi-step forms (``train/loop.py``: ``make_multi_train_step``,
``make_cached_train_step(multi=True)``, ``make_multi_eval_step``,
``stack_batches``) and the Trainer's grouped epoch (``train/trainer.py``:
``_grouped``, ``steps_per_dispatch``, partial caching, ``validated_epoch``)
on the CPU, against the port's single steps and the JAX package.

Tolerances: the port against itself (K steps against K single steps, a
partially cached epoch against a host-fed one, ``validated_epoch`` against
``train_epoch`` then ``validate``) bit for bit: the same computation in the
same order. The port against the JAX package's multi-step (SGD, dropout 0)
5e-6 on the parameters and 5e-5 on the losses, the bars of
``test_torch_port_cache.py``; the Trainer against the JAX Trainer at
``test_trainer_matches_jax``'s bars (losses 5e-5 relative, the validation
c-index within one comparable pair).
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from multimodal_path_omic_tpu.models import MCAT as JMCAT  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu.train import optim as joptim  # noqa: E402
from multimodal_path_omic_tpu.train import trainer as jtrainer  # noqa: E402
from multimodal_path_omic_tpu_torch.data import device_cache as tcache  # noqa: E402
from multimodal_path_omic_tpu_torch.data import pipeline as tpipeline  # noqa: E402
from multimodal_path_omic_tpu_torch.models import build_model  # noqa: E402
from multimodal_path_omic_tpu_torch.train import loop  # noqa: E402
from multimodal_path_omic_tpu_torch.train import trainer as ttrainer  # noqa: E402
from multimodal_path_omic_tpu_torch.train.optim import load_state, make_optimizer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
    seeded_init_,
)

from test_torch_port_trainer import (  # noqa: E402
    LOSS_RTOL,
    _comparable_pairs,
    _epochs,
    _jax,
    _params,
    _port,
    _raw,
    cohort,  # noqa: F401  (a module fixture, reused)
)

MODEL_ATOL = 5e-5
STEP_ATOL = 5e-6
SIZES = (10, 20, 30)
WSI = 64
BATCH = 4
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module's tests: under the tier-1
    run's six workers on fewer cores, torch's thread teams spin against
    each other (this module took 10x its one-process time there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Cohort:
    """Nine seeded bags of 20..128 patches (buckets 64 and 128) with the
    table columns ``survival_extras`` reads."""

    LENGTHS = (40, 100, 64, 20, 128, 90, 33, 70, 50)

    def __init__(self):
        rng = np.random.default_rng(0)
        n = len(self.LENGTHS)
        self.bags = [rng.normal(size=(m, WSI)).astype(np.float32) for m in self.LENGTHS]
        names = [f"sig{j}" for j in range(len(SIZES))]
        self.table = SimpleNamespace(
            survival_months=rng.uniform(1, 100, n).astype(np.float32),
            survival_class=rng.integers(0, 4, n).astype(np.int32),
            censorship=rng.integers(0, 2, n).astype(np.float32),
            signature_names=names,
            signature_data={k: rng.normal(size=(n, s)).astype(np.float32)
                            for k, s in zip(names, SIZES)},
        )

    def __len__(self):
        return len(self.bags)

    def bag(self, i):
        return self.bags[i]


# K batches of the 128 bucket's rows (the last short) and their host form
ROWS = ([1, 4, 5, 7], [4, 1, 7, 5], [5, 7, 1])


@pytest.fixture(scope="module")
def world():
    ds = Cohort()
    cache = tcache.DeviceBagCache(ds, tpipeline.survival_extras, (64, 128), device="cpu")
    metas = [tcache.build_meta(rows, BATCH, cache)[0] for rows in ROWS]
    batcher = tpipeline.BucketBatcher(ds, tpipeline.survival_extras, BATCH, (64, 128))
    host = [batcher._make_batch(rows, 128) for rows in ROWS]
    rng = np.random.default_rng(1)
    jmodel = JMCAT(n_signatures=len(SIZES), model_size="small", dropout_rate=0.0)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, 64, WSI)), [jnp.zeros((1, s)) for s in SIZES],
        jnp.ones((1, 64), bool), deterministic=True,
    ))(jax.random.key(0))["params"]
    jparams = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    return SimpleNamespace(ds=ds, cache=cache, metas=metas, host=host, jparams=jparams)


def _model(world, rate=0.25, name="MCAT"):
    model = build_model(name, omic_sizes=SIZES, model_size="small", dropout=rate, wsi_dim=WSI)
    if name == "MCAT":
        return load_jax_params(model, world.jparams)
    return seeded_init_(model, 0)


def _state_dict(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_same_tree(a, b):
    for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cached", [False, True], ids=["host-fed", "cached"])
def test_multi_train_step_equals_single_steps(world, cached):
    """K = 3 steps in one multi-step call (dropout 0.25 and patch dropout:
    one generator chain) against three single steps: every metric, every
    parameter and the generator's state, bit for bit."""
    runs = []
    for multi in (False, True):
        model = _model(world)
        spec = make_optimizer("adam", 1e-3, 1e-5)
        state = loop.init_train_state(model, spec, seed=3)
        kw = dict(omic_sizes=SIZES, patch_dropout=0.1)
        if cached:
            step = loop.make_cached_train_step(model, "ces", spec, multi=multi, **kw)
            cache = world.cache.caches[128]
            if multi:
                stacked = {k: np.stack([m[k] for m in world.metas]) for k in world.metas[0]}
                state, metrics = step(state, cache, stacked)
            else:
                out = []
                for meta in world.metas:
                    state, m = step(state, cache, meta)
                    out.append(m)
                metrics = loop.stack_results(out)
        else:
            if multi:
                step = loop.make_multi_train_step(model, "ces", spec, **kw)
                stacked = tpipeline.to_device(loop.stack_batches(world.host), "cpu", False)
                state, metrics = step(state, stacked)
            else:
                step = loop.make_train_step(model, "ces", spec, **kw)
                out = []
                for b in world.host:
                    state, m = step(state, tpipeline.to_device(b, "cpu", False))
                    out.append(m)
                metrics = loop.stack_results(out)
        assert state.step == K and metrics.loss.shape == (K,)
        assert metrics.risk.shape == (K, BATCH)
        runs.append((metrics, _state_dict(model), state.generator.get_state()))
    (m0, p0, g0), (m1, p1, g1) = runs
    _assert_same_tree(m0, m1)
    for name, v in p0.items():
        assert torch.equal(v, p1[name]), name
    assert torch.equal(g0, g1)


def test_multi_train_step_matches_jax(world):
    """K = 3 SGD steps (ces, dropout 0) through one multi-step call of each
    package on the same weights: the losses and the final parameters."""
    model_j = JMCAT(n_signatures=len(SIZES), model_size="small", dropout_rate=0.0)
    tx = joptim.make_optimizer("sgd", 0.05)
    step_j = jloop.make_multi_train_step(model_j, "ces", tx, omic_sizes=SIZES)
    params = jax.tree_util.tree_map(jnp.asarray, world.jparams)
    state_j = jloop.TrainState(params, tx.init(params), jax.random.key(1),
                               jnp.zeros((), jnp.int32))
    stacked = loop.stack_batches(world.host)
    jbatch = {k: ([jnp.asarray(o) for o in v] if k == "omics" else jnp.asarray(v))
              for k, v in stacked.items() if k != "index"}
    state_j, metrics_j = step_j(state_j, jbatch)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, state_j.params))

    model = _model(world, rate=0.0)
    spec = make_optimizer("sgd", 0.05)
    step = loop.make_multi_train_step(model, "ces", spec, omic_sizes=SIZES)
    _, metrics = step(loop.init_train_state(model, spec, seed=1),
                      tpipeline.to_device(stacked, "cpu", False))
    np.testing.assert_allclose(metrics.loss.numpy(), np.asarray(metrics_j.loss),
                               atol=MODEL_ATOL, rtol=0)
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), atol=STEP_ATOL, rtol=0)


@pytest.mark.parametrize("cached", [False, True], ids=["host-fed", "cached"])
def test_multi_eval_step_equals_eval_steps(world, cached):
    """``make_multi_eval_step`` over K stacked batches (cesar: the map and
    its loss) against K eval steps: every result leaf bit for bit."""
    model = _model(world, name="NaCAGaT")
    kw = dict(omic_sizes=SIZES, l1_lambda=1e-4, cached=cached)
    single = loop.make_eval_step(model, "cesar", **kw)
    multi = loop.make_multi_eval_step(model, "cesar", **kw)
    if cached:
        cache = world.cache.caches[128]
        stacked = {k: np.stack([m[k] for m in world.metas]) for k in world.metas[0]}
        got = multi(cache, stacked)
        ref = loop.stack_results([single(cache, m) for m in world.metas])
    else:
        got = multi(tpipeline.to_device(loop.stack_batches(world.host), "cpu", False))
        ref = loop.stack_results([single(tpipeline.to_device(b, "cpu", False))
                                  for b in world.host])
    assert got["loss"].shape == (K,) and got["attention"]["coattn"].shape[0] == K
    _assert_same_tree(got, ref)


def test_stack_batches_equals_jax(world):
    got, ref = loop.stack_batches(world.host), jloop.stack_batches(world.host)
    assert set(got) == set(ref)
    for key, value in ref.items():
        for a, r in zip(got[key] if key == "omics" else [got[key]],
                        value if key == "omics" else [value]):
            assert a.dtype == r.dtype and np.array_equal(a, r), key


@pytest.mark.parametrize("seed", range(4))
def test_grouped_equals_jax(seed):
    """The (k, 8, 1) ladder over seeded streams of bucketed items, with a
    per-bucket k cap: the same groups as the JAX Trainer's ``_grouped``."""
    rng = random.Random(seed)
    items = [(rng.choice((64, 128, 256)), i) for i in range(rng.randint(0, 120))]
    items.sort(key=lambda it: (rng.random() < 0.7, it[0]))  # runs of one bucket
    for K in (1, 2, 5, 16, 64):
        cap = {64: K, 128: 3, 256: 1}
        for k_fn in (None, lambda it: min(K, cap[it[0]])):
            got = list(ttrainer._grouped(iter(items), key_fn=lambda it: it[0], K=K, k_fn=k_fn))
            assert got == list(jtrainer._grouped(iter(items), key_fn=lambda it: it[0], K=K,
                                                 k_fn=k_fn))
            assert [it for g in got for it in g] == items


class _HostReads(TorchDispatchMode):
    """Records the ops that, on a CUDA tensor, read a value on the host (a
    CUDA graph cannot capture them)."""

    SYNCING = ("_local_scalar_dense", "nonzero", "masked_select", "is_nonzero", "equal",
               "_unique", "item")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(name in str(func) for name in self.SYNCING):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,loss", [("NaCAGaT", "cesar"), ("MCAT", "nll"),
                                       ("NaCAGaT", "cox"), ("GE-NaCAGaT", "ce")])
def test_steps_read_nothing_on_the_host(world, name, loss):
    """A train step (SGD, dropout and patch dropout on, L1 on) and an eval
    step run no op that reads a device value on the host, so a CUDA graph
    can capture them. (torch's own cumprod backward reads one, but not
    under a dispatch mode, which sends it down its other branch: its
    replacement is held by ``test_cumprod_backward_reads_nothing_on_the_host``.)"""
    ge = name.startswith("GE")
    model = seeded_init_(build_model(name, omic_sizes=() if ge else SIZES, model_size="small",
                                     dropout=0.25, wsi_dim=WSI, n_classes=3 if ge else None), 0)
    spec = make_optimizer("sgd", 0.01)
    kw = dict(ge_mode=ge, omic_sizes=None if ge else SIZES, l1_lambda=1e-4)
    step = loop.make_train_step(model, loss, spec, patch_dropout=0.1, **kw)
    evaluate = loop.make_eval_step(model, loss, **kw)
    batch = tpipeline.to_device(world.host[2], "cpu", ge)
    if ge:
        batch["label"] = batch["label"] % 3
    state = loop.init_train_state(model, spec, seed=0)
    state, _ = step(state, batch)  # the first step makes the gradients
    with _HostReads() as reads:
        step(state, batch)
        evaluate(batch)
    assert reads.seen == []


def test_cumprod_backward_reads_nothing_on_the_host():
    """``CumProd`` (the survival head's cumprod): torch's cumprod forward,
    a backward equal to torch's within float64 rounding on inputs with and
    without zeros (gradcheck), and no host read in the backward (torch's
    asks the host whether the input holds a zero)."""
    from multimodal_path_omic_tpu_torch.models.common import CumProd

    g = torch.Generator().manual_seed(0)
    x = torch.rand(6, 4, dtype=torch.float64, generator=g)
    zeros = x.clone()
    zeros[1, 2] = zeros[3, 0] = zeros[3, 3] = zeros[4, 1] = 0.0
    dout = torch.randn(6, 4, dtype=torch.float64, generator=g)
    for inp in (x, zeros):
        a = inp.clone().requires_grad_()
        b = inp.clone().requires_grad_()
        assert torch.equal(CumProd.apply(a), torch.cumprod(b, -1))
        got = torch.autograd.grad(CumProd.apply(a), a, dout)[0]
        ref = torch.autograd.grad(torch.cumprod(b, -1), b, dout)[0]
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-14)
        assert torch.autograd.gradcheck(CumProd.apply, (a,))
    with _HostReads() as reads:
        CumProd.backward(SimpleNamespace(saved_tensors=(zeros,)), dout)
    assert reads.seen == []


def test_card_optimizer_state_loads_on_the_cpu():
    """A state saved by the card's form (tensor lr, ``capturable``) loads
    into a CPU optimizer with a float lr and its step count on the host, and
    the other way round; the lr's value is the saved one."""
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = make_optimizer("adam", 1e-3).init(params)
    params[0].grad = torch.ones(3)
    opt.step()
    card = opt.state_dict()
    card["param_groups"][0].update(lr=torch.tensor(5e-4), capturable=True)
    fresh = make_optimizer("adam", 1e-3).init(params)
    load_state(fresh, card)
    group = fresh.param_groups[0]
    assert isinstance(group["lr"], float) and group["lr"] == pytest.approx(5e-4)
    assert group["capturable"] is False
    assert fresh.state[params[0]]["step"].device.type == "cpu"
    fresh.step()
    assert float(fresh.state[params[0]]["step"]) == 2.0


# ------------------------------------------------------------ the Trainer


@pytest.fixture(scope="module")
def jax_mcat(cohort):  # noqa: F811
    """The JAX Trainer's MCAT run of test_torch_port_trainer.py: its
    initial weights and two epochs."""
    raw = _raw(cohort, "MCAT", "ces")
    jt = _jax(cohort, raw, "MCAT-spd")
    return SimpleNamespace(raw=raw, params=_params(jt), epochs=_epochs(jt, 2))


@pytest.mark.parametrize("spd", [1, 2, 0], ids=["spd-1", "spd-2", "spd-auto"])
def test_trainer_matches_jax_at_steps_per_dispatch(cohort, jax_mcat, spd):  # noqa: F811
    """The port Trainer with ``steps_per_dispatch`` 1, 2 and auto (two
    epochs, three steps each: groups of 1, of 2 + 1, of 3) against the JAX
    Trainer (auto), at ``test_trainer_matches_jax``'s bars."""
    pt = _port(cohort, jax_mcat.raw, f"spd{spd}", jax_mcat.params, device_cache="off",
               steps_per_dispatch=spd)
    assert pt.steps_per_dispatch == (spd or ttrainer._SPD_AUTO)
    got = _epochs(pt, 2)
    pairs = _comparable_pairs(pt)
    assert pairs > 0 and pt.last_epoch_steps == 3
    for g, r in zip(got, jax_mcat.epochs):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], r[key], rtol=LOSS_RTOL)
        assert abs(g["val_c_index"] - r["val_c_index"]) <= 1.0 / pairs


def _two_bucket_raw(cohort):  # noqa: F811
    raw = _raw(cohort, "NaCAGaT", "cesar", optimizer="adam", lr=2e-4, patch_dropout=0.1)
    raw["model"]["dropout"] = 0.25
    raw["tpu"]["bag_buckets"] = [64, 128]
    raw["tpu"]["steps_per_dispatch"] = 2
    return raw


def test_partially_cached_epochs_equal_host_fed(cohort):  # noqa: F811
    """Buckets 64 and 128 and a budget that fits the 64 bucket only: the
    64 bucket's batches gather on the device, the 128 bucket's are
    host-fed; two epochs (dropout on, K = 2) equal a host-fed run bit for
    bit."""
    raw = _two_bucket_raw(cohort)
    fed = _port(cohort, raw, "partial-fed", device_cache="off")
    lengths = np.concatenate([fed.train_batcher._bag_lengths(), fed.val_batcher._bag_lengths()])
    per = tcache.DeviceBagCache.bucket_bytes(lengths, (64, 128), fed.wsi_dim)
    part = _port(cohort, raw, "partial", device_cache="auto",
                 device_cache_budget_bytes=per[64] + 1)
    a, b = _epochs(fed, 2), _epochs(part, 2)
    assert part._cache_partial and part.device_cache.cached_buckets == [64]
    assert fed.device_cache is None
    for x, y in zip(a, b):
        for key in ("train_loss", "train_attn_loss", "val_loss", "val_c_index"):
            assert x[key] == y[key], key
    assert np.array_equal(fed.val_risks, part.val_risks)


@pytest.mark.parametrize("cache", ["off", "on"])
def test_validated_epoch_equals_train_epoch_then_validate(cohort, cache):  # noqa: F811
    """``validated_epoch`` (one chain, one fetch) against ``train_epoch``
    then ``validate`` on a twin Trainer: two epochs' metrics and validation
    risks bit for bit; a Trainer whose ``validate`` was replaced runs the
    two calls."""
    raw = _two_bucket_raw(cohort)
    serial = _port(cohort, raw, f"serial-{cache}", device_cache=cache)
    chained = _port(cohort, raw, f"chained-{cache}", device_cache=cache)
    for e in range(2):
        train, val = chained.validated_epoch(e)
        ref = {**serial.train_epoch(e), **serial.validate(e)}
        for key, value in {**train, **val}.items():
            if key != "epoch_seconds":
                assert value == ref[key], key
        assert np.array_equal(chained.val_risks, serial.val_risks)
    seen = []
    inner = chained.validate
    chained.validate = lambda e: seen.append(e) or inner(e)
    chained.validated_epoch(2)
    assert seen == [2]
