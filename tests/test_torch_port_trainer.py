"""The port's ``Trainer`` (``train/trainer.py``) against the JAX package's
``Trainer`` on the same synthetic cohort and the same initial weights (the
JAX Trainer's, carried by the port's weight bridge), on the CPU.

Setup: 24 patients, bags of 48/80/120 patches of 1024 features, 36 genes in
four signatures, bucket 128, batch 8, ``small`` models, SGD (lr 0.05),
dropout 0, patch dropout 0, two epochs; MCAT (ces), NaCAGaT (cesar) and one
GE-NaCAGaT epoch (ce). Both packages split, shuffle and batch alike (held
exactly in ``test_torch_port_data.py``), so each epoch runs the same steps.

Tolerances: per-epoch train and validation loss 5e-5 relative (float32 on
both sides in other summation orders, carried through six SGD updates);
the c-index within 1/(the number of comparable pairs): one pair of
near-tied risks may flip. The port against itself (cached against
host-fed, resumed against uninterrupted) 1e-6 and exact.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.train import trainer as ttrainer  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import drop_patches  # noqa: E402
from multimodal_path_omic_tpu_torch.train.metrics import concordance_index_censored  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

LOSS_RTOL = 5e-5
SELF_ATOL = 1e-6
LR = 0.05


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's six workers on
    eight cores, each with a thread a core, oversubscribe them (the host-fed
    Trainers here then run several times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    paths = make_synthetic_cohort(str(root / "cohort"), n_patients=24, bag_lengths=(48, 80, 120),
                                  n_genes=36, n_signatures=4, seed=0, signal_strength=2.0)
    return SimpleNamespace(root=root, paths=paths)


def _raw(cohort, model="MCAT", loss="ces", epochs=2, **training):
    raw = synthetic_config_dict(*cohort.paths)
    raw["model"].update(name=model, model_size="small", dropout=0.0)
    if model.startswith("GE"):
        raw["model"]["gene"] = "G000"
    raw["training"].update({"loss": loss, "epochs": epochs, "optimizer": "sgd", "lr": LR,
                            **training})
    raw["tpu"] = {"bag_buckets": [128], "batch_size": 8, "use_pallas": False}
    return raw


def _dirs(cfg, cohort, tag):
    cfg.model.checkpoint_dir = str(cohort.root / tag / "checkpoints")
    cfg.training.test_output_dir = str(cohort.root / tag / "outputs")
    return cfg


def _jax(cohort, raw, tag):
    return JTrainer(_dirs(jconfig_from_dict(raw), cohort, "jax-" + tag), verbose=False)


def _port(cohort, raw, tag, params=None, **tpu):
    cfg = config_from_dict(raw)
    for key, value in tpu.items():
        setattr(cfg.tpu, key, value)
    trainer = ttrainer.Trainer(_dirs(cfg, cohort, tag), device="cpu", verbose=False)
    if params is not None:
        load_jax_params(trainer.model, params)
    return trainer


def _epochs(trainer, n):
    out = []
    for e in range(n):
        train, val = trainer.train_epoch(e), trainer.validate(e)
        out.append({**train, **val})
    return out


def _params(jt):
    return jax.tree_util.tree_map(np.asarray, jt.state.params)


@pytest.fixture(scope="module")
def jax_runs(cohort):
    """Each model's JAX Trainer: its initial weights and two epochs."""
    runs = {}
    for model, loss in (("MCAT", "ces"), ("NaCAGaT", "cesar")):
        jt = _jax(cohort, _raw(cohort, model, loss), model)
        params = _params(jt)
        runs[model] = SimpleNamespace(raw=_raw(cohort, model, loss), params=params,
                                      epochs=_epochs(jt, 2))
    return runs


def _comparable_pairs(trainer):
    t = trainer.val_ds.table
    _, con, dis, tied, _ = concordance_index_censored(
        (1 - t.censorship).astype(bool), t.survival_months, trainer.val_risks)
    return con + dis + tied


@pytest.mark.parametrize("model", ["MCAT", "NaCAGaT"])
def test_trainer_matches_jax(cohort, jax_runs, model):
    run = jax_runs[model]
    pt = _port(cohort, run.raw, model, run.params, device_cache="off")
    got = _epochs(pt, 2)
    pairs = _comparable_pairs(pt)
    assert pairs > 0
    for g, r in zip(got, run.epochs):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], r[key], rtol=LOSS_RTOL)
        assert abs(g["val_c_index"] - r["val_c_index"]) <= 1.0 / pairs
        assert abs(g["train_c_index"] - r["train_c_index"]) <= 0.05
        if model == "NaCAGaT":
            np.testing.assert_allclose(g["train_attn_loss"], r["train_attn_loss"],
                                       rtol=LOSS_RTOL)
    assert got[0]["train_loss"] != got[1]["train_loss"]  # the steps moved the weights
    assert len(pt.val_risks) == len(pt.val_ds) and pt.last_epoch_steps == 3


@pytest.mark.parametrize("model", ["MCAT", "NaCAGaT"])
def test_cached_epochs_match_host_fed(cohort, jax_runs, model):
    run = jax_runs[model]
    fed = _port(cohort, run.raw, model + "-fed", run.params, device_cache="off")
    cached = _port(cohort, run.raw, model + "-cached", run.params, device_cache="on")
    a, b = _epochs(fed, 2), _epochs(cached, 2)
    assert fed.device_cache is None and cached.device_cache is not None
    for x, y in zip(a, b):
        for key in ("train_loss", "val_loss", "val_c_index"):
            np.testing.assert_allclose(x[key], y[key], atol=SELF_ATOL, rtol=0)
    np.testing.assert_allclose(fed.val_risks, cached.val_risks, atol=SELF_ATOL, rtol=0)


def test_resume_equals_uninterrupted(cohort):
    """With dropout and patch dropout on (Adam), save after epoch 1, restore
    into a fresh Trainer through ``model.load_from_checkpoint`` and run
    epoch 2: the same losses and risks as an uninterrupted run, exactly
    (the weights, the optimizer state, the dropout generator and the
    shuffle all resume)."""
    raw = _raw(cohort, "NaCAGaT", "cesar", optimizer="adam", lr=2e-4, patch_dropout=0.25)
    raw["model"]["dropout"] = 0.25
    straight = _port(cohort, raw, "straight")
    ref = _epochs(straight, 2)
    first = _port(cohort, raw, "first")
    _epochs(first, 1)
    path = first.save(0, 0.0)
    assert os.path.basename(path).startswith("NaCAGaT_synthetic_E1_") and path.endswith(".pt")
    with pytest.raises(FileExistsError):
        first.save(0, 0.0)
    raw_resume = dict(raw, model=dict(raw["model"], load_from_checkpoint=path))
    resumed = _port(cohort, raw_resume, "resumed")
    assert resumed.starting_epoch == 1 and resumed.state.step == first.state.step
    got = {**resumed.train_epoch(1), **resumed.validate(1)}
    for key in ("train_loss", "train_attn_loss", "val_loss", "val_c_index"):
        assert got[key] == ref[1][key], key
    assert np.array_equal(resumed.val_risks, straight.val_risks)
    assert got["train_loss"] != ref[0]["train_loss"]


def _record_epochs(trainer):
    seen = []
    inner = trainer.validated_epoch

    def wrapped(epoch):
        seen.append(epoch)
        return inner(epoch)

    trainer.validated_epoch = wrapped
    return seen


def test_keep_best_and_early_stopping_stop_where_jax_does(cohort, jax_runs):
    """lr 1e-7 leaves the validation c-index where it starts, so patience 1
    stops both after their second epoch, with the best checkpoint of
    epoch 1."""
    raw = _raw(cohort, epochs=5, lr=1e-7, keep_best=True, early_stopping=1)
    jt = _jax(cohort, raw, "stop")
    pt = _port(cohort, raw, "stop", _params(jt))
    jseen, pseen = _record_epochs(jt), _record_epochs(pt)
    jout, pout = jt.fit(), pt.fit()
    assert pseen == jseen == [0, 1]
    assert pout["best_epoch"] == jout["best_epoch"] == 1.0
    best = os.path.join(pt.config.model.checkpoint_dir, "MCAT_synthetic_best.pt")
    assert os.path.exists(best) and os.path.exists(
        os.path.join(jt.config.model.checkpoint_dir, "MCAT_synthetic_best"))
    np.testing.assert_allclose(pout["val_loss"], jout["val_loss"], rtol=LOSS_RTOL)


def test_patch_dropout_hides_its_share_and_keeps_emptied_bags():
    gen = torch.Generator().manual_seed(0)
    lengths = torch.randint(1, 2049, (64,), generator=gen)
    lengths[:16] = 1  # single-patch bags: a quarter of them lose their patch
    mask = torch.arange(2048)[None] < lengths[:, None]
    dropped = drop_patches(mask, 0.25, gen)
    assert not (dropped & ~mask).any()  # only real patches are hidden
    share = 1.0 - dropped[16:].sum().item() / mask[16:].sum().item()
    assert abs(share - 0.25) <= 0.02
    assert torch.equal(dropped[:16], mask[:16])  # an emptied bag keeps its mask
    assert dropped.any(dim=1).all()
    # the draws come from the generator: the same state draws the same mask
    state = gen.get_state()
    assert torch.equal(drop_patches(mask, 0.25, gen),
                       drop_patches(mask, 0.25, torch.Generator().set_state(state)))


def test_patch_dropout_reaches_the_training_step(cohort, jax_runs):
    run = jax_runs["MCAT"]
    raw = dict(run.raw, training=dict(run.raw["training"], patch_dropout=0.25))
    plain = _port(cohort, run.raw, "pd0", run.params).train_epoch(0)
    hidden = _port(cohort, raw, "pd", run.params).train_epoch(0)
    assert np.isfinite(hidden["train_loss"]) and hidden["train_loss"] != plain["train_loss"]


def test_ge_epoch_matches_jax(cohort):
    raw = _raw(cohort, "GE-NaCAGaT", "ce", epochs=1)
    jt = _jax(cohort, raw, "ge")
    pt = _port(cohort, raw, "ge", _params(jt), device_cache="off")
    ref = {**jt.train_epoch(0), **jt.validate(0)}
    got = {**pt.train_epoch(0), **pt.validate(0)}
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], ref[key], rtol=LOSS_RTOL)
    assert got["val_accuracy"] == ref["val_accuracy"]


def test_leave_one_out_export_matches_jax(cohort, jax_runs):
    raw = _raw(cohort, leave_one_out="P003", output_attn_epoch=1)
    jt = _jax(cohort, raw, "loo")
    pt = _port(cohort, raw, "loo", _params(jt))
    assert len(pt.test_ds) == len(jt.test_ds) == 1
    jt.test(1, save=True)
    pt.test(1, save=True)
    (jname,) = [n for n in os.listdir(jt.config.training.test_output_dir) if n.endswith(".npy")]
    (pname,) = [n for n in os.listdir(pt.config.training.test_output_dir) if n.endswith(".npy")]
    assert pname.startswith("ATTN_MCAT_P003_") and pname.endswith("_E1_0.npy")
    ref = np.load(os.path.join(jt.config.training.test_output_dir, jname))
    got = np.load(os.path.join(pt.config.training.test_output_dir, pname))
    assert got.shape == ref.shape and got.shape[0] == 4  # [signatures, the bag's patches]
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


def test_reference_checkpoint_is_refused(cohort, tmp_path):
    path = str(tmp_path / "reference.pt")
    torch.save({"epoch": 3, "model_state_dict": {}, "optimizer_state_dict": {}, "loss": 0.5},
               path)
    with pytest.raises(ValueError, match="reference PyTorch checkpoint.*load_torch_checkpoint"):
        _port(cohort, _raw(cohort), "ref").restore(path)


def test_main_trains_from_a_config_file(cohort, tmp_path):
    raw = _raw(cohort, epochs=1)
    raw["device"] = "cpu"
    raw["model"]["checkpoint_dir"] = str(tmp_path / "ck")
    raw["training"]["test_output_dir"] = str(tmp_path / "out")
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = ttrainer.main(str(path), {"tpu.device_cache": "on", "training.lr": 0.01,
                                    "training.debug_nans": "on"})
    assert np.isfinite(out["train_loss"]) and np.isfinite(out["val_loss"])
    assert os.path.exists(tmp_path / "out" / "run_log.jsonl")


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(cohort):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = config_from_dict(_raw(cohort))
    for device in ("tpu", "cuda", "gpu"):
        cfg.device = device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.Trainer(cfg, verbose=False)
    cfg.device = "cpu"
    assert ttrainer.Trainer(_dirs(cfg, cohort, "cpu"), verbose=False).device.type == "cpu"


def test_lr_schedules_equal_jax():
    from multimodal_path_omic_tpu.train import optim as joptim
    from multimodal_path_omic_tpu_torch.train import optim as toptim

    for name in (None, "exp", "cosine", "step"):
        for warmup in (0, 2):
            for epoch in range(8):
                kw = dict(gamma=0.8, total_epochs=8, warmup_epochs=warmup, min_lr=1e-5,
                          step_size=3)
                assert toptim.schedule_lr(name, 2e-3, epoch, **kw) == \
                    joptim.schedule_lr(name, 2e-3, epoch, **kw)
    opt = toptim.make_optimizer("adam", 1e-3).init([torch.nn.Parameter(torch.zeros(2))])
    toptim.step_exponential(opt, 0.5)
    assert toptim.current_lr(opt) == 5e-4


@pytest.mark.parametrize("scheduler,warmup", [("exp", 0), ("cosine", 1)])
def test_trainer_steps_the_lr_schedule(cohort, scheduler, warmup):
    from multimodal_path_omic_tpu_torch.train.optim import current_lr, schedule_lr

    raw = _raw(cohort, epochs=3, scheduler=scheduler, warmup_epochs=warmup, gamma=0.5,
               min_lr=1e-4)
    trainer = _port(cohort, raw, "lr-" + scheduler)
    seen = []
    for e in range(3):
        trainer.train_epoch(e)
        seen.append(current_lr(trainer.state.optimizer))
    if scheduler == "exp":  # stepped at each epoch's end
        assert seen == [LR * 0.5, LR * 0.25, LR * 0.125]
    else:  # set at each epoch's start
        assert seen == [schedule_lr("cosine", LR, e, total_epochs=3, warmup_epochs=1,
                                    min_lr=1e-4) for e in range(3)]
