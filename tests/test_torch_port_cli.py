"""The port's CLI (``cli.py``) on the CPU: each case of ``tests/test_cli.py``
that a ported command covers (train, validate, export-attn with ``--png``,
predict with ``--mc`` and an ensemble, convert-checkpoint, convert-bags,
check-data, evaluate, stratify with ``--png``, the overrides, the serve
passthrough, and the tooling: ``train --profile-dir``, ``profile``, ``plan``,
``cv``, ``sweep``, ``export-model``), driven as a user would (a config YAML
with ``device: cpu`` and dotted overrides). ``evaluate``'s and
``stratify``'s results and ``check_data``'s report are held against the JAX
package's on the same cohort and the same (bridged) weights; without a CUDA
device and without ``device: cpu`` the entry points raise.

Setup as in ``tests/test_cli.py``: 16 patients, bags of 48/96 patches, 24
genes in three signatures, ``small`` MCAT, bucket 128, batch 8, one epoch.
Tolerances against JAX: risks and the metrics computed from them 5e-5
absolute (float32 on both sides in other summation orders); the c-index and
the risk groups exactly (no two risks of this cohort lie within 5e-5).
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.data.check import check_data as jcheck_data  # noqa: E402
from multimodal_path_omic_tpu.train import analysis as janalysis  # noqa: E402
from multimodal_path_omic_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from multimodal_path_omic_tpu_torch import cli  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict, load_config  # noqa: E402
from multimodal_path_omic_tpu_torch.data.check import check_data  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train import analysis  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils import transplant  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

ATOL = 5e-5


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
def world(tmp_path_factory):
    """The cohort, its config (``device: cpu``) and a checkpoint holding the
    JAX Trainer's initial weights, bridged."""
    tmp = tmp_path_factory.mktemp("cli")
    csv, sig, patches = make_synthetic_cohort(
        str(tmp), n_patients=16, bag_lengths=(48, 96), n_genes=24,
        n_signatures=3, seed=11, signal_strength=2.0,
    )
    raw = synthetic_config_dict(csv, sig, patches)
    raw["device"] = "cpu"
    raw["model"]["model_size"] = "small"
    raw["model"]["checkpoint_dir"] = str(tmp / "ckpts")
    raw["training"]["epochs"] = 1
    raw["training"]["test_output_dir"] = str(tmp / "outputs")
    raw["tpu"] = {"bag_buckets": [128], "batch_size": 8, "use_pallas": False}
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    jt = JTrainer(jconfig_from_dict(raw), verbose=False)
    t = Trainer(config_from_dict(raw), verbose=False)
    load_jax_params(t.model, jax.tree_util.tree_map(np.asarray, jt.state.params))
    ckpt = t.save(0, 0.0, tag="bridged")
    return dict(tmp=tmp, raw=raw, config_path=str(path), jt=jt, ckpt=ckpt, csv=csv)


@pytest.fixture(scope="module")
def config_path(world):
    return world["config_path"]


def _last_json(out):
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def test_cli_train(config_path, capsys):
    rc = cli.main(["train", "--config", config_path])
    assert rc == 0
    out = capsys.readouterr().out
    assert "train_loss" in out


@pytest.mark.parametrize("fusion", ["gated_concat", "bilinear"])
def test_cli_train_with_overrides(config_path, fusion, capsys):
    rc = cli.main(["train", "--config", config_path, "--set", "training.lr=0.002",
                   "--set", f"model.fusion={fusion}", "--bug-compat"])
    assert rc == 0
    assert "train_loss" in capsys.readouterr().out


def test_cli_train_profile_is_not_ported(config_path, tmp_path, capsys):
    """(Its name kept from when it pinned the refusal.) ``train
    --profile-dir`` trains and writes a torch.profiler trace there, which
    ``profile --trace-dir`` reads."""
    trace = tmp_path / "trace"
    assert cli.main(["train", "--config", config_path, "--profile-dir", str(trace)]) == 0
    assert "train_loss" in capsys.readouterr().out
    assert [f for f in os.listdir(trace) if f.endswith(".json")]
    assert cli.main(["profile", "--trace-dir", str(trace), "--top", "5"]) == 0
    assert "occupancy" in capsys.readouterr().out


def test_cli_validate(world, capsys):
    rc = cli.main(["validate", "--config", world["config_path"], "--checkpoint", world["ckpt"]])
    assert rc == 0
    assert "val_loss" in capsys.readouterr().out


@pytest.mark.parametrize("png", [False, True], ids=["npy", "png"])
def test_cli_export_attn(config_path, png):
    cfg = yaml.safe_load(open(config_path))
    out_dir = cfg["training"]["test_output_dir"]
    epoch = "4" if png else "3"
    rc = cli.main(["export-attn", "--config", config_path, "--patient", "P000",
                   "--epoch", epoch] + (["--png"] if png else []))
    assert rc == 0
    files = [f for f in os.listdir(out_dir) if f.startswith("ATTN_") and f"_E{epoch}_" in f]
    arrays = [f for f in files if f.endswith(".npy")]
    assert arrays
    attn = np.load(os.path.join(out_dir, arrays[0]))
    assert attn.ndim == 2 and attn.shape[0] == 3
    pngs = [f for f in files if f.endswith(".png")]
    assert bool(pngs) == png
    if png:
        assert os.path.getsize(os.path.join(out_dir, pngs[0])) > 1000


def test_cli_unknown_override_errors(config_path):
    with pytest.raises(KeyError):
        cli.main(["train", "--config", config_path, "--set", "training.bogus=1"])


def test_cli_override_on_off_spellings():
    ov = cli._parse_overrides(
        ["tpu.device_cache=on", "tpu.use_native_pipeline=off", "wandb.enabled=true"]
    )
    assert ov["tpu.device_cache"] == "on"
    assert ov["tpu.use_native_pipeline"] == "off"
    assert ov["wandb.enabled"] is True
    with pytest.raises(SystemExit, match="key=value"):
        cli._parse_overrides(["training.lr"])


def test_override_rejects_non_integral_float_for_int_field(config_path):
    with pytest.raises(ValueError, match="epochs"):
        load_config(config_path, {"training.epochs": 19.9})
    cfg = load_config(config_path, {"tpu.device_cache_budget_bytes": 2.5e9})
    assert cfg.tpu.device_cache_budget_bytes == 2_500_000_000


def _reference_payload(trainer, epoch=None):
    """The trainer's weights as a reference checkpoint (the transplant rules
    run backwards)."""
    state, sizes = trainer.model.state_dict(), trainer.omic_sizes
    sd = {}
    for ref_key, port_key, slot in transplant.transplant_rules(
            trainer.config.model.name, len(sizes), trainer.config.model.fusion):
        v = state[port_key]
        if slot is not None:
            v = v[slot]
            v = v[:sizes[slot]].t() if port_key == "G.fc1_kernel" else (
                v.t() if port_key == "G.fc2_kernel" else v)
        sd[ref_key] = v.clone()
    payload = {"model_state_dict": sd, "optimizer_state_dict": {}, "loss": 0.5}
    if epoch is not None:
        payload["epoch"] = epoch
    return payload


def test_cli_convert_checkpoint_roundtrip(world, tmp_path, capsys):
    """Reference .pt -> the port's checkpoint via the CLI, then restore: the
    weights equal the reference's, and the epoch round-trips (a payload
    without one resumes at epoch 0)."""
    t = Trainer(load_config(world["config_path"]), verbose=False)
    t.restore(world["ckpt"])
    for epoch, want in ((4, 5), (None, 0)):
        pt_path = str(tmp_path / f"ref_{epoch}.pt")
        torch.save(_reference_payload(t, epoch), pt_path)
        rc = cli.main(["convert-checkpoint", "--config", world["config_path"],
                       "--torch-checkpoint", pt_path,
                       "--set", f"model.checkpoint_dir={tmp_path / str(epoch)}"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "Converted checkpoint written to" in out
        restored = Trainer(load_config(world["config_path"]), verbose=False)
        restored.restore(out.strip().rsplit(" ", 1)[-1])
        assert restored.starting_epoch == want
        for (name, a), b in zip(restored.model.state_dict().items(),
                                t.model.state_dict().values()):
            assert torch.equal(a, b), name


def test_cli_predict_writes_csv(world, tmp_path):
    out_csv = str(tmp_path / "preds.csv")
    rc = cli.main(["predict", "--config", world["config_path"], "--checkpoint", world["ckpt"],
                   "--out", out_csv])
    assert rc == 0
    df = pd.read_csv(out_csv)
    assert "slide_id" in df.columns and "risk" in df.columns
    assert len(df) == 16
    assert set(f"hazard_{j}" for j in range(4)) <= set(df.columns)
    ens_csv = str(tmp_path / "ens.csv")
    assert cli.main(["predict", "--config", world["config_path"], "--checkpoint", world["ckpt"],
                     "--checkpoint", world["ckpt"], "--out", ens_csv]) == 0
    ens = pd.read_csv(ens_csv)
    assert (ens["risk_ens_std"] == 0).all()  # two copies of one member
    np.testing.assert_array_equal(ens["risk"], df["risk"])


def test_predictor_single_bag(config_path):
    pred = Predictor.from_config(load_config(config_path))
    _, _, _, omics, bag = pred._t.dataset[0]
    out = pred.predict_bag(bag, omics)
    assert out["hazards"].shape == (1, 4)
    np.testing.assert_allclose(out["y"].sum(), 1.0, rtol=1e-5)


def test_predictor_matches_eval_risks(config_path):
    pred = Predictor.from_config(load_config(config_path))
    cols = pred.predict_dataset(pred._t.val_ds)
    ds = pred._t.val_ds
    _, _, _, omics, bag = ds[0]
    single = pred.predict_bag(bag, omics)
    i = list(cols["slide_id"]).index(ds.slide_id(0))
    np.testing.assert_allclose(single["risk"][0], cols["risk"][i], atol=1e-5)


def test_cli_convert_bags_pt_dir_and_h5(tmp_path):
    h5py = pytest.importorskip("h5py")

    from multimodal_path_omic_tpu_torch.data.bags import NpyBagStore

    rng = np.random.default_rng(0)
    bags = {f"S{i:03d}.svs": rng.normal(size=(8 + i, 16)).astype(np.float32) for i in range(3)}
    pt_dir = tmp_path / "pt"
    pt_dir.mkdir()
    h5_path = tmp_path / "bags.h5"
    with h5py.File(h5_path, "w") as f:
        for sid, arr in bags.items():
            torch.save(torch.from_numpy(arr), pt_dir / (sid + ".pt"))
            f.create_dataset(sid, data=arr)
    out_pt, out_h5 = tmp_path / "npy_from_pt", tmp_path / "npy_from_h5"
    assert cli.main(["convert-bags", "--src", str(pt_dir), "--dst", str(out_pt)]) == 0
    assert cli.main(["convert-bags", "--src", str(h5_path), "--dst", str(out_h5)]) == 0
    for out in (out_pt, out_h5):
        store = NpyBagStore(str(out))
        for sid, arr in bags.items():
            assert store.exists(sid)
            np.testing.assert_array_equal(store.get(sid), arr)
    out_f16 = tmp_path / "npy_f16"
    assert cli.main(["convert-bags", "--src", str(pt_dir), "--dst", str(out_f16),
                     "--dtype", "float16"]) == 0
    store = NpyBagStore(str(out_f16))
    for sid, arr in bags.items():
        got = store.get(sid)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, arr, rtol=2e-3, atol=2e-3)


def test_cli_serve_passthrough_delegates_to_server(monkeypatch):
    from multimodal_path_omic_tpu_torch import server

    seen = {}

    def fake_main(argv):
        seen["argv"] = argv
        return 0

    monkeypatch.setattr(server, "main", fake_main)
    assert cli.main(["serve", "--config", "x.yaml", "--port", "1234"]) == 0
    assert seen["argv"] == ["--config", "x.yaml", "--port", "1234"]


def test_cli_predict_mc_columns(world, tmp_path):
    out_csv = str(tmp_path / "preds_mc.csv")
    rc = cli.main(["predict", "--config", world["config_path"], "--checkpoint", world["ckpt"],
                   "--out", out_csv, "--mc", "4", "--mc-seed", "1"])
    assert rc == 0
    df = pd.read_csv(out_csv)
    assert "risk_mc_std" in df.columns and "risk_mc_mean" in df.columns
    assert "y_0_mc_std" in df.columns
    assert (df["risk_mc_std"] > 0).all()
    assert len(df) == 16


def test_cli_check_data_matches_jax(world, capsys):
    assert cli.main(["check-data", "--config", world["config_path"]]) == 0
    assert "check-data: OK" in capsys.readouterr().out
    got = check_data(load_config(world["config_path"]), verbose=False)
    ref = jcheck_data(jconfig_from_dict(world["raw"]), verbose=False)
    assert got == ref


def test_cli_evaluate_matches_jax(world, capsys):
    """`cli evaluate` on the bridged checkpoint against the JAX package's
    evaluate on the same weights: n, events, c-index and eval times exactly,
    Brier scores, IBS and AUC(t) within 5e-5."""
    rc = cli.main(["evaluate", "--config", world["config_path"], "--checkpoint",
                   world["ckpt"], "--split", "all", "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "c-index" in out and "IBS" in out
    got = _last_json(out)
    ref = janalysis.evaluate(jconfig_from_dict(world["raw"]), split="all", trainer=world["jt"],
                             verbose=False)
    assert set(got) == set(ref)
    for k in ("split", "n", "n_events", "c_index", "eval_times", "bin_edges_exact"):
        assert got[k] == pytest.approx(ref[k], abs=1e-12), k
    for k in ("brier_scores", "integrated_brier_score", "auc", "mean_auc"):
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=0)
    t0 = got["eval_times"][0]
    rc = cli.main(["evaluate", "--config", world["config_path"], "--checkpoint",
                   world["ckpt"], "--split", "all", "--times", f"{t0}", "--json"])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["eval_times"] == [t0]


def test_cli_stratify_matches_jax(world, tmp_path, capsys):
    """`cli stratify` with the CSV and the KM PNG, against the JAX package's
    stratify on the same weights: the same groups and log-rank statistic."""
    out_csv, png = str(tmp_path / "strat.csv"), str(tmp_path / "km.png")
    rc = cli.main(["stratify", "--config", world["config_path"], "--checkpoint",
                   world["ckpt"], "--split", "all", "--out", out_csv, "--png", png, "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "log-rank" in out
    got = _last_json(out)
    ref = janalysis.stratify(jconfig_from_dict(world["raw"]), split="all", trainer=world["jt"],
                             verbose=False)
    assert got["n"] == 16 and got["n_high"] + got["n_low"] == 16
    for k in ("n_high", "n_low", "quantile", "median_months_high", "median_months_low"):
        assert got[k] == ref[k], k
    for k in ("risk_threshold", "chi2", "p_value"):
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=0)
    df = pd.read_csv(out_csv)
    assert set(df["group"]) == {"high", "low"} and len(df) == 16
    assert os.path.getsize(png) > 1000
    with pytest.raises(ValueError):
        analysis.stratify(load_config(world["config_path"]), quantile=1.5)


def test_stratify_label_alignment_across_buckets(tmp_path):
    """predict_dataset emits rows in bucket order: on a two-bucket cohort
    every CSV row's months must be the table's value for its slide."""
    csv, sig, patches = make_synthetic_cohort(
        str(tmp_path), n_patients=12, bag_lengths=(40, 200), n_genes=24,
        n_signatures=3, seed=2,
    )
    raw = synthetic_config_dict(csv, sig, patches)
    raw["device"] = "cpu"
    raw["model"]["model_size"] = "small"
    raw["tpu"] = {"bag_buckets": [64, 256], "batch_size": 4}
    out_csv = str(tmp_path / "strat.csv")
    analysis.stratify(config_from_dict(raw), split="all", out_csv=out_csv, verbose=False)
    df = pd.read_csv(out_csv)
    cohort = pd.read_csv(csv).set_index("slide_id")
    assert len(df) == 12
    for _, row in df.iterrows():
        assert row["survival_months"] == pytest.approx(
            float(cohort.loc[row["slide_id"], "survival_months"])), row["slide_id"]


def test_predict_dataset_mc_keys_independent_per_batch(config_path):
    pred = Predictor.from_config(load_config(config_path))
    cols = pred.predict_dataset(pred._t.dataset, mc_samples=6, mc_seed=1)
    assert len(cols["risk_std"]) == 16
    assert (np.asarray(cols["risk_std"]) > 0).all()
    again = pred.predict_dataset(pred._t.dataset, mc_samples=6, mc_seed=1)
    np.testing.assert_array_equal(cols["risk_std"], again["risk_std"])


def test_stratify_uses_passed_trainer(config_path):
    cfg = load_config(config_path)
    t = Trainer(cfg, verbose=False)
    t.fit()
    trained = analysis.stratify(cfg, split="all", trainer=t, verbose=False)
    fresh = analysis.stratify(cfg, split="all", verbose=False)
    assert trained["risk_threshold"] != fresh["risk_threshold"]


@pytest.mark.parametrize("argv,item", [
    (["cv", "--folds", "2", "--set", "training.epochs=1"], "2-fold val_c_index"),
    (["sweep", "--grid", "training.lr=1e-4,2e-4"], "best val_c_index"),
    (["plan"], "estimated peak"),
    (["export-model", "--out", "bundle", "--allow-untrained"], "Exported 1 programs"),
    (["profile", "--epochs", "1", "--top", "5"], "occupancy"),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_unported_commands_exit_nonzero_naming_their_item(config_path, argv, item, tmp_path,
                                                          capsys):
    """(Its name kept from when these commands were refused.) ``cv``,
    ``sweep``, ``plan``, ``export-model`` and ``profile`` run through
    ``cli.main`` and exit 0, each printing its report."""
    argv = [str(tmp_path / a) if a == "bundle" else a for a in argv]
    if argv[0] == "profile":
        argv += ["--trace-dir", str(tmp_path / "trace")]
    rc = cli.main(argv[:1] + ["--config", config_path] + argv[1:])
    assert rc == 0
    assert item in capsys.readouterr().out


def test_entry_points_raise_without_cuda_unless_the_config_says_cpu(world, tmp_path):
    """No path drops to the CPU: without a CUDA device and without
    ``device: cpu`` the CLI, ``server.main`` and ``Predictor.from_config``
    raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from multimodal_path_omic_tpu_torch import server

    raw = dict(world["raw"], device="tpu")
    path = tmp_path / "card.yaml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_config(config_from_dict(raw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["predict", "--config", str(path), "--out", str(tmp_path / "p.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["validate", "--config", str(path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--config", str(path), "--port", "0"])
    assert cli.main(["predict", "--config", str(path), "--set", "device=cpu",
                     "--out", str(tmp_path / "p.csv")]) == 0
