"""The port's tooling on the CPU against the JAX package's: the memory plan
(``train/plan.py``: the JAX plan's keys; parameter and per-bucket cache
bytes equal), cross-validation (``train/cv.py``: the same patients in each
fold; saved folds load as an ensemble), the grid sweep (``train/sweep.py``:
``parse_grid`` and its errors, the ranking) and the trace report
(``train/profiling.py``: a ``torch.profiler`` trace captured on the CPU;
the busy union equal to a brute-force union). Every comparison here is
exact: byte counts, row indices, rankings and microsecond sums.

Sizes: 12 synthetic patients, ``small`` MCAT, bucket 128, batch 4, one
epoch (``tests/test_deploy.py``'s cohort).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.data.tables import patient_kfold as jpatient_kfold  # noqa: E402
from multimodal_path_omic_tpu.train import plan as jplan  # noqa: E402
from multimodal_path_omic_tpu.train import sweep as jsweep  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.data.tables import patient_kfold  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train import cv, plan, profiling, sweep  # noqa: E402
from multimodal_path_omic_tpu_torch.train.logging import profile_trace  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402


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
def raw(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tooling")
    r = synthetic_config_dict(*make_synthetic_cohort(
        str(tmp), n_patients=12, bag_lengths=(48, 80, 120), n_genes=36, n_signatures=4,
        seed=0, signal_strength=2.0))
    r["device"] = "cpu"
    r["model"].update(name="MCAT", model_size="small", checkpoint_dir=str(tmp / "ckpt"))
    r["training"].update(loss="ces", epochs=1, lr=1e-3, test_output_dir=str(tmp / "out"))
    r["tpu"] = {"bag_buckets": [128], "batch_size": 4, "use_pallas": False,
                "device_cache": "auto"}
    return r


def test_plan_keys_and_bytes_match_jax(raw):
    """Same keys as JAX's ``memory_plan``; parameters and the device cache
    (per bucket, total, resident) in the same bytes. The optimizer state is
    counted (Adam's two moments; optax adds its step counts), not read from
    a compiled program; on the CPU the step peaks are None
    (``cpu_backend_note``)."""
    got = plan.memory_plan(config_from_dict(raw))
    ref = jplan.memory_plan(jconfig_from_dict(raw))
    assert set(got) == set(ref)
    for key in ("params_bytes", "n_bags", "cache_bytes_per_bucket",
                "cache_bytes_total", "cache_resident_bytes", "cache_bytes_per_device",
                "cache_wanted", "cache_engaged", "cache_partial_buckets", "cache_budget_bytes",
                "cache_fits_budget", "n_mesh_devices", "batch_size", "transfer_dtype"):
        assert got[key] == ref[key], key
    assert got["opt_state_bytes"] == 2 * got["params_bytes"]  # Adam's two moments
    assert 0 <= ref["opt_state_bytes"] - got["opt_state_bytes"] <= 64  # optax's step counts
    assert got["cpu_backend_note"] and got["hbm_assumed"] and got["fits"]
    assert [r["bucket"] for r in got["step_programs"]] == [
        r["bucket"] for r in ref["step_programs"]]
    assert all(r["peak"] is None for r in got["step_programs"])
    assert "not measured (no GPU)" in plan.format_plan(got)


def test_cv_folds_are_jax_folds_and_load_as_an_ensemble(raw):
    """``patient_kfold`` gives JAX's folds; ``cross_validate`` trains on them
    (each fold's Trainer holds exactly its rows) and its saved folds load as
    a ``Predictor`` ensemble (JAX ``test_train.py:1696``)."""
    cfg = config_from_dict(raw)
    split_probe = Trainer(cfg, verbose=False, split_rows=None)
    patients = split_probe.dataset.table.patients
    folds = patient_kfold(patients, 2, seed=cfg.training.seed)
    for (a, b), (ja, jb) in zip(folds, jpatient_kfold(patients, 2, seed=cfg.training.seed)):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    split = Trainer(cfg, verbose=False, split_rows=folds[1])
    assert list(split.val_ds.table.slide_ids) == list(
        split_probe.dataset.table.slide_ids[folds[1][1]])
    # one fold of the two trained here (cli cv trains both, test_torch_port_cli.py)
    result = cv.cross_validate(cfg, k=2, verbose=False, save_folds=True, fold_indices=[1])
    assert result["k"] == 2 and [r["fold"] for r in result["folds"]] == [1]
    assert result["mean"] == result["folds"][0]["val_c_index"] and result["std"] == 0.0
    path = result["folds"][0]["checkpoint"]
    assert os.path.exists(path) and "fold1" in path
    ens = Predictor.from_config(cfg, checkpoint=[path, path])
    assert ens.n_members == 2
    bag = np.random.default_rng(0).normal(size=(40, 1024)).astype(np.float32)
    omics = [np.zeros(s, np.float32) for s in ens.omic_sizes]
    assert np.isfinite(ens.predict_bag(bag, omics)["risk_ens_std"]).all()
    with pytest.raises(ValueError, match="out of range"):
        cv.cross_validate(cfg, k=2, fold_indices=[2], verbose=False)
    loo = config_from_dict({**raw, "training": {**raw["training"], "leave_one_out": "P000"}})
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(loo, verbose=False, split_rows=folds[0])


@pytest.mark.parametrize("specs", [
    ["training.lr=1e-4,2e-4", "model.fusion=concat,bilinear"],
    ["tpu.device_cache=on,off", "training.epochs=1"],
    ["model.model_size=small"],
])
def test_parse_grid_matches_jax(specs):
    assert sweep.parse_grid(specs) == jsweep.parse_grid(specs)


def test_parse_grid_errors_match_jax():
    for bad in (["training.lr"], ["noequals"]):
        with pytest.raises(ValueError, match="--grid expects") as ours:
            sweep.parse_grid(bad)
        with pytest.raises(ValueError) as theirs:
            jsweep.parse_grid(bad)
        assert str(ours.value) == str(theirs.value)


def test_sweep_ranks_as_jax(raw, tmp_path, monkeypatch):
    """The ranking (descending, or ascending for a loss), the per-point
    checkpoint namespaces and the unknown-metric error, with each point's
    training replaced by a stub whose metrics depend on the point."""
    path = tmp_path / "config.yaml"
    import yaml

    path.write_text(yaml.safe_dump(raw))
    seen = []

    class Stub:
        def __init__(self, cfg, verbose=False):
            seen.append(cfg.model.checkpoint_dir)
            self.lr = cfg.training.lr

        def fit(self):
            return {"val_c_index": 1.0 - self.lr * 1e3, "val_loss": self.lr * 1e3}

    from multimodal_path_omic_tpu.train import trainer as jtrainer
    from multimodal_path_omic_tpu_torch.train import trainer as ttrainer

    monkeypatch.setattr(ttrainer, "Trainer", Stub)
    monkeypatch.setattr(jtrainer, "Trainer", Stub)
    grid = ["training.lr=0.0003,0.0001,0.0002"]
    for metric in (None, "val_loss"):
        ours = sweep.run_sweep(str(path), grid, metric=metric, verbose=False)
        theirs = jsweep.run_sweep(str(path), grid, metric=metric, verbose=False)
        assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    assert ours["lower_is_better"] and ours["best"]["point"] == {"training.lr": 1e-4}
    assert seen[0].endswith("point0") and seen[2].endswith("point2")
    with pytest.raises(ValueError, match="not in run results"):
        sweep.run_sweep(str(path), grid, metric="val_auc", verbose=False)


def _brute_union(events):
    """Busy microseconds by marking every integer microsecond tick."""
    covered = set()
    for e in events:
        if e.get("dur"):
            start = int(round(e["ts"]))
            covered.update(range(start, start + int(round(e["dur"]))))
    return len(covered)


def test_parse_trace_on_a_cpu_capture(tmp_path):
    """A ``profile_trace`` capture of CPU work: no device track, so the host
    operators are ranked by self time; the busy union of the ranked events
    equals a brute-force union (integer-microsecond events)."""
    x = torch.randn(256, 256)
    with profile_trace(str(tmp_path)):
        for _ in range(3):
            (x @ x).relu().sum()
    summary = profiling.parse_trace(str(tmp_path), steps=3)
    assert summary["fallback_track"]
    names = [r["name"] for r in summary["ops"]]
    assert any("mm" in n for n in names)
    events = [e for e in profiling._load_events(str(tmp_path)) if e.get("cat") == "cpu_op"]
    rounded = [{"ts": round(float(e["ts"])), "dur": round(float(e.get("dur", 0)))}
               for e in events]
    assert profiling._busy_union_us(rounded) == _brute_union(rounded)
    assert summary["busy_union_us"] <= summary["wall_us"]
    assert "occupancy" in profiling.format_report(summary, top=5)


def test_parse_trace_device_track_categories(tmp_path):
    """Device events (torch.profiler's ``kernel`` / ``gpu_memcpy`` categories)
    with the port's kernel names: ranked, categorized, the busy union and
    the idle gaps exact."""
    evs = [("fused_k_kernel<128, 256>", "kernel", 0, 10), ("plain_kernel", "kernel", 5, 10),
           ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 30, 4),
           ("ampere_sgemm_128x64_tn", "kernel", 40, 6), ("flash_fwd_kernel<64>", "kernel", 50, 2),
           ("milpool_kernel", "kernel", 60, 3), ("gather_rows_kernel", "kernel", 70, 1),
           ("void at::native::vectorized_elementwise_kernel<4>", "kernel", 80, 1),
           ("aten::mm", "cpu_op", 0, 100)]
    trace = {"traceEvents": [{"ph": "X", "name": n, "cat": c, "ts": ts, "dur": d, "pid": 1,
                              "tid": 7} for n, c, ts, d in evs]}
    (tmp_path / "trace_0.json").write_text(json.dumps(trace))
    s = profiling.parse_trace(str(tmp_path))
    assert not s["fallback_track"]
    assert s["busy_union_us"] == 15 + 4 + 6 + 2 + 3 + 1 + 1
    assert s["wall_us"] == 81 and s["idle_gaps"] == 6 and s["largest_gap_us"] == 15
    cats = s["categories"]
    assert cats["coattn kernels"] == 20 and cats["copies"] == 4 and cats["matmul"] == 6
    assert cats["flash forward"] == 2 and cats["MIL pool kernel"] == 3
    assert cats["row gather kernel"] == 1 and cats["elementwise"] == 1
    assert "aten::mm" not in [r["name"] for r in s["ops"]]
