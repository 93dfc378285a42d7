"""The port's wandb sink (``train/logging.py::MetricLogger``) and the
Trainer's run config (``Trainer._wandb_config``) against the JAX package's,
with a stub ``wandb`` module standing in (as the JAX package's own test
does, ``tests/test_train.py:881``): the stub records init, log and finish,
and the port's records equal the JAX package's for the same calls and the
same config. wandb itself is imported only when enabled; enabled without
the package installed raises ``ImportError``.

Tolerances: records exact; a fit's logged losses 5e-5 relative, as
``test_torch_port_trainer.py`` holds the two Trainers.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.train.logging import MetricLogger as JMetricLogger  # noqa: E402
from multimodal_path_omic_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.train.logging import MetricLogger  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

LOSS_RTOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's six workers on
    eight cores, each with a thread a core, oversubscribe them (the host-fed
    Trainers here then run several times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _stub(monkeypatch):
    """A stub ``wandb`` module in sys.modules; returns its call record."""
    calls = {"init": [], "log": [], "finish": 0}
    stub = types.ModuleType("wandb")
    stub.Settings = lambda **kw: kw
    stub.run = None  # like real wandb: set by init, cleared by finish

    def _init(**kw):
        calls["init"].append(kw)
        stub.run = object()

    def _finish():
        calls["finish"] += 1
        stub.run = None

    stub.init = _init
    stub.log = lambda metrics, step=None: calls["log"].append((dict(metrics), step))
    stub.finish = _finish
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return calls


def _drive(cls, path):
    logger = cls(wandb_enabled=True, wandb_project="proj",
                 wandb_config={"model": "MCAT", "loss": "ces"}, jsonl_path=path)
    logger.log({"train_loss": 1.0, "train_c_index": 0.7}, step=0)
    logger.log({"val_loss": 0.9}, step=0)
    logger.log({"val_loss": 0.8})
    logger.finish()
    logger.log({"train_loss": 0.5}, step=99)  # after finish: neither wandb nor a crash


def test_sink_calls_equal_the_jax_packages(tmp_path, monkeypatch):
    """init (project, settings, the config), each log with its step, one
    finish, nothing after finish; the JSONL sink beside it; the same
    records as the JAX package's MetricLogger makes for the same calls."""
    records = []
    for cls, name in ((JMetricLogger, "jax"), (MetricLogger, "port")):
        calls = _stub(monkeypatch)
        path = str(tmp_path / f"{name}.jsonl")
        _drive(cls, path)
        recs = [json.loads(line) for line in open(path)]
        records.append((calls, [{k: v for k, v in r.items() if k != "time"} for r in recs]))
    (calls_j, jsonl_j), (calls_p, jsonl_p) = records
    assert calls_p == calls_j
    assert calls_p["init"][0]["project"] == "proj"
    assert calls_p["init"][0]["settings"] == {"init_timeout": 300}
    assert calls_p["finish"] == 1 and len(calls_p["log"]) == 3
    assert jsonl_p == jsonl_j


def test_wandb_is_imported_only_when_enabled(tmp_path, monkeypatch):
    """Disabled, the sink never imports wandb; enabled without the package
    installed, it raises a clear ImportError (no run is silently dropped)."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # any import of it fails
    logger = MetricLogger(jsonl_path=str(tmp_path / "run.jsonl"))
    logger.log({"train_loss": 1.0}, step=0)
    logger.finish()
    with pytest.raises(ImportError, match="wandb.enabled"):
        MetricLogger(wandb_enabled=True, wandb_project="proj")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wandb_cohort")
    return str(root), make_synthetic_cohort(str(root), n_patients=24, bag_lengths=(48, 80, 120),
                                            n_genes=36, n_signatures=4, seed=0,
                                            signal_strength=2.0)


def _raw(files, label):
    root, paths = files
    raw = synthetic_config_dict(*paths)
    raw["device"] = "cpu"
    raw["model"].update(name="MCAT", model_size="small", dropout=0.0,
                        checkpoint_dir=os.path.join(root, f"ck_{label}"))
    raw["training"].update(loss="ces", epochs=2, lr=0.05, optimizer="sgd", weight_decay=0.0,
                           test_output_dir=os.path.join(root, f"o_{label}"))
    raw["tpu"] = {"bag_buckets": [128], "batch_size": 8, "use_pallas": False}
    raw["wandb"] = {"enabled": True, "project": "mpo-test"}
    return raw


def test_trainer_run_config_and_fit_records_equal_the_jax_trainers(files, monkeypatch):
    """With wandb.enabled the port's Trainer hands wandb.init the JAX
    Trainer's flattened run config, logs each epoch's train and validation
    metrics (and the final validation) at the JAX Trainer's steps and keys,
    with its values (the same initial weights), and finishes once."""
    calls_j = _stub(monkeypatch)
    jt = JTrainer(jconfig_from_dict(_raw(files, "jax")), verbose=False)
    params = jax.tree_util.tree_map(np.array, jt.state.params)  # copied: fit donates them
    jt.fit()
    calls_p = _stub(monkeypatch)
    t = Trainer(config_from_dict(_raw(files, "port")), verbose=False)
    load_jax_params(t.model, params)
    t.fit()
    assert calls_p["init"] == calls_j["init"]
    assert calls_p["init"][0]["config"]["model"] == "MCAT"
    assert t._wandb_config() == jt._wandb_config()
    assert calls_p["finish"] == calls_j["finish"] == 1
    assert [(sorted(m), s) for m, s in calls_p["log"]] == \
        [(sorted(m), s) for m, s in calls_j["log"]]
    for (got, _), (ref, _) in zip(calls_p["log"], calls_j["log"]):
        for key, value in ref.items():
            if "loss" in key:
                np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL, err_msg=key)
            elif key == "epoch_seconds":
                assert got[key] > 0
