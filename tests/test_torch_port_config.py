"""The port's configuration loader (``config.py``) against the JAX package's:
every shipped example loads to the same dictionary, overrides (the on/off
spellings included) apply alike and fail alike, and the settings the port
cannot honour yet raise ``NotImplementedError`` naming their ROADMAP.md item.
All comparisons are exact.
"""

import glob
import json
import os

import pytest

from multimodal_path_omic_tpu import config as jconfig
from multimodal_path_omic_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml")))
OVERRIDES = {
    "tpu.device_cache": "on",
    "training.keep_best": "yes",
    "training.debug_nans": "off",
    "tpu.remat": "false",
    "training.lr": "1e-3",
    "training.epochs": "3",
    "tpu.batch_size": "16",
    "tpu.bag_buckets": "[4096, 8192]",
    "training.lambda": "0.001",
    "training.scheduler": "cosine",
    "model.gene": "G000",
    "dataset.h5_dataset": "~",
}


def test_examples_are_all_found():
    assert {os.path.basename(p) for p in EXAMPLES} >= {
        "mcat.yaml", "nacagat.yaml", "ge_nacagat.yaml", "full_reference.yaml"}


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_examples_load_to_the_same_dict(path):
    got, ref = tconfig.load_config(path), jconfig.load_config(path)
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(ref)
    tconfig.require_supported(got)  # every shipped example trains on the port


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_overrides_apply_alike(path):
    parsed = {k: tconfig.parse_cli_scalar(v) for k, v in OVERRIDES.items()}
    assert parsed == {k: jconfig.parse_cli_scalar(v) for k, v in OVERRIDES.items()}
    assert parsed["tpu.device_cache"] == "on" and parsed["training.keep_best"] == "yes"
    got, ref = tconfig.load_config(path, parsed), jconfig.load_config(path, parsed)
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(ref)
    assert got.tpu.device_cache == "on" and got.training.keep_best is True
    assert got.training.lambda_ == 0.001 and got.tpu.bag_buckets == [4096, 8192]


@pytest.mark.parametrize("key,value,error", [
    ("training.nope", 1, KeyError),
    ("training.epochs", 2.5, ValueError),
    ("training.keep_best", "maybe", ValueError),
    ("training.loss", "mse", ValueError),
    ("tpu.device_cache", "sometimes", ValueError),
    ("training.train_size", 1.5, ValueError),
    ("model.fusion", "sum", ValueError),
])
def test_bad_overrides_fail_alike_and_roll_back(key, value, error):
    for mod in (tconfig, jconfig):
        cfg = mod.config_from_dict({})
        before = mod.config_to_dict(cfg)
        with pytest.raises(error):
            mod._apply_override(cfg, key, value)
        assert mod.config_to_dict(cfg) == before


def test_unknown_keys_warn_and_defaults_match(capsys):
    raw = {"device": "cpu", "tpu": {"device_cahce": "off"}, "training": {"lambda": 0.5}}
    got, ref = tconfig.config_from_dict(raw), jconfig.config_from_dict(raw)
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(ref)
    assert capsys.readouterr().err.count("device_cahce") == 2
    assert tconfig.config_to_dict(tconfig.Config()) == jconfig.config_to_dict(jconfig.Config())


# queue 1 items whose settings the port honours now
PORTED_ITEMS = ("reduced precision", "the Trainer's rest", "tooling")


@pytest.mark.parametrize("key,value,item", [
    ("tpu.compute_dtype", "bfloat16", "reduced precision"),
    ("tpu.transfer_dtype", "int8", "reduced precision"),
    ("tpu.transfer_dtype", "bfloat16", "reduced precision"),
    ("tpu.cache_dtype", "bfloat16", "reduced precision"),
    ("tpu.data_axis", 2, "multi-GPU"),
    ("tpu.seq_axis", 4, "multi-GPU"),
    ("tpu.remat", True, "tooling"),
    ("tpu.int8_matmul", True, "reduced precision"),
    ("wandb.enabled", True, "the Trainer's rest"),
])
def test_settings_the_port_cannot_honour_raise(key, value, item):
    """The settings of a queue 1 item not yet ported raise, naming it, in
    ``require_supported`` and before the Trainer reads any data; those of
    the items ported since (reduced precision, the Trainer's rest, tooling:
    the dtypes, int8_matmul, wandb.enabled, remat) pass
    ``require_supported``. The mesh
    axes are ported (multi-GPU): an axis above 1 in a world of one rank
    raises ``ValueError`` naming the world size, before any data is read."""
    cfg = tconfig.config_from_dict({"device": "cpu"})
    tconfig.require_supported(cfg)
    tconfig._apply_override(cfg, key, value)
    if item in PORTED_ITEMS:
        tconfig.require_supported(cfg)
        return
    if item == "multi-GPU":  # ported: a mesh the world does not span
        with pytest.raises(ValueError, match="world size is 1"):
            tconfig.require_supported(cfg)
        from multimodal_path_omic_tpu_torch.train.trainer import Trainer

        with pytest.raises(ValueError, match="world size is 1"):
            Trainer(cfg, device="cpu")  # refused before any data is read
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        tconfig.require_supported(cfg)
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    with pytest.raises(NotImplementedError, match=item):
        Trainer(cfg, device="cpu")  # refused before any data is read


def test_auto_and_float32_dtypes_are_supported():
    for value in ("auto", "float32"):
        cfg = tconfig.config_from_dict({"tpu": {"compute_dtype": value, "transfer_dtype": value,
                                                "cache_dtype": value}})
        tconfig.require_supported(cfg)


def test_metric_logger_writes_the_run_log(tmp_path):
    from multimodal_path_omic_tpu_torch.train.logging import MetricLogger

    path = tmp_path / "logs" / "run_log.jsonl"
    logger = MetricLogger(jsonl_path=str(path))
    logger.log({"train_loss": 0.5}, step=0)
    logger.log({"val_loss": 0.25}, step=1)
    logger.finish()
    logger.log({"late": 1.0})  # after finish: dropped, no error
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r.get("train_loss"), r.get("val_loss"), r["step"]) for r in recs] == [
        (0.5, None, 0), (None, 0.25, 1)]
    MetricLogger().finish()
