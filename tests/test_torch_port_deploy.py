"""Deployment bundles (``deploy.py``: ``torch.export`` programs whose
kernels are ``mpo_torch::`` custom ops) on the CPU, against the port's
``Predictor`` and the JAX package's on the same weights.

Each bundle (bucket 64, batch 2) is held against the port's float32
``Predictor`` (batch 4) within 1e-6 (the same routes; the exported graph
decomposes a few operations and the batch differs, so the last bits can
move), and against the JAX
``Predictor`` on the bridged weights (``utils/weights.py``) within 1e-5
(float32 on both sides in other summation orders): NaCAGaT ``ces`` (the
fuse-K eval op) and ``cesar`` (the export passes' op), MCAT and GE-NaCAGaT
(the MIL-pool and flash ops). The rest of ``tests/test_deploy.py``: row
alignment over the (bucket, batch) grid (1e-5, JAX's), the errors,
``max_bag``, the untrained refusal, warm-up, and the bfloat16-weight bundle
at JAX's tolerance (risk 0.02, survs 0.05 relative / 0.02 absolute).

Sizes: 12 synthetic patients, bags of 48/80/120 patches, 1024 wide,
``small`` models, buckets 64/128, batch 4.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.serve import Predictor as JPredictor  # noqa: E402
from multimodal_path_omic_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from multimodal_path_omic_tpu_torch import cli  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.deploy import ExportedModel, export_model  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

DIM = 1024
CASES = {"nacagat-ces": ("NaCAGaT", "ces"), "nacagat-cesar": ("NaCAGaT", "cesar"),
         "mcat": ("MCAT", "ces"), "ge": ("GE-NaCAGaT", "ce")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deploy")
    paths = make_synthetic_cohort(str(tmp / "cohort"), n_patients=12, bag_lengths=(48, 80, 120),
                                  n_genes=36, n_signatures=4, embedding_dim=DIM, seed=0,
                                  signal_strength=2.0)
    return tmp, paths


def _raw(root, name, loss):
    tmp, paths = root
    r = synthetic_config_dict(*paths)
    r["device"] = "cpu"
    r["model"].update(name=name, model_size="small", checkpoint_dir=str(tmp / "ck"))
    if name.startswith("GE"):
        r["model"]["gene"] = "G000"
    r["training"].update(loss=loss, epochs=1, lr=1e-3, test_output_dir=str(tmp / "out"))
    r["tpu"] = {"bag_buckets": [64, 128], "batch_size": 4, "use_pallas": False}
    return r


_BUILT = {}


def _case(root, key):
    """(JAX Trainer, port Trainer on its weights, a bundle of bucket 64 at
    batch 2), built once per case."""
    if key not in _BUILT:
        raw = _raw(root, *CASES[key])
        jt = JTrainer(jconfig_from_dict(raw), verbose=False)
        t = Trainer(config_from_dict(raw), verbose=False)
        load_jax_params(t.model, jax.tree_util.tree_map(np.asarray, jt.state.params))
        bundle = str(root[0] / f"bundle-{key}")
        export_model(t, bundle, buckets=(64,), batch_sizes=(2,), platforms=("cpu",))
        _BUILT[key] = (jt, t, bundle)
    return _BUILT[key]


def _inputs(trainer, lengths, seed=7):
    rng = np.random.default_rng(seed)
    bags = [rng.normal(size=(m, DIM)).astype(np.float32) for m in lengths]
    if trainer.ge_mode:
        return bags, None
    return bags, [[rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
                  for _ in lengths]


@pytest.mark.parametrize("key", list(CASES))
def test_bundle_matches_predictor_and_jax(root, key):
    jt, t, bundle = _case(root, key)
    exported = ExportedModel(bundle, device="cpu")
    man = exported.manifest
    assert man["exported_on"] == "cpu" and man["artifacts"] == {"64:2": "b64_n2.pt2"}
    bags, omics = _inputs(t, [40, 64, 33])  # two chunks of the batch-2 program
    got = exported.predict_bags(bags, omics)
    ours = Predictor.from_trainer(t).predict_bags(bags, omics)
    theirs = JPredictor(jt).predict_bags(bags, omics)
    assert set(got) == set(man["outputs"])
    for k in man["outputs"]:
        np.testing.assert_allclose(got[k], ours[k], atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(theirs[k]), atol=1e-5, rtol=0, err_msg=k)


def test_bundle_calls_its_kernel_ops(root):
    """The exported graphs hold the routes as custom-op nodes: the fuse-K
    eval op for NaCAGaT ces, the export passes' op for cesar, the MIL-pool
    and flash ops for GE."""
    want = {"nacagat-ces": "coattn_fused_k", "nacagat-cesar": "coattention_weights",
            "ge": "milpool"}
    for key, op in want.items():
        _, _, bundle = _case(root, key)
        program = torch.export.load(os.path.join(bundle, "b64_n2.pt2"))
        targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
        assert f"mpo_torch.{op}.default" in targets, (key, sorted(targets))
        if key == "ge":
            assert "mpo_torch.flash_fwd.default" in targets


@pytest.fixture(scope="module")
def grid(root):
    """An MCAT bundle over buckets (64,) with ``max_bag`` 100 (so 64 and
    128) at batch size 2."""
    t = Trainer(config_from_dict(_raw(root, "MCAT", "ces")), verbose=False)
    bundle = str(root[0] / "bundle-grid")
    man = export_model(t, bundle, buckets=(64,), batch_sizes=(2,), platforms=("cpu",),
                       max_bag=100)
    return t, bundle, man


def test_rows_align_max_bag_and_warmup(grid):
    t, bundle, man = grid
    assert man["buckets"] == [64, 128]  # the rounded-up bucket of a 100-patch bag
    exported = ExportedModel(bundle, device="cpu")
    assert sorted(exported.warmup()) == [(64, 2), (128, 2)]
    bags, omics = _inputs(t, [48, 100, 60, 120, 30])  # per bucket a chunk of 2 + 1
    batched = exported.predict_bags(bags, omics)
    assert batched["risk"].shape == (5,)
    for i, (bag, om) in enumerate(zip(bags, omics)):
        single = exported.predict_bag(bag, om)
        for k in ("hazards", "survs", "y", "risk"):
            np.testing.assert_allclose(batched[k][i], single[k], atol=1e-5, err_msg=f"{k}[{i}]")
    ref = Predictor.from_trainer(t).predict_bag(bags[1], omics[1])
    np.testing.assert_allclose(exported.predict_bag(bags[1], omics[1])["risk"], ref["risk"][0],
                               atol=1e-5)


def test_bundle_errors(grid, tmp_path):
    t, bundle, _ = grid
    exported = ExportedModel(bundle, device="cpu")
    bags, omics = _inputs(t, [300])
    with pytest.raises(ValueError, match="re-export with export-model --max-bag"):
        exported.predict_bags(bags, omics)
    with pytest.raises(ValueError, match="one omics list per bag"):
        exported.predict_bags([np.zeros((4, DIM), np.float32)], None)
    with pytest.raises(ValueError, match="weights_dtype"):
        export_model(t, str(tmp_path / "bad"), weights_dtype="int4")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExportedModel(bundle)  # the card by default, as every entry point
    moved = str(tmp_path / "moved")
    os.makedirs(moved)
    man = json.load(open(os.path.join(bundle, "manifest.json")))
    for name in man["artifacts"].values():
        os.link(os.path.join(bundle, name), os.path.join(moved, name))
    man["exported_on"] = "cuda"  # a program from another device is moved on load
    json.dump(man, open(os.path.join(moved, "manifest.json"), "w"))
    np.testing.assert_array_equal(ExportedModel(moved, device="cpu").predict_bag(
        bags[0][:40], omics[0])["risk"], exported.predict_bag(bags[0][:40], omics[0])["risk"])
    man["format_version"] = 99
    json.dump(man, open(os.path.join(moved, "manifest.json"), "w"))
    with pytest.raises(ValueError, match="unsupported bundle format"):
        ExportedModel(moved, device="cpu")


def test_cli_export_model_refuses_untrained(root, tmp_path):
    cfg_path = tmp_path / "config.yaml"
    import yaml

    cfg_path.write_text(yaml.safe_dump(_raw(root, "MCAT", "ces")))
    out = str(tmp_path / "bundle")
    with pytest.raises(SystemExit, match="RANDOM weights"):
        cli.main(["export-model", "--config", str(cfg_path), "--out", out])
    assert not os.path.exists(os.path.join(out, "manifest.json"))


def test_bf16_weight_bundle_halves_bytes_within_tolerance(grid, tmp_path):
    t, b32, _ = grid
    b16 = str(tmp_path / "b16")
    man16 = export_model(t, b16, buckets=(64,), batch_sizes=(2,), platforms=("cpu",),
                         weights_dtype="bfloat16")
    assert man16["weights_dtype"] == "bfloat16"
    s32 = os.path.getsize(os.path.join(b32, "b64_n2.pt2"))
    s16 = os.path.getsize(os.path.join(b16, "b64_n2.pt2"))
    assert s16 < 0.65 * s32, (s16, s32)
    bags, omics = _inputs(t, [40])
    a = ExportedModel(b32, device="cpu").predict_bag(bags[0], omics[0])
    b = ExportedModel(b16, device="cpu").predict_bag(bags[0], omics[0])
    np.testing.assert_allclose(a["risk"], b["risk"], rtol=0.02, atol=0.02)
    np.testing.assert_allclose(a["survs"], b["survs"], rtol=0.05, atol=0.02)
