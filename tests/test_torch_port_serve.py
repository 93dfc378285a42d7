"""The port's ``Predictor`` entry points (``serve.py``: ``from_config`` with a
checkpoint or an ensemble, ``predict_dataset``, ``predict_to_csv``,
``warmup``, MC dropout) against the JAX package's ``Predictor``, on the CPU.

Setup: the port's synthetic cohort (16 patients, bags of 48/96 patches,
24 genes in three signatures), NaCAGaT ``small`` (ces), bucket 128, batch 8.
The JAX Trainer's weights (seeds 0 and 9) are bridged into the port and
saved as the port's checkpoints, so both packages score the same models.

Tolerances: outputs, ensemble columns and CSV values 5e-5 absolute
(float32 on both sides in other summation orders). MC dropout at rate 0:
its mean within 5e-5 of JAX's eval, its standard deviation exactly 0 (eight
identical forwards); at rate 0.25, bit for bit against training-mode
forwards replayed from a generator in the same state.
"""

import copy

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_path_omic_tpu.config import config_from_dict as jconfig_from_dict  # noqa: E402
from multimodal_path_omic_tpu.serve import Predictor as JPredictor  # noqa: E402
from multimodal_path_omic_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.data.pipeline import (  # noqa: E402
    BucketBatcher,
    survival_extras,
    to_device,
)
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import mc_generator  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

ATOL = 5e-5
KEYS = ("y", "risk", "hazards", "survs")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cohort, both packages' configs, the JAX weights of seeds 0 and 9
    and the port's checkpoints holding them."""
    root = tmp_path_factory.mktemp("serve")
    paths = make_synthetic_cohort(str(root / "cohort"), n_patients=16, bag_lengths=(48, 96),
                                  n_genes=24, n_signatures=3, seed=11, signal_strength=2.0)

    def raw(dropout=0.25):
        r = synthetic_config_dict(*paths)
        r["device"] = "cpu"
        r["model"].update(name="NaCAGaT", model_size="small", dropout=dropout,
                          checkpoint_dir=str(root / "ck"))
        r["training"].update(loss="ces", test_output_dir=str(root / "out"))
        r["tpu"] = {"bag_buckets": [128], "batch_size": 8, "use_pallas": False}
        return r

    jtrainers, params = [], []
    for seed in (0, 9):
        jraw = raw()
        jraw["training"]["seed"] = seed
        jt = JTrainer(jconfig_from_dict(jraw), verbose=False)
        jtrainers.append(jt)
        params.append(jax.tree_util.tree_map(np.asarray, jt.state.params))
    cfg = config_from_dict(raw())
    t = Trainer(cfg, verbose=False)
    ckpts = []
    for tag, p in zip(("a", "b"), params):
        load_jax_params(t.model, p)
        ckpts.append(t.save(0, 0.0, tag=tag))
    return dict(root=root, raw=raw, cfg=cfg, jt=jtrainers[0], params=params, ckpts=ckpts)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def _jax_ensemble(world):
    return JPredictor(world["jt"], param_sets=world["params"])


def test_from_config_one_checkpoint_matches_jax(world):
    pred = Predictor.from_config(world["cfg"], checkpoint=world["ckpts"][0])
    assert pred.n_members == 1 and pred.device.type == "cpu"
    got, ref = pred.predict_dataset(), JPredictor(world["jt"]).predict_dataset()
    assert list(got["slide_id"]) == list(ref["slide_id"])
    assert set(got) == set(ref)
    for k in KEYS:
        _close(got[k], ref[k])
    ds = pred._t.dataset
    _, _, _, omics, bag = ds[3]
    single = pred.predict_bag(bag, omics)
    i = list(got["slide_id"]).index(ds.slide_id(3))
    _close(single["risk"][0], got["risk"][i])


def test_from_trainer_shares_model_and_eval_step(world):
    t = Trainer(world["cfg"], verbose=False)
    pred = Predictor.from_trainer(t)
    assert pred.model is t.model and pred._eval_step is t.eval_step
    assert pred.buckets == t.buckets and pred.batch_size == t.batch_size
    assert pred.n_params == t.n_params and pred.model_name == "NaCAGaT"


def test_ensemble_matches_jax(world):
    ens = Predictor.from_config(world["cfg"], checkpoint=world["ckpts"])
    assert ens.n_members == 2
    got, ref = ens.predict_dataset(), _jax_ensemble(world).predict_dataset()
    assert set(got) == set(ref) and "risk_ens_std" in got
    for k in KEYS + ("risk_ens_std",):
        _close(got[k], ref[k])
    assert float(got["risk_ens_std"].max()) > 1e-4  # the members differ
    members = [Predictor.from_config(world["cfg"], checkpoint=c).predict_dataset()
               for c in world["ckpts"]]
    _close(got["survs"], (members[0]["survs"] + members[1]["survs"]) / 2, 1e-6)


@pytest.mark.parametrize("ensemble", [False, True], ids=["single", "ensemble"])
def test_predict_to_csv_matches_jax(world, ensemble, tmp_path):
    ckpt = world["ckpts"] if ensemble else world["ckpts"][0]
    port_csv = Predictor.from_config(world["cfg"], checkpoint=ckpt).predict_to_csv(
        str(tmp_path / "port.csv"))
    jpred = _jax_ensemble(world) if ensemble else JPredictor(world["jt"])
    jax_csv = jpred.predict_to_csv(str(tmp_path / "jax.csv"))
    got, ref = pd.read_csv(port_csv), pd.read_csv(jax_csv)
    assert list(got.columns) == list(ref.columns)
    assert ("risk_ens_std" in got.columns) == ensemble
    assert list(got["slide_id"]) == list(ref["slide_id"]) and len(got) == 16
    num = [c for c in got.columns if c != "slide_id"]
    _close(got[num].to_numpy(), ref[num].to_numpy())


def test_warmup_returns_each_bucket_and_batch_size(world):
    pred = Predictor.from_config(world["cfg"])
    assert pred.warmup() == [(128, 1), (128, 8)]
    assert pred.warmup(buckets=[64, 128, 64]) == [(64, 1), (64, 8), (128, 1), (128, 8)]


def test_mc_at_dropout_zero_is_the_eval(world):
    """Dropout 0 in both models: the MC mean is JAX's eval, its spread 0."""
    cfg = config_from_dict(world["raw"](dropout=0.0))
    pred = Predictor.from_config(cfg, checkpoint=world["ckpts"][0])
    got = pred.predict_dataset(mc_samples=4, mc_seed=1)
    ref = JPredictor(world["jt"]).predict_dataset()
    assert list(got["slide_id"]) == list(ref["slide_id"])
    _close(got["risk_mean"], ref["risk"])
    _close(got["survs_mean"], ref["survs"])
    _close(got["hazards_mean"], ref["hazards"])
    _close(got["y_mean"], ref["y"])
    for k in ("risk_std", "survs_std", "y_std"):
        assert np.count_nonzero(got[k]) == 0, k


def _replay(pred, batch, gen, n):
    """n training-mode forwards of ``pred``'s model drawing from ``gen``:
    (mean, population std) of the risks."""
    risks = []
    pred.model.train()
    with torch.inference_mode():
        for _ in range(n):
            out = pred.model(batch["wsi"], list(torch.split(batch["omics_packed"],
                                                            list(pred.omic_sizes), dim=1)),
                             batch["mask"], need_attention=False, generator=gen)
            risks.append(-out.survs.sum(dim=1))
    pred.model.eval()
    r = torch.stack(risks)
    return r.mean(dim=0), r.std(dim=0, correction=0)


def test_mc_samples_replay_training_forwards_per_batch(world):
    """Dropout 0.25: batch i of predict_dataset draws from the generator of
    (mc_seed, i), its columns equal bit for bit to training-mode forwards
    replayed from that generator; the batches draw other masks."""
    pred = Predictor.from_config(world["cfg"], checkpoint=world["ckpts"][0])
    cols = pred.predict_dataset(mc_samples=3, mc_seed=7)
    assert (cols["risk_std"] > 0).all()
    again = pred.predict_dataset(mc_samples=3, mc_seed=7)
    assert np.array_equal(cols["risk_std"], again["risk_std"])
    batcher = BucketBatcher(pred._t.dataset, survival_extras, 8, pred.buckets, shuffle=False)
    start = 0
    for bi, host in enumerate(batcher.batches()):
        real = int(host["weight"].sum())
        mean, std = _replay(pred, to_device(host, pred.device, False), mc_generator("cpu", 7, bi),
                            3)
        assert torch.equal(torch.from_numpy(cols["risk_mean"][start:start + real]), mean[:real])
        assert torch.equal(torch.from_numpy(cols["risk_std"][start:start + real]), std[:real])
        start += real
    assert bi >= 1  # at least two batches
    a = torch.rand(4, generator=mc_generator("cpu", 7, 0))
    assert not torch.equal(a, torch.rand(4, generator=mc_generator("cpu", 7, 1)))


def test_predict_bag_mc_and_ensemble_refusal(world):
    pred = Predictor.from_config(world["cfg"], checkpoint=world["ckpts"][0])
    ds = pred._t.dataset
    _, _, _, omics, bag = ds[0]
    plain = pred.predict_bag(bag, omics)
    out = pred.predict_bag(bag, omics, mc_samples=8, mc_seed=3)
    assert np.array_equal(out["risk"], plain["risk"])  # the deterministic columns untouched
    assert out["survs_mean"].shape == (1, 4) and float(out["risk_std"][0]) > 0
    assert np.array_equal(out["risk_std"], pred.predict_bag(bag, omics, 8, 3)["risk_std"])
    assert out["risk_mean"][0] != pred.predict_bag(bag, omics, 8, 4)["risk_mean"][0]
    ens = Predictor.from_config(world["cfg"], checkpoint=world["ckpts"])
    with pytest.raises(ValueError, match="ensemble"):
        ens.predict_bag(bag, omics, mc_samples=2)
    with pytest.raises(ValueError, match="ensemble"):
        ens.predict_dataset(mc_samples=2)


def test_restore_keeps_a_fresh_generator_from_another_device(world, tmp_path):
    """A checkpoint written on the card holds a CUDA generator state, which a
    CPU generator cannot take: the weights load and the generator stays
    seeded (a warning says so)."""
    payload = torch.load(world["ckpts"][0], weights_only=True)
    payload = copy.copy(payload)
    payload["generator"] = torch.zeros(16, dtype=torch.uint8)  # a CUDA Philox state's size
    path = str(tmp_path / "card.pt")
    torch.save(payload, path)
    with pytest.warns(UserWarning, match="another device type"):
        pred = Predictor.from_config(world["cfg"], checkpoint=path)
    ref = Predictor.from_config(world["cfg"], checkpoint=world["ckpts"][0])
    for (name, a), b in zip(pred.model.state_dict().items(), ref.model.state_dict().values()):
        assert torch.equal(a, b), name
