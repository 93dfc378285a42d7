"""The port's reference-checkpoint rules (``utils/transplant.py``) against
the JAX package's (``multimodal_path_omic_tpu/utils/transplant.py``), and
``Trainer.load_torch_checkpoint``.

A reference-named state dict is built from the JAX package's
``transplant_rules`` with random values, for MCAT, NaCAGaT (each with the
three fusions) and GE-NaCAGaT, ``small`` width, three signature groups of
5, 7 and 9 genes, 64-wide patch features. The port's state after loading it
must equal, exactly, JAX's ``from_torch_state_dict`` passed through the
weight bridge (both start from the same initial weights, which the
``gated_concat`` gates keep: reference state dicts do not hold them).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models.common import build_model as jbuild_model  # noqa: E402
from multimodal_path_omic_tpu.utils import transplant as jtransplant  # noqa: E402
from multimodal_path_omic_tpu_torch.config import config_from_dict  # noqa: E402
from multimodal_path_omic_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_cohort,
    synthetic_config_dict,
)
from multimodal_path_omic_tpu_torch.models import build_model  # noqa: E402
from multimodal_path_omic_tpu_torch.train.trainer import Trainer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils import transplant  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
)

SIZES = (5, 7, 9)
WSI, M = 64, 16
CASES = [("MCAT", f) for f in ("concat", "gated_concat", "bilinear")] + \
    [("NaCAGaT", f) for f in ("concat", "gated_concat", "bilinear")] + [("GE-NaCAGaT", "concat")]


def _key(model):
    return model.lower().replace("-", "_")


def _jax_init(model, fusion):
    jm = jbuild_model(model, omic_sizes=SIZES, model_size="small", fusion=fusion)
    wsi = jnp.zeros((1, M, WSI))
    mask = jnp.ones((1, M), bool)
    if _key(model) == "ge_nacagat":
        args = (wsi, mask)
    else:
        args = (wsi, [jnp.zeros((1, s)) for s in SIZES], mask)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args, deterministic=True))
    rng = np.random.default_rng(1)  # initial weights: any values, the same on both sides
    return jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), shapes["params"])


def _reference_state_dict(model, fusion, params, seed=0):
    """Random values under the reference's names, shaped as the JAX rules
    read them (a transposed rule's leaf reversed; a slot rule's one slot of
    the stacked leaf, the SNN block of its signature's width)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for rule in jtransplant.transplant_rules(_key(model), len(SIZES), fusion):
        torch_key, path, transform = rule[:3]
        leaf = params
        for part in path:
            leaf = leaf[part]
        shape = leaf.shape[1:] if len(rule) > 3 else leaf.shape  # a slot of a stacked leaf
        if transform is jtransplant._t:
            shape = shape[::-1]
        if path[-1] == "fc1_kernel":  # the SNN block of signature i: [d1, s_i]
            shape = (shape[0], SIZES[rule[3]])
        sd[torch_key] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return sd


def _port_model(model, fusion, params):
    port = build_model(model, omic_sizes=SIZES, model_size="small", fusion=fusion, wsi_dim=WSI)
    return load_jax_params(port, params)


def _assert_state_equal(got, ref):
    assert set(got) == set(ref)
    for name, value in got.items():
        assert torch.equal(value, ref[name]), name


@pytest.mark.parametrize("model,fusion", CASES, ids=[f"{m}-{f}" for m, f in CASES])
def test_reference_state_dict_matches_jax_transplant(model, fusion):
    params = _jax_init(model, fusion)
    sd = _reference_state_dict(model, fusion, params)
    init = _port_model(model, fusion, params).state_dict()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        jparams = jtransplant.from_torch_state_dict(
            _key(model), {k: v.numpy() for k, v in sd.items()}, {"params": params},
            n_signatures=len(SIZES), fusion=fusion)
        got = transplant.from_torch_state_dict(model, sd, init, n_signatures=len(SIZES),
                                               fusion=fusion)
    # every key matched: no transplant warning on either side
    assert not [w for w in record if "transplant" in str(w.message)]
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams["params"]))
    _assert_state_equal(got, ref)
    assert not torch.equal(got["classifier.weight"], init["classifier.weight"])  # it moved


def test_module_prefix_missing_and_unused_keys_warn():
    params = _jax_init("NaCAGaT", "concat")
    sd = _reference_state_dict("NaCAGaT", "concat", params)
    init = _port_model("NaCAGaT", "concat", params).state_dict()
    plain = transplant.from_torch_state_dict("NaCAGaT", sd, init, n_signatures=len(SIZES))
    prefixed = {"module." + k: v for k, v in sd.items()}
    _assert_state_equal(
        transplant.from_torch_state_dict("NaCAGaT", prefixed, init, n_signatures=len(SIZES)),
        plain)
    partial = dict(sd)
    del partial["classifier.bias"]
    partial["extra.weight"] = torch.zeros(3)
    with pytest.warns(UserWarning) as record:
        got = transplant.from_torch_state_dict("NaCAGaT", partial, init,
                                               n_signatures=len(SIZES))
    messages = [str(w.message) for w in record]
    assert any("classifier.bias missing" in m for m in messages)
    assert any("unused torch keys" in m and "extra.weight" in m for m in messages)
    assert torch.equal(got["classifier.bias"], init["classifier.bias"])  # kept from init
    assert torch.equal(got["classifier.weight"], plain["classifier.weight"])


def test_shape_mismatch_raises():
    params = _jax_init("MCAT", "concat")
    sd = _reference_state_dict("MCAT", "concat", params)
    sd["classifier.weight"] = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="shape mismatch"):
        transplant.from_torch_state_dict("MCAT", sd, _port_model("MCAT", "concat", params)
                                         .state_dict(), n_signatures=len(SIZES))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("transplant")
    paths = make_synthetic_cohort(str(root / "cohort"), n_patients=10, bag_lengths=(24, 40),
                                  n_genes=21, n_signatures=3, seed=3, embedding_dim=WSI)
    return root, paths


def _trainer(cohort, **training):
    root, paths = cohort
    raw = synthetic_config_dict(*paths)
    raw["device"] = "cpu"
    raw["model"].update(name="NaCAGaT", model_size="small", checkpoint_dir=str(root / "ck"))
    raw["training"].update(test_output_dir=str(root / "out"), **training)
    raw["tpu"] = {"bag_buckets": [64], "batch_size": 4}
    return Trainer(config_from_dict(raw), verbose=False)


class _NotATensor:
    pass


@pytest.mark.parametrize("payload,bug_compat,want", [
    ({"epoch": 4, "loss": 0.5}, False, 5),
    ({"epoch": 4, "loss": torch.tensor(0.5)}, True, 4),
    ({}, False, 0),
    ({}, True, 0),
], ids=["epoch4", "epoch4-bug_compat-tensor_loss", "no-epoch", "no-epoch-bug_compat"])
def test_load_torch_checkpoint_starting_epoch(cohort, tmp_path, payload, bug_compat, want):
    """A reference checkpoint's epoch is the one it finished: training
    resumes at the next (under bug_compat, at that one again); without an
    epoch at 0. The weights land, and the optimizer state and a float or
    0-d tensor loss load under weights_only=True."""
    t = _trainer(cohort, bug_compat=bug_compat)
    ref_sd = {k: v + 1.0 for k, v in _reference_weights(t).items()}
    path = str(tmp_path / "ref.pt")
    opt = torch.optim.Adam(t.model.parameters())
    torch.save({**payload, "model_state_dict": ref_sd, "optimizer_state_dict": opt.state_dict()},
               path)
    t.load_torch_checkpoint(path)
    assert t.starting_epoch == want and t.train_batcher._epoch == want
    assert torch.equal(t.model.classifier.weight, ref_sd["classifier.weight"])


def _reference_weights(trainer):
    """The trainer's weights under the reference's names (the rules run
    backwards)."""
    state = trainer.model.state_dict()
    out = {}
    for ref_key, port_key, slot in transplant.transplant_rules("NaCAGaT", len(trainer.omic_sizes)):
        v = state[port_key]
        if slot is not None:
            v = v[slot]
            if port_key == "G.fc1_kernel":
                v = v[:trainer.omic_sizes[slot]].t()
            elif port_key == "G.fc2_kernel":
                v = v.t()
        out[ref_key] = v.clone()
    return out


def test_refused_payload_and_restore_of_a_reference_checkpoint(cohort, tmp_path):
    t = _trainer(cohort)
    bad = str(tmp_path / "bad.pt")
    torch.save({"model_state_dict": {}, "extra": _NotATensor()}, bad)
    with pytest.raises(ValueError, match="weights_only"):
        t.load_torch_checkpoint(bad)
    ref = str(tmp_path / "ref.pt")
    torch.save({"epoch": 1, "model_state_dict": _reference_weights(t)}, ref)
    with pytest.raises(ValueError, match="load_torch_checkpoint"):
        t.restore(ref)
