"""``tpu.remat`` (``ops/remat.py``) and the standalone blocks of
``ops/attention.py`` on the CPU.

Remat recomputes the tagged patch-axis activations in the backward; it is
exact: with dropout 0.25 on, a remat step's parameters and the dropout
generator's state after it are bitwise those of the step without it
(NaCAGaT and GE-NaCAGaT ``small``, 2 bags of 48 128-wide patches: the
lean-V kernel route and the self-attention; MCAT below),
and the tagged tensors are really recomputed (the graph keeps a recipe in
their place). Against the JAX remat
step (``tests/test_train.py:441``: MCAT ``small``, B = 4, M = 32, SGD) with
dropout off the parameters agree within 5e-5 (float32 in other summation
orders, as ``test_torch_port_train.py``'s step tolerance).

``PreGatedAttention`` and ``PreGatingContextualAttentionGate`` (JAX
``attention.py:651-698``) from bridged JAX weights: outputs within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.models import MCAT as JMCAT  # noqa: E402
from multimodal_path_omic_tpu.ops import attention as jattention  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu.train import optim as joptim  # noqa: E402
from multimodal_path_omic_tpu_torch.models import build_model  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import attention as tattention  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import remat  # noqa: E402
from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step  # noqa: E402
from multimodal_path_omic_tpu_torch.train.optim import make_optimizer  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
    seeded_init_,
)

SIZES = [10, 20, 30, 40, 50, 60]
STEP_ATOL = 5e-5
BLOCK_ATOL = 1e-5


def _batch(b, m, seed, ge=False, dim=1024):
    rng = np.random.default_rng(seed)
    batch = {"wsi": rng.normal(size=(b, m, dim)).astype(np.float32),
             "mask": np.arange(m)[None] < rng.integers(m // 2, m + 1, b)[:, None],
             "label": rng.integers(0, 3 if ge else 4, b).astype(np.int64),
             "weight": np.ones(b, np.float32)}
    if not ge:
        batch.update(omics=[rng.normal(size=(b, s)).astype(np.float32) for s in SIZES],
                     censorship=rng.integers(0, 2, b).astype(np.float32),
                     survival_months=rng.uniform(1, 100, b).astype(np.float32))
    return {k: [torch.from_numpy(o) for o in v] if k == "omics" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("name,loss", [("NaCAGaT", "cesar"), ("GE-NaCAGaT", "ce")])
def test_remat_is_bitwise_with_dropout_on(name, loss, monkeypatch):
    ge = name.startswith("GE")
    packed = []
    pack = remat._Scope.pack

    def counting(self, t):
        out = pack(self, t)
        packed.append(isinstance(out, remat._Saved))
        return out

    monkeypatch.setattr(remat._Scope, "pack", counting)
    runs = []
    for on in (False, True):
        model = seeded_init_(build_model(name, omic_sizes=() if ge else SIZES, model_size="small",
                                         dropout=0.25, n_classes=3 if ge else 4, wsi_dim=128), 0)
        spec = make_optimizer("adam", 1e-3)
        state = init_train_state(model, spec, seed=5)
        state, metrics = make_train_step(model, loss, spec, ge_mode=ge, remat=on)(
            state, _batch(2, 48, 1, ge, dim=128))
        runs.append((float(metrics.loss), [p.detach().clone() for p in model.parameters()],
                     state.generator.get_state()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert torch.equal(runs[0][2], runs[1][2])  # the generator ends where it would
    assert sum(packed) >= 1  # h at least: a recipe, not a tensor


def test_remat_step_matches_jax_remat_step():
    """JAX ``test_train.py:441``'s case: MCAT ``small``, B = 4, M = 32, six
    signatures, SGD 1e-2, one step with remat, dropout off."""
    rng = np.random.default_rng(11)
    b, m = 4, 32
    batch = {"wsi": rng.normal(size=(b, m, 1024)).astype(np.float32),
             "mask": np.ones((b, m), bool),
             "omics": [rng.normal(size=(b, s)).astype(np.float32) for s in SIZES],
             "label": rng.integers(0, 4, b).astype(np.int32),
             "censorship": rng.integers(0, 2, b).astype(np.float32),
             "survival_months": rng.uniform(1, 100, b).astype(np.float32),
             "weight": np.ones(b, np.float32)}
    jb = {k: [jnp.asarray(o) for o in v] if k == "omics" else jnp.asarray(v)
          for k, v in batch.items()}
    jmodel = JMCAT(n_signatures=6, model_size="small", dropout_rate=0.0)
    tx = joptim.make_optimizer("sgd", 1e-2)
    params = jmodel.init(jax.random.key(0), jb["wsi"], jb["omics"])["params"]
    jstate = jloop.TrainState(params, tx.init(params), jax.random.key(1),
                              jnp.zeros((), jnp.int32))
    jstate, jm = jloop.make_train_step(jmodel, "ces", tx, remat=True)(jstate, jb)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))

    model = load_jax_params(build_model("MCAT", omic_sizes=SIZES, model_size="small",
                                        dropout=0.0), jax.tree_util.tree_map(np.asarray, params))
    spec = make_optimizer("sgd", 1e-2)
    state = init_train_state(model, spec, seed=0)
    tb = {k: [torch.from_numpy(o) for o in v] if k == "omics" else torch.from_numpy(v)
          for k, v in batch.items()}
    tb["label"] = tb["label"].long()
    state, metrics = make_train_step(model, "ces", spec, remat=True)(state, tb)
    np.testing.assert_allclose(float(metrics.loss), float(jm.loss), atol=STEP_ATOL)
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), atol=STEP_ATOL, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_standalone_blocks_match_jax(masked):
    rng = np.random.default_rng(3)
    x1 = rng.normal(size=(2, 40, 96)).astype(np.float32)
    x2 = rng.normal(size=(2, 6, 64)).astype(np.float32)
    mask = (np.arange(40)[None] < np.array([40, 17])[:, None]) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def perturbed(tree):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), tree)

    pga = jattention.PreGatedAttention(dk=32)
    p = perturbed(pga.init(jax.random.key(0), jnp.asarray(x1), jnp.asarray(x2), jm)["params"])
    ref = pga.apply({"params": p}, jnp.asarray(x1), jnp.asarray(x2), jm)
    got = load_jax_params(tattention.PreGatedAttention(96, 64, dk=32), p)(
        torch.from_numpy(x1), torch.from_numpy(x2), tm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=BLOCK_ATOL)

    pcag = jattention.PreGatingContextualAttentionGate(dk=32, output_dim=16)
    p = perturbed(pcag.init(jax.random.key(1), jnp.asarray(x1), jnp.asarray(x2), jm)["params"])
    ref = pcag.apply({"params": p}, jnp.asarray(x1), jnp.asarray(x2), jm)
    got = load_jax_params(tattention.PreGatingContextualAttentionGate(96, 64, dk=32,
                                                                      output_dim=16), p)(
        torch.from_numpy(x1), torch.from_numpy(x2), tm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=BLOCK_ATOL)
