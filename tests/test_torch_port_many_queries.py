"""The plain-K co-attention past eight queries against the JAX package on the
CPU. The JAX kernels take up to 256 queries (``kernel_eligible``: a grid
step keeps the whole query block); the port's CUDA kernels take the same
range, past eight the forward with values and its backward in query tiles
of 16..64 queries a block, the export passes in slabs of eight. On the CPU
the wrappers run the plain versions, which the card's slab instances are held to in
``chip_smoke.py`` phase 31; these tests hold those plain versions to the
Pallas kernels in interpret mode at N in {9, 40} signature groups (B = 2,
D = 128, M <= 1024, the masks of ``test_torch_port_coattn_plain.py``), and
the forward and the VJP at the edges of the card's query tiles (16, 32 and
64 queries a block: N = 15..17, 31..33, 63..65) over a short M = 77 that no
key sub-step (8, 16, 32) divides:

* ``_coattn_fwd_impl`` with values (o, l, m, ssq, sumw), with and without the
  pre-gate;
* the ``coattention`` VJP (dq, dk, dv under cotangents on o, ssq and sumw),
  through autograd and ``PlainKAttention`` as the models take it;
* ``coattention_weights`` (export passes 1 and 2);
* one bfloat16 case at N = 40 (the bfloat16 plain versions, forward and VJP,
  against the Pallas kernels on bfloat16 tiles);

and MCAT and NaCAGaT ``small`` at 40 signature groups, built from the same
weights as the JAX models, whose co-attention then takes the plain-K route
(more than 32 groups leave the lean routes, as in JAX): eval hazards, survs
and y, the ``cesar`` map, and one training forward's loss and every
parameter's gradient.

Tolerances, the sibling files': 2e-5 absolute on o, m, ssq and sumw, l with
an added 1e-5 relative; gradients 5e-5 of each gradient's largest magnitude;
w 2e-5 absolute and 1e-4 relative above a 1e-8 floor (a row sums to 1 over
up to 1000 keys); bfloat16 as ``test_torch_port_plain_values_bf16.py``
(o one bfloat16 unit of its largest magnitude, statistics 1e-5 of theirs,
gradients 3e-2); the models 5e-5 absolute (``test_torch_port_mcat.py``).
The pre-gate alternates with the mask in the VJP and weights cases, so each
N meets both forms.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_bf16 as bf16  # noqa: E402
from multimodal_path_omic_tpu.models import MCAT as JMCAT  # noqa: E402
from multimodal_path_omic_tpu.models import NaCAGaT as JNaCAGaT  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu_torch.models import MCAT, NaCAGaT  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import losses as tlosses  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
)

from test_torch_port_coattn_fwd import _mask  # noqa: E402
from test_torch_port_coattn_plain import MASKS  # noqa: E402

ATOL = 2e-5
L_RTOL = 1e-5
GRAD_RTOL = 5e-5
W_RTOL, W_ATOL = 1e-4, 1e-8
BF16_O_RTOL, BF16_STAT_RTOL, BF16_GRAD_RTOL = 2.0 ** -7, 1e-5, 3e-2
MODEL_ATOL = 5e-5
B, D = 2, 128
N_VALUES = (9, 40)
MASK_CASES = [pytest.param(*p.values[:2], id=p.id) for p in MASKS]
# (N, M, mask, pre-gate): every mask at both N, the gate alternating
TURNING = [pytest.param(n, *p.values[:2], (i + j) % 2 == 1, id=f"n{n}-{p.id}")
           for j, n in enumerate(N_VALUES) for i, p in enumerate(MASKS)]
# the query tiles' edges (csrc/plain_k_tiles.cuh FWD_QT, DQ_QT), M = 77: the
# masks cycle (keys 64..76 of bag 0 masked; bag 1 without a valid key; every
# key valid), the pre-gate alternates
EDGE_M = 77
EDGES = [pytest.param(n, EDGE_M, ("holes", "no-valid-key", "ragged-m")[i % 3], i % 2 == 1,
                      id=f"edge-n{n}-m{EDGE_M}")
         for i, n in enumerate((15, 16, 17, 31, 32, 33, 63, 64, 65))]
FORWARD_CASES = [pytest.param(n, *p.values[:2], pg, id=f"{n}-{p.id}-{gid}")
                 for n in N_VALUES for p in MASKS
                 for pg, gid in ((False, "plain"), (True, "pre-gate"))] + EDGES
GROUPS = tuple(4 + j % 5 for j in range(40))  # 40 signature groups
WSI = 64


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs (the suite's six workers on
    eight cores)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _data(n, m_len, seed):
    rng = np.random.default_rng(seed)
    q = (0.7 * rng.normal(size=(B, n, D))).astype(np.float32)
    k = (0.7 * rng.normal(size=(B, m_len, D))).astype(np.float32)
    v = rng.normal(size=(B, m_len, D)).astype(np.float32)
    cot = (rng.normal(size=(B, n, D)).astype(np.float32),
           rng.normal(size=(B, n)).astype(np.float32), rng.normal(size=(B, n)).astype(np.float32))
    return (q, k, v), cot


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close_rel(got, ref, rtol, name):
    got, ref = bf16._f32(got), bf16._f32(ref)
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_the_kernels_take_the_jax_range():
    """The port's predicate admits what JAX's ``kernel_eligible`` admits on
    the query axis, 1..256, and the forms' checks agree with it."""
    assert tcoattn.MAX_PLAIN_QUERIES == 256
    for n in (1, 8, 9, 40, 50, 256):
        assert tcoattn.plain_k_supports(n, D, 100, values=True)
        assert tcoattn.plain_k_supports(n, D, 100, values=False, dtype=torch.bfloat16)
    assert not tcoattn.plain_k_supports(257, D, 100, values=True)
    assert tcoattn._slabs(8) == 1 and tcoattn._slabs(9) == 2 and tcoattn._slabs(256) == 32


def _cuda_rows(name):
    """{(D, bfloat16): queries a block} from the rows {D, float32, bfloat16}
    of the table ``name`` in csrc/plain_k_tiles.cuh."""
    src = (Path(tcoattn.__file__).parents[1] / "csrc" / "plain_k_tiles.cuh").read_text()
    body = re.search(rf"constexpr int {name}\[3\]\[3\] = \{{(.*?)\}};", src).group(1)
    rows = [tuple(int(x) for x in r.split(",")) for r in re.findall(r"\{([^{}]*)\}", body)]
    return {(d, bf): row[2 if bf else 1] for row in rows for d in (row[0],) for bf in (False, True)}


@pytest.mark.parametrize("pre_gate", [False, True], ids=["plain", "pre-gate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [128, 256, 512])
def test_query_tile_geometry(d, dtype, pre_gate):
    """The wrapper's query tiles and buffers agree with the card's kernels:
    the tile sizes are csrc/plain_k_tiles.cuh's (the partial buffers
    [max(1, blocks // S) + B, N, *] hold what a grid (per_tile, S) writes
    only if S is the kernels'); at N = QT - 1, QT, QT + 1 one, one and two
    tiles, a block count per tile of blocks // S (at least 1); at most
    eight queries one tile (the kernels at up to eight queries); the
    backward's scratch the dq partials and, past eight queries, the dk / dv
    pass's da (du with the pre-gate) over S QT queries; the export passes'
    slabs of eight unchanged."""
    bf = dtype == torch.bfloat16
    assert tcoattn.QUERY_TILE == _cuda_rows("QUERY_TILE")
    qt = tcoattn.QUERY_TILE[(d, bf)]
    assert qt % 16 == 0 and 16 <= qt <= 64
    blocks, b, m_len = 2 * 132, 32, 1077
    for n, tiles in ((qt - 1, 1), (qt, 1), (qt + 1, 2), (256, -(-256 // qt))):
        if n <= tcoattn.MAX_QUERIES:
            continue
        assert tcoattn._query_tiles(n, d, dtype) == tiles
        parts = tcoattn._slab_parts(blocks, tiles) + b
        assert parts == max(1, blocks // tiles) + b
        # every block of the grid writes at most one partial a bag it visits,
        # at index block + bag: per_tile = max(1, resident // tiles) <= parts - B
        for resident in (132, 264):
            assert max(1, resident // tiles) + b <= parts
        got = tcoattn._dq_scratch(blocks, b, n, d, m_len, dtype, pre_gate)
        assert got == parts * n * d + (1 + pre_gate) * b * m_len * tiles * qt
    for n in (1, 8):
        assert tcoattn._query_tiles(n, d, dtype) == 1
        assert tcoattn._slab_parts(blocks, 1) == blocks
        assert tcoattn._dq_scratch(blocks, b, n, d, m_len, dtype, pre_gate) == (blocks + b) * n * d
    assert tcoattn._slab_parts(blocks, tcoattn._slabs(50)) == blocks // 7


@pytest.mark.parametrize("n,m_len,case,pre_gate", FORWARD_CASES)
def test_forward_with_values_matches_pallas(n, m_len, case, pre_gate):
    """o, l, m, ssq, sumw of the plain version and of the wrapper's CPU path
    (training form at rate 0; eval form o, l, m) against the forward Pallas
    kernel over one tile of M keys."""
    (q, k, v), _ = _data(n, m_len, 3 * n + m_len + pre_gate)
    mask = _mask(m_len, case)
    out = jcoattn._coattn_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask, jnp.float32)[:, None, :],
        None, pre_gate=pre_gate, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=True,
        emit_sumw=True)
    ref = [np.asarray(x) if i == 0 else np.asarray(x)[:, 0] for i, x in enumerate(out)]
    args = [_t(x) for x in (q, k, v, mask)]
    got = tcoattn.coattn_fwd_plain_k_plain(*args, None, 0.0, pre_gate=pre_gate)
    train = tcoattn.coattn_fwd_plain_k(*args, torch.zeros((1,), dtype=torch.int32), 0.0,
                                       pre_gate=pre_gate)
    ev = tcoattn.coattn_fwd_plain_k(*args, pre_gate=pre_gate, train=False)
    assert got[0].shape == (B, n, D)
    for name, a, t, e, r in zip(("o", "l", "m", "ssq", "sumw"), got, train, ev, ref):
        for x in (a, t) + ((e,) if e is not None else ()):
            assert torch.isfinite(x).all(), name
            np.testing.assert_allclose(x.numpy(), r, atol=ATOL,
                                       rtol=L_RTOL if name == "l" else 0.0, err_msg=name)


@pytest.mark.parametrize("n,m_len,case,pre_gate", TURNING + EDGES)
def test_coattention_vjp_matches_pallas(n, m_len, case, pre_gate):
    """dq, dk, dv of the plain backward, of the wrapper's CPU path and of
    autograd through ``coattention`` (``PlainKAttention``) against jax.vjp
    through ``coattention`` in interpret mode (its custom VJP: the backward
    Pallas kernel); dk and dv exactly 0 at the masked keys of a bag with a
    valid key."""
    (q, k, v), cot = _data(n, m_len, 50 + 3 * n + m_len + pre_gate)
    mask = _mask(m_len, case)
    mask_j = jnp.asarray(mask)

    def fj(q_, k_, v_):
        return jcoattn.coattention(q_, k_, v_, mask_j, pre_gate=pre_gate, need_ssq=True,
                                   need_sumw=True, block_k=m_len, interpret=True)

    _, vjp = jax.vjp(fj, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    args = [_t(x) for x in (q, k, v, mask)]
    seed = torch.zeros((1,), dtype=torch.int32)
    tcot = [_t(c) for c in cot]
    got = tcoattn.coattn_bwd_plain_k_plain(*args, seed, 0.0, *tcot, pre_gate=pre_gate)
    o, l, m, ssq, sumw = tcoattn.coattn_fwd_plain_k_plain(*args, seed, 0.0, pre_gate=pre_gate)
    di = (o * tcot[0]).sum(-1) + 2.0 * tcot[1] * ssq + tcot[2] * sumw
    wrapped = tcoattn.coattn_bwd_plain_k(*args, seed, 0.0, tcot[0], l, m, di, tcot[1], tcot[2],
                                         pre_gate=pre_gate)
    leaves = [t.clone().requires_grad_(True) for t in args[:3]]
    o2, ssq2, sumw2 = tcoattn.coattention(*leaves, args[3], pre_gate=pre_gate, need_ssq=True,
                                          need_sumw=True)
    ((o2 * tcot[0]).sum() + (ssq2 * tcot[1]).sum() + (sumw2 * tcot[2]).sum()).backward()
    for name, a, w, leaf, r in zip(("dq", "dk", "dv"), got, wrapped, leaves, ref):
        _close_rel(a, r, GRAD_RTOL, name)
        assert torch.equal(a, w), name
        _close_rel(leaf.grad, r, GRAD_RTOL, name + " autograd")
    has = mask.any(-1)
    for name, g in zip(("dk", "dv"), got[1:]):
        assert not np.any(g.numpy()[has][~mask[has]]), name


@pytest.mark.parametrize("n,m_len,case,pre_gate", TURNING)
def test_coattention_weights_matches_pallas(n, m_len, case, pre_gate):
    """l, m of export pass 1 against ``_coattn_fwd_impl`` with zero values;
    w of pass 2 and of ``coattention_weights`` against
    ``coattention_weights`` in interpret mode; a bag without a valid key
    uniform over its M keys, masked keys of the others exactly 0."""
    (q, k, _), _ = _data(n, m_len, 90 + 3 * n + m_len + pre_gate)
    mask = _mask(m_len, case)
    qj, kj = jnp.asarray(q), jnp.asarray(k)
    _, l_j, m_j, _, _ = jcoattn._coattn_fwd_impl(
        qj, kj, jnp.zeros_like(kj), jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=pre_gate, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=False)
    w_j = np.asarray(jcoattn.coattention_weights(qj, kj, jnp.asarray(mask), pre_gate=pre_gate,
                                                 block_k=m_len, interpret=True))
    tq, tk, tm = _t(q), _t(k), _t(mask)
    l, m = tcoattn.coattn_stats(tq, tk, tm, pre_gate=pre_gate)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j)[:, 0], atol=ATOL, rtol=L_RTOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j)[:, 0], atol=ATOL)
    w = tcoattn.coattn_weights(tq, tk, tm, l, m, pre_gate=pre_gate)
    both = tcoattn.coattention_weights(tq, tk, tm, pre_gate=pre_gate)
    assert w.shape == (B, n, m_len) and torch.equal(both, w)
    np.testing.assert_allclose(w.numpy(), w_j, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), w_j, atol=W_ATOL, rtol=W_RTOL)
    has = mask.any(-1)
    assert not np.any(w.numpy()[has][np.broadcast_to(~mask[has][:, None], (int(has.sum()), n,
                                                                          m_len))])
    if not has.all():
        assert np.all(w.numpy()[~has] == np.float32(1.0 / m_len))


def test_bf16_at_40_queries_matches_pallas():
    """The bfloat16 plain versions at 40 queries (masked tiles mid-bag, with
    the pre-gate): the forward's o, l, m, ssq, sumw against the forward
    Pallas kernel on bfloat16 tiles, dq, dk, dv against jax.vjp through
    ``coattention`` on bfloat16 inputs."""
    n, m_len, pre_gate = 40, 640, True
    rng = np.random.default_rng(40)
    q, k, v = (bf16._bf(scale * rng.normal(size=(B, rows, D)))
               for scale, rows in ((0.7, n), (0.7, m_len), (1.0, m_len)))
    cot = (bf16._bf(rng.normal(size=(B, n, D))), rng.normal(size=(B, n)).astype(np.float32),
           rng.normal(size=(B, n)).astype(np.float32))
    mask = _mask(m_len, "holes")
    out = jcoattn._coattn_fwd_impl(
        *(bf16._jb(x) for x in (q, k, v)), jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=pre_gate, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=True,
        emit_sumw=True)
    args = [bf16._tb(x) for x in (q, k, v)] + [_t(mask)]
    got = tcoattn.coattn_fwd_plain_k_plain(*args, None, 0.0, pre_gate=pre_gate)
    assert got[0].dtype == torch.bfloat16
    _close_rel(got[0], out[0], BF16_O_RTOL, "o")
    for name, a, r in zip(("l", "m", "ssq", "sumw"), got[1:], out[1:]):
        _close_rel(a, np.asarray(r)[:, 0], BF16_STAT_RTOL, name)
    mask_j = jnp.asarray(mask)

    def fj(q_, k_, v_):
        return jcoattn.coattention(q_, k_, v_, mask_j, pre_gate=pre_gate, need_ssq=True,
                                   need_sumw=True, block_k=m_len, interpret=True)

    _, vjp = jax.vjp(fj, *(bf16._jb(x) for x in (q, k, v)))
    ref = vjp((bf16._jb(cot[0]), jnp.asarray(cot[1]), jnp.asarray(cot[2])))
    tcot = [bf16._tb(cot[0]), _t(cot[1]), _t(cot[2])]
    grads = tcoattn.coattn_bwd_plain_k_plain(*args, torch.zeros((1,), dtype=torch.int32), 0.0,
                                             *tcot, pre_gate=pre_gate)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert a.dtype == torch.bfloat16, name
        _close_rel(a, r, BF16_GRAD_RTOL, name)


# ---------------------------------------------------------------- the models


def _jax_params(cls):
    """A JAX ``small`` parameter tree at 40 signature groups, every leaf
    perturbed with noise (the key's PRNG named: a JAX Trainer built earlier
    in the process may change the default)."""
    rng = np.random.default_rng(0)
    model = cls(n_signatures=len(GROUPS), model_size="small", dropout_rate=0.0)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, WSI)), [jnp.zeros((1, s)) for s in GROUPS],
        jnp.ones((1, 64), bool), deterministic=True,
    ))(jax.random.key(0, impl="threefry2x32"))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _batch(m_len, lengths, seed):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    return {
        "wsi": rng.normal(size=(b, m_len, WSI)).astype(np.float32),
        "mask": np.arange(m_len)[None] < np.asarray(lengths)[:, None],
        "omics": [rng.normal(size=(b, s)).astype(np.float32) for s in GROUPS],
        "label": rng.integers(0, 4, b).astype(np.int32),
        "censorship": rng.integers(0, 2, b).astype(np.float32),
        "weight": np.ones(b, np.float32),
    }


@pytest.mark.parametrize("name,loss_name", [("MCAT", "ces"), ("NaCAGaT", "cesar")])
def test_models_at_40_groups_match_jax(name, loss_name, monkeypatch):
    """MCAT (ces) and NaCAGaT (cesar) ``small`` at 40 signature groups on the
    JAX models' weights: eval hazards, survs and y; the map of 40 queries
    (``need_attention=True``: the export passes); a training forward at
    dropout 0 (NaCAGaT with cesar's ssq) and its loss; every parameter's
    gradient. The port's co-attention takes the plain-K forms: one forward
    with values a forward, one backward a gradient, two export passes a
    map."""
    jcls, tcls = (JMCAT, MCAT) if name == "MCAT" else (JNaCAGaT, NaCAGaT)
    params = _jax_params(jcls)
    model_j = jcls(n_signatures=len(GROUPS), model_size="small", dropout_rate=0.0)
    model = load_jax_params(tcls(GROUPS, model_size="small", dropout_rate=0.0, wsi_dim=WSI),
                            params)
    batch = _batch(300, (300, 140, 0), 5)
    batch["weight"][2] = 0.0
    wsi, omics, mask = (jnp.asarray(batch["wsi"]), [jnp.asarray(o) for o in batch["omics"]],
                        jnp.asarray(batch["mask"]))
    args = (_t(batch["wsi"]), [_t(o) for o in batch["omics"]], _t(batch["mask"]))
    calls = {"fwd": 0, "bwd": 0, "stats": 0, "weights": 0}
    for key, fn in (("fwd", "coattn_fwd_plain_k"), ("bwd", "coattn_bwd_plain_k"),
                    ("stats", "coattn_stats_plain"), ("weights", "coattn_weights_plain")):
        monkeypatch.setattr(tcoattn, fn, lambda *a, _f=getattr(tcoattn, fn), _k=key, **kw:
                            calls.update({_k: calls[_k] + 1}) or _f(*a, **kw))

    model.eval()
    evaluated = jax.jit(lambda p, need: model_j.apply({"params": p}, wsi, omics, mask,
                                                      deterministic=True, need_attention=need),
                        static_argnums=1)
    for need in (False, True):
        out_j = evaluated(params, need)
        with torch.no_grad():
            out = model(*args, need_attention=need)
        for key in ("hazards", "survs", "y"):
            np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(getattr(out_j, key)),
                                       atol=MODEL_ATOL, err_msg=key)
        if need:
            cmap = out.attention["coattn"]
            assert cmap.shape == (3, len(GROUPS), 300)
            np.testing.assert_allclose(cmap.numpy(), np.asarray(out_j.attention["coattn"]),
                                       atol=MODEL_ATOL, err_msg="map")
    assert calls == {"fwd": 1, "bwd": 0, "stats": 1, "weights": 1}, calls

    need = "ssq" if loss_name == "cesar" else False

    def jloss(p):
        o = model_j.apply({"params": p}, wsi, omics, mask, deterministic=False,
                          need_attention=need, rngs={"dropout": jax.random.key(0)})
        loss, _ = jloop._survival_loss(loss_name, o, jnp.asarray(batch["label"]),
                                       jnp.asarray(batch["censorship"]), None, 0.75,
                                       jnp.asarray(batch["weight"]))
        return loss, o

    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model.train()
    out = model(*args, need_attention=need, generator=torch.Generator().manual_seed(0))
    loss, _ = tlosses.survival_loss(loss_name, out, _t(batch["label"]).long(),
                                    _t(batch["censorship"]), 0.75, _t(batch["weight"]))
    loss.backward()
    assert calls["fwd"] == 2 and calls["bwd"] == 1, calls
    np.testing.assert_allclose(out.hazards.detach().numpy(), np.asarray(out_j.hazards),
                               atol=MODEL_ATOL)
    np.testing.assert_allclose(float(loss), float(loss_j), atol=MODEL_ATOL)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(ref) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[key], atol=MODEL_ATOL, err_msg=key)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3  # not a comparison of zeros


@pytest.mark.parametrize("loss,op", [("ces", "coattn_plain_k"), ("cesar", "coattention_weights")])
def test_bundle_at_40_groups_holds_the_plain_k_ops(tmp_path, loss, op):
    """A deployment bundle (``deploy.py``, ``torch.export``) of NaCAGaT
    ``small`` at 40 signature groups: the co-attention is a custom-op node
    of the plain-K forms (the eval form with values for ces, the export
    passes for cesar), whose fake implementations give the shapes at any
    query count, and the bundle's outputs equal the Predictor's within
    1e-6 (``test_torch_port_deploy.py``'s bar)."""
    import os

    from multimodal_path_omic_tpu_torch.config import config_from_dict
    from multimodal_path_omic_tpu_torch.data.synthetic import (
        make_synthetic_cohort,
        synthetic_config_dict,
    )
    from multimodal_path_omic_tpu_torch.deploy import ExportedModel, export_model
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    paths = make_synthetic_cohort(str(tmp_path / "cohort"), n_patients=8, bag_lengths=(48, 80),
                                  n_genes=80, n_signatures=40, embedding_dim=WSI, seed=0)
    raw = synthetic_config_dict(*paths)
    raw["device"] = "cpu"
    raw["model"].update(name="NaCAGaT", model_size="small", checkpoint_dir=str(tmp_path / "ck"))
    raw["training"].update(loss=loss, epochs=1, test_output_dir=str(tmp_path / "out"))
    raw["tpu"] = {"bag_buckets": [64], "batch_size": 2}
    trainer = Trainer(config_from_dict(raw), verbose=False)
    assert len(trainer.omic_sizes) == 40
    bundle = str(tmp_path / "bundle")
    export_model(trainer, bundle, buckets=(64,), batch_sizes=(2,), platforms=("cpu",))
    program = torch.export.load(os.path.join(bundle, "b64_n2.pt2"))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert f"mpo_torch.{op}.default" in targets, sorted(targets)
    rng = np.random.default_rng(40)
    bags = [rng.normal(size=(m, WSI)).astype(np.float32) for m in (40, 64, 33)]
    omics = [[rng.normal(size=(s,)).astype(np.float32) for s in trainer.omic_sizes]
             for _ in bags]
    got = ExportedModel(bundle, device="cpu").predict_bags(bags, omics)
    ours = Predictor.from_trainer(trainer).predict_bags(bags, omics)
    for key in ("hazards", "survs", "risk"):
        np.testing.assert_allclose(got[key], ours[key], atol=1e-6, rtol=0, err_msg=key)
