"""The plain-K co-attention with values under bfloat16 compute against the
JAX package on the CPU: the bfloat16 plain versions of the forward
(``coattn_fwd_plain_k``: o, l, m, ssq, sumw) and of the backward
(``coattn_bwd_plain_k``: dq, dk, dv), which the card's bfloat16 instances
are held to, against ``coattention`` and its custom VJP (the forward and
backward Pallas kernels in interpret mode on bfloat16 tiles, dropout 0), at
D = 128, 256 and 512, with and without the pre-gate, on the masks of
``test_torch_port_coattn_plain.py``; and MCAT and NaCAGaT with
``lean=False`` (their co-attention through this pair) at ``small`` and
``big`` with ``dtype=torch.bfloat16`` against the JAX models with
``dtype=jnp.bfloat16`` and ``MPO_NO_LEAN_ATTENTION=1`` on the same
parameters, at M = 4096 (JAX's ``kernel_eligible``: its Pallas kernels run
there): eval hazards, and a training forward's hazards, loss and every
parameter's gradient.

Tolerances, each with its reason (measured values in brackets, the worst
case of each):

* forward: o within one bfloat16 unit (2^-7) of o's largest magnitude: both
  sides round the same float32 sums to bfloat16 once, in other summation
  orders, and tanh(q), tanh(k) are rounded to bfloat16 on both sides from
  two libraries' float32 tanh, which land on the two sides of a rounding
  now and then [2.7e-3 of the largest]; l, m, ssq and sumw within 1e-5 of
  their largest magnitude [2.4e-6, l];
* backward: dq, dk, dv within 3e-2 of each one's largest magnitude (as
  ``test_torch_port_bf16.py``'s fuse-K backward): the JAX kernel forms
  1 - tanh^2 from the bfloat16 tanh in bfloat16 arithmetic, the port in
  float32 [dk 1.2e-2, dq 1.0e-2, dv 2.2e-3];
  dk and dv exactly 0 at the masked keys of a bag with a valid key;
* models: ``test_torch_port_bf16.py``'s rules (hazards and the loss within
  5e-3 or within twice the distance bfloat16 moves them in JAX; each
  parameter's gradient within 2e-2 of the leaf's largest magnitude or twice
  JAX's own bfloat16 distance for that leaf). Readings, as shares of JAX's
  own bfloat16 distance (eval hazards, loss, the worst gradient leaf): MCAT
  ``small`` 1.64, 1.79, 1.95 (``branch_transformer.1.layers.0.linear1``'s
  weight, a ReLU-gated feed-forward leaf); MCAT ``big`` 1.17, 1.18, 1.50;
  NaCAGaT ``small`` 0.66, 1.59, 1.33; NaCAGaT ``big`` 0.71, 0.70, 1.30.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_port_bf16 as bf16  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.train import loop as jloop  # noqa: E402
from multimodal_path_omic_tpu_torch.models import build_model  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import losses as tlosses  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import load_jax_params  # noqa: E402

from test_torch_port_coattn_fwd import _mask  # noqa: E402
from test_torch_port_coattn_plain import GATES, MASKS  # noqa: E402

BF16 = torch.bfloat16
B, N = 2, 3
O_RTOL = 2.0 ** -7
STAT_RTOL = 1e-5
GRAD_RTOL = 3e-2
WIDTHS = [128, 256, 512]
MASK_CASES = [pytest.param(*p.values[:2], id=p.id) for p in MASKS]
MODEL_M = 4096


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads while this file runs: the suite's six workers on
    eight cores, each with a thread a core, oversubscribe them (the host-fed
    Trainers here then run several times slower than alone)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _data(d, m_len, seed):
    rng = np.random.default_rng(seed)
    q = bf16._bf(0.7 * rng.normal(size=(B, N, d)))
    k = bf16._bf(0.7 * rng.normal(size=(B, m_len, d)))
    v = bf16._bf(rng.normal(size=(B, m_len, d)))
    cot = (bf16._bf(rng.normal(size=(B, N, d))), rng.normal(size=(B, N)).astype(np.float32),
           rng.normal(size=(B, N)).astype(np.float32))
    return (q, k, v), cot


def _close_max(got, ref, rtol, name):
    got, ref = bf16._f32(got), bf16._f32(ref)
    assert np.isfinite(got).all(), name
    err = np.abs(got - ref).max()
    print(f"{name}: {err / np.abs(ref).max():.2e} of its largest magnitude")
    assert err <= rtol * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("pre_gate", GATES)
@pytest.mark.parametrize("m_len,case", MASK_CASES)
@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_plain_forward_matches_pallas(d, m_len, case, pre_gate):
    """The bfloat16 plain version (and the wrapper's CPU path, training form
    at rate 0 and eval form) against the forward Pallas kernel on bfloat16
    tiles over one tile of M keys: o bfloat16, l, m, ssq, sumw float32."""
    (q, k, v), _ = _data(d, m_len, d + m_len + pre_gate)
    mask = _mask(m_len, case)
    out = jcoattn._coattn_fwd_impl(
        *(bf16._jb(x) for x in (q, k, v)), jnp.asarray(mask, jnp.float32)[:, None, :], None,
        pre_gate=pre_gate, block_k=m_len, interpret=True, dropout_rate=0.0, emit_ssq=True,
        emit_sumw=True)
    assert out[0].dtype == jnp.bfloat16
    ref = [out[0]] + [np.asarray(x)[:, 0] for x in out[1:]]
    args = [bf16._tb(x) for x in (q, k, v)] + [torch.from_numpy(mask)]
    got = tcoattn.coattn_fwd_plain_k_plain(*args, None, 0.0, pre_gate=pre_gate)
    train = tcoattn.coattn_fwd_plain_k(*args, torch.zeros((1,), dtype=torch.int32), 0.0,
                                       pre_gate=pre_gate)
    ev = tcoattn.coattn_fwd_plain_k(*args, pre_gate=pre_gate, train=False)
    assert got[0].dtype == BF16 and all(t.dtype == torch.float32 for t in got[1:])
    for a, t in zip(got, train):
        assert torch.equal(a, t)
    for a, e in zip(got[:3], ev[:3]):
        assert torch.equal(a, e)
    _close_max(got[0], ref[0], O_RTOL, "o")
    for name, a, r in zip(("l", "m", "ssq", "sumw"), got[1:], ref[1:]):
        _close_max(a, r, STAT_RTOL, name)


@pytest.mark.parametrize("pre_gate", GATES)
@pytest.mark.parametrize("m_len,case", MASK_CASES)
@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_plain_backward_matches_pallas_vjp(d, m_len, case, pre_gate):
    """dq, dk, dv in bfloat16 of the plain backward, of the wrapper's CPU path
    and of autograd through ``coattention`` (``PlainKAttention``) under
    cotangents on o, ssq and sumw, against jax.vjp through ``coattention``
    on bfloat16 inputs (its custom VJP: the backward Pallas kernel)."""
    (q, k, v), cot = _data(d, m_len, 50 + d + m_len + pre_gate)
    mask = _mask(m_len, case)
    mask_j = jnp.asarray(mask)

    def fj(q_, k_, v_):
        return jcoattn.coattention(q_, k_, v_, mask_j, pre_gate=pre_gate, need_ssq=True,
                                   need_sumw=True, block_k=m_len, interpret=True)

    _, vjp = jax.vjp(fj, *(bf16._jb(x) for x in (q, k, v)))
    ref = vjp((bf16._jb(cot[0]), jnp.asarray(cot[1]), jnp.asarray(cot[2])))
    assert all(r.dtype == jnp.bfloat16 for r in ref)
    args = [bf16._tb(x) for x in (q, k, v)] + [torch.from_numpy(mask)]
    seed = torch.zeros((1,), dtype=torch.int32)
    tcot = [bf16._tb(cot[0]), torch.from_numpy(cot[1]), torch.from_numpy(cot[2])]
    got = tcoattn.coattn_bwd_plain_k_plain(*args, seed, 0.0, *tcot, pre_gate=pre_gate)
    o, l, m, ssq, sumw = tcoattn.coattn_fwd_plain_k_plain(*args, seed, 0.0, pre_gate=pre_gate)
    di = (o.float() * tcot[0].float()).sum(-1) + 2.0 * tcot[1] * ssq + tcot[2] * sumw
    wrapped = tcoattn.coattn_bwd_plain_k(*args, seed, 0.0, tcot[0], l, m, di, tcot[1], tcot[2],
                                         pre_gate=pre_gate)
    leaves = [t.detach().clone().requires_grad_(True) for t in args[:3]]
    o2, ssq2, sumw2 = tcoattn.coattention(*leaves, args[3], pre_gate=pre_gate, need_ssq=True,
                                          need_sumw=True)
    ((o2.float() * tcot[0].float()).sum() + (ssq2 * tcot[1]).sum()
     + (sumw2 * tcot[2]).sum()).backward()
    for name, a, w, t, r in zip(("dq", "dk", "dv"), got, wrapped, leaves, ref):
        assert a.dtype == BF16 and torch.equal(a, w), name
        assert t.grad.dtype == BF16
        _close_max(t.grad, a, 2.0 ** -7, name + " autograd vs plain")
        _close_max(a, r, GRAD_RTOL, name)
    has = mask.any(-1)
    for name, g in zip(("dk", "dv"), got[1:]):
        assert not np.any(bf16._f32(g)[has][~mask[has]]), name


def test_bf16_plain_version_rounds_tanh_and_pools_in_float32():
    """What the bfloat16 instances compute, in float32 terms: the forward on
    bfloat16 inputs equals the float32 forward with tanh(q) and tanh(k)
    rounded to bfloat16 and w . v in float32, o rounded once at the end."""
    (q, k, v), _ = _data(256, 300, 7)
    mask = torch.from_numpy(_mask(300, "no-valid-key"))
    got = tcoattn.coattn_fwd_plain_k_plain(*(bf16._tb(x) for x in (q, k, v)), mask, None, 0.0,
                                           pre_gate=True)
    qf, kf, vf = (torch.from_numpy(x) for x in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) / 16.0
    g = torch.tanh(qf).to(BF16).float() @ torch.tanh(kf).to(BF16).float().transpose(-1, -2)
    s = torch.where(mask[:, None, :], s * (g + 1.0) * 0.5, torch.full_like(s, tcoattn.NEG))
    w = torch.softmax(s, dim=-1)
    torch.testing.assert_close(got[0], (w @ vf).to(BF16), atol=0, rtol=2.0 ** -7)
    torch.testing.assert_close(got[4], w.sum(-1), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- the models


@pytest.mark.parametrize("size", ["small", "big"])
@pytest.mark.parametrize("name,loss_name", [("MCAT", "ces"), ("NaCAGaT", "cesar")])
def test_lean_false_models_bf16_match_jax(name, loss_name, size, monkeypatch):
    """MCAT and NaCAGaT with ``lean=False`` at bfloat16 compute (their
    co-attention through the plain-K pair's bfloat16 plain versions; one
    forward and one backward call a step) against the JAX models at bfloat16
    with ``MPO_NO_LEAN_ATTENTION=1`` (the Pallas kernels in interpret mode):
    eval hazards, a training forward's hazards and loss, and every
    parameter's gradient."""
    monkeypatch.setenv("MPO_NO_LEAN_ATTENTION", "1")
    jcls = bf16.JNaCAGaT if name == "NaCAGaT" else bf16.JMCAT
    params = bf16._jax_params(jcls, size, n_signatures=len(bf16.SIZES))
    batch = bf16._batch(MODEL_M, (4000, 1500), 1)
    model_j, model_j32 = (jcls(n_signatures=len(bf16.SIZES), model_size=size, dropout_rate=0.0,
                               use_pallas=True, dtype=dt) for dt in (jnp.bfloat16, None))
    wsi, omics, mask = (jnp.asarray(batch["wsi"]), [jnp.asarray(o) for o in batch["omics"]],
                        jnp.asarray(batch["mask"]))
    model = load_jax_params(build_model(name, omic_sizes=bf16.SIZES, model_size=size,
                                        dropout=0.0, wsi_dim=bf16.WSI, lean=False, dtype=BF16),
                            params)
    args = (bf16._t(batch["wsi"]), [bf16._t(o) for o in batch["omics"]], bf16._t(batch["mask"]))
    nudged_params = [bf16._nudged(params, scale) for scale in bf16.NUDGES]
    calls = {"fwd": 0, "bwd": 0}
    for key, fn in (("fwd", "coattn_fwd_plain_k"), ("bwd", "coattn_bwd_plain_k")):
        monkeypatch.setattr(tcoattn, fn, lambda *a, _f=getattr(tcoattn, fn), _k=key, **kw:
                            calls.update({_k: calls[_k] + 1}) or _f(*a, **kw))
    jcoattn.DISPATCH_COUNTS.update(kernel=0, flash=0, xla=0)

    @jax.jit
    def evaluated(p):
        return model_j.apply({"params": p}, wsi, omics, mask, need_attention=False).hazards

    hazards_j = np.asarray(evaluated(params))
    assert jcoattn.DISPATCH_COUNTS["kernel"] == 1 and jcoattn.DISPATCH_COUNTS["xla"] == 0
    witnesses = [np.asarray(model_j32.apply({"params": params}, wsi, omics, mask,
                                            need_attention=False).hazards)]
    witnesses += [np.asarray(evaluated(p)) for p in nudged_params]
    model.eval()
    with torch.no_grad():
        out = model(*args, need_attention=False)
    assert out.hazards.dtype == torch.float32 and calls == {"fwd": 1, "bwd": 0}
    bf16._close_or_witnessed("eval hazards", out.hazards.numpy(), hazards_j, witnesses)

    need = "ssq" if loss_name == "cesar" else False

    def jloss(p, m=model_j):
        o = m.apply({"params": p}, wsi, omics, mask, deterministic=False, need_attention=need)
        loss, _ = jloop._survival_loss(loss_name, o, jnp.asarray(batch["label"]),
                                       jnp.asarray(batch["censorship"]), None, 0.75,
                                       jnp.asarray(batch["weight"]))
        return loss, o

    value_and_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (loss_j, out_j), grads_j = value_and_grad(params)
    nudged = [value_and_grad(p) for p in nudged_params]
    f32 = jax.jit(jax.value_and_grad(lambda p: jloss(p, model_j32), has_aux=True))(params)
    seen = {}

    def loss_of(m):
        out = m.train()(*args, need_attention=need, generator=torch.Generator().manual_seed(0))
        loss, _ = tlosses.survival_loss(loss_name, out, bf16._t(batch["label"]),
                                        bf16._t(batch["censorship"]), 0.75,
                                        bf16._t(batch["weight"]))
        seen.setdefault("out", (out.hazards.detach(), float(loss.detach())))
        return loss

    grads = bf16._grads(model, loss_of)
    assert calls == {"fwd": 2, "bwd": 1}
    hazards, loss = seen["out"]
    bf16._close_or_witnessed("training hazards", hazards.numpy(), np.asarray(out_j.hazards),
                             [np.asarray(w[0][1].hazards) for w in (f32, *nudged)])
    bf16._close_or_witnessed("loss", loss, float(loss_j), [float(w[0][0]) for w in (f32, *nudged)])
    bf16._check_grads(grads, grads_j, [w[1] for w in (f32, *nudged)])
