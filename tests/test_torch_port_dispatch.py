"""The port's kernel dispatch against the JAX package's, on the CPU.

Each kernel wrapper states what its CUDA kernel takes in one predicate
(``coattn.fused_k_supports``, ``coattn.plain_k_supports``, ``flash.supports``,
``milpool.supports``, the counterparts of the JAX package's
``leank_eligible``, ``kernel_eligible``, ``flash.supported`` and
``milpool_eligible``). The wrapper's raise on a CUDA shape and the module's
gate both read it, so a shape the kernels refuse is routed to
``attention_core`` (the JAX dispatchers' ``_xla_fused`` / ``attention_core``
fallback), and a pool to ``GatedMILPool``'s eager branch (the JAX module's
XLA branch), by its shape alone, before any launch, on the CPU and on the
card alike. These tests hold

* each predicate against the wrapper's own checks on a grid of shapes (the
  checks raise "unsupported" on a refused shape and, on an admitted one, go on
  to the device check, which a CPU tensor fails);
* the routes ``MultiheadAttention`` takes at shapes on both sides of the
  predicates, and the output at each refused shape against the JAX module
  (``use_pallas=True``) on the same weights, within 5e-5 (float32 on both
  sides, other summation orders; the tolerance of the port's module tests);
* the lean-V branch's training form with a gradient to take (NaCAGaT
  ``medium`` and ``big``): the fuse-K training forward and backward run, and
  the output and gradients match ``jax.grad`` of the JAX module within 5e-5
  of each one's largest magnitude.

The same shapes run on the card in ``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_path_omic_tpu.ops import attention as jattention  # noqa: E402
from multimodal_path_omic_tpu.ops import blocks as jblocks  # noqa: E402
from multimodal_path_omic_tpu.ops import coattn as jcoattn  # noqa: E402
from multimodal_path_omic_tpu.ops import milpool as jmilpool  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import attention as tattention  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import blocks as tblocks  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn, flash, milpool  # noqa: E402
from multimodal_path_omic_tpu_torch.utils.weights import (  # noqa: E402
    jax_params_to_state_dict,
    load_jax_params,
)

MODEL_ATOL = 5e-5


def _refusal(fn, *args, **kw) -> bool:
    """True where the check refuses the shape, False where it admits it (and
    the device check that follows refuses the CPU tensor)."""
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    msg = str(info.value)
    assert ("unsupported" in msg) != ("must be a CUDA tensor" in msg), msg
    return "unsupported" in msg


@pytest.mark.parametrize("train", [False, True])
def test_fused_k_supports_is_the_wrappers_check(train):
    seen = set()
    for n in (1, 6, 8, 9, 12):
        for e in (64, 128, 256, 512):
            for f in (128, 256, 512, 1024, 1040):
                q, kv = torch.zeros(2, n, e), torch.zeros(2, 40, f)
                wk, bk = torch.zeros(f, e), torch.zeros(e)
                refused = _refusal(coattn._fused_k_checks, q, kv, wk, bk, None, train=train)
                assert refused == (not coattn.fused_k_supports(n, e, f, 40, train=train))
                seen.add(refused)
    assert seen == {True, False}


@pytest.mark.parametrize("values", [False, True])
def test_plain_k_supports_is_the_wrappers_check(values):
    seen = set()
    for n in (1, 6, 8, 9, 12, 32, 256, 257):
        for d in (16, 32, 64, 128, 256, 512):
            q, k = torch.zeros(2, n, d), torch.zeros(2, 40, d)
            refused = _refusal(coattn._plain_k_checks, q, k, values=values)
            assert refused == (not coattn.plain_k_supports(n, d, 40, values=values))
            seen.add(refused)
    assert seen == {True, False}


class _Ran(Exception):
    pass


@pytest.mark.parametrize("rate,ssq,grad", [(0.0, False, False), (0.25, False, False),
                                           (0.0, True, False), (0.0, False, True)])
def test_leank_train_form_is_the_form_the_dispatcher_runs(monkeypatch, rate, ssq, grad):
    """The lean-V gate asks ``fused_k_supports`` about the form that
    ``leank_train_form`` names; ``fused_attention_leank`` runs that form."""
    def stop(form):
        def run(*args, **kw):
            raise _Ran(form)
        return run

    monkeypatch.setattr(coattn.FusedKTrain, "apply", stop("train"))
    monkeypatch.setattr(coattn, "coattn_fwd_fused_k", stop("eval"))
    q, kv = torch.zeros(2, 3, 128), torch.zeros(2, 40, 128)
    wk, bk = torch.zeros(128, 128, requires_grad=grad), torch.zeros(128)
    seed = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(_Ran) as info:
        coattn.fused_attention_leank(q, kv, wk, bk, None, dropout_rate=rate, dropout_seed=seed,
                                     need_ssq=ssq)
    assert coattn.leank_train_form(rate, ssq, q, kv, wk, bk) == (str(info.value) == "train")
    assert str(info.value) == ("eval" if (rate, ssq, grad) == (0.0, False, False) else "train")
    with torch.no_grad():  # no gradient to take: the eval form unless dropout or ssq
        assert coattn.leank_train_form(rate, ssq, q, kv, wk, bk) == (rate > 0.0 or ssq)


def test_flash_supports_is_the_wrappers_check():
    for d in (2, 8, 16, 24, 32, 64, 96, 128, 256, 512, 1024):
        q = torch.zeros(2, 3, 40, d)
        refused = _refusal(flash._check_qkv, q, q, q, None)
        assert refused == (not flash.supports(2, 3, 40, d))
        assert refused == (d not in (16, 32, 64, 128, 256, 512))


# ---------------------------------------------------------------------------
# The routes MultiheadAttention takes
# ---------------------------------------------------------------------------

ROUTES = ("fused_attention_leank", "fused_attention", "flash_attention",
          "attention_with_weights", "attention_core", "tiny_attention")


def _spy_all(monkeypatch):
    calls = {name: 0 for name in ROUTES}
    for name in ROUTES:
        inner = getattr(tattention, name)

        def wrapper(*args, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*args, **kw)

        monkeypatch.setattr(tattention, name, wrapper)
    return calls


def _params(e, rng):
    return {
        "in_proj_kernel": rng.normal(size=(e, 3 * e), scale=e ** -0.5).astype(np.float32),
        "in_proj_bias": rng.normal(size=(3 * e,), scale=0.1).astype(np.float32),
        "out_proj": {"kernel": rng.normal(size=(e, e), scale=e ** -0.5).astype(np.float32),
                     "bias": rng.normal(size=(e,), scale=0.1).astype(np.float32)},
    }


# (id, embed width, heads, pre-gate, queries (None: self-attention), keys,
#  need_weights, the route the port takes, whether a kernel takes the shape)
CASES = [
    # F1: cross-attention of 6 queries over 100 keys in 8 heads of width 32
    ("f1-6q-width32", 256, 8, False, 6, 100, False, "attention_core", False),
    ("6q-width256-8heads", 2048, 8, False, 6, 100, False, "fused_attention", True),
    # F2: NaCAGaT with 12 signature groups (past the fuse-K kernels' 8: the
    # plain-K kernels' slab instances); NaCAGaT big (E = F = 512): its eval
    # and training forms on the fuse-K kernels
    ("f2-nacagat-12-groups", 256, 1, True, 12, 100, False, "fused_attention", True),
    ("f2-nacagat-12-groups-ssq", 256, 1, True, 12, 100, "ssq", "fused_attention", True),
    ("f2-nacagat-big", 512, 1, True, 6, 100, False, "fused_attention_leank", True),
    ("f2-nacagat-big-ssq", 512, 1, True, 6, 100, "ssq", "fused_attention_leank", True),
    ("nacagat-medium", 256, 1, True, 6, 100, False, "fused_attention_leank", True),
    # F3: the map requested for 12 queries (the export passes' slab instances)
    ("f3-weights-12q", 256, 1, True, 12, 100, True, "attention_with_weights", True),
    ("weights-6q", 256, 1, True, 6, 100, True, "attention_with_weights", True),
    # the JAX kernels' range of signature groups, 1..256, and one past it
    ("nacagat-33-groups", 256, 1, True, 33, 100, False, "fused_attention", True),
    ("mcat-256-groups", 256, 1, False, 256, 100, False, "fused_attention", True),
    ("nacagat-256-groups-ssq", 256, 1, True, 256, 100, "ssq", "fused_attention", True),
    ("weights-256q", 256, 1, True, 256, 100, True, "attention_with_weights", True),
    ("mcat-257-groups", 256, 1, False, 257, 100, False, "attention_core", False),
    ("weights-257q", 256, 1, True, 257, 100, True, "attention_with_weights", False),
    # F4: self-attention at head widths with and without a flash instance
    ("f4-width8", 16, 2, False, None, 64, False, "attention_core", False),
    ("f4-width2", 16, 8, False, None, 64, False, "attention_core", False),
    ("f4-ge-small-width16", 128, 8, False, None, 64, False, "flash_attention", True),
    ("f4-ge-big-width512", 512, 1, False, None, 64, False, "flash_attention", True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_routes_follow_the_predicates_and_match_jax(case, monkeypatch):
    _, e, heads, pre_gate, n, m_len, need_weights, route, kernel = case
    rng = np.random.default_rng(e + heads + m_len)
    p = _params(e, rng)
    kv = rng.normal(size=(2, m_len, e)).astype(np.float32)
    query = kv if n is None else rng.normal(size=(2, n, e)).astype(np.float32)
    mask = np.arange(m_len)[None] < np.array([m_len - 7, 0])[:, None]
    module = load_jax_params(tattention.MultiheadAttention(e, heads, pre_gate=pre_gate), p).eval()
    calls = _spy_all(monkeypatch)
    tkv = torch.from_numpy(kv)
    tq = tkv if n is None else torch.from_numpy(query)
    with torch.no_grad():
        out, second = module(tq, tkv, tkv, torch.from_numpy(mask), need_weights=need_weights)
    assert calls[route] >= 1, calls
    if route == "attention_with_weights":
        # inside it: the kernels' two passes, or attention_core where refused
        assert calls["attention_core"] == int(not kernel), calls
    else:
        assert sum(calls.values()) == 1, calls
    # the predicate that decided
    d = e // heads
    if route in ("fused_attention", "attention_with_weights") or (
            route == "attention_core" and n is not None and (heads > 1 or n > 256)):
        assert coattn.plain_k_supports(n, d, m_len, values=route != "attention_with_weights") \
            == kernel
    if n is None:
        assert flash.supports(2, heads, m_len, d) == kernel
    if pre_gate and heads == 1 and need_weights is not True:
        assert coattn.fused_k_supports(n, e, e, m_len, train=need_weights == "ssq") == (
            route == "fused_attention_leank")

    jmodule = jattention.MultiheadAttention(embed_dim=e, num_heads=heads, pre_gate=pre_gate,
                                            use_pallas=True)
    jkv = jnp.asarray(kv)
    jq = jkv if n is None else jnp.asarray(query)
    jout, jsecond = jmodule.apply({"params": p}, jq, jkv, jkv, jnp.asarray(mask),
                                  need_weights=need_weights)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=MODEL_ATOL, rtol=0)
    if need_weights:
        np.testing.assert_allclose(second.numpy(), np.asarray(jsecond), atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("e", [256, 512], ids=["nacagat-medium-grad", "f2-nacagat-big-grad"])
def test_training_form_with_a_gradient_runs_the_kernels_and_matches_jax(e, monkeypatch):
    """A gradient to take through the lean-V branch (dropout 0, no ssq) asks
    for the fuse-K training form, which the kernels take at NaCAGaT medium's
    and big's E = F: one training forward and one backward, no other route;
    the output and the gradients of the inputs and of every parameter
    against jax.grad of the JAX module (its fuse-K Pallas kernels in
    interpret mode)."""
    monkeypatch.setenv("MPO_LEANK_MIN_M", "256")
    n, m_len = 6, 256  # JAX's leank_eligible: M a multiple of 256
    rng = np.random.default_rng(e + 3)
    p = _params(e, rng)
    kv = rng.normal(size=(2, m_len, e)).astype(np.float32)
    query = rng.normal(size=(2, n, e)).astype(np.float32)
    cot = rng.normal(size=(2, n, e)).astype(np.float32)
    mask = np.arange(m_len)[None] < np.array([m_len - 7, 40])[:, None]
    assert coattn.fused_k_supports(n, e, e, m_len, train=True)
    module = load_jax_params(tattention.MultiheadAttention(e, 1, pre_gate=True), p).eval()
    calls = _spy_all(monkeypatch)
    ran = []
    for name in ("coattn_fwd_fused_k_train", "coattn_bwd_fused_k"):
        monkeypatch.setattr(coattn, name, lambda *a, _fn=getattr(coattn, name), _name=name:
                            ran.append(_name) or _fn(*a))
    tq, tkv = (torch.from_numpy(x).requires_grad_(True) for x in (query, kv))
    out, _ = module(tq, tkv, tkv, torch.from_numpy(mask), need_weights=False)
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls["fused_attention_leank"] == 1 and sum(calls.values()) == 1, calls
    assert ran == ["coattn_fwd_fused_k_train", "coattn_bwd_fused_k"]

    jmodule = jattention.MultiheadAttention(embed_dim=e, num_heads=1, pre_gate=True,
                                            use_pallas=True)

    def jloss(params, q_, kv_):
        o, _ = jmodule.apply({"params": params}, q_, kv_, kv_, jnp.asarray(mask),
                             need_weights=False)
        return jnp.sum(o * cot), o

    before = jcoattn.DISPATCH_COUNTS["kernel"]
    (_, jout), (gp, gq, gkv) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        p, jnp.asarray(query), jnp.asarray(kv))
    assert jcoattn.DISPATCH_COUNTS["kernel"] > before  # the Pallas kernels ran
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=MODEL_ATOL, rtol=0)
    ref = {"query": gq, "kv": gkv, **jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gp))}
    got = {"query": tq.grad, "kv": tkv.grad,
           **{k: t.grad for k, t in module.named_parameters()}}
    assert set(got) == set(ref)
    for name, g in got.items():
        r = np.asarray(ref[name])
        assert np.abs(g.numpy() - r).max() <= MODEL_ATOL * np.abs(r).max(), name


# ---------------------------------------------------------------------------
# The MIL pool's gate
# ---------------------------------------------------------------------------


def test_milpool_supports_is_the_wrappers_check():
    """The wrapper refuses exactly what ``milpool.supports`` refuses (meta
    tensors: an admitted shape goes on to the CUDA check)."""
    seen = set()
    for d in (8, 24, 96, 128, 1024, 1040, 1152):
        for h in (64, 96, 128, 256, 1152):
            x = torch.empty(2, 40, d, device="meta")
            w = [torch.empty(*s, device="meta") for s in ((d, h), (h,), (d, h), (h,), (h, 1), (1,))]
            refused = _refusal(milpool.fused_gated_mil_pool, x, None, *w)
            assert refused == (not milpool.supports(d, h, 40))
            seen.add(refused)
    assert seen == {True, False}


# (id, width D = H of GatedMILPool(dim), whether the port's kernel takes it,
#  whether the JAX module's takes it: milpool_eligible asks D % 128 == 0 and
#  H % 128 == 0, and has no upper limit on D)
POOL_CASES = [
    ("milpool-h96-refused", 96, False, False),      # H % 128 != 0
    ("milpool-d24-refused", 24, False, False),      # D % 16 != 0
    ("milpool-d1152-refused", 1152, False, True),   # D > 1024 (H = 1152 is whole packs)
    ("milpool-d128-kernel", 128, True, True),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_mil_pool_routes_follow_supports_and_match_jax(case, monkeypatch):
    """An eval pool over 256 positions: at a width the kernel refuses, the
    port takes the eager branch, as the JAX module takes XLA where its own
    kernel refuses; at one it takes, ``fused_gated_mil_pool`` (its plain
    version on the CPU). The JAX module runs its Pallas kernel (interpret
    mode) wherever ``milpool_eligible`` admits the width. Pooled rows and raw
    scores agree within 5e-5."""
    _, dim, kernel, jax_kernel = case
    assert milpool.supports(dim, dim, 256) == kernel
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(2, 256, dim)).astype(np.float32)
    mask = np.arange(256)[None] < np.array([256, 100])[:, None]
    jmodule = jblocks.GatedMILPool(dim=dim, use_pallas=True)
    params = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), True)["params"]
    monkeypatch.setattr(jmilpool, "_FORCE_KERNEL", True)
    before = dict(jmilpool.DISPATCH_COUNTS)
    jpooled, ja = jmodule.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), True)
    assert jmilpool.DISPATCH_COUNTS["kernel"] - before["kernel"] == int(jax_kernel)
    assert jmilpool.DISPATCH_COUNTS["xla"] - before["xla"] == int(not jax_kernel)
    calls = []
    inner = tblocks.fused_gated_mil_pool
    monkeypatch.setattr(tblocks, "fused_gated_mil_pool",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    module = load_jax_params(tblocks.GatedMILPool(dim), params).eval()
    with torch.no_grad():
        pooled, a = module(torch.from_numpy(x), torch.from_numpy(mask))
    assert len(calls) == int(kernel)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=MODEL_ATOL, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=MODEL_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# bfloat16 compute: the shapes no bfloat16 instance takes
# ---------------------------------------------------------------------------

# (id, embed width, heads, pre-gate, queries (None: self-attention), keys,
#  need_weights, the route the port takes, whether a bfloat16 instance takes it)
BF16_ROUTE_RTOL = 5e-2
BF16_CASES = [
    ("bf16-nacagat-medium", 256, 1, True, 6, 100, False, "fused_attention_leank", True),
    ("bf16-nacagat-small-ssq", 128, 1, True, 6, 100, "ssq", "fused_attention_leank", True),
    # NaCAGaT big: the E = F = 512 fuse-K and D = 512 export instances
    ("bf16-nacagat-big", 512, 1, True, 6, 100, False, "fused_attention_leank", True),
    ("bf16-nacagat-big-ssq", 512, 1, True, 6, 100, "ssq", "fused_attention_leank", True),
    # off the lean routes: the plain-K pair with values, its bfloat16 instance
    ("bf16-lean-false-width256-8heads", 2048, 8, False, 6, 100, False, "fused_attention", True),
    ("bf16-weights-6q", 256, 1, True, 6, 100, True, "attention_with_weights", True),
    # 50 signature groups (a Hallmark-sized signature file): the slab instances
    ("bf16-mcat-50-groups", 256, 1, False, 50, 100, False, "fused_attention", True),
    ("bf16-weights-50q", 256, 1, True, 50, 100, True, "attention_with_weights", True),
    ("bf16-weights-d512", 512, 1, True, 6, 100, True, "attention_with_weights", True),
    # GE's self-attentions: the flash kernels' bfloat16 instances, every size
    ("bf16-ge-width256", 256, 1, False, None, 64, False, "flash_attention", True),
    ("bf16-ge-width32", 256, 8, False, None, 64, False, "flash_attention", True),
    ("bf16-ge-small-width128", 128, 1, False, None, 64, False, "flash_attention", True),
    ("bf16-ge-small-width16", 128, 8, False, None, 64, False, "flash_attention", True),
    ("bf16-ge-big-width512", 512, 1, False, None, 64, False, "flash_attention", True),
    ("bf16-ge-big-width64", 512, 8, False, None, 64, False, "flash_attention", True),
]


@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_routes_follow_the_predicates_and_match_jax(case, monkeypatch):
    """Under a bfloat16 compute dtype the predicates, asked about bfloat16,
    send every shape without a bfloat16 instance to ``attention_core`` on
    the CPU (on the card such a shape raises before any launch where a
    float32 kernel takes it: the next test) and every shape with one to its
    kernel's route (GE's self-attentions at every size: the flash kernels'
    bfloat16 plain versions on the CPU), and the output (and the map, or
    ssq) matches the JAX module in float32 on the same weights and the same
    bfloat16 inputs within 5e-2 of its largest magnitude (measured up to
    3.4e-2: the q and k projections rounded to bfloat16, 2^-8 relative, move
    scores of magnitude up to ~10 by ~0.04, which exp turns into ~4% of a
    weight; the JAX module's own bfloat16 path rounds the scores too, so it
    is no closer)."""
    from multimodal_path_omic_tpu_torch.ops.layers import set_compute_dtype

    _, e, heads, pre_gate, n, m_len, need_weights, route, kernel = case
    rng = np.random.default_rng(e + heads + m_len)
    p = _params(e, rng)
    kv = rng.normal(size=(2, m_len, e)).astype(np.float32)
    query = kv if n is None else rng.normal(size=(2, n, e)).astype(np.float32)
    mask = np.arange(m_len)[None] < np.array([m_len - 7, 0])[:, None]
    module = set_compute_dtype(load_jax_params(
        tattention.MultiheadAttention(e, heads, pre_gate=pre_gate), p), torch.bfloat16).eval()
    calls = _spy_all(monkeypatch)
    tkv = torch.from_numpy(kv).to(torch.bfloat16)
    tq = tkv if n is None else torch.from_numpy(query).to(torch.bfloat16)
    with torch.no_grad():
        out, second = module(tq, tkv, tkv, torch.from_numpy(mask), need_weights=need_weights)
    assert out.dtype == torch.bfloat16
    assert calls[route] >= 1, calls
    if route == "attention_with_weights":
        assert calls["attention_core"] == int(not kernel), calls
    else:
        assert sum(calls.values()) == 1, calls
    d, bf16 = e // heads, torch.bfloat16
    if pre_gate and heads == 1 and need_weights is not True:
        assert coattn.fused_k_supports(n, e, e, m_len, train=need_weights == "ssq",
                                       dtype=bf16) == kernel
        assert coattn.fused_k_supports(n, e, e, m_len, train=need_weights == "ssq")  # float32
    if route == "attention_with_weights":
        assert coattn.plain_k_supports(n, d, m_len, values=False, dtype=bf16) == kernel
    if n is None:
        assert flash.supports(2, heads, m_len, d, dtype=bf16) == kernel and flash.supports(
            2, heads, m_len, d)
    if heads > 1 and n is not None:
        assert coattn.plain_k_supports(n, d, m_len, values=True, dtype=bf16) == kernel

    # the JAX module in float32 on the same (bfloat16) inputs
    jmodule = jattention.MultiheadAttention(embed_dim=e, num_heads=heads, pre_gate=pre_gate,
                                            use_pallas=True)
    jkv = jnp.asarray(tkv.float().numpy())
    jq = jkv if n is None else jnp.asarray(tq.float().numpy())
    jout, jsecond = jmodule.apply({"params": p}, jq, jkv, jkv, jnp.asarray(mask),
                                  need_weights=need_weights)
    pairs = [(out, jout)] + ([(second, jsecond)] if need_weights else [])
    for got, ref in pairs:
        got, ref = got.float().numpy(), np.asarray(ref)
        assert np.abs(got - ref).max() <= BF16_ROUTE_RTOL * np.abs(ref).max()


def _model_kernels_take(name, e, device, dtype):
    """Whether every attention kernel the model ``name`` reaches at width
    ``e`` takes its shapes in ``dtype`` on ``device`` (``kernels.takes``,
    which raises on the card for a bfloat16 shape without an instance):
    GE-NaCAGaT's flash kernels at its two head widths; NaCAGaT's fuse-K
    forms, export passes and (``lean=False``) plain-K pair; MCAT's export
    passes and plain-K pair (its lean branch runs no kernel)."""
    from multimodal_path_omic_tpu_torch.ops.kernels import takes

    if name == "GE-NaCAGaT":
        return all(takes("flash", flash.supports, device, 2, h, 64, e // h, dtype=dtype)
                   for h in (1, 8))
    took = [takes("export", coattn.plain_k_supports, device, 6, e, 100, values=False,
                  dtype=dtype),
            takes("plain-K", coattn.plain_k_supports, device, 6, e, 100, values=True,
                  dtype=dtype)]
    if name == "NaCAGaT":
        took += [takes("fuse-K", coattn.fused_k_supports, device, 6, e, e, 100, train=t,
                       dtype=dtype) for t in (False, True)]
    return all(took)


@pytest.mark.parametrize("device,refused", [("cuda", True), ("cpu", False)])
@pytest.mark.parametrize("name", ["GE-NaCAGaT", "NaCAGaT"])
def test_ge_bf16_is_refused_on_the_card(name, device, refused):
    """GE-NaCAGaT and NaCAGaT under bfloat16 compute are no longer refused on
    a CUDA device at any size: every kernel they reach takes its shapes in
    bfloat16 (the flash kernels at every head width, the co-attention
    kernels at E = F = D 128, 256 and 512, ``lean=False``'s plain-K pair
    among them), on the card and on the CPU (the plain versions), and so in
    float32. What the card still refuses under bfloat16 is a float32 shape
    without an instance, at the kernel, before any launch: the eval fuse-K
    form at E = 512, F = 256, which takes ``attention_core`` on the CPU.
    (The Trainer on the card: ``test_torch_port_cuda.py``.)"""
    from multimodal_path_omic_tpu_torch.ops.kernels import takes

    for e in (128, 256, 512):
        assert _model_kernels_take(name, e, device, torch.bfloat16)
    assert _model_kernels_take(name, 256, device, torch.float32)
    eval_e512_f256 = (6, 512, 256, 100)
    if refused:
        with pytest.raises(NotImplementedError, match="queue 2 item 5"):
            takes("fuse-K", coattn.fused_k_supports, device, *eval_e512_f256, train=False,
                  dtype=torch.bfloat16)
    else:
        assert not takes("fuse-K", coattn.fused_k_supports, device, *eval_e512_f256,
                         train=False, dtype=torch.bfloat16)


# (id, the kernel's predicate, its shape arguments, keywords): shapes that a
# float32 kernel takes and no bfloat16 instance does: the fuse-K eval form's
# float32-only (E, F) pairs
BF16_NO_INSTANCE = [
    ("bf16-eval-e512-f256", coattn.fused_k_supports, (6, 512, 256, 100), {"train": False}),
    ("bf16-eval-e128-f512", coattn.fused_k_supports, (6, 128, 512, 100), {"train": False}),
    ("bf16-eval-e256-f512", coattn.fused_k_supports, (6, 256, 512, 100), {"train": False}),
    ("bf16-eval-e256-f1024", coattn.fused_k_supports, (6, 256, 1024, 100), {"train": False}),
    ("bf16-eval-e512-f1024", coattn.fused_k_supports, (6, 512, 1024, 100), {"train": False}),
    ("bf16-eval-e128-f1024", coattn.fused_k_supports, (6, 128, 1024, 100), {"train": False}),
]


@pytest.mark.parametrize("case", BF16_NO_INSTANCE, ids=[c[0] for c in BF16_NO_INSTANCE])
def test_bf16_shapes_without_an_instance_raise_on_the_card(case):
    """``kernels.takes``, which the dispatchers ask: a bfloat16 shape that a
    float32 kernel takes but no bfloat16 instance does takes the plain route
    on the CPU and raises ``NotImplementedError`` (queue 2 item 5) on the
    card, where no plain version stands in for a kernel; a shape with a
    bfloat16 instance, and a float32 shape, take the kernel on both."""
    from multimodal_path_omic_tpu_torch.ops.kernels import takes

    _, supports, shape, kw = case
    assert supports(*shape, **kw) and not supports(*shape, dtype=torch.bfloat16, **kw)
    assert takes("k", supports, "cpu", *shape, dtype=torch.bfloat16, **kw) is False
    with pytest.raises(NotImplementedError, match="queue 2 item 5"):
        takes("k", supports, "cuda", *shape, dtype=torch.bfloat16, **kw)
    assert takes("k", supports, "cuda", *shape, dtype=torch.float32, **kw)
    assert takes("k", coattn.fused_k_supports, "cuda", 6, 256, 256, 100, train=True,
                 dtype=torch.bfloat16)
    # more queries than any kernel takes: the plain route in both types, no refusal
    assert not takes("k", coattn.fused_k_supports, "cuda", 9, 256, 256, 100, train=True,
                     dtype=torch.bfloat16)


@pytest.mark.parametrize("n", [9, 12, 33, 50, 256, 257])
def test_bf16_query_counts_never_raise_on_the_card(n):
    """``kernels.takes`` never raises for a bfloat16 query count that the
    float32 plain-K kernels take: the bfloat16 slab instances cover the same
    1..256, at every width, with values and for the export passes; 257 takes
    the plain route in both types, on the card and on the CPU."""
    from multimodal_path_omic_tpu_torch.ops.kernels import takes

    for d in (128, 256, 512):
        for values in (True, False):
            for device in ("cuda", "cpu"):
                took = takes("plain-K", coattn.plain_k_supports, device, n, d, 100,
                             values=values, dtype=torch.bfloat16)
                assert took == (n <= coattn.MAX_PLAIN_QUERIES)
                assert took == coattn.plain_k_supports(n, d, 100, values=values)


# the plain-K pair with values off the lean routes (``lean=False``), once
# without a bfloat16 instance: (id, head width)
BF16_LEAN_FALSE = [("bf16-lean-false-width256-8heads", 256), ("bf16-lean-false-width128", 128),
                   ("bf16-lean-false-width512", 512)]


@pytest.mark.parametrize("case", BF16_LEAN_FALSE, ids=[c[0] for c in BF16_LEAN_FALSE])
def test_bf16_lean_false_shapes_take_their_instances(case):
    """``kernels.takes`` on the plain-K forms with values in bfloat16: every
    shipped head width (D 128, 256, 512) has its bfloat16 instance, so the
    card takes the kernel and the CPU its plain version, as in float32."""
    from multimodal_path_omic_tpu_torch.ops.kernels import takes

    _, d = case
    for dtype in (torch.bfloat16, torch.float32):
        assert coattn.plain_k_supports(6, d, 100, values=True, dtype=dtype)
        for device in ("cuda", "cpu"):
            assert takes("plain-K", coattn.plain_k_supports, device, 6, d, 100, values=True,
                         dtype=dtype)


@pytest.mark.parametrize("name,size", [
    ("NaCAGaT", "small"), ("NaCAGaT", "medium"), ("NaCAGaT", "big"), ("MCAT", "big"),
])
def test_bf16_models_without_instances_are_refused_on_the_card(name, size):
    """Under bfloat16 compute the card would refuse a model whose kernels had
    no bfloat16 instance at its width (``kernels.takes``, before any launch);
    every size has them now (``big``: E = F = D = 512, ``lean=False``'s
    plain-K pair included), so each model's kernels take their shapes, on
    the card and on the CPU (the plain versions), in float32 as well."""
    from multimodal_path_omic_tpu_torch.models.common import MODEL_SIZES

    e = MODEL_SIZES[size][1]
    for dtype, device in ((torch.bfloat16, "cuda"), (torch.bfloat16, "cpu"),
                          (torch.float32, "cuda")):
        assert _model_kernels_take(name, e, device, dtype)
