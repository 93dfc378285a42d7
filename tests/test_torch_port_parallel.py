"""The port's mesh layer against the one-rank port and the JAX package: the
collectives of ``parallel/comm.py`` and their autograd adjoints, the ring
self-attention and the stat-merge cross-attention of ``parallel/ring.py``,
the seq-merged MIL pool (``ops/blocks.py``) and the per-rank co-attention
wrappers with the global bag index in the dropout counter (``bag0``,
``ops/coattn.py``).

Ranks are gloo processes on the CPU, spawned once per world size (2 and 4,
``torch_mesh_workers.run_world``): every case of a world runs in that one
spawn (``torch_mesh_jobs.parallel_cases``), each rank on its slice of the
same numpy inputs (rows by its data position, patches by its seq position);
the parent reassembles the slices. The mesh shapes: 1x2 and 2x1 (world 2),
1x4 and 2x2 (world 4). The JAX side runs its ``parallel/ring.py`` on a mesh
of the same shape over the conftest's CPU devices.

Tolerances: against the one-rank port 1e-5 of each tensor's largest
magnitude (other summation orders), where a tensor is a sum of the ranks'
partial gradients 1e-5 of the largest partial (a sum that cancels to nearly
zero, as a softmax bias' gradient does, keeps its terms' rounding); against
JAX 5e-5 absolute (the port's parity bar); dropout cases draw the one-rank
call's masks (the same zeros) and meet the same bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from multimodal_path_omic_tpu.ops import blocks as jblocks  # noqa: E402
from multimodal_path_omic_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodal_path_omic_tpu.parallel import ring as jring  # noqa: E402
from multimodal_path_omic_tpu_torch.ops import coattn as tcoattn  # noqa: E402
from multimodal_path_omic_tpu_torch.ops.attention import attention_core  # noqa: E402
from multimodal_path_omic_tpu_torch.ops.blocks import GatedMILPool  # noqa: E402
from multimodal_path_omic_tpu_torch.parallel.ring import _ring_chunk_size  # noqa: E402

from torch_mesh_jobs import attn_inputs, rng_array  # noqa: E402
from torch_mesh_workers import run_world  # noqa: E402

JAX_ATOL = 5e-5
SHAPES = {"1x2": (2, 1, 2), "2x1": (2, 2, 1), "1x4": (4, 1, 4), "2x2": (4, 2, 2)}
SEQ_TAGS = ("1x2", "1x4", "2x2")


@pytest.fixture(scope="module")
def runs():
    """Each world's per-rank results, spawned once."""
    return {w: run_world("parallel_cases", w, 0) for w in (2, 4)}


def _case(runs, tag, name):
    world = SHAPES[tag][0]
    return [r[name] for r in runs[world]]


def _join(parts, tag, row_axis=0, patch_axis=None):
    """Reassemble per-rank slices (ranks data-major) into the global tensor."""
    _, data, seq = SHAPES[tag]
    rows = []
    for d in range(data):
        seg = [parts[d * seq + s] for s in range(seq)]
        rows.append(torch.cat(seg, dim=patch_axis) if patch_axis is not None else seg[0])
    return torch.cat(rows, dim=row_axis)


def _near_port(got, ref, what, parts=()):
    """|got - ref| <= 1e-5 of ref's largest magnitude, or of the largest
    of the per-rank ``parts`` that ``got`` sums (a sum that cancels to
    nearly zero keeps the rounding of its terms)."""
    ref = ref.detach()
    scale = max([float(ref.abs().max()), 1e-6] + [float(p.abs().max()) for p in parts])
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * scale, f"{what}: {err} > {1e-5 * scale}"


def _near_jax(got, ref, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=JAX_ATOL, rtol=0,
                               err_msg=what)


def _jmesh(tag):
    _, data, seq = SHAPES[tag]
    return jmesh.make_mesh(data=data, seq=seq)


# ----------------------------------------------------------------- collectives


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_their_adjoints(runs, world):
    """sum / gather forward on every rank, and their backward the adjoint:
    sum_r <f(x)_r, y_r> == sum_r <x_r, f^T(y)_r>; max, the ring shift and
    the uneven byte all-to-all move what they say."""
    res = [r["comm"] for r in runs[world]]
    xs = [torch.from_numpy(rng_array(100 + r, (3, 4))) for r in range(world)]
    out_sums = {}
    for name in ("sum", "gather"):
        ys = [torch.from_numpy(rng_array(200 + r, tuple(res[r][name][0].shape)))
              for r in range(world)]
        want = sum(xs) if name == "sum" else torch.cat(xs, dim=1)
        for r in range(world):
            torch.testing.assert_close(res[r][name][0], want, rtol=0, atol=1e-6)
        lhs = sum(float((res[r][name][0] * ys[r]).sum()) for r in range(world))
        rhs = sum(float((xs[r] * res[r][name][1]).sum()) for r in range(world))
        out_sums[name] = (lhs, rhs)
        total = sum(ys)
        for r in range(world):
            want_g = total if name == "sum" else total[:, 4 * r:4 * (r + 1)]
            torch.testing.assert_close(res[r][name][1], want_g, rtol=0, atol=1e-6)
        assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs)), (name, lhs, rhs)
    vals = [torch.from_numpy(rng_array(300 + r, (5,))) for r in range(world)]
    for r in range(world):
        assert torch.equal(res[r]["max"], torch.stack(vals).amax(dim=0))
        assert torch.equal(res[r]["shift"], vals[(r - 1) % world])
        for j, got in enumerate(res[r]["a2a"]):  # rank j sent r + 1 rows of 10 j + r
            assert torch.equal(got, torch.full((j + 1, 2), float(10 * j + r)))


# ------------------------------------------------------------------------ ring


def _ring_reference(q, k, v, mask, dout):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    o, _ = attention_core(qt, kt, vt, torch.from_numpy(mask), pre_gate=False,
                          need_weights=False)
    (o * torch.from_numpy(dout)).sum().backward()
    return o.detach(), [t.grad for t in (qt, kt, vt)]


@pytest.mark.parametrize("tag", SEQ_TAGS)
def test_ring_self_attention(runs, tag):
    """Forward and dq, dk, dv of the ring at seq 2 and 4 (a bag without a
    valid key in shard 0, a bag without any), against the unsharded
    attention and JAX's ring on the same mesh shape."""
    _, data, seq = SHAPES[tag]
    b, h, m, d = 2, 2, 64 * seq, 8
    q, k, v, mask = attn_inputs(0, b, h, m, m, d, seq)
    dout = rng_array(9, (b, h, m, d))
    res = _case(runs, tag, f"ring/{tag}")
    o = _join([r["o"] for r in res], tag, 0, 2)
    grads = [_join([r["grads"][i] for r in res], tag, 0, 2) for i in range(3)]
    ref_o, ref_g = _ring_reference(q, k, v, mask, dout)
    _near_port(o, ref_o, "o")
    for name, got, ref in zip("qkv", grads, ref_g):
        _near_port(got, ref, f"d{name}")
    mesh = _jmesh(tag)
    jmask = jnp.asarray(mask)

    def jloss(q_, k_, v_):
        return (jring.ring_self_attention(q_, k_, v_, jmask, mesh) * dout).sum()

    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jo = jax.jit(lambda *a: jring.ring_self_attention(*a, jmask, mesh))(*jargs)
    _near_jax(o, jo, "o vs JAX")
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jargs)
    for name, got, ref in zip("qkv", grads, jg):
        _near_jax(got, ref, f"d{name} vs JAX")


def test_ring_backward_holds_no_whole_step_block(runs):
    """At Ml = 1024 local patches (seq 2) the largest product of the ring's
    forward and backward is a [512, 1024] query chunk's scores, never the
    [1024, 1024] block of a whole step (JAX tests/test_parallel.py:1022)."""
    ml = 1024
    res = _case(runs, "1x2", "ring_memory/1x2")
    qc = _ring_chunk_size(ml)
    assert qc == 512
    for r in res:
        assert 0 < r["peak"] <= qc * ml < ml * ml
    q, k, v, mask = attn_inputs(0, 1, 1, 2048, 2048, 8, 2)
    ref_o, ref_g = _ring_reference(q, k, v, mask, rng_array(9, (1, 1, 2048, 8)))
    _near_port(_join([r["o"] for r in res], "1x2", 0, 2), ref_o, "o")
    _near_port(_join([r["grads"][1] for r in res], "1x2", 0, 2), ref_g[1], "dk")


# ----------------------------------------------------------- cross-attention


def _cross_reference(q, k, v, mask, dout, pre_gate, ssq, rate=0.0, seed=0, philox=True):
    """The one-rank routes: no dropout and the mask draw through
    ``attention_core`` (the generator's keep mask), the counter draw through
    the plain-K training form on the folded heads."""
    b, h, n, d = q.shape
    qt, kt, vt = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    gen = torch.Generator().manual_seed(seed)
    mt = torch.from_numpy(mask)
    if rate > 0.0 and philox:
        seed_t = torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32)
        fold = [t.reshape(b * h, t.shape[2], d) for t in (qt, kt, vt)]
        o, _, _, s, _ = tcoattn.coattn_fwd_plain_k_plain(
            *fold, mt.repeat_interleave(h, dim=0), seed_t, rate, pre_gate=pre_gate)
        o, s = o.reshape(b, h, n, d), s.reshape(b, h, n)
    else:
        o, w = attention_core(qt, kt, vt, mt, pre_gate=pre_gate, need_weights=True,
                              dropout_rate=rate, generator=gen)
        s = (w * w).sum(dim=-1)
    loss = (o * torch.from_numpy(dout)).sum() + (s.sum() if ssq else 0.0)
    loss.backward()
    return o.detach(), s.detach(), [t.grad for t in (qt, kt, vt)]


@pytest.mark.parametrize("tag", SEQ_TAGS)
@pytest.mark.parametrize("pre_gate,ssq", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_sequence_parallel_cross_attention(runs, tag, pre_gate, ssq):
    """Stat-merged cross-attention with and without the pre-gate and ssq:
    forward and gradients against the unsharded attention and JAX's
    ``sequence_parallel_cross_attention`` on the same mesh shape."""
    _, data, seq = SHAPES[tag]
    q, k, v, mask = attn_inputs(0, 4, 2, 6, 64, 16, seq)
    dout = rng_array(9, (4, 2, 6, 16))
    res = _case(runs, tag, f"cross/{tag}/pg{int(pre_gate)}/ssq{int(ssq)}")
    # outputs are the same on every seq rank: the seq-0 ranks' rows
    o = _join([r["o"] for r in res], tag)
    grads = [_join([r["grads"][i] for r in res], tag, 0, 2) for i in (1, 2)]
    ref_o, ref_s, ref_g = _cross_reference(q, k, v, mask, dout, pre_gate, ssq)
    _near_port(o, ref_o, "o")
    if ssq:
        _near_port(_join([r["ssq"] for r in res], tag), ref_s, "ssq")
    # dq: each seq rank holds the part from its keys; they sum to the whole
    dq_parts = [torch.cat([res[dd * seq + s]["grads"][0] for dd in range(data)])
                for s in range(seq)]
    dq = sum(dq_parts)
    _near_port(dq, ref_g[0], "dq", dq_parts)
    for name, got, ref in zip("kv", grads, ref_g[1:]):
        _near_port(got, ref, f"d{name}")
    mesh = _jmesh(tag)
    jargs = tuple(jnp.asarray(t) for t in (q, k, v))

    def jfn(q_, k_, v_):
        return jring.sequence_parallel_cross_attention(
            q_, k_, v_, jnp.asarray(mask), mesh, pre_gate=pre_gate, need_ssq=ssq)

    def jloss(*a):
        res_ = jfn(*a)
        return (res_[0] * dout).sum() + res_[1].sum() if ssq else (res_ * dout).sum()

    jres = jax.jit(jfn)(*jargs)
    _near_jax(o, jres[0] if ssq else jres, "o vs JAX")
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jargs)
    _near_jax(dq, jg[0], "dq vs JAX")
    for name, got, ref in zip("kv", grads, jg[1:]):
        _near_jax(got, ref, f"d{name} vs JAX")


@pytest.mark.parametrize("tag", SEQ_TAGS)
@pytest.mark.parametrize("philox", [True, False], ids=["counter", "keep-mask"])
def test_cross_attention_dropout_draws_the_one_rank_masks(runs, tag, philox):
    """With dropout 0.25 the split call drops what the one-rank route drops
    (the kernels' counter at the global bag and key index, or the
    generator's global keep mask sliced): out, ssq and the gradients."""
    _, data, seq = SHAPES[tag]
    q, k, v, mask = attn_inputs(0, 4, 2, 6, 64, 16, seq)
    res = _case(runs, tag, f"cross_dropout/{tag}/philox{int(philox)}")
    ref_o, ref_s, ref_g = _cross_reference(q, k, v, mask, rng_array(9, (4, 2, 6, 16)), True,
                                           True, rate=0.25, seed=0, philox=philox)
    _near_port(_join([r["o"] for r in res], tag), ref_o, "o")
    _near_port(_join([r["ssq"] for r in res], tag), ref_s, "ssq")
    for i, name in ((1, "dk"), (2, "dv")):
        _near_port(_join([r["grads"][i] for r in res], tag, 0, 2), ref_g[i], name)


# ------------------------------------------------------------------ MIL pool


def _pool_reference(training):
    pool = GatedMILPool(16, dropout_rate=0.25)
    torch.manual_seed(0)
    for p in pool.parameters():
        torch.nn.init.normal_(p, std=0.3)
    pool.train(training)
    x = torch.from_numpy(rng_array(1, (4, 64, 16))).requires_grad_(True)
    return pool, x


@pytest.mark.parametrize("tag", SEQ_TAGS)
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_seq_merged_mil_pool(runs, tag, training):
    """The gated MIL pool over a split patch axis (local max, its max over
    the seq group, the sums of exp and of the weighted rows): pooled, raw
    scores, dx and the parameter gradients against the unsharded pool (in
    training with the same dropout masks), and in eval against JAX's
    ``GatedMILPool`` with the mesh."""
    _, data, seq = SHAPES[tag]
    res = _case(runs, tag, f"pool/{tag}/train{int(training)}")
    mask = attn_inputs(0, 4, 1, 1, 64, 1, seq)[3]
    pool, x = _pool_reference(training)
    pooled, a = pool(x, torch.from_numpy(mask), torch.Generator().manual_seed(0))
    (pooled * torch.from_numpy(rng_array(2, (4, 16)))).sum().backward()
    _near_port(_join([r["pooled"] for r in res], tag), pooled, "pooled")
    _near_port(_join([r["a"] for r in res], tag, 0, 2), a, "scores")
    _near_port(_join([r["dx"] for r in res], tag, 0, 1), x.grad, "dx")
    for name, p in pool.named_parameters():
        # before the merge each rank's part of the patches, after it each
        # seq rank's share: the world's sum is the gradient
        parts = [r["grads"][name] for r in res]
        _near_port(sum(parts), p.grad, name, parts)
    if training:
        return
    params = {"attention_head": {n: {"kernel": jnp.asarray(getattr(pool.attention_head, n)
                                                          .weight.detach().numpy().T),
                                     "bias": jnp.asarray(getattr(pool.attention_head, n)
                                                         .bias.detach().numpy())}
                                 for n in ("attention_a", "attention_b", "attention_c")},
              "rho": {"kernel": jnp.asarray(pool.rho.weight.detach().numpy().T),
                      "bias": jnp.asarray(pool.rho.bias.detach().numpy())}}
    mesh = _jmesh(tag)
    jpool = jblocks.GatedMILPool(dim=16, dropout_rate=0.25, ring_mesh=mesh)
    put = lambda t, spec: jax.device_put(jnp.asarray(t), NamedSharding(mesh, spec))  # noqa: E731
    jp, ja = jax.jit(lambda p_, x_, m_: jpool.apply({"params": p_}, x_, m_))(
        params, put(x.detach().numpy(), P("data", "seq", None)), put(mask, P("data", "seq")))
    _near_jax(_join([r["pooled"] for r in res], tag), jp, "pooled vs JAX")
    _near_jax(_join([r["a"] for r in res], tag, 0, 2), ja, "scores vs JAX")


# ------------------------------------------------------- per-rank kernel wrappers


@pytest.mark.parametrize("tag", ["2x1", "2x2"])
def test_sharded_kernel_wrappers_take_the_global_bag_index(runs, tag):
    """``fused_attention_sharded`` (plain-K training form, pre-gated) and
    ``fused_attention_leank_sharded`` (fuse-K training form) with dropout
    0.25 on each rank's rows equal the one-rank calls' rows: the counter's
    ``bag0`` (the global index of the rank's first row) makes every rank
    draw the one-rank bits; out, ssq, sumw and the gradients."""
    _, data, seq = SHAPES[tag]
    res = _case(runs, tag, f"sharded_kernels/{tag}")
    pick = [res[d * seq] for d in range(data)]  # seq ranks hold the same rows
    b, h, n, m, d = 4, 1, 6, 96, 128
    q, k, v, mask = attn_inputs(0, b, h, n, m, d, 1)
    qt, kt, vt = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    o, ssq = tcoattn.fused_attention(qt, kt, vt, torch.from_numpy(mask), pre_gate=True,
                                     dropout_rate=0.25,
                                     generator=torch.Generator().manual_seed(0), need_ssq=True)
    (o.sum() + ssq.sum()).backward()

    def cat(key, i=None):
        return torch.cat([r[key] if i is None else r[key][i] for r in pick])

    _near_port(cat("plain_o"), o, "plain-K o")
    _near_port(cat("plain_ssq"), ssq, "plain-K ssq")
    for i, t in enumerate((qt, kt, vt)):
        _near_port(cat("plain_grads", i), t.grad, f"plain-K grad {i}")
    kv = torch.from_numpy(rng_array(5, (b, m, 64))).requires_grad_(True)
    wk = torch.from_numpy(rng_array(6, (64, d), 0.1)).requires_grad_(True)
    bk = torch.from_numpy(rng_array(7, (d,), 0.1)).requires_grad_(True)
    qf = torch.from_numpy(np.ascontiguousarray(q[:, 0])).requires_grad_(True)
    o2, s2, w2 = tcoattn.fused_attention_leank(
        qf, kv, wk, bk, torch.from_numpy(mask), dropout_rate=0.25,
        dropout_seed=torch.tensor([1234], dtype=torch.int32), need_ssq=True, need_sumw=True)
    (o2.sum() + s2.sum() + w2.sum()).backward()
    _near_port(cat("leank_o"), o2, "fuse-K o")
    _near_port(cat("leank_ssq"), s2, "fuse-K ssq")
    _near_port(cat("leank_sumw"), w2, "fuse-K sumw")
    _near_port(cat("leank_grads", 0), qf.grad, "fuse-K dq")
    _near_port(cat("leank_grads", 1), kv.grad, "fuse-K dkv")
    for i, t in ((2, wk), (3, bk)):  # every rank's partial sums to the whole
        parts = [r["leank_grads"][i] for r in pick]
        _near_port(sum(parts), t.grad, f"fuse-K grad {i}", parts)


def test_dropout_bits_offsets_are_the_global_bits():
    """``dropout_bits`` at ``bag0`` and ``key0`` is the slice of the
    one-call bits: bags [bag0, bag0 + B), keys [key0, key0 + M)."""
    seed = torch.tensor([77], dtype=torch.int32)
    full = tcoattn.dropout_bits(seed, (6, 3, 40), "cpu")
    part = tcoattn.dropout_bits(seed, (3, 3, 16), "cpu", bag0=2, key0=24)
    assert torch.equal(part, full[2:5, :, 24:40])


def test_take_rows_sharded_gathers_the_local_chunk():
    """The gather of a mesh rank's cache slice is the kernel's (on the CPU
    its plain version) on the local [N, bucket / size, D] pool, with the
    whole batch's indices; ``sharded_supported`` is the kernel's predicate
    on that slice (rows of a multiple of 16 bytes, 1 to 65535 indices)."""
    from multimodal_path_omic_tpu_torch.ops import gather as tgather

    pool = torch.from_numpy(rng_array(0, (5, 16, 8)))
    idx = torch.tensor([4, 0, 4])
    assert torch.equal(tgather.take_rows_sharded(pool, idx, None), pool[idx])
    assert tgather.sharded_supported(pool, idx, None)
    assert not tgather.sharded_supported(pool[:, :3, :1].contiguous(), idx, None)  # 12 bytes
    assert not tgather.sharded_supported(pool, idx[:0], None)
