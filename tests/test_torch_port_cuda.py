"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrappers' input checks, and the GPU Predictor against the CPU
one. Marked ``cuda``; every test skips where no CUDA device is present.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -p no:cacheprovider

Tolerance 1e-4 absolute (l: plus 1e-5 relative): float32 on both sides in
other summation orders; an indexing or masking fault moves outputs by O(1).
Gradients (the training backward kernel, the training step) are held to 1e-4
of each tensor's largest magnitude: dwk and dbk are sums over B*M terms, so
their absolute rounding error grows with them.
The weights w are held relative to themselves (1e-4, floor 1e-8 absolute):
a row sums to 1 over up to 4096 keys, so an absolute 1e-4 would pass a kernel
that wrote 0 for every small weight; the scores differ by ~1e-5 absolute
between the two summation orders, which exp turns into ~1e-5 relative in w.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_path_omic_tpu_torch.ops import coattn  # noqa: E402
from multimodal_path_omic_tpu_torch.serve import Predictor  # noqa: E402

pytestmark = pytest.mark.cuda
ATOL, L_RTOL = 1e-4, 1e-5
GRAD_RTOL = 1e-4
W_RTOL, W_ATOL = 1e-4, 1e-8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    from multimodal_path_omic_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _inputs(dev, b, n, e, m_len, f, seed):
    g = torch.Generator().manual_seed(seed)
    q = 0.7 * torch.randn(b, n, e, generator=g)
    kv = torch.relu(torch.randn(b, m_len, f, generator=g))
    wk = 0.7 * torch.randn(f, e, generator=g) / math.sqrt(f)
    bk = 0.1 * torch.randn(e, generator=g)
    k = 0.7 * torch.randn(b, m_len, e, generator=g)
    lengths = torch.randint(1, m_len + 1, (b,), generator=g)
    lengths[-1] = 0  # a fully-masked filler row
    mask = torch.arange(m_len)[None] < lengths[:, None]
    return [t.to(dev) for t in (q, kv, wk, bk, k, mask)]


def _close(got, ref, rtol=0.0, atol=ATOL):
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "b,n,e,m_len,f",
    [(2, 3, 128, 1000, 256), (4, 6, 256, 4096, 256), (3, 8, 256, 777, 1024), (1, 1, 256, 70, 256)],
)
def test_kernels_match_plain_on_card(dev, b, n, e, m_len, f):
    q, kv, wk, bk, k, mask = _inputs(dev, b, n, e, m_len, f, m_len)
    before = dict(coattn.LAUNCH_COUNTS)
    got = coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
    ref = coattn.coattn_fwd_fused_k_plain(q, kv, wk, bk, mask)
    for a, r, rtol in zip(got, ref, (0.0, L_RTOL, 0.0, 0.0)):
        _close(a, r, rtol)
    l, m = coattn.coattn_stats(q, k, mask)
    l_ref, m_ref = coattn.coattn_stats_plain(q, k, mask)
    _close(l, l_ref, L_RTOL)
    _close(m, m_ref)
    _close(coattn.coattn_weights(q, k, mask, l_ref, m_ref),
           coattn.coattn_weights_plain(q, k, mask, l_ref, m_ref), W_RTOL, W_ATOL)
    torch.cuda.synchronize()
    for k in ("coattn_fwd_fused_k", "coattn_stats", "coattn_weights"):
        assert coattn.LAUNCH_COUNTS[k] == before[k] + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, kv, wk, bk, k, mask = _inputs(dev, 2, 3, 256, 256, 256, 0)
    with pytest.raises(ValueError, match="queries"):
        coattn.coattn_stats(torch.zeros(2, 9, 256, device=dev), k, mask)
    with pytest.raises(TypeError):
        coattn.coattn_stats(q.double(), k.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattn_stats(q, k.transpose(1, 2).contiguous().transpose(1, 2), mask)
    with pytest.raises(ValueError, match="unsupported"):
        coattn.coattn_fwd_fused_k(torch.zeros(2, 3, 64, device=dev), kv, wk[:, :64].contiguous(),
                                  bk[:64].contiguous(), mask)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattn_stats(q, k.cpu(), mask)


@pytest.mark.parametrize("loss", ["ces", "cesar"])
def test_predictor_on_card_matches_cpu(dev, loss):
    rng = np.random.default_rng(0)
    sizes = (10, 20, 30)
    bags = [rng.standard_normal((n, 256), dtype=np.float32) for n in (300, 900, 450)]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in sizes] for _ in bags]
    kw = dict(omic_sizes=sizes, model_size="small", wsi_dim=256, buckets=(512, 1024),
              batch_size=2, loss=loss, seed=3)
    coattn.reset_launch_counts()
    got = Predictor(device=dev, **kw).predict_bags(bags, omics)
    counts = dict(coattn.LAUNCH_COUNTS)
    ref = Predictor(device="cpu", **kw).predict_bags(bags, omics)
    for key in ("hazards", "survs", "y", "risk"):
        np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0)
    if loss == "ces":
        assert counts["coattn_fwd_fused_k"] == 2 and counts["coattn_stats"] == 0
    else:
        assert counts["coattn_stats"] == 2 and counts["coattn_weights"] == 2


def _close_rel(got, ref, rtol=GRAD_RTOL):
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= rtol * ref.abs().max()


@pytest.mark.parametrize(
    "b,n,e,f,m_len,rate",
    [(2, 3, 128, 128, 1000, 0.25), (4, 6, 256, 256, 4096, 0.25), (3, 8, 128, 256, 333, 0.0),
     (1, 1, 256, 128, 70, 0.5)],
)
def test_training_kernels_match_plain_on_card(dev, b, n, e, f, m_len, rate):
    """The training forward (dropout, ssq, sumw, l, m) and the backward
    against their plain versions; two backward runs agree bitwise."""
    q, kv, wk, bk, _, mask = _inputs(dev, b, n, e, m_len, f, m_len)
    seed = torch.tensor([m_len * 7 + 1], dtype=torch.int32, device=dev)
    before = dict(coattn.LAUNCH_COUNTS)
    got = coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, rate)
    ref = coattn.coattn_fwd_fused_k_train_plain(q, kv, wk, bk, mask, seed, rate)
    for a, r, rtol in zip(got, ref, (0.0, L_RTOL, 0.0, 0.0, 0.0)):
        _close(a, r, rtol)
    o, l, m, ssq, sumw = got
    g = torch.Generator().manual_seed(m_len)
    dout = torch.randn(b, n, f, generator=g).to(dev)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    di = (o * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, kv, wk, bk, mask, seed, rate, dout, l, m, di, dssq, dsumw)
    grads = coattn.coattn_bwd_fused_k(*args)
    again = coattn.coattn_bwd_fused_k(*args)
    ref = coattn.coattn_bwd_fused_k_plain(q, kv, wk, bk, mask, seed, rate, dout, dssq, dsumw)
    for a, r in zip(grads, ref):
        _close_rel(a, r)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    torch.cuda.synchronize()
    assert coattn.LAUNCH_COUNTS["coattn_fwd_fused_k_train"] == before["coattn_fwd_fused_k_train"] + 1
    assert coattn.LAUNCH_COUNTS["coattn_bwd_fused_k"] == before["coattn_bwd_fused_k"] + 2


def test_leank_training_form_gradients_on_card(dev):
    """fused_attention_leank with dropout and ssq (the autograd Function over
    both kernels) against autograd through the plain training form."""
    q, kv, wk, bk, _, mask = _inputs(dev, 3, 6, 256, 900, 256, 5)
    seed = torch.tensor([11], dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(3)
    w_o = torch.randn(3, 6, 256, generator=g).to(dev)
    w_s, w_w = (torch.randn(3, 6, generator=g).to(dev) for _ in range(2))
    grads = []
    for fn in ("kernel", "plain"):
        ins = [t.clone().requires_grad_(True) for t in (q, kv, wk, bk)]
        if fn == "kernel":
            o, ssq, sumw = coattn.fused_attention_leank(
                *ins, mask, dropout_rate=0.25, dropout_seed=seed, need_ssq=True, need_sumw=True)
        else:
            o, _, _, ssq, sumw = coattn.coattn_fwd_fused_k_train_plain(*ins, mask, seed, 0.25)
        ((o * w_o).sum() + (ssq * w_s).sum() + (sumw * w_w).sum()).backward()
        grads.append([t.grad for t in ins])
    for a, r in zip(*grads):
        _close_rel(a, r)


def test_training_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, kv, wk, bk, _, mask = _inputs(dev, 2, 3, 256, 256, 256, 0)
    seed = torch.tensor([1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        coattn.coattn_fwd_fused_k_train(q, torch.zeros(2, 256, 512, device=dev),
                                        torch.zeros(512, 256, device=dev), bk, mask, seed, 0.25)
    with pytest.raises(TypeError):
        coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed.long(), 0.25)
    with pytest.raises(ValueError, match="rate"):
        coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, seed.cpu(), 0.25)


def test_train_step_on_card_matches_cpu(dev):
    """Three SGD steps of a small NaCAGaT (dropout 0, cesar) on the card and
    on the CPU from the same weights: the same parameters, the training
    kernels launched once each per step."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    rng = np.random.default_rng(0)
    sizes, m_len = (10, 20, 30), 700
    host = {
        "wsi": rng.standard_normal((4, m_len, 256), dtype=np.float32),
        "mask": np.arange(m_len)[None] < np.array([700, 500, 90, 0])[:, None],
        "omics": [rng.standard_normal((4, s), dtype=np.float32) for s in sizes],
        "label": np.array([0, 1, 2, 3]), "censorship": np.array([0.0, 1.0, 0.0, 1.0], np.float32),
        "weight": np.array([1.0, 1.0, 1.0, 0.0], np.float32),
    }
    params = {}
    for device in (dev, torch.device("cpu")):
        model = seeded_init_(build_model("NaCAGaT", omic_sizes=sizes, model_size="small",
                                         dropout=0.0, wsi_dim=256), 0).to(device)
        opt = make_optimizer("sgd", 0.1)
        state, step = init_train_state(model, opt, 0), make_train_step(model, "cesar", opt)
        batch = {k: ([torch.from_numpy(o).to(device) for o in v] if k == "omics"
                     else torch.from_numpy(v).to(device)) for k, v in host.items()}
        coattn.reset_launch_counts()
        for _ in range(3):
            state, metrics = step(state, batch)
        assert np.isfinite(float(metrics.loss))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert coattn.LAUNCH_COUNTS["coattn_fwd_fused_k_train"] == 3
            assert coattn.LAUNCH_COUNTS["coattn_bwd_fused_k"] == 3
        params[device.type] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for k, v in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][k].numpy(), v.numpy(), atol=ATOL, rtol=0)
