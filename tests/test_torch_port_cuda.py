"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrappers' input checks, and the GPU Predictor against the CPU
one. Marked ``cuda``; every test skips where no CUDA device is present.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -p no:cacheprovider

Tolerance 1e-4 absolute (l: plus 1e-5 relative): float32 on both sides in
other summation orders; an indexing or masking fault moves outputs by O(1).
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
    assert all(coattn.LAUNCH_COUNTS[k] == before[k] + 1 for k in before)


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
