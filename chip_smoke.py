#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its NaCAGaT serving path on one GPU.

    python3 chip_smoke.py              # phases 1-3 below
    python3 chip_smoke.py --profile    # where one predict_bags call's time goes

Phases (any failure exits non-zero, and no result line is printed):

1. Build every kernel from ``multimodal_path_omic_tpu_torch/csrc`` with nvcc
   (sm_90a), then hold each kernel against its plain PyTorch version on the
   card at the serving shapes (B=32 bags, N=6 queries, E=256, M up to 8192,
   ragged masks, one fully-masked row, a non-tile-multiple M).
2. The NaCAGaT ``Predictor`` at full width (``medium``, 1024-wide patch
   features, six signatures of 100..600 genes, buckets 4096/8192, batch 32,
   random weights from a seed) through ``predict_bags`` and ``predict_bag``,
   once with ``loss="ces"`` (lean-V: fuse-K forward kernel) and once with
   ``loss="cesar"`` (export: stats + weights kernels). Launch counts are
   reset just before and read just after; every kernel must have launched.
   Outputs must be finite and match the same Predictor on the CPU (plain
   versions) on a few bags.
3. Timings with CUDA events: each kernel, its plain version and its bound;
   ``predict_bags`` bags/s.

Output: phase lines, a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``. Imports nothing of
JAX; runs only where CUDA is available and the port package sits beside it.

``--profile`` runs none of the phases. It builds the kernels, warms the
phase-2 Predictor for each loss on the same bags, and traces one
``predict_bags`` call with ``torch.profiler``: device time by kernel / copy
name, wall time and the device busy share (summed device time over wall
time), then one JSON line per loss with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores (the kernels run float32 FMAs for parity).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

B, N, E = 32, 6, 256
SIZES = (100, 200, 300, 400, 500, 600)
BUCKETS = (4096, 8192)
N_BAGS = 40
SOURCE = "multimodal_path_omic_tpu_torch/csrc/coattn.cu"
# kernel name -> the TPU kernel's function reaching pallas_call
REPLACES = {
    "coattn_fwd_fused_k": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_stats": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_weights": "multimodal_path_omic_tpu/ops/coattn.py:908",
}
# the kernels each serving loss must launch (and no other)
WANT = {"ces": ("coattn_fwd_fused_k",), "cesar": ("coattn_stats", "coattn_weights")}
# kernel vs plain version on the card: both float32, other summation
# orders (per-tile online softmax and split merges vs one pass through
# cuBLAS); outputs of magnitude ~1 move by ~1e-6, so 1e-4 absolute leaves
# room while catching any indexing or masking fault (those move outputs by
# O(1)). l is a sum of up to M terms: relative 1e-5.
KERNEL_ATOL = 1e-4
L_RTOL = 1e-5
# The weights w are held relative to themselves: a row sums to 1 over up to
# 8192 keys, so most weights lie far below any useful absolute limit, and a
# kernel that wrote 0 (or any wrong value) for every small weight would pass
# 1e-4 absolute. The scores differ by ~1e-5 absolute between the two summation
# orders (the gate sums 256 products of magnitude ~1), and exp turns that into
# a ~1e-5 relative error of w: relative 1e-4, with a floor of 1e-8 absolute
# only for weights that small (1e-4 of the smallest mean weight 1/8192).
W_RTOL, W_ATOL = 1e-4, 1e-8
# GPU Predictor vs CPU Predictor (plain versions, other BLAS): 1e-4 on
# hazards / survs / y / risk.
MODEL_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def check_close(name, got, ref, atol, rtol=0.0) -> float:
    import torch

    err = max_err(got, ref)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    excess = ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()
    ok = excess <= 1.0
    log(f"  {name}: max_abs_err={err:.3e} (tolerance {atol:g} abs + {rtol:g} rel; "
        f"worst element at {excess:.3f} of it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def make_inputs(m_len, f_dim, seed, dev):
    """Serving-like inputs: projected queries and keys of NaCAGaT's scale
    (std ~0.7: ELU / ReLU activations through a xavier-initialized [256, 256]
    projection), ReLU patch embeddings as kv, ragged key masks, the last bag
    fully masked (a filler row)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = 0.7 * torch.randn(B, N, E, generator=g)
    kv = torch.relu(torch.randn(B, m_len, f_dim, generator=g))
    wk = 0.7 * torch.randn(f_dim, E, generator=g) / math.sqrt(f_dim)
    bk = 0.1 * torch.randn(E, generator=g)
    k = 0.7 * torch.randn(B, m_len, E, generator=g)
    lengths = torch.randint(m_len // 5, m_len + 1, (B,), generator=g)
    lengths[0] = m_len
    lengths[-1] = 0
    mask = torch.arange(m_len)[None, :] < lengths[:, None]
    return [t.to(dev) for t in (q, kv, wk, bk, k, mask)]


def phase1_kernels(dev) -> dict:
    from multimodal_path_omic_tpu_torch.ops import coattn

    errs = {name: 0.0 for name in REPLACES}
    for m_len, f_dim in ((8192, 256), (4096, 256), (4000, 256), (4096, 1024)):
        log(f"phase 1: B={B} N={N} E={E} M={m_len} F={f_dim}")
        q, kv, wk, bk, k, mask = make_inputs(m_len, f_dim, m_len + f_dim, dev)
        got = coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
        ref = coattn.coattn_fwd_fused_k_plain(q, kv, wk, bk, mask)
        e = 0.0
        for name, a, b, rtol in zip(("o", "l", "m", "sumw"), got, ref,
                                    (0.0, L_RTOL, 0.0, 0.0)):
            err = check_close(f"fused_k.{name}", a, b, KERNEL_ATOL, rtol)
            if name != "l":
                e = max(e, err)
        errs["coattn_fwd_fused_k"] = max(errs["coattn_fwd_fused_k"], e)
        if f_dim != E:
            continue  # the plain-K forms take k [B, M, E]
        l, m = coattn.coattn_stats(q, k, mask, pre_gate=True)
        l_ref, m_ref = coattn.coattn_stats_plain(q, k, mask, pre_gate=True)
        check_close("stats.l", l, l_ref, KERNEL_ATOL, L_RTOL)
        errs["coattn_stats"] = max(errs["coattn_stats"],
                                   check_close("stats.m", m, m_ref, KERNEL_ATOL))
        w = coattn.coattn_weights(q, k, mask, l_ref, m_ref, pre_gate=True)
        w_ref = coattn.coattn_weights_plain(q, k, mask, l_ref, m_ref, pre_gate=True)
        errs["coattn_weights"] = max(errs["coattn_weights"],
                                     check_close("weights.w", w, w_ref, W_ATOL, W_RTOL))
        # the fully-masked filler row: uniform over its M keys, never NaN
        check_close("weights.filler_row", w[-1], w_ref.new_full(w[-1].shape, 1.0 / w.shape[-1]),
                    W_ATOL, W_RTOL)
    return errs


def make_bags(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1500, 8193, size=N_BAGS)
    bags = [rng.standard_normal((int(n), 1024), dtype=np.float32) for n in lengths]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in SIZES] for _ in bags]
    return bags, omics


def make_predictor(dev, loss, batch_size=B):
    """The serving configuration: NaCAGaT medium, random weights from seed 0."""
    from multimodal_path_omic_tpu_torch.serve import Predictor

    return Predictor("NaCAGaT", omic_sizes=SIZES, model_size="medium",
                     buckets=BUCKETS, batch_size=batch_size, loss=loss, seed=0, device=dev)


def phase2_predictor(dev, bags, omics) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    launches = {name: 0 for name in REPLACES}
    results = {}
    for loss in ("ces", "cesar"):
        log(f"phase 2: NaCAGaT medium Predictor, loss={loss}, {len(bags)} bags, "
            f"buckets {BUCKETS}, batch_size {B}")
        pred = make_predictor(dev, loss)
        coattn.reset_launch_counts()
        out = pred.predict_bags(bags, omics)
        single = pred.predict_bag(bags[1], omics[1])
        torch.cuda.synchronize()
        counts = dict(coattn.LAUNCH_COUNTS)
        log(f"  launches: {counts}")
        for name, c in counts.items():
            launches[name] += c
            if (name in WANT[loss]) != (c > 0):
                raise AssertionError(f"{loss}: kernel {name} launched {c} times")
        for k, v in out.items():
            if not np.isfinite(v).all():
                raise AssertionError(f"{loss}: non-finite {k}")
        assert out["risk"].shape == (len(bags),) and out["hazards"].shape == (len(bags), 4)
        log(f"  risk over {len(bags)} bags: min {out['risk'].min():.6f} max "
            f"{out['risk'].max():.6f} std {out['risk'].std():.3e}")
        # row order: predict_bag on bag 1 alone equals row 1
        d = float(np.abs(single["risk"] - out["risk"][1:2]).max())
        log(f"  predict_bag vs predict_bags row 1: |risk diff| = {d:.3e}")
        if d > MODEL_ATOL:
            raise AssertionError("predict_bag and predict_bags disagree")
        # against the plain path: the same Predictor (same seed) on the CPU
        cpu = make_predictor("cpu", loss, batch_size=4)
        idx = [0, 1, 2]
        ref = cpu.predict_bags([bags[i] for i in idx], [omics[i] for i in idx])
        for k in ("hazards", "survs", "y", "risk"):
            err = float(np.abs(out[k][idx] - ref[k]).max())
            log(f"  {k} vs CPU plain path: max_abs_err={err:.3e} (tolerance {MODEL_ATOL:g})")
            if err > MODEL_ATOL:
                raise AssertionError(f"{loss}: {k} disagrees with the CPU plain path")
        results[loss] = pred
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    log(f"phase 2: kernels launched per loss as expected ({WANT})")
    return {"launches": launches, "predictors": results}


def bound_ms(name, m_len, f_dim) -> tuple:
    """(bound ms, 'bytes' | 'operations'): each input read once, each output
    written once; float32 multiply-adds counted as 2 operations."""
    if name == "coattn_fwd_fused_k":
        nbytes = 4 * (B * N * E + B * m_len * f_dim + f_dim * E + E + B * N * f_dim
                      + 3 * B * N) + B * m_len
        ops = 2 * B * m_len * f_dim * E + 4 * B * N * m_len * E + 2 * B * N * m_len * f_dim
    else:
        out = 2 * B * N if name == "coattn_stats" else B * N * m_len
        nbytes = 4 * (B * N * E + B * m_len * E + out) + B * m_len
        if name == "coattn_weights":
            nbytes += 4 * 2 * B * N  # l, m in
        ops = 4 * B * N * m_len * E
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase3_timings(dev, errs, launches, predictors, bags, omics) -> list:
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    m_len = 8192
    q, kv, wk, bk, k, mask = make_inputs(m_len, E, 7, dev)
    l, m = coattn.coattn_stats_plain(q, k, mask)
    calls = {
        "coattn_fwd_fused_k": (lambda: coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask),
                               lambda: coattn.coattn_fwd_fused_k_plain(q, kv, wk, bk, mask)),
        "coattn_stats": (lambda: coattn.coattn_stats(q, k, mask),
                         lambda: coattn.coattn_stats_plain(q, k, mask)),
        "coattn_weights": (lambda: coattn.coattn_weights(q, k, mask, l, m),
                           lambda: coattn.coattn_weights_plain(q, k, mask, l, m)),
    }
    rows = []
    for name, (kern, plain) in calls.items():
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        bms, by = bound_ms(name, m_len, E)
        log(f"phase 3: {name} B={B} N={N} M={m_len} F=E={E}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes a pre-gated (tanh-gated) attention
            "library_ms": None,
        })
    for loss, pred in predictors.items():
        pred.predict_bags(bags, omics)  # warm
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict_bags(bags, omics)
            torch.cuda.synchronize()
            rates.append(len(bags) / (time.perf_counter() - t0))
        log(f"phase 3: predict_bags loss={loss}: {len(bags)} bags, 3 calls: "
            f"{', '.join(repr(r) for r in rates)} bags/s (host clock, batches of {B}, "
            f"buckets {BUCKETS})")
    return rows


def profile_serving(dev, loss, bags, omics, top=15) -> None:
    import torch

    pred = make_predictor(dev, loss)
    pred.predict_bags(bags, omics)  # warm: library load, cuBLAS handles, allocator
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred.predict_bags(bags, omics)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy, memset): the host-side aten
    # ops also carry their kernels' device time and would count it twice
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    log(f"profile: loss={loss}; {len(bags)} bags; wall {wall_ms:.3f} ms; "
        f"device {device_ms:.3f} ms; busy share {device_ms / wall_ms:.4f}")
    for name, ms, count in rows[:top]:
        log(f"  {ms:10.4f} ms  x{count:<5d} {name[:100]}")
    log(json.dumps({
        "loss": loss, "bags": len(bags), "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in rows[:top]],
    }))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one predict_bags call per loss instead of phases 1-3")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    try:
        from multimodal_path_omic_tpu_torch.device import resolve_device
        from multimodal_path_omic_tpu_torch.ops import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing beside this script ({exc})",
              file=sys.stderr)
        return 2

    dev = resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {sorted(kernels.SIGNATURES)} in {time.perf_counter() - t0:.1f} s "
        f"into {kernels.BUILD_DIR}")
    for name, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc[{name}]: {line.strip()}")

    bags, omics = make_bags(0)
    if args.profile:
        for loss in WANT:
            profile_serving(dev, loss, bags, omics)
        log(gpu_name_and_power())
        return 0
    errs = phase1_kernels(dev)
    p2 = phase2_predictor(dev, bags, omics)
    rows = phase3_timings(dev, errs, p2["launches"], p2["predictors"], bags, omics)
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
