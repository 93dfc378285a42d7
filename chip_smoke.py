#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its NaCAGaT, GE-NaCAGaT and MCAT
serving and training paths and its device-cache training step on one GPU.

    python3 chip_smoke.py              # phases 1-20 below
    python3 chip_smoke.py --profile    # where one predict_bags call's and one
                                       # training step's time goes

Phases (any failure exits non-zero, and no result line is printed):

1. Build every kernel from ``multimodal_path_omic_tpu_torch/csrc`` with nvcc
   (sm_90a), then hold each kernel against its plain PyTorch version on the
   card at the serving shapes (B=32 bags, N=6 queries, E=256, M up to 8192,
   ragged masks, one fully-masked row, a non-tile-multiple M); the fuse-K
   forward also at E = F = 512 (NaCAGaT big; M 8192 and 4000), E = 512 with
   F = 1024, E = 128, on masks with whole masked key tiles in mid-bag and with
   a bag of one valid key (o = that key's kv row), two runs bitwise equal.
   The export passes (stats, weights, and ``coattention_weights`` on one tile
   list) at D = 256, 128 and 512 with and without the pre-gate, on prefix
   masks (M 8192, 4000, 1001), masked tiles mid-bag (M 8192, 4000) and a bag
   of one valid key (M 1500): l, m and w against their plain versions, two
   runs bitwise equal, w exactly 0 at the masked keys of bags with a valid
   key, the filler bag at l = M, m = NEG, w = 1/M exactly; and the tile flag
   and list passes on each of those masks equal to their torch reference, as
   the fuse-K and plain-K kernels run them and with lone filler bags.
2. The NaCAGaT ``Predictor`` at full width (``medium``, 1024-wide patch
   features, six signatures of 100..600 genes, buckets 4096/8192, batch 32,
   random weights from a seed) through ``predict_bags`` and ``predict_bag``,
   once with ``loss="ces"`` (lean-V: fuse-K forward kernel) and once with
   ``loss="cesar"`` (export: stats + weights kernels). Launch counts are
   reset just before and read just after; every kernel must have launched.
   Outputs must be finite and match the same Predictor on the CPU (plain
   versions) on a few bags.
3. Timings with CUDA events: each kernel, its plain version and its bound
   (the fuse-K forward: 3xTF32 over the valid keys, float32 FMA over the
   valid keys and over every key, with the share of each reached; the
   export passes: bytes over the keys they need, the k rows of the valid
   keys, over the 64-key tiles they read and over every key, pre-gated and
   not, and both passes through ``coattention_weights``); the E =
   512 instance at B=32, M=8192 beside the route it replaces (k by
   torch.matmul, then ``attention_core``); ``predict_bags`` bags/s.
4. The training kernels (fuse-K training forward with dropout 0.25, ssq and
   sumw; the fuse-K backward) against their plain versions at B=32, N=6,
   E=F=256, M in {8192, 4000 (ragged, one fully-masked row)}, M=8192 with
   whole masked key tiles in the middle of every bag, M=1500 with one bag
   of a single valid key (its dq held to the noise of the terms that
   cancel), E=F=128 at M=4000 with masked tiles, and E=F=512 (NaCAGaT big)
   at M=8192 (prefix and masked-tile masks) and M=1500 with the single-key
   bag; each run twice must agree bitwise, the backward's dkv exactly 0 at
   the masked keys of bags with a valid key; the drop share of the Philox
   bits.
5. The NaCAGaT ``medium`` trainer (cesar, dropout 0.25 at every site, Adam
   lr 2e-4, weight decay 1e-5) on one 32-bag batch of the 8192 bucket,
   staged on the card once: 5 steps with the counts reset just before and
   read just after (one training-forward and one backward launch per
   accumulation chunk, no other kernel), every loss finite; then one step
   from the same state and seed with the kernels and with their plain
   versions, whose gradients must agree.
6. Timings: the training kernels beside their plain versions and bounds
   (3xTF32 over the valid keys, float32 FMA over the valid keys and over
   every key, with the share of each reached); the training step's ms and
   train bags/s.
7. The GE kernels against their plain versions on the card: the gated-MIL
   pool at D=H=256, B=8, M in {16384, 24576, 5000 (ragged)}, ragged masks,
   one fully-masked bag, one call without a mask; the flash forward at
   every (heads, width) instance, read in place from a packed [B, M, 3E]
   projection (and from contiguous q, k, v at B=2, M=5000): GE medium's
   (1, 256) and (8, 32) at the main path's batch (B=8, M=16384), at B=2
   with M in {16384, 5000} and at B=1 with M=24576; GE small's (1, 128),
   (8, 16) and big's (1, 512), (8, 64) at phase 17's B=4, M=4096 and at
   B=2, M=5000; ragged masks and one fully-masked bag, valid and pad rows
   alike.
8. The GE-NaCAGaT ``Predictor`` at full width (``medium``, 1024-wide patch
   features, 3 classes, buckets 8192/16384, batch 8, random weights from a
   seed) through ``predict_bags`` (12 bags of 5000..16384 patches, no omics)
   and ``predict_bag``. Launch counts are reset just before and read just
   after: three flash launches and one pool launch per batch, no
   co-attention kernel. ``y`` must be finite, sum to 1 per row and match the
   same Predictor on the CPU on two bags of the 8192 bucket, as must the raw
   MIL scores of an eval step.
9. Timings: the pool and every flash forward instance (at B=8, M=16384)
   beside their plain versions, their bounds (the flash kernels: 3xTF32 and
   float32 FMA, valid keys) and, for the flash forward, one
   ``scaled_dot_product_attention`` call; GE ``predict_bags`` bags/s.
10. Every flash backward instance against its plain version on the card,
    from the forward kernel's own out and row statistics (m, l): medium's at
    the main path's B=8, M=16384 and at B=2 with M in {5000, 24576}, small's
    and big's at B=4, M=4096 and B=2, M=5000; q, k, v read in place from a
    packed projection (contiguous at M=5000), ragged masks, one bag without a
    valid key, a random cotangent that is non-zero on pad rows too. dq, dk,
    dv within 1e-4 of each one's largest magnitude; two runs bitwise equal;
    masked keys get exactly no dq/dk; (m, l) against the plain forward; the
    forward's out the same bits with and without (m, l).
11. The GE-NaCAGaT ``medium`` trainer (ce, dropout 0.25, Adam lr 2e-4, weight
    decay 1e-5; ``make_train_step(..., ge_mode=True)``) on one 8-row batch
    of the 16384 bucket (seven bags and one zero-weight filler row), staged
    on the card once: 3 steps with the counts reset just before and read
    just after (per step 1 + 2 flash forward and 1 + 2 flash backward
    launches, no other kernel), every loss finite; then one step from the
    same state and seed with the kernels and with their plain versions,
    whose parameter gradients must agree.
12. Timings: every flash backward instance (at B=8, M=16384) beside its
    plain version, its bounds and the backward of one
    ``scaled_dot_product_attention`` call; the GE training step's ms and GE
    train bags/s.
13. The plain-K co-attention kernels with values against their plain
    versions at B=32, N=6: D=256 with M in {8192, 5000 (not a multiple of
    any tile)} on ragged masks with one fully-masked row, M=8192 with whole
    masked 64-key tiles mid-bag (which the kernels skip), M=1500 with a bag
    of a single valid key (o = that key's v row; its dq and dk held to the
    noise of the terms that cancel); D=128 with masked tiles (M=4000) and a
    single-key bag; with and without the pre-gate: the forward's eval form
    and training form (dropout 0.25, ssq, sumw), two runs bitwise equal;
    the backward's dq, dk, dv under random cotangents of o, ssq and sumw,
    two runs bitwise equal, exactly no dk through masked keys and dv exactly
    0 at the masked keys of bags with a valid key; the filler row uniform
    over its M keys; the drop share. The row gather against
    ``index_select``, bit for bit, for float32, bfloat16 and int8 pools and
    repeated indices.
14. MCAT at full width (``medium``, six signatures, seed-0 weights) on the
    40 bags of phase 2: (a) the lean ``Predictor`` (``ces``): no kernel
    launch, the GPU within 1e-4 of the CPU Predictor, and the [B, 6, M]
    co-attention map of an eval step with ``need_attention=True``; (b) the
    ``lean=False`` Predictor: one ``coattn_plain`` launch a batch and no
    other kernel, within 1e-4 of (a); (c) NaCAGaT ``lean=False`` (``ces``,
    pre-gated): one ``coattn_plain`` launch a batch, within 1e-4 of the
    lean-V Predictor of phase 2; (d) training on the 32-bag batch of phase 5
    (MCAT ``ces``, dropout 0.25, Adam): 3 steps lean (no kernel), 3 steps
    ``lean=False`` (one forward and one backward launch a step), a
    kernels-vs-plain step's parameter gradients, then 2 steps of NaCAGaT
    ``cesar`` with ``lean=False`` (dropout and ssq through the kernels).
15. The device cache: a cohort of 96 seeded bags (64 in the 8192 bucket, 32
    in the 4096 bucket) uploaded once into ``DeviceBagCache``; 4 cached MCAT
    steps (lean, ``ces``) over ``build_meta`` batches of 32, 32, 20 and 12
    bags (short batches filled with zero-weight repeats), one ``gather_rows``
    launch a step; then the same 4 batches host-fed from the same state and
    seed: losses and final parameters bitwise equal.
16. Timings: the three kernels beside their plain versions, bounds and
    library calls (``scaled_dot_product_attention`` and its backward for the
    form without pre-gate and dropout, ``index_select`` for the gather); the
    plain-K kernels in every form (pre-gate on and off, dropout 0 and 0.25)
    with three byte bounds, over the keys the function needs (the kernels
    line's: the valid keys, and in the forward the v rows of a bag without
    one), over the keys of the 64-key tiles they compute and over every
    key, and the share of each reached; MCAT ``predict_bags``
    bags/s and train bags/s, lean and ``lean=False``; the cached step
    against the host-fed step including the batch's staging.

17. GE-NaCAGaT ``small`` and ``big`` (heads of width 128 and 16, 512 and 64)
    at full width, random weights from seed 0: ``predict_bags`` on 6 bags of
    1000..4096 patches (bucket 4096, batch 4) and one training step (ce,
    dropout 0.25, Adam) on 3 bags and a filler row, each with the flash
    kernels and with their plain versions on the card (y and the raw MIL
    scores within 1e-4, the 40 parameter gradients within GRAD_RTOL), the
    launch counts of their flash instances exact.
18. Shapes the co-attention kernels do not take, routed to
    ``attention_core`` by the kernels' predicates: cross-attention of 6
    queries over 100 keys in 8 heads of width 32 and NaCAGaT with 12
    signature groups (``ces``; ``cesar``, whose map has 12 queries): the card
    within 1e-4 of the CPU, no co-attention launch.
19. NaCAGaT ``big`` (E = F = 512) serving with ``ces`` at full width on the
    40 bags of phase 2 (buckets 4096/8192, batch 32): one launch of the
    fuse-K eval kernel's E = 512 instance a batch and no other kernel, the
    card within 1e-4 of the CPU Predictor on 8 bags (the longest among
    them), ``predict_bags`` bags/s over three calls; then with ``cesar``:
    one launch of each export pass's D = 512 instance a batch and no other
    kernel, within 1e-4 of the CPU Predictor on 3 bags.
20. NaCAGaT ``big`` training (cesar, dropout 0.25, Adam lr 2e-4, weight decay
    1e-5) on phase 5's staged batch: 5 steps with exactly one launch of the
    fuse-K training forward's and backward's E = F = 512 instances a step
    and no other kernel; one step from the same state and seed with the
    kernels and with their plain versions, whose parameter gradients must
    agree; train bags/s over 5 more steps; both instances timed at B=32,
    M=8192 beside their plain versions, bounds and the route they replace
    (k by torch.matmul, then ``attention_core``; for the backward, with
    autograd's backward).

Output: phase lines, a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``. Imports nothing of
JAX; runs only where CUDA is available and the port package sits beside it.

``--profile`` runs none of the phases. It builds the kernels, warms the
phase-2 Predictor for each loss on the same bags, and traces one
``predict_bags`` call with ``torch.profiler``: device time by kernel / copy
name, wall time and the device busy share (summed device time over wall
time), then one JSON line per loss with the same numbers. It then traces one
phase-5 training step the same way (``medium``, then ``big``: phase 20's
trainer), after the host-clock median of 10 steps and their peak device
memory, with its device time split into
matrix-product, co-attention-kernel, optimizer and other kernels, and one GE
``predict_bags`` call of phase 8, split into flash kernel, MIL-pool kernel,
matrix products, copies and other; and one GE training step of phase 11,
split into flash forward, flash backward, matrix products, optimizer and
other; and one cached MCAT training step (lean) over a 32-bag cohort of the
8192 bucket; and, last, each launch of the export passes at phase 3's
inputs (stats, weights, both on one tile list, stats without the pre-gate)
and of the plain-K kernels at phase 16's inputs (the eval forward with and
without the pre-gate and without a mask, the backward), device time a call
over 5 calls.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores (the co-attention and pool kernels run float32 FMAs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# TF32 on the tensor cores, dense: the flash kernels (K6) and the fuse-K
# backward (K3) run each float32 product as three TF32 products (3xTF32), so
# their bound is 3 x operations over this rate; the float32-FMA bound is
# logged beside it.
PEAK_TF32_FLOP_PER_S = 495e12

B, N, E = 32, 6, 256
ONE_KEY = 1337  # the valid key of the single-key masks
SIZES = (100, 200, 300, 400, 500, 600)
BUCKETS = (4096, 8192)
N_BAGS = 40
SOURCES = {
    "coattn_fwd_fused_k": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_fwd_fused_k_e512": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_stats": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_weights": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_fwd_fused_k_train": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_fwd_fused_k_train_e512": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_bwd_fused_k": "multimodal_path_omic_tpu_torch/csrc/coattn_bwd.cu",
    "coattn_bwd_fused_k_e512": "multimodal_path_omic_tpu_torch/csrc/coattn_bwd.cu",
    "milpool": "multimodal_path_omic_tpu_torch/csrc/milpool.cu",
    **{f"flash_{way}_d{w}": f"multimodal_path_omic_tpu_torch/csrc/{src}.cu"
       for way, src in (("fwd", "flash"), ("bwd", "flash_bwd"))
       for w in (16, 32, 64, 128, 256, 512)},
    "coattn_plain": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_plain_bwd": "multimodal_path_omic_tpu_torch/csrc/coattn_bwd.cu",
    "gather_rows": "multimodal_path_omic_tpu_torch/csrc/gather.cu",
}
# kernel name -> the TPU kernel's function reaching pallas_call
REPLACES = {
    "coattn_fwd_fused_k": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_fwd_fused_k_e512": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_stats": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_weights": "multimodal_path_omic_tpu/ops/coattn.py:908",
    "coattn_fwd_fused_k_train": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_fwd_fused_k_train_e512": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_bwd_fused_k": "multimodal_path_omic_tpu/ops/coattn.py:508",
    "coattn_bwd_fused_k_e512": "multimodal_path_omic_tpu/ops/coattn.py:508",
    "milpool": "multimodal_path_omic_tpu/ops/milpool.py:131",
    # the backward: the library kernel's custom VJP, reached through the same call
    **{f"flash_{way}_d{w}": "multimodal_path_omic_tpu/ops/flash.py:44"
       for way in ("fwd", "bwd") for w in (16, 32, 64, 128, 256, 512)},
    "coattn_plain": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_plain_bwd": "multimodal_path_omic_tpu/ops/coattn.py:508",
    "gather_rows": "multimodal_path_omic_tpu/ops/gather.py:63",
}
TRAIN_KERNELS = ("coattn_fwd_fused_k_train", "coattn_bwd_fused_k")
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
# Training (phases 4-6): the default NaCAGaT configuration
# (examples/nacagat.yaml: cesar, dropout 0.25, Adam lr 2e-4, weight decay
# 1e-5), B=32 bags in the 8192 bucket.
TRAIN_RATE, TRAIN_M, TRAIN_STEPS = 0.25, 8192, 5
# Gradients (kernel vs plain, and a training step's parameter gradients with
# the kernels vs with the plain versions) are held relative to each tensor's
# largest magnitude: dwk and dbk are sums over B*M = 262,144 terms, so their
# absolute rounding error grows with them; float32 in other summation orders
# moves them by ~1e-5 of their scale, an indexing or mask fault by O(1).
GRAD_RTOL = 1e-4
# A training step's parameter gradients add an absolute floor: the MIL pool
# scorers' output bias has a zero gradient by construction (the softmax over
# the bag is shift-invariant), so both sides hold only float32 noise (~1e-11)
# there, and a limit relative to that noise would measure nothing.
GRAD_ATOL = 1e-8
# The drop share of the Philox bits over B*N*M = 1.57M draws: its standard
# error is 3.5e-4, so 0.002 is ~6 of them.
DROP_TOL = 0.002
# GE serving (phases 7-9): examples/ge_nacagat.yaml's buckets and batch size
# (the 24576 bucket is held by phase 7 at the kernel level), medium width.
GE_B, GE_M, GE_D = 8, 16384, 256
GE_BUCKETS = (8192, 16384)
GE_N_BAGS = 12
# (heads, width) of GE's three self-attentions: the first once, the second in
# each of the path transformer's two layers. The flash kernel has one template
# instance per width, each with its own count and row (flash_fwd_d<width>).
GE_HEADS = ((1, 256), (8, 32))
# The same for GE small and big (phase 17: GE_WIDE_B bags of the GE_WIDE_M
# bucket); every flash instance is held and timed (phases 7, 9, 10, 12).
GE_SIZE_HEADS = {"small": ((1, 128), (8, 16)), "medium": GE_HEADS, "big": ((1, 512), (8, 64))}
GE_SIZE_E = {"small": 128, "medium": 256, "big": 512}
FLASH_INSTANCES = tuple((h, w, GE_SIZE_E[size]) for size in ("medium", "small", "big")
                        for h, w in GE_SIZE_HEADS[size])
GE_WIDE_B, GE_WIDE_M = 4, 4096
# The GE kernels against their plain versions, both float32: the pool sums
# up to 24,576 weighted rows of magnitude ~1 per split and merges splits; the
# flash forward sums 256 (or 32) products per score and up to 24,576 weighted
# values per output, per 128-key tile, where cuBLAS and torch.softmax take
# other orders. Outputs of magnitude ~1 move by ~1e-6 to 1e-5; a tiling,
# stride or mask fault moves them by O(0.1-1). 1e-4 absolute for the pooled
# rows, the raw scores and every attention output row, pad rows included.
GE_ATOL = 1e-4
# GE training (phases 10-12): examples/ge_nacagat.yaml's training settings
# (ce, dropout 0.25, Adam lr 2e-4, weight decay 1e-5), 8 rows of the 16384
# bucket (B * M = 131,072: one accumulation chunk). The flash backward's
# gradients are held like the co-attention backward's, to GRAD_RTOL of each
# tensor's largest magnitude: dk and dv sum up to 16,384 query rows' terms,
# ds = p * (dp - delta) cancels, and cuBLAS takes other orders; float32
# moves them by ~1e-6 to 1e-5 of their scale, a tile, stride or mask fault
# by O(1).
GE_TRAIN_STEPS = 2
# MCAT and the device cache (phases 13-16): examples/mcat.yaml's model (medium,
# concat, ces, dropout 0.25, Adam lr 2e-4, weight decay 1e-5) on phase 2's
# bags; the cache cohort's bags per bucket and the cached run's batches (rows
# of a bucket, in bucket order; batch size 32).
MCAT_STEPS = 3
CACHE_COHORT = {8192: 64, 4096: 32}
CACHE_BATCHES = ((8192, 0, 32), (8192, 32, 64), (4096, 0, 20), (4096, 20, 32))


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


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


def make_inputs(m_len, f_dim, seed, dev, e=E, kind="prefix", with_k=True):
    """Serving-like inputs: projected queries and keys of NaCAGaT's scale
    (std ~0.7: ELU / ReLU activations through a xavier-initialized [e, e]
    projection), ReLU patch embeddings as kv, ragged key masks, the last bag
    fully masked (a filler row). ``kind``: "prefix" (those masks), "holes"
    (the same with keys 1024..2047 and 3000..3199 masked in every bag: whole
    masked 64-key tiles in the middle of a bag, which the fuse-K kernels skip)
    or "one" (bag 0 with a single valid key, key 1337). ``with_k`` False: no
    plain-K keys (k None; the masks then come from other draws)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = 0.7 * torch.randn(B, N, e, generator=g)
    kv = torch.relu(torch.randn(B, m_len, f_dim, generator=g))
    wk = 0.7 * torch.randn(f_dim, e, generator=g) / math.sqrt(f_dim)
    bk = 0.1 * torch.randn(e, generator=g)
    k = 0.7 * torch.randn(B, m_len, e, generator=g) if with_k else None
    mask = make_mask(m_len, g, kind)
    return [None if t is None else t.to(dev) for t in (q, kv, wk, bk, k, mask)]


def make_mask(m_len, g, kind):
    """[B, M] ragged key masks (lengths uniform in [M/5, M] from ``g``, bag 0
    full, the last bag fully masked), with :func:`make_inputs`' ``kind``."""
    import torch

    lengths = torch.randint(m_len // 5, m_len + 1, (B,), generator=g)
    lengths[0] = m_len
    lengths[-1] = 0
    mask = torch.arange(m_len)[None, :] < lengths[:, None]
    if kind == "holes":
        mask[:, 1024:2048] = False
        mask[:, 3000:3200] = False
    elif kind == "one":
        mask[0] = False
        mask[0, ONE_KEY % m_len] = True
    return mask


def export_inputs(m_len, d, seed, dev, kind="prefix"):
    """q [B, N, d], k [B, M, d] of :func:`make_inputs`' scale and its masks:
    the export passes' inputs, without the fuse-K operands."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = 0.7 * torch.randn(B, N, d, generator=g)
    k = 0.7 * torch.randn(B, m_len, d, generator=g)
    return [t.to(dev) for t in (q, k, make_mask(m_len, g, kind))]


def check_fk_forward(name, got, ref, again, kv, mask) -> float:
    """A fuse-K forward (o, l, m[, ssq], sumw) against its plain version:
    1e-4 absolute, l 1e-5 relative; a second run bitwise equal; a bag with
    a single valid key pools exactly that key's kv row (eval: o = kv_r).
    Returns the largest error but l's."""
    import torch

    names = ("o", "l", "m", "sumw") if len(got) == 4 else ("o", "l", "m", "ssq", "sumw")
    e = 0.0
    for what, a, b in zip(names, got, ref):
        err = check_close(f"{name}.{what}", a, b, KERNEL_ATOL, L_RTOL if what == "l" else 0.0)
        if what != "l":
            e = max(e, err)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two runs differ")
    one = mask.sum(-1) == 1
    if len(got) == 4 and bool(one.any()):
        row = kv[one][torch.arange(int(one.sum()), device=kv.device), mask[one].float().argmax(-1)]
        check_close(f"{name}.o of the bag with one valid key, its kv row", got[0][one],
                    row[:, None, :].expand_as(got[0][one]), KERNEL_ATOL)
    log(f"  {name}: two runs bitwise equal")
    return e


# Phase 1's fuse-K eval shapes (M, F, E, mask kind): the serving path's
# (E = F = 256; NaCAGaT big's E = F = 512), the widest F the eval form takes,
# the tile-skipping masks, and E = 128.
# The holes masks keep the prefix masks' ragged and fully-masked rows.
PHASE1_CASES = ((8192, 256, 256, "prefix"), (4096, 256, 256, "prefix"), (4000, 256, 256, "prefix"),
                (4096, 1024, 256, "prefix"), (8192, 256, 256, "holes"), (1500, 256, 256, "one"),
                (4000, 128, 128, "holes"), (8192, 512, 512, "holes"), (4000, 512, 512, "prefix"),
                (4096, 1024, 512, "prefix"), (1500, 512, 512, "one"))


def phase1_kernels(dev) -> dict:
    from multimodal_path_omic_tpu_torch.ops import coattn

    errs = {}
    for m_len, f_dim, e_dim, kind in PHASE1_CASES:
        log(f"phase 1: B={B} N={N} E={e_dim} M={m_len} F={f_dim}, {kind} masks")
        q, kv, wk, bk, _, mask = make_inputs(m_len, f_dim, m_len + f_dim, dev, e_dim, kind,
                                             with_k=False)
        got = coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
        again = coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask)
        ref = coattn.coattn_fwd_fused_k_plain(q, kv, wk, bk, mask)
        row = "coattn_fwd_fused_k_e512" if e_dim == 512 else "coattn_fwd_fused_k"
        errs[row] = max(errs.get(row, 0.0), check_fk_forward("fused_k", got, ref, again, kv, mask))
        del got, again, ref
    errs["coattn_stats"] = errs["coattn_weights"] = 0.0
    for m_len, kind, d in EXPORT_CASES:
        q, k, mask = export_inputs(m_len, d, m_len + d, dev, kind)
        check_tiles(mask, kind)
        for pre_gate in (True, False):
            log(f"phase 1: export passes B={B} N={N} D={d} M={m_len} pre_gate={pre_gate}, "
                f"{kind} masks")
            e_s, e_w = check_export(q, k, mask, pre_gate)
            errs["coattn_stats"] = max(errs["coattn_stats"], e_s)
            errs["coattn_weights"] = max(errs["coattn_weights"], e_w)
        del q, k, mask
    return errs


# Phase 1's export cases (M, mask kind, D), each with and without the
# pre-gate: the serving batch's M with prefix masks and with whole masked
# 64-key tiles mid-bag (which the kernels skip), a bag with a single valid
# key, M = 4000 (no multiple of 64) and M = 1001 (no multiple of 4: w's rows
# are not 16-byte aligned), at D = 256, 128 (MCAT and NaCAGaT small) and
# 512 (NaCAGaT big). Every case keeps a fully-masked filler bag.
EXPORT_CASES = ((8192, "prefix", 256), (8192, "holes", 256), (1500, "one", 256),
                (4000, "prefix", 256), (1001, "prefix", 256), (4000, "holes", 128),
                (1500, "one", 128), (8192, "holes", 512), (1500, "one", 512),
                (4000, "prefix", 512))


def check_tiles(mask, kind) -> None:
    """The tile flag and list passes on the card against their torch
    reference, bit for bit, as the fuse-K and plain-K kernels run them and
    with lone filler bags (the export passes)."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    for lone in (False, True):
        got = coattn.coattn_tiles(mask, lone=lone)
        ref = coattn.coattn_tiles_plain(mask, lone=lone)
        if not all(torch.equal(a, r) for a, r in zip(got, ref)):
            raise AssertionError(f"tile flags / list (lone={lone}, {kind} masks, M="
                                 f"{mask.shape[1]}) differ from their reference")
    log(f"  tile flags and list at M={mask.shape[1]} ({kind} masks, {int(ref[2][-1])} units with "
        f"lone filler bags): equal to the reference, both modes")


def check_export(q, k, mask, pre_gate) -> tuple:
    """The export passes against their plain versions: l 1e-5 relative and
    m 1e-4 absolute, w 1e-4 relative (1e-8 floor) from the plain l, m and,
    through ``coattention_weights`` (one tile list for both passes), from
    the kernel's own; two runs bitwise equal; w exactly 0 at the masked keys
    of a bag with a valid key; a bag without one at m = NEG, l = M and
    w = 1 / M exactly. Returns the largest errors of m and of w."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    m_len = mask.shape[1]
    l, m = coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)
    l2, m2 = coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)
    l_ref, m_ref = coattn.coattn_stats_plain(q, k, mask, pre_gate=pre_gate)
    check_close("stats.l", l, l_ref, KERNEL_ATOL, L_RTOL)
    e_s = check_close("stats.m", m, m_ref, KERNEL_ATOL)
    w = coattn.coattn_weights(q, k, mask, l_ref, m_ref, pre_gate=pre_gate)
    w2 = coattn.coattn_weights(q, k, mask, l_ref, m_ref, pre_gate=pre_gate)
    w_ref = coattn.coattn_weights_plain(q, k, mask, l_ref, m_ref, pre_gate=pre_gate)
    e_w = check_close("weights.w", w, w_ref, W_ATOL, W_RTOL)
    both = coattn.coattention_weights(q, k, mask, pre_gate=pre_gate)
    check_close("coattention_weights (both passes, one tile list)", both, w_ref, W_ATOL, W_RTOL)
    if not (torch.equal(l, l2) and torch.equal(m, m2) and torch.equal(w, w2)):
        raise AssertionError("two runs of the export passes differ")
    has = mask.any(-1)
    masked = (~mask & has[:, None])[:, None, :].expand_as(w)
    if not (bool((w[masked] == 0).all()) and bool((both[masked] == 0).all())):
        raise AssertionError("w is not exactly 0 at a masked key of a bag with a valid key")
    empty = ~has
    if not (bool((l[empty] == m_len).all()) and bool((m[empty] == m_ref[empty]).all())
            and bool((w[empty] == 1.0 / m_len).all()) and bool((both[empty] == 1.0 / m_len).all())):
        raise AssertionError("a bag without a valid key is not uniform over its M keys")
    log(f"  export: two runs bitwise equal; w exactly 0 at the masked keys of bags with a valid "
        f"key; {int(empty.sum())} bag(s) without one at l = M, m = NEG, w = 1/M exactly")
    return e_s, e_w


def make_bags(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1500, 8193, size=N_BAGS)
    bags = [rng.standard_normal((int(n), 1024), dtype=np.float32) for n in lengths]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in SIZES] for _ in bags]
    return bags, omics


def make_predictor(dev, loss, batch_size=B, model="NaCAGaT", **kw):
    """The serving configuration: NaCAGaT (or MCAT) medium, random weights
    from seed 0."""
    from multimodal_path_omic_tpu_torch.serve import Predictor

    return Predictor(model, omic_sizes=SIZES, model_size="medium", buckets=BUCKETS,
                     batch_size=batch_size, loss=loss, seed=0, device=dev, **kw)


def phase2_predictor(dev, bags, omics) -> dict:
    import torch

    launches = {}
    results = {}
    for loss in ("ces", "cesar"):
        log(f"phase 2: NaCAGaT medium Predictor, loss={loss}, {len(bags)} bags, "
            f"buckets {BUCKETS}, batch_size {B}")
        pred = make_predictor(dev, loss)
        reset_counts()
        out = pred.predict_bags(bags, omics)
        single = pred.predict_bag(bags[1], omics[1])
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"  launches: {counts}")
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
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
    for name in {n for names in WANT.values() for n in names}:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the serving path")
    log(f"phase 2: kernels launched per loss as expected ({WANT})")
    return {"launches": launches, "predictors": results}


def fk_bytes_ops(name, m_len, f_dim, e=E) -> tuple:
    """(bytes, operations) of one co-attention kernel call at B=32, N=6:
    each input read once, each output written once; float32 multiply-adds
    counted as 2 operations (the training kernels' integer Philox work,
    ~1e8 operations, is left out). ``e``: the fuse-K forms' E."""
    ins = 4 * (B * N * e + B * m_len * f_dim + f_dim * e + e) + B * m_len  # q kv wk bk mask
    if name.startswith("coattn_fwd_fused_k"):
        # l, m, sumw (+ ssq in the training form)
        n_stats = 4 if name.startswith("coattn_fwd_fused_k_train") else 3
        nbytes = ins + 4 * (B * N * f_dim + n_stats * B * N)
        ops = 2 * B * m_len * f_dim * e + 4 * B * N * m_len * e + 2 * B * N * m_len * f_dim
    else:  # the fuse-K backward
        # in: + dout, l, m, di, dssq, dsumw; out: dq, dkv, dwk, dbk
        nbytes = ins + 4 * (B * N * f_dim + 5 * B * N) + 4 * (
            B * N * e + B * m_len * f_dim + f_dim * e + e)
        # k, dk wk^T, kv^T dk; scores + gate; dO.kv and pd^T dO; dq and dk terms
        ops = (6 * B * m_len * f_dim * e + 4 * B * N * m_len * e + 4 * B * N * m_len * f_dim
               + 8 * B * N * m_len * e)
    return nbytes, ops


def bound_ms(name, m_len, f_dim, e=E) -> tuple:
    """(bound ms, 'bytes' | 'operations') at the float32 rate of the CUDA
    cores, every key counted."""
    nbytes, ops = fk_bytes_ops(name, m_len, f_dim, e)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fk_bwd_bound_ms(mask, e=E) -> tuple:
    """(bound ms, 'bytes' | 'operations', float32-FMA bound ms over the same
    keys, float32-FMA bound ms over every key) of the fuse-K backward at
    B=32, N=6, E=F=``e``. Its three products (k = kv wk, dk wk^T, kv^T dk) run
    as 3xTF32 on the tensor cores (three TF32 products each) and are needed
    only for the valid keys (a tile without one is skipped; a bag without a
    valid key needs all of its keys): counted from ``mask``. The bytes are
    ``bound_ms``'s (each input read once, each output written once); so is
    the float32-FMA bound over every key."""
    m_len = mask.shape[1]
    ops = 6 * valid_keys(mask) * e * e
    t_bytes = fk_bytes_ops("coattn_bwd_fused_k", m_len, e, e)[0] / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * ops / PEAK_TF32_FLOP_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (
        ops / PEAK_F32_FLOP_PER_S * 1e3, bound_ms("coattn_bwd_fused_k", m_len, e, e)[0])


def valid_keys(mask) -> int:
    """The keys a fuse-K kernel must compute for ``mask``: the valid ones,
    and every key of a bag without one."""
    import torch

    n_valid = mask.sum(dim=1)
    return int(torch.where(n_valid == 0, mask.shape[1], n_valid).sum().item())


def fk_fwd_bound_ms(name, mask, e=E) -> tuple:
    """(bound ms, 'bytes' | 'operations', float32-FMA bound ms over the same
    keys, float32-FMA bound ms over every key) of a fuse-K forward at B=32,
    N=6, E=F=``e``. Its projection k = kv wk runs as 3xTF32 on the tensor
    cores (three TF32 products) and is needed only for the valid keys (a
    tile without one is skipped; a bag without a valid key needs all of its
    keys): 3 x 2 keys F E operations over the TF32 rate. The bytes are
    ``bound_ms``'s (each input read once, each output written once); the
    float32-FMA bounds count the projection, the scores and o += p kv."""
    m_len = mask.shape[1]
    keys = valid_keys(mask)
    nbytes, ops_all = fk_bytes_ops(name, m_len, e, e)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * 2 * keys * e * e / PEAK_TF32_FLOP_PER_S * 1e3
    f32_all = ops_all / PEAK_F32_FLOP_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (
        f32_all * keys / (B * m_len), f32_all)


def fk_bound_line(ms, bounds) -> str:
    """A fuse-K kernel's three bounds beside its time, with the share of
    each reached."""
    bms, by, f32_valid, f32_all = bounds
    return (f"bounds: 3xTF32 over the valid keys {bms:.4f} ms ({by}; {bms / ms:.3f} of it "
            f"reached), float32 FMA over the valid keys {f32_valid:.4f} ms ({f32_valid / ms:.3f} "
            f"reached), over every key {f32_all:.4f} ms ({f32_all / ms:.3f} reached)")


def export_bound_ms(name, mask, keys, d=E) -> tuple:
    """(bound ms, 'bytes' | 'operations') of an export pass at N=6, pre-gated,
    its k rows read over ``keys`` (bag, key) pairs: q and the mask read
    whole; stats writes l and m; weights reads them and writes w [B, N, M]
    whole. Operations: q.k and the gate, float32 multiply-adds as 2."""
    b, m_len = mask.shape
    nbytes = 4 * (b * N * d + keys * d + 2 * b * N) + b * m_len
    if name == "coattn_weights":
        nbytes += 4 * b * N * m_len
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * N * keys * d / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def export_bounds(mask, d=E) -> dict:
    """Each export pass's three bounds: over the keys it needs (the k rows
    of the valid keys; a bag without one needs none), over the keys of the
    64-key tiles the kernels read (lone filler bags read nothing) and over
    every key."""
    valid, tiled = int(mask.sum()), computed_tile_keys(mask, lone=True)
    log(f"  export masks of {mask.numel()} keys: {valid} valid ({valid / mask.numel():.4f}), "
        f"{tiled} in the tiles read ({tiled / mask.numel():.4f})")
    return {name: [export_bound_ms(name, mask, keys, d) for keys in (valid, tiled, mask.numel())]
            for name in ("coattn_stats", "coattn_weights")}


def bounds_line(ms, bounds) -> str:
    """Three byte bounds beside a time, with the share of each reached."""
    (b_need, _), (b_tile, _), (b_every, _) = bounds
    return (f"{ms:.4f} ms (bounds {b_need:.4f} keys needed, {b_tile:.4f} tiles read, "
            f"{b_every:.4f} every key; {b_need / ms:.3f} / {b_tile / ms:.3f} / "
            f"{b_every / ms:.3f} reached)")


def phase3_timings(dev, errs, launches, predictors, bags, omics) -> list:
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    m_len = 8192
    q, kv, wk, bk, k, mask = make_inputs(m_len, E, 7, dev)
    l, m = coattn.coattn_stats_plain(q, k, mask)
    ebounds = export_bounds(mask)
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
        line = (f"phase 3: {name} B={B} N={N} M={m_len} F=E={E}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, ")
        if name == "coattn_fwd_fused_k":
            bms, by, _, _ = bounds = fk_fwd_bound_ms(name, mask)
            log(line + fk_bound_line(ms, bounds))
        else:
            bms, by = ebounds[name][0]
            log(line + bounds_line(ms, ebounds[name]))
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes a pre-gated (tanh-gated) attention
            "library_ms": None,
        })
    for name in ("coattn_stats", "coattn_weights"):
        log(f"phase 3: {name} device ms a call by launch (torch.profiler, 5 calls): "
            + ", ".join(f"{n} {t:.4f}" for n, t in launch_ms(calls[name][0])))
    both = cuda_ms(lambda: coattn.coattention_weights(q, k, mask, pre_gate=True))
    both_plain = cuda_ms(lambda: coattn.coattn_weights_plain(
        q, k, mask, *coattn.coattn_stats_plain(q, k, mask), pre_gate=True))
    log(f"phase 3: coattention_weights (both export passes on one tile list) {both:.4f} ms, "
        f"plain {both_plain:.4f} ms")
    # MCAT's form (no pre-gate); the rows above are NaCAGaT's
    l0, m0 = coattn.coattn_stats_plain(q, k, mask, pre_gate=False)
    stats0 = cuda_ms(lambda: coattn.coattn_stats(q, k, mask, pre_gate=False))
    weights0 = cuda_ms(lambda: coattn.coattn_weights(q, k, mask, l0, m0, pre_gate=False))
    log(f"phase 3: pre_gate=False: coattn_stats {bounds_line(stats0, ebounds['coattn_stats'])}, "
        f"coattn_weights {bounds_line(weights0, ebounds['coattn_weights'])}")
    rows.append(time_e512(dev, errs))
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


def time_e512(dev, errs) -> dict:
    """The E = F = 512 eval instance (NaCAGaT big serving) at B=32, N=6,
    M=8192 beside its plain version, its bounds and the route it replaces:
    k = kv wk + bk formed by torch.matmul, then ``attention_core`` over it
    (the lean-V gate's refusal before the instance existed). Its launches
    are phase 19's."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn
    from multimodal_path_omic_tpu_torch.ops.attention import attention_core

    name, m_len, e = "coattn_fwd_fused_k_e512", 8192, 512
    q, kv, wk, bk, _, mask = make_inputs(m_len, e, 11, dev, e, with_k=False)

    def replaced():
        k = torch.matmul(kv, wk) + bk
        return attention_core(q[:, None], k[:, None], kv[:, None], mask, pre_gate=True,
                              need_weights=False)[0]

    ms = cuda_ms(lambda: coattn.coattn_fwd_fused_k(q, kv, wk, bk, mask))
    plain_ms = cuda_ms(lambda: coattn.coattn_fwd_fused_k_plain(q, kv, wk, bk, mask), 3, 1)
    core_ms = cuda_ms(replaced, 3, 1)
    bms, by, _, _ = bounds = fk_fwd_bound_ms(name, mask, e)
    log(f"phase 3: {name} B={B} N={N} M={m_len} F=E={e}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, the route it replaces (k by torch.matmul, then attention_core) "
        f"{core_ms:.4f} ms, " + fk_bound_line(ms, bounds))
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": 0, "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def check_rel(name, got, ref, rtol) -> float:
    """Hold got to ref within rtol of ref's largest magnitude; returns the
    max abs error."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = max_err(got, ref)
    scale = float(ref.abs().max().item())
    ok = err <= rtol * scale
    log(f"  {name}: max_abs_err={err:.3e}, {err / max(scale, 1e-30):.3e} of max |ref| "
        f"{scale:.3e} (tolerance {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def train_kernel_inputs(m_len, dev, seed, kind="prefix", e=E):
    """Phase-1 style inputs at E = F = ``e`` (``kind``: make_inputs' masks)
    plus a dropout seed, the backward's cotangents and the forward
    statistics it needs."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    q, kv, wk, bk, _, mask = make_inputs(m_len, e, seed, dev, e, kind, with_k=e == E)
    dseed = torch.tensor([seed], dtype=torch.int32, device=dev)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    dout = torch.randn(B, N, e, generator=g).to(dev)
    dssq, dsumw = (torch.randn(B, N, generator=g).to(dev) for _ in range(2))
    fwd = coattn.coattn_fwd_fused_k_train_plain(q, kv, wk, bk, mask, dseed, TRAIN_RATE)
    _, l, m, ssq, sumw = fwd
    di = (fwd[0] * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    return (q, kv, wk, bk, mask, dseed), (dout, l, m, di, dssq, dsumw), fwd


def check_one_key_dq(got, ref, q, kv, wk, bk, fwd, dout, dssq, dsumw, di) -> None:
    """dq of bags with a single valid key. That key's weight is 1 and
    o = pd kv_r, so ds = pd dp - p di + 2 dssq pd^2 + dsumw pd is 0 in exact
    arithmetic and dq holds float32 noise alone on both sides, which a bound
    relative to dq's own largest value cannot compare: held to GRAD_RTOL of
    the terms that cancel, c_n = |o_n.dO_n| + |di_n| + 2 |dssq_n ssq_n| +
    |dsumw_n sumw_n|, times the largest factor ds meets on its way to dq
    (scale |k|max + |a|max / 2, with |a| <= scale |q_n|_1 |k|max)."""
    import torch

    o, _, _, ssq, sumw = fwd
    scale = 1.0 / math.sqrt(q.shape[-1])
    kmax = (torch.matmul(kv, wk) + bk).abs().amax((1, 2))[:, None]  # [bags, 1]
    c = (o * dout).sum(-1).abs() + di.abs() + 2 * (dssq * ssq).abs() + (dsumw * sumw).abs()
    limit = (GRAD_RTOL * c * (scale * kmax + scale * q.abs().sum(-1) * kmax / 2))[..., None]
    worst = max(float((got.abs() / limit).max()), float((ref.abs() / limit).max()))
    log(f"  bwd.dq, {got.shape[0]} bag(s) with one valid key: max |dq| {got.abs().max():.3e} "
        f"(plain {ref.abs().max():.3e}), at {worst:.3f} of the limit {GRAD_RTOL:g} x the "
        f"terms that cancel {'ok' if worst <= 1.0 else 'FAIL'}")
    if not (worst <= 1.0 and bool(torch.isfinite(got).all())):
        raise AssertionError("dq of a bag with one valid key is above its noise limit")


# Phase 4's (M, mask kind, E = F): NaCAGaT medium's width on the training
# batch's M, a ragged M, the tile-skipping masks; E = F = 128; NaCAGaT big's
# E = F = 512 on the training batch's M (prefix and holes) and the single-key
# bag.
PHASE4_CASES = ((TRAIN_M, "prefix", E), (4000, "prefix", E), (TRAIN_M, "holes", E),
                (1500, "one", E), (4000, "holes", 128), (TRAIN_M, "prefix", 512),
                (TRAIN_M, "holes", 512), (1500, "one", 512))


def phase4_train_kernels(dev) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    errs = {}
    for m_len, kind, e_dim in PHASE4_CASES:
        log(f"phase 4: training kernels B={B} N={N} E=F={e_dim} M={m_len} dropout {TRAIN_RATE}, "
            f"{kind} masks")
        ins, (dout, l, m, di, dssq, dsumw), ref = train_kernel_inputs(m_len, dev, 97 + m_len,
                                                                      kind, e_dim)
        fwd_row, bwd_row = (name + ("_e512" if e_dim == 512 else "") for name in TRAIN_KERNELS)
        got = fwd = coattn.coattn_fwd_fused_k_train(*ins, TRAIN_RATE)
        again = coattn.coattn_fwd_fused_k_train(*ins, TRAIN_RATE)
        errs[fwd_row] = max(errs.get(fwd_row, 0.0),
                            check_fk_forward("fwd_train", got, ref, again, ins[1], ins[4]))
        got = coattn.coattn_bwd_fused_k(*ins, TRAIN_RATE, dout, l, m, di, dssq, dsumw)
        again = coattn.coattn_bwd_fused_k(*ins, TRAIN_RATE, dout, l, m, di, dssq, dsumw)
        ref = coattn.coattn_bwd_fused_k_plain(*ins, TRAIN_RATE, dout, dssq, dsumw)
        mask = ins[4]
        one = mask.sum(-1) == 1
        if bool(one.any()):  # dq of a bag with one valid key: float32 noise on both sides
            q, kv, wk, bk = ins[:4]
            check_one_key_dq(got[0][one], ref[0][one], q[one], kv[one], wk, bk,
                             [t[one] for t in fwd], dout[one], dssq[one], dsumw[one], di[one])
        for name, a, r in zip(("dq", "dkv", "dwk", "dbk"), got, ref):
            if name == "dq":
                a, r = a[~one], r[~one]
            errs[bwd_row] = max(errs.get(bwd_row, 0.0), check_rel(f"bwd.{name}", a, r, GRAD_RTOL))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("two backward runs differ")
        has = mask.any(-1)
        if not bool((got[1][has][~mask[has]] == 0).all()):
            raise AssertionError("dkv is not exactly 0 at a masked key of a bag with a valid key")
        log("  bwd: two runs bitwise equal; dkv exactly 0 at the masked keys of bags with one")
        keep = coattn.dropout_bits(ins[-1], (B, N, m_len), dev) >= coattn.dropout_threshold(
            TRAIN_RATE)
        drop = 1.0 - float(keep.double().mean().item())
        log(f"  drop share of the Philox bits over {keep.numel()} draws: {drop:.6f} "
            f"(tolerance {TRAIN_RATE} +- {DROP_TOL})")
        if abs(drop - TRAIN_RATE) > DROP_TOL:
            raise AssertionError("the dropout bits miss the rate")
    return errs


def make_trainer(dev, model="NaCAGaT", loss="cesar", lean=True, cached=False, size="medium"):
    """The training configuration: NaCAGaT (cesar) or MCAT (ces), ``size``
    medium (or big: NaCAGaT's E = F = 512), random weights from seed 0,
    dropout 0.25, Adam lr 2e-4 / weight decay 1e-5, dropout generator seeded
    with 0; ``cached``: the device-cache step."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train import loop
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    net = build_model(model, omic_sizes=SIZES, model_size=size, dropout=TRAIN_RATE, lean=lean)
    net = seeded_init_(net, 0).to(dev)
    opt = make_optimizer("adam", 2e-4, 1e-5)
    make = loop.make_cached_train_step if cached else loop.make_train_step
    return net, loop.init_train_state(net, opt, seed=0), make(net, loss, opt, omic_sizes=SIZES)


def stage_train_batch(dev, bags, omics) -> dict:
    """One 32-bag batch of the 8192 bucket (the first 32 serving bags,
    1500..8192 patches) and labels from a numpy seed, on the card once."""
    import torch

    rng = np.random.default_rng(1)
    wsi = torch.zeros((B, TRAIN_M, bags[0].shape[1]), device=dev)
    mask = torch.zeros((B, TRAIN_M), dtype=torch.bool, device=dev)
    for row in range(B):
        wsi[row, :len(bags[row])] = torch.from_numpy(bags[row]).to(dev)
        mask[row, :len(bags[row])] = True
    return {
        "wsi": wsi, "mask": mask,
        "omics": [torch.from_numpy(np.stack([omics[r][j] for r in range(B)])).to(dev)
                  for j in range(len(SIZES))],
        "label": torch.from_numpy(rng.integers(0, 4, B)).to(dev),
        "censorship": torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)).to(dev),
        "weight": torch.ones(B, device=dev),
    }


def train_step_grads(dev, batch, plain: bool, size="medium") -> dict:
    """Parameter gradients of one training step from the phase-5 (``size``
    big: phase-20) start state and seed, through the kernels or through
    their plain versions."""
    from multimodal_path_omic_tpu_torch.ops import coattn

    model, state, step = make_trainer(dev, size=size)
    saved = coattn.coattn_fwd_fused_k_train, coattn.coattn_bwd_fused_k
    if plain:
        coattn.coattn_fwd_fused_k_train = coattn.coattn_fwd_fused_k_train_plain
        coattn.coattn_bwd_fused_k = (
            lambda q, kv, wk, bk, mk, seed, rate, dout, l, m, di, dssq, dsumw:
            coattn.coattn_bwd_fused_k_plain(q, kv, wk, bk, mk, seed, rate, dout, dssq, dsumw))
    try:
        step(state, batch)
    finally:
        coattn.coattn_fwd_fused_k_train, coattn.coattn_bwd_fused_k = saved
    return {name: p.grad.clone() for name, p in model.named_parameters()}


def check_step_grads(got: dict, ref: dict) -> None:
    """Hold a step's parameter gradients to GRAD_RTOL of each one's largest
    magnitude plus GRAD_ATOL."""
    import torch

    worst, worst_name = 0.0, ""
    for k in ref:
        err, scale = float((got[k] - ref[k]).abs().max()), float(ref[k].abs().max())
        limit = GRAD_RTOL * scale + GRAD_ATOL
        if err / limit > worst:
            worst, worst_name = err / limit, f"{k}, max_abs_err {err:.3e}, max |ref| {scale:.3e}"
        if not (err <= limit and bool(torch.isfinite(got[k]).all())):
            raise AssertionError(f"grad {k}: max_abs_err {err:.3e} over the limit {limit:.3e} "
                                 f"(max |ref| {scale:.3e})")
    log(f"  {len(ref)} parameter gradients within {GRAD_RTOL:g} of each one's max + "
        f"{GRAD_ATOL:g} (worst at {worst:.3f} of its limit: {worst_name})")


def phase5_training(dev, batch) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.train.loop import accumulation_chunks

    log(f"phase 5: NaCAGaT medium trainer, cesar, dropout {TRAIN_RATE}, Adam; batch "
        f"[{B}, {TRAIN_M}, 1024], {TRAIN_STEPS} steps")
    model, state, step = make_trainer(dev)
    reset_counts()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics.loss)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [float(x) for x in losses]
    log(f"  losses: {losses}")
    log(f"  launches: {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a training loss is not finite")
    chunks = accumulation_chunks(B, TRAIN_M, 262_144, "cesar")
    want = {name: (TRAIN_STEPS * chunks if name in TRAIN_KERNELS else 0) for name in counts}
    if counts != want:
        raise AssertionError(f"training launches {counts}, expected {want}")
    log("phase 5: one step from the same state and seed, kernels vs plain versions")
    got = train_step_grads(dev, batch, plain=False)
    ref = train_step_grads(dev, batch, plain=True)
    check_step_grads(got, ref)
    return {"launches": counts, "model": model, "state": state, "step": step}


def phase6_train_timings(dev, errs, launches, trainer, batch) -> list:
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    ins, (dout, l, m, di, dssq, dsumw), _ = train_kernel_inputs(TRAIN_M, dev, 5)
    calls = {
        "coattn_fwd_fused_k_train": (
            lambda: coattn.coattn_fwd_fused_k_train(*ins, TRAIN_RATE),
            lambda: coattn.coattn_fwd_fused_k_train_plain(*ins, TRAIN_RATE)),
        "coattn_bwd_fused_k": (
            lambda: coattn.coattn_bwd_fused_k(*ins, TRAIN_RATE, dout, l, m, di, dssq, dsumw),
            lambda: coattn.coattn_bwd_fused_k_plain(*ins, TRAIN_RATE, dout, dssq, dsumw)),
    }
    rows = []
    for name, (kern, plain) in calls.items():
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        line = (f"phase 6: {name} B={B} N={N} M={TRAIN_M} F=E={E} dropout {TRAIN_RATE}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, ")
        # 3xTF32 products over the valid keys
        bounds = (fk_bwd_bound_ms(ins[4]) if name == "coattn_bwd_fused_k"
                  else fk_fwd_bound_ms(name, ins[4]))
        bms, by = bounds[:2]
        log(line + fk_bound_line(ms, bounds))
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
    step, state = trainer["step"], trainer["state"]
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    log(f"phase 6: training step, {B} bags of the {TRAIN_M} bucket: "
        f"{', '.join(f'{t:.3f}' for t in times)} ms (host clock, synchronized); median "
        f"{med:.3f} ms = {B / med * 1e3:.1f} train bags/s")
    return rows


def ge_pool_inputs(m_len, seed, dev, masked=True):
    """Pool inputs of GE's scale: x like a post-LayerNorm transformer output
    (std 1), gating weights that give a and g of order 1 and scores of std
    ~2 (a peaked, non-uniform softmax), ragged masks, the last bag fully
    masked (a filler row)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(GE_B, m_len, GE_D, generator=g)
    wa, wb = (torch.randn(GE_D, GE_D, generator=g) / math.sqrt(GE_D) for _ in range(2))
    ba, bb = (0.1 * torch.randn(GE_D, generator=g) for _ in range(2))
    wc = 0.25 * torch.randn(GE_D, 1, generator=g)
    bc = 0.1 * torch.randn(1, generator=g)
    mask = None
    if masked:
        lengths = torch.randint(m_len // 5, m_len + 1, (GE_B,), generator=g)
        lengths[0] = m_len
        lengths[-1] = 0
        mask = (torch.arange(m_len)[None, :] < lengths[:, None]).to(dev)
    return [x.to(dev), mask] + [t.to(dev) for t in (wa, ba, wb, bb, wc, bc)]


def ge_flash_inputs(b, heads, m_len, seed, dev, e=GE_D):
    """q, k, v as MultiheadAttention hands them over: the head views of one
    packed [B, M, 3E] projection (strided, read in place), q and k of std
    ~1.5 and 1 (scores of std ~1.5: a peaked softmax); ragged masks, the
    last bag fully masked when there is more than one."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(b, m_len, 3 * e, generator=g)
    qkv[..., :e] *= 1.5
    qkv = qkv.to(dev)
    lengths = torch.randint(m_len // 5, m_len + 1, (b,), generator=g)
    if b > 1:
        lengths[-1] = 0
    mask = (torch.arange(m_len)[None, :] < lengths[:, None]).to(dev)
    q, k, v = (t.reshape(b, m_len, heads, e // heads).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    return q, k, v, mask


def plain_chunk(b, heads, m_len) -> int:
    """Query rows per step of the plain attention: scores of at most 1 GiB."""
    return max(1, min(1024, 2**28 // (b * heads * m_len)))


def phase7_ge_kernels(dev) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash, milpool

    errs = {"milpool": 0.0, **{f"flash_fwd_d{w}": 0.0 for _, w, _ in FLASH_INSTANCES}}
    for m_len, masked in ((GE_M, True), (24576, True), (5000, True), (5000, False)):
        log(f"phase 7: MIL pool B={GE_B} M={m_len} D=H={GE_D} "
            f"{'ragged masks, one fully-masked bag' if masked else 'mask=None'}")
        args = ge_pool_inputs(m_len, m_len + int(masked), dev, masked)
        pooled, scores = milpool.fused_gated_mil_pool(*args)
        pooled_ref, scores_ref = milpool.gated_mil_pool_plain(*args)
        errs["milpool"] = max(errs["milpool"],
                              check_close("milpool.pooled", pooled, pooled_ref, GE_ATOL),
                              check_close("milpool.scores", scores, scores_ref, GE_ATOL))
        if masked:  # the fully-masked filler bag pools uniformly, never NaN
            check_close("milpool.filler_bag", pooled[-1], args[0][-1].mean(dim=0), GE_ATOL)
    for heads, width, e in FLASH_INSTANCES:
        name = f"flash_fwd_d{width}"
        # medium at its own path's shapes; small and big at phase 17's
        shapes = (((GE_B, GE_M, False), (2, GE_M, False), (2, 5000, True), (1, 24576, False))
                  if e == GE_D else ((GE_WIDE_B, GE_WIDE_M, False), (2, 5000, True)))
        for b, m_len, contiguous in shapes:
            log(f"phase 7: flash forward B={b} H={heads} dh={width} M={m_len}, "
                f"{'contiguous' if contiguous else 'strided'} q/k/v, ragged masks"
                f"{', one fully-masked bag' if b > 1 else ''}")
            q, k, v, mask = ge_flash_inputs(b, heads, m_len, m_len + heads, dev, e)
            if contiguous:
                q, k, v = (t.contiguous() for t in (q, k, v))
            out = flash.flash_attention(q, k, v, mask)
            ref = flash.flash_attention_plain(q, k, v, mask, chunk=plain_chunk(b, heads, m_len))
            if out.shape != ref.shape:
                raise AssertionError(f"flash output shape {tuple(out.shape)}")
            valid = mask[:, None, :, None].expand_as(out)
            errs[name] = max(
                errs[name],
                check_close("flash.valid_rows", out[valid], ref[valid], GE_ATOL),
                check_close("flash.pad_rows", out[~valid], ref[~valid], GE_ATOL))
            if b > 1:  # no valid key: the uniform mean of v
                check_close("flash.filler_bag", out[-1],
                            v[-1].mean(dim=1, keepdim=True).expand_as(out[-1]), GE_ATOL)
            del out, ref, valid
    torch.cuda.synchronize()
    return errs


def make_ge_bags(seed):
    """12 bags of 5000..16384 patches; the first two sit in the 8192 bucket."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5000, GE_BUCKETS[-1] + 1, size=GE_N_BAGS)
    lengths[0], lengths[1] = 5000, 7001
    return [rng.standard_normal((int(n), 1024), dtype=np.float32) for n in lengths]


def make_ge_predictor(dev, batch_size=GE_B, size="medium", buckets=GE_BUCKETS):
    """The GE serving configuration: GE-NaCAGaT (medium), random weights from
    seed 0, 3 classes, loss ce."""
    from multimodal_path_omic_tpu_torch.serve import Predictor

    return Predictor("GE-NaCAGaT", model_size=size, buckets=buckets,
                     batch_size=batch_size, seed=0, device=dev)


def reset_counts() -> None:
    from multimodal_path_omic_tpu_torch.ops import coattn, flash, gather, milpool

    for mod in (coattn, flash, gather, milpool):
        mod.reset_launch_counts()


def read_counts() -> dict:
    from multimodal_path_omic_tpu_torch.ops import coattn, flash, gather, milpool

    return {**coattn.LAUNCH_COUNTS, **flash.LAUNCH_COUNTS, **gather.LAUNCH_COUNTS,
            **milpool.LAUNCH_COUNTS}


def ge_eval_scores(pred, bags, bucket=GE_BUCKETS[0]):
    """The raw MIL scores [len(bags), bucket] of one eval step on ``bags``
    padded into ``bucket``."""
    import torch

    wsi = torch.zeros((len(bags), bucket, 1024))
    mask = torch.zeros((len(bags), bucket), dtype=torch.bool)
    for row, bag in enumerate(bags):
        wsi[row, :len(bag)] = torch.from_numpy(bag)
        mask[row, :len(bag)] = True
    dev = pred.device
    out = pred.eval_step({
        "wsi": wsi.to(dev), "mask": mask.to(dev),
        "label": torch.zeros(len(bags), dtype=torch.long, device=dev),
        "weight": torch.ones(len(bags), device=dev),
    })
    return out["attention"]["path"][:, 0].cpu(), mask


def phase8_ge_predictor(dev, bags) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.data.bags import bucket_for

    log(f"phase 8: GE-NaCAGaT medium Predictor, {len(bags)} bags of "
        f"{min(map(len, bags))}..{max(map(len, bags))} patches, buckets {GE_BUCKETS}, "
        f"batch_size {GE_B}, no omics")
    pred = make_ge_predictor(dev)
    per_bucket = {}
    for bag in bags:
        bucket = bucket_for(len(bag), GE_BUCKETS)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    batches = sum(-(-n // GE_B) for n in per_bucket.values()) + 1  # + predict_bag
    reset_counts()
    out = pred.predict_bags(bags)
    single = pred.predict_bag(bags[1])
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches over {batches} batches: {counts}")
    want = {name: 0 for name in counts}
    want.update(flash_fwd_d256=batches, flash_fwd_d32=2 * batches, milpool=batches)
    if counts != want:
        raise AssertionError(f"GE launches {counts}, expected {want}")
    y = out["y"]
    if set(out) != {"y"} or y.shape != (len(bags), 3) or not np.isfinite(y).all():
        raise AssertionError(f"GE outputs {set(out)}, y {y.shape}")
    if float(np.abs(y.sum(axis=1) - 1.0).max()) > 1e-5:
        raise AssertionError("GE class probabilities do not sum to 1")
    log(f"  y over {len(bags)} bags: min {y.min():.6f} max {y.max():.6f}; spread over bags "
        f"{y.std(axis=0).max():.3e}")
    d = float(np.abs(single["y"] - y[1:2]).max())
    log(f"  predict_bag vs predict_bags row 1: |y diff| = {d:.3e}")
    if d > MODEL_ATOL:
        raise AssertionError("GE predict_bag and predict_bags disagree")
    # against the plain path: the same Predictor (same seed) on the CPU, on the
    # two bags of the 8192 bucket (the CPU's chunked M x M attention is slow)
    cpu = make_ge_predictor("cpu", batch_size=2)
    t0 = time.perf_counter()
    ref = cpu.predict_bags(bags[:2])
    err = float(np.abs(y[:2] - ref["y"]).max())
    log(f"  y vs CPU plain path: max_abs_err={err:.3e} (tolerance {MODEL_ATOL:g}; CPU "
        f"{time.perf_counter() - t0:.1f} s)")
    if err > MODEL_ATOL:
        raise AssertionError("GE y disagrees with the CPU plain path")
    # y is a softmax over 3 classes and hides much; the raw MIL scores of the
    # valid patches carry every layer's output
    got_s, mask = ge_eval_scores(pred, bags[:2])
    ref_s, _ = ge_eval_scores(cpu, bags[:2])
    err = float((got_s - ref_s)[mask].abs().max())
    log(f"  raw MIL scores of the valid patches vs CPU plain path: max_abs_err={err:.3e} "
        f"(tolerance {MODEL_ATOL:g}; max |score| {float(ref_s[mask].abs().max()):.3e})")
    if not (err <= MODEL_ATOL and bool(torch.isfinite(got_s).all())):
        raise AssertionError("GE MIL scores disagree with the CPU plain path")
    return {"launches": counts, "predictor": pred}


def ge_bound_ms(name, mask=None, e=GE_D) -> tuple:
    """(bound ms, 'bytes' | 'operations', float32-FMA bound ms or None) of the
    GE kernels at B=8, M=16384, D=H=256 (the pool) or heads * width = e (the
    flash forward). The flash forward needs only the valid keys' products (a
    masked key's weight is exactly 0; a bag with no valid key needs all of
    them): counted from ``mask``. Its operations run as 3xTF32 on the tensor
    cores (three TF32 products each); the float32-FMA bound comes beside."""
    import torch

    b, m, d = GE_B, GE_M, GE_D
    t_f32 = None
    if name == "milpool":
        nbytes = 4 * (b * m * d + 2 * d * d + 3 * d + 1 + b * d + b * m) + b * m
        t_ops = (4 * b * m * d * d + 2 * b * m * d + 2 * b * m * d) / PEAK_F32_FLOP_PER_S * 1e3
    else:
        n_valid = mask.sum(dim=1)
        keys = int(torch.where(n_valid == 0, m, n_valid).sum().item())
        nbytes = 4 * 4 * b * m * e + b * m
        ops = 4 * m * keys * e  # heads * width = e
        t_ops = 3 * ops / PEAK_TF32_FLOP_PER_S * 1e3
        t_f32 = ops / PEAK_F32_FLOP_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (t_f32,)


def sdpa_ms(q, k, v, mask):
    """One scaled_dot_product_attention call on the same inputs (timed as the
    yardstick; the port never calls it), restricted to its memory-efficient
    backend: the math backend would materialize the M x M scores."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :])

    return cuda_ms(call, iters=2, warmup=1), call()


def phase9_ge_timings(dev, errs, launches, pred, bags) -> list:
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash, milpool

    def row(name, ms, plain_ms, bound, library_ms):
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}

    args = ge_pool_inputs(GE_M, 11, dev)
    ms = cuda_ms(lambda: milpool.fused_gated_mil_pool(*args))
    plain_ms = cuda_ms(lambda: milpool.gated_mil_pool_plain(*args))
    bound = ge_bound_ms("milpool")
    log(f"phase 9: milpool B={GE_B} M={GE_M} D=H={GE_D}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    # no single PyTorch call computes a gated scoring head with its pooled sum
    rows = [row("milpool", ms, plain_ms, bound, None)]
    del args
    for heads, width, e in FLASH_INSTANCES:  # every instance at the medium path's B and M
        name = f"flash_fwd_d{width}"
        q, k, v, mask = ge_flash_inputs(GE_B, heads, GE_M, 13 + heads, dev, e)
        chunk = plain_chunk(GE_B, heads, GE_M)
        ms = cuda_ms(lambda: flash.flash_attention(q, k, v, mask), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: flash.flash_attention_plain(q, k, v, mask, chunk=chunk),
                           iters=1, warmup=1)
        lib_ms, lib_out = sdpa_ms(q, k, v, mask)
        bound = ge_bound_ms(name, mask, e)
        log(f"phase 9: {name} B={GE_B} H={heads} dh={width} M={GE_M}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (chunks of {chunk} rows), "
            f"scaled_dot_product_attention {lib_ms:.4f} ms; bounds over the valid keys: "
            f"3xTF32 {bound[0]:.4f} ms ({bound[1]}; {bound[0] / ms:.3f} of it reached), "
            f"float32 FMA {bound[2]:.4f} ms (all keys: "
            f"{4 * GE_B * GE_M * GE_M * e / PEAK_F32_FLOP_PER_S * 1e3:.4f} ms)")
        # the library call is a second reference on the bags with valid keys
        # (its -inf fill makes the bag without one NaN)
        out = flash.flash_attention(q, k, v, mask)
        check_close(f"{name} vs scaled_dot_product_attention", out[:-1], lib_out[:-1], GE_ATOL)
        rows.append(row(name, ms, plain_ms, bound, lib_ms))
        del q, k, v, mask, out, lib_out
    pred.predict_bags(bags)  # warm
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_bags(bags)
        torch.cuda.synchronize()
        rates.append(len(bags) / (time.perf_counter() - t0))
    log(f"phase 9: GE predict_bags: {len(bags)} bags, 3 calls: "
        f"{', '.join(repr(r) for r in rates)} bags/s (host clock, batches of {GE_B}, "
        f"buckets {GE_BUCKETS})")
    return rows


def flash_bwd_inputs(b, heads, m_len, seed, dev, e=GE_D, contiguous=False):
    """The flash backward's inputs as autograd hands them over: q, k, v and
    the mask of :func:`ge_flash_inputs`, the forward kernel's own out and
    (m, l), and a random cotangent laid out [B, M, E] (the out-projection's
    input gradient), non-zero on pad rows too."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash

    q, k, v, mask = ge_flash_inputs(b, heads, m_len, seed, dev, e)
    if contiguous:
        q, k, v = (t.contiguous() for t in (q, k, v))
    out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    dout = torch.randn(b, m_len, e, generator=g).to(dev)
    dout = dout.reshape(b, m_len, heads, e // heads).transpose(1, 2)
    return q, k, v, mask, out, m, l, dout


def phase10_flash_bwd_kernels(dev) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash

    errs = {}
    for heads, width, e in FLASH_INSTANCES:
        name = f"flash_bwd_d{width}"
        errs[name] = 0.0
        shapes = (((GE_B, GE_M, False), (2, 5000, True), (2, 24576, False)) if e == GE_D
                  else ((GE_WIDE_B, GE_WIDE_M, False), (2, 5000, True)))
        for b, m_len, contiguous in shapes:
            log(f"phase 10: flash backward B={b} H={heads} dh={width} M={m_len}, "
                f"{'contiguous' if contiguous else 'strided'} q/k/v, ragged masks, one bag "
                f"without a valid key; dq, dk, dv packed")
            q, k, v, mask, out, m, l, dout = flash_bwd_inputs(b, heads, m_len, m_len + heads, dev,
                                                              e, contiguous)
            chunk = plain_chunk(b, heads, m_len)
            if not torch.equal(out, flash.flash_fwd(q, k, v, mask)[0]):
                raise AssertionError("the forward's out differs with and without (m, l)")
            ref_out, ref_m, ref_l = flash.flash_attention_plain(q, k, v, mask, chunk=chunk,
                                                               return_stats=True)
            check_close("flash.out", out, ref_out, GE_ATOL)
            check_close("flash.m", m, ref_m, GE_ATOL)
            check_close("flash.l", l, ref_l, GE_ATOL, L_RTOL)
            if not (bool((m[-1] == -1e9).all()) and bool((l[-1] == m_len).all())):
                raise AssertionError("the bag without a valid key must have m = -1e9, l = M")
            del ref_out, ref_m, ref_l
            got = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
            again = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
            ref = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout, chunk=chunk)
            for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
                errs[name] = max(errs[name], check_rel(f"flash_bwd.{gname}", a, r, GRAD_RTOL))
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError("two flash backward runs differ")
            log("  flash_bwd: two runs bitwise equal")
            # the mask is a where: no dq or dk through a masked key, even in
            # the bag without a valid key, whose weights 1/M still feed dv
            dq, dk, dv = got
            pad = ~mask[:, None, :, None].expand_as(dk)
            if float(dk[pad].abs().max()) != 0.0 or float(dq[-1].abs().max()) != 0.0:
                raise AssertionError("a masked key passed a gradient to q or k")
            if not float(dv[-1].abs().min()) > 0.0:
                raise AssertionError("the bag without a valid key must still feed dv")
            del got, again, ref, dq, dk, dv, pad
    torch.cuda.synchronize()
    return errs


def make_ge_trainer(dev, size="medium"):
    """The GE training configuration: GE-NaCAGaT (medium), random weights from
    seed 0, ce, dropout 0.25, Adam lr 2e-4 / weight decay 1e-5, dropout
    generator seeded with 0."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    model = seeded_init_(build_model("GE-NaCAGaT", model_size=size, dropout=TRAIN_RATE),
                         0).to(dev)
    opt = make_optimizer("adam", 2e-4, 1e-5)
    return model, init_train_state(model, opt, seed=0), make_train_step(model, "ce", opt,
                                                                        ge_mode=True)


def stage_ge_train_batch(dev, bags, b=GE_B, m_len=GE_M, seed=3) -> dict:
    """One b-row batch of the m_len bucket, on the card once: the first b - 1
    bags (phase 8's: numpy seed 2) and one zero-weight filler row without a
    valid patch; labels from numpy ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    wsi = torch.zeros((b, m_len, bags[0].shape[1]), device=dev)
    mask = torch.zeros((b, m_len), dtype=torch.bool, device=dev)
    weight = torch.ones(b, device=dev)
    for row in range(b - 1):
        wsi[row, :len(bags[row])] = torch.from_numpy(bags[row]).to(dev)
        mask[row, :len(bags[row])] = True
    weight[-1] = 0.0
    return {"wsi": wsi, "mask": mask, "weight": weight,
            "label": torch.from_numpy(rng.integers(0, 3, b)).to(dev)}


def plain_flash():
    """The flash wrappers' plain versions, on the card, in the row chunks that
    fit it: (forward, backward) with the wrappers' signatures."""
    from multimodal_path_omic_tpu_torch.ops import flash

    def fwd_plain(q, k, v, key_mask=None, sm_scale=None, *, need_stats=False):
        res = flash.flash_attention_plain(q, k, v, key_mask, sm_scale, return_stats=need_stats,
                                          chunk=plain_chunk(*q.shape[:3]))
        return res if need_stats else (res, None, None)

    def bwd_plain(q, k, v, key_mask, out, m, l, dout, sm_scale=None):
        return flash.flash_attention_bwd_plain(q, k, v, key_mask, out, m, l, dout, sm_scale,
                                               chunk=plain_chunk(*q.shape[:3]))

    return fwd_plain, bwd_plain


def ge_train_step_grads(dev, batch, plain: bool, size="medium") -> dict:
    """Parameter gradients of one GE training step from the phase-11 start
    state and seed, through the flash kernels or through their plain
    versions."""
    from multimodal_path_omic_tpu_torch.ops import flash

    model, state, step = make_ge_trainer(dev, size)
    saved = flash.flash_fwd, flash.flash_bwd
    if plain:
        flash.flash_fwd, flash.flash_bwd = plain_flash()
    try:
        step(state, batch)
    finally:
        flash.flash_fwd, flash.flash_bwd = saved
    return {name: p.grad.clone() for name, p in model.named_parameters()}


def phase11_ge_training(dev, batch) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.train.loop import accumulation_chunks

    n_real = int(batch["weight"].sum().item())
    log(f"phase 11: GE-NaCAGaT medium trainer, ce, dropout {TRAIN_RATE}, Adam; batch "
        f"[{GE_B}, {GE_M}, 1024] ({n_real} bags, {GE_B - n_real} zero-weight filler row), "
        f"{GE_TRAIN_STEPS} steps")
    if accumulation_chunks(GE_B, GE_M, 262_144, "ce") != 1:
        raise AssertionError("the GE batch must fit one accumulation chunk")
    model, state, step = make_ge_trainer(dev)
    reset_counts()
    losses = []
    for _ in range(GE_TRAIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics.loss)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [float(x) for x in losses]
    log(f"  losses: {losses}")
    log(f"  launches: {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a GE training loss is not finite")
    want = {name: 0 for name in counts}
    for width, per_step in ((256, 1), (32, 2)):  # GE's own self-attention; two layers
        want[f"flash_fwd_d{width}"] = want[f"flash_bwd_d{width}"] = per_step * GE_TRAIN_STEPS
    if counts != want:
        raise AssertionError(f"GE training launches {counts}, expected {want}")
    log("phase 11: one step from the same state and seed, kernels vs plain versions")
    got = ge_train_step_grads(dev, batch, plain=False)
    ref = ge_train_step_grads(dev, batch, plain=True)
    check_step_grads(got, ref)
    return {"launches": counts, "state": state, "step": step, "n_real": n_real}


def ge_bwd_bound_ms(heads, mask, e=GE_D) -> tuple:
    """(bound ms, 'bytes' | 'operations', float32-FMA bound ms) of one flash
    backward at B=8, M=16384, heads * width = e: the five necessary products
    (s, dp, dv, dq, dk) over the valid keys (a bag with no valid key needs all
    of them) as 3xTF32; q, k, v, out, dout, m, l and the mask read once, dq,
    dk, dv written once."""
    import torch

    b, m = GE_B, GE_M
    n_valid = mask.sum(dim=1)
    keys = int(torch.where(n_valid == 0, m, n_valid).sum().item())
    nbytes = 4 * (8 * b * m * e + 2 * b * heads * m) + b * m
    ops = 10 * m * keys * e
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * ops / PEAK_TF32_FLOP_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (
        ops / PEAK_F32_FLOP_PER_S * 1e3,)


def sdpa_bwd_ms(q, k, v, mask, dout):
    """The backward of one scaled_dot_product_attention call on the same
    inputs (memory-efficient backend; timed as the yardstick, the port never
    calls it): (ms, (dq, dk, dv))."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask[:, None, None, :])

    def call():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    return cuda_ms(call, iters=2, warmup=1), call()


def phase12_ge_train_timings(dev, errs, launches, trainer, batch) -> list:
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash

    rows = []
    for heads, width, e in FLASH_INSTANCES:  # every instance at the medium path's B and M
        name = f"flash_bwd_d{width}"
        q, k, v, mask, out, m, l, dout = flash_bwd_inputs(GE_B, heads, GE_M, 17 + heads, dev, e)
        chunk = plain_chunk(GE_B, heads, GE_M)
        ms = cuda_ms(lambda: flash.flash_bwd(q, k, v, mask, out, m, l, dout), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: flash.flash_attention_bwd_plain(
            q, k, v, mask, out, m, l, dout, chunk=chunk), iters=1, warmup=1)
        lib_ms, lib = sdpa_bwd_ms(q, k, v, mask, dout)
        bound = ge_bwd_bound_ms(heads, mask, e)
        log(f"phase 12: {name} B={GE_B} H={heads} dh={width} M={GE_M}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (chunks of {chunk} rows), "
            f"scaled_dot_product_attention backward {lib_ms:.4f} ms; bounds of the five "
            f"products over the valid keys: 3xTF32 {bound[0]:.4f} ms ({bound[1]}; "
            f"{bound[0] / ms:.3f} of it reached), float32 FMA {bound[2]:.4f} ms")
        # the library's gradients are a second reference on the bags with
        # valid keys (its -inf fill makes the bag without one NaN)
        got = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
        for gname, a, r in zip(("dq", "dk", "dv"), got, lib):
            check_rel(f"{name}.{gname} vs scaled_dot_product_attention", a[:-1], r[:-1],
                      GRAD_RTOL)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms,
        })
        del q, k, v, mask, out, m, l, dout, got, lib
    step, state = trainer["step"], trainer["state"]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    n_real = trainer["n_real"]
    log(f"phase 12: GE training step, {n_real} bags and {GE_B - n_real} filler row of the "
        f"{GE_M} bucket: {', '.join(f'{t:.3f}' for t in times)} ms (host clock, "
        f"synchronized); median {med:.3f} ms = {n_real / med * 1e3:.3f} GE train bags/s")
    return rows


def plain_k_inputs(m_len, seed, dev, kind="prefix", d=E):
    """q, k and the mask of :func:`make_inputs` (projected queries and keys
    of width ``d``; ``kind``: its masks), ReLU-free projected values, a
    dropout seed and the backward's cotangents."""
    import torch

    q, _, _, _, k, mask = make_inputs(m_len, d, seed, dev, d, kind)
    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    v = 0.7 * torch.randn(B, m_len, d, generator=g)
    dout = torch.randn(B, N, d, generator=g)
    dssq, dsumw = (torch.randn(B, N, generator=g) for _ in range(2))
    dseed = torch.tensor([seed], dtype=torch.int32)
    return (q, k, v.to(dev), mask, dseed.to(dev)), tuple(t.to(dev) for t in (dout, dssq, dsumw))


def check_one_key_plain(got, ref, q, k, fwd, dout, dssq, dsumw, di) -> None:
    """dq and dk of the plain-K backward in bags with a single valid key:
    zero in exact arithmetic (ds = 0, as :func:`check_one_key_dq` states),
    so both sides hold float32 noise alone, held to GRAD_RTOL of the terms
    that cancel, c_n, times the largest factor ds meets on its way to dq
    (scale |k|max + |a|max / 2) or, summed over the queries, to dk (scale
    |q_n|max + |a|max / 2; |tanh| <= 1), with |a| <= scale |q_n|_1 |k|max."""
    import torch

    o, _, _, ssq, sumw = fwd
    scale = 1.0 / math.sqrt(q.shape[-1])
    kmax = k.abs().amax((1, 2))[:, None]  # [bags, 1]
    c = (o * dout).sum(-1).abs() + di.abs() + 2 * (dssq * ssq).abs() + (dsumw * sumw).abs()
    amax = scale * q.abs().sum(-1) * kmax / 2
    limits = (GRAD_RTOL * c * (scale * kmax + amax))[..., None], (
        GRAD_RTOL * c * (scale * q.abs().amax(-1) + amax)).sum(-1)[:, None, None]
    def ratio(x, limit):  # a query whose one weight was dropped has c = 0 and ds = 0 exactly
        x = x.abs().expand(torch.broadcast_shapes(x.shape, limit.shape))
        limit = limit.expand_as(x)
        r = torch.where(x == 0, torch.zeros_like(x), torch.full_like(x, math.inf))
        return float(torch.where(limit > 0, x / limit.clamp_min(1e-30), r).max())

    for name, a, r, limit in zip(("dq", "dk"), got, ref, limits):
        worst = max(ratio(a, limit), ratio(r, limit))
        log(f"  plain_bwd.{name}, {a.shape[0]} bag(s) with one valid key: max |{name}| "
            f"{a.abs().max():.3e} (plain {r.abs().max():.3e}), at {worst:.3f} of the limit "
            f"{GRAD_RTOL:g} x the terms that cancel {'ok' if worst <= 1.0 else 'FAIL'}")
        if not (worst <= 1.0 and bool(torch.isfinite(a).all())):
            raise AssertionError(f"{name} of a bag with one valid key is above its noise limit")


# Phase 13's plain-K cases (M, mask kind, D): the serving and training
# batch's M and a ragged one with prefix masks (a fully-masked filler row),
# whole masked 64-key tiles mid-bag (which the kernels skip), a bag with a
# single valid key, and D = 128.
PHASE13_CASES = ((TRAIN_M, "prefix", E), (5000, "prefix", E), (TRAIN_M, "holes", E),
                 (1500, "one", E), (4000, "holes", 128), (1500, "one", 128))


def phase13_plain_kernels(dev) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn, gather

    errs = {"coattn_plain": 0.0, "coattn_plain_bwd": 0.0, "gather_rows": 0.0}
    for m_len, kind, d in PHASE13_CASES:
        ins, (dout, dssq, dsumw) = plain_k_inputs(m_len, 131 + m_len, dev, kind, d)
        q, k, v, mask, dseed = ins
        one = mask.sum(-1) == 1
        has = mask.any(-1)
        for pre_gate in (True, False):
            log(f"phase 13: plain-K kernels B={B} N={N} D={d} M={m_len} pre_gate={pre_gate}, "
                f"{kind} masks")
            got = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
            again = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
            ref = coattn.coattn_fwd_plain_k_plain(q, k, v, mask, None, 0.0, pre_gate=pre_gate)
            if got[3] is not None or got[4] is not None:
                raise AssertionError("the eval form returns no ssq / sumw")
            e = 0.0
            for name, a, r, rtol in zip(("o", "l", "m"), got, ref, (0.0, L_RTOL, 0.0)):
                err = check_close(f"plain_fwd_eval.{name}", a, r, KERNEL_ATOL, rtol)
                e = max(e, 0.0 if name == "l" else err)
            # the fully-masked filler row: uniform over its M keys
            check_close("plain_fwd_eval.filler_row", got[0][-1],
                        v[-1].mean(dim=0).expand_as(got[0][-1]), KERNEL_ATOL)
            if bool(one.any()):  # a bag with one valid key pools that key's v row
                row = v[one][torch.arange(int(one.sum()), device=dev),
                             mask[one].float().argmax(-1)]
                check_close("plain_fwd_eval.o of the bag with one valid key, its v row",
                            got[0][one], row[:, None, :].expand_as(got[0][one]), KERNEL_ATOL)
            if not all(torch.equal(a, c) for a, c in zip(got[:3], again[:3])):
                raise AssertionError("two plain-K eval forward runs differ")
            got = coattn.coattn_fwd_plain_k(*ins, TRAIN_RATE, pre_gate=pre_gate)
            again = coattn.coattn_fwd_plain_k(*ins, TRAIN_RATE, pre_gate=pre_gate)
            ref = coattn.coattn_fwd_plain_k_plain(*ins, TRAIN_RATE, pre_gate=pre_gate)
            for name, a, r, rtol in zip(("o", "l", "m", "ssq", "sumw"), got, ref,
                                        (0.0, L_RTOL, 0.0, 0.0, 0.0)):
                err = check_close(f"plain_fwd_train.{name}", a, r, KERNEL_ATOL, rtol)
                e = max(e, 0.0 if name == "l" else err)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError("two plain-K training forward runs differ")
            log("  plain_fwd: two runs bitwise equal, eval and training forms")
            errs["coattn_plain"] = max(errs["coattn_plain"], e)
            o, l, m, ssq, sumw = fwd = ref
            di = (o * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
            args = (*ins, TRAIN_RATE, dout, l, m, di, dssq, dsumw)
            got = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
            again = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
            ref = coattn.coattn_bwd_plain_k_plain(*ins, TRAIN_RATE, dout, dssq, dsumw,
                                                  pre_gate=pre_gate)
            if bool(one.any()):  # dq, dk of a bag with one valid key: noise on both sides
                check_one_key_plain([t[one] for t in got[:2]], [t[one] for t in ref[:2]], q[one],
                                    k[one], [t[one] for t in fwd], dout[one], dssq[one],
                                    dsumw[one], di[one])
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                if name != "dv":
                    a, r = a[~one], r[~one]
                errs["coattn_plain_bwd"] = max(errs["coattn_plain_bwd"],
                                               check_rel(f"plain_bwd.{name}", a, r, GRAD_RTOL))
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError("two plain-K backward runs differ")
            dq, dk, dv = got
            pad = ~mask[:, :, None].expand_as(dk)
            if float(dk[pad].abs().max()) != 0.0 or float(dq[-1].abs().max()) != 0.0:
                raise AssertionError("a masked key passed a gradient to q or k")
            if float(dv[has][~mask[has]].abs().max()) != 0.0:
                raise AssertionError("dv is not exactly 0 at a masked key of a bag with a valid key")
            if not float(dv[-1].abs().max()) > 0.0:
                raise AssertionError("the fully-masked row must still feed dv")
            log("  plain_bwd: two runs bitwise equal; no dk, dq through masked keys; dv exactly "
                "0 at the masked keys of bags with a valid key")
        keep = coattn.dropout_bits(dseed, (B, N, m_len), dev) >= coattn.dropout_threshold(
            TRAIN_RATE)
        drop = 1.0 - float(keep.double().mean().item())
        log(f"  drop share of the Philox bits over {keep.numel()} draws: {drop:.6f} "
            f"(tolerance {TRAIN_RATE} +- {DROP_TOL})")
        # held at M >= 5000 (>= 960,000 draws: DROP_TOL is >= 4.5 standard errors)
        if m_len >= 5000 and abs(drop - TRAIN_RATE) > DROP_TOL:
            raise AssertionError("the dropout bits miss the rate")
        del ins, got, again, ref, dq, dk, dv, pad, keep
    g = torch.Generator(device="cpu").manual_seed(17)
    idx = torch.randint(0, 12, (B,), generator=g)
    idx[1] = idx[0]  # a repeated index
    for dtype, shape in ((torch.float32, (12, TRAIN_M, 1024)), (torch.bfloat16, (12, 4096, 1024)),
                         (torch.int8, (12, 4096, 1024)), (torch.int8, (12, 100, 24)),
                         (torch.float32, (3, 5000, 1024))):
        if dtype == torch.int8:
            pool = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).to(dev)
        else:
            pool = torch.randn(shape, generator=g).to(dev).to(dtype)
        for ix in (idx % shape[0]).to(dev), (idx % shape[0]).to(dev).int():
            got = gather.gather_rows(pool, ix)
            if not torch.equal(got, torch.index_select(pool, 0, ix.long())):
                raise AssertionError(f"gather_rows differs from index_select ({dtype}, {shape})")
        log(f"phase 13: gather_rows {dtype} pool {shape}, {B} indices (int64 and int32, "
            f"repeats): equal to index_select bit for bit")
        del pool, got
    torch.cuda.synchronize()
    return errs


def expect_counts(what, counts, **want) -> None:
    full = {name: 0 for name in counts}
    full.update(want)
    log(f"  launches ({what}): { {k: v for k, v in counts.items() if v} }")
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def check_outputs_close(what, got, ref, idx=None) -> None:
    for k in ("hazards", "survs", "y", "risk"):
        a = got[k] if idx is None else got[k][idx]
        if not np.isfinite(a).all():
            raise AssertionError(f"{what}: non-finite {k}")
        err = float(np.abs(a - ref[k]).max())
        log(f"  {k} vs {what}: max_abs_err={err:.3e} (tolerance {MODEL_ATOL:g})")
        if err > MODEL_ATOL:
            raise AssertionError(f"{k} disagrees with {what}")


def n_batches(bags) -> int:
    from multimodal_path_omic_tpu_torch.data.bags import bucket_for

    per_bucket = {}
    for bag in bags:
        bucket = bucket_for(len(bag), BUCKETS)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    return sum(-(-n // B) for n in per_bucket.values())


def mcat_train_step_grads(dev, batch, plain: bool) -> dict:
    """Parameter gradients of one MCAT ``lean=False`` training step from the
    phase-14 start state and seed, through the plain-K kernels or through
    their plain versions."""
    from multimodal_path_omic_tpu_torch.ops import coattn

    model, state, step = make_trainer(dev, "MCAT", "ces", lean=False)
    saved = coattn.coattn_fwd_plain_k, coattn.coattn_bwd_plain_k
    if plain:
        coattn.coattn_fwd_plain_k = (
            lambda q, k, v, mk, seed=None, rate=0.0, *, pre_gate, train=True:
            coattn.coattn_fwd_plain_k_plain(q, k, v, mk, seed, rate, pre_gate=pre_gate))
        coattn.coattn_bwd_plain_k = (
            lambda q, k, v, mk, seed, rate, dout, l, m, di, dssq, dsumw, *, pre_gate:
            coattn.coattn_bwd_plain_k_plain(q, k, v, mk, seed, rate, dout, dssq, dsumw,
                                            pre_gate=pre_gate))
    try:
        step(state, batch)
    finally:
        coattn.coattn_fwd_plain_k, coattn.coattn_bwd_plain_k = saved
    return {name: p.grad.clone() for name, p in model.named_parameters()}


def run_steps(what, step, state, batch, steps):
    import torch

    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics.loss)
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    log(f"  {what}: losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: a training loss is not finite")
    if losses[-1] > losses[0] + 0.1:
        raise AssertionError(f"{what}: the loss rises")
    return state


def phase14_mcat(dev, bags, omics, batch, nacagat_ces) -> dict:
    import torch

    launches = {"coattn_plain": 0, "coattn_plain_bwd": 0}
    batches = n_batches(bags) + 1  # + predict_bag
    log(f"phase 14a: MCAT medium Predictor (lean), ces, {len(bags)} bags, buckets {BUCKETS}, "
        f"batch_size {B}")
    lean = make_predictor(dev, "ces", model="MCAT")
    reset_counts()
    out_lean = lean.predict_bags(bags, omics)
    single = lean.predict_bag(bags[1], omics[1])
    torch.cuda.synchronize()
    expect_counts("MCAT lean serving", read_counts())
    assert out_lean["risk"].shape == (len(bags),) and out_lean["hazards"].shape == (len(bags), 4)
    log(f"  risk over {len(bags)} bags: min {out_lean['risk'].min():.6f} max "
        f"{out_lean['risk'].max():.6f} std {out_lean['risk'].std():.3e}")
    if float(np.abs(single["risk"] - out_lean["risk"][1:2]).max()) > MODEL_ATOL:
        raise AssertionError("MCAT predict_bag and predict_bags disagree")
    idx = [0, 1, 2]
    cpu = make_predictor("cpu", "ces", batch_size=4, model="MCAT")
    ref = cpu.predict_bags([bags[i] for i in idx], [omics[i] for i in idx])
    check_outputs_close("the CPU Predictor", out_lean, ref, idx)
    # the map of an eval step with need_attention=True, on the training batch
    attn = make_predictor(dev, "ces", model="MCAT", need_attention=True).eval_step(
        batch)["attention"]["coattn"]
    mask = batch["mask"]
    row_sums = (attn * mask[:, None, :]).sum(-1)
    if (tuple(attn.shape) != (B, N, TRAIN_M) or not bool(torch.isfinite(attn).all())
            or float((row_sums - 1.0).abs().max()) > 1e-4
            or float((attn * ~mask[:, None, :]).abs().max()) > 1e-12):
        raise AssertionError("the exported co-attention map is not a masked softmax")
    log(f"  need_attention=True: map {tuple(attn.shape)}, rows sum to 1 over the valid keys "
        f"(max deviation {float((row_sums - 1.0).abs().max()):.3e})")
    del attn, row_sums

    log("phase 14b: MCAT medium Predictor, lean=False (k, v projected; plain-K kernel)")
    pred = make_predictor(dev, "ces", model="MCAT", lean=False)
    reset_counts()
    out = pred.predict_bags(bags, omics)
    pred.predict_bag(bags[1], omics[1])
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("MCAT lean=False serving", counts, coattn_plain=batches)
    launches["coattn_plain"] += counts["coattn_plain"]
    check_outputs_close("the lean route", out, out_lean)

    log("phase 14c: NaCAGaT medium Predictor, ces, lean=False (pre-gated plain-K kernel)")
    pred_n = make_predictor(dev, "ces", lean=False)
    reset_counts()
    out = pred_n.predict_bags(bags, omics)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("NaCAGaT lean=False serving", counts, coattn_plain=batches - 1)
    launches["coattn_plain"] += counts["coattn_plain"]
    check_outputs_close("the lean-V route", out, nacagat_ces.predict_bags(bags, omics))

    log(f"phase 14d: MCAT medium trainer, ces, dropout {TRAIN_RATE}, Adam; batch "
        f"[{B}, {TRAIN_M}, 1024]")
    from multimodal_path_omic_tpu_torch.train.loop import accumulation_chunks

    if accumulation_chunks(B, TRAIN_M, 262_144, "ces") != 1:
        raise AssertionError("the MCAT batch must fit one accumulation chunk")
    trainers = {}
    for is_lean in (True, False):
        _, state, step = make_trainer(dev, "MCAT", "ces", lean=is_lean)
        reset_counts()
        state = run_steps(f"MCAT lean={is_lean}, {MCAT_STEPS} steps", step, state, batch,
                          MCAT_STEPS)
        counts = read_counts()
        want = {} if is_lean else {"coattn_plain": MCAT_STEPS, "coattn_plain_bwd": MCAT_STEPS}
        expect_counts(f"MCAT lean={is_lean} training", counts, **want)
        for name in launches:
            launches[name] += counts[name]
        trainers[is_lean] = (step, state)
    log("phase 14d: one lean=False step from the same state and seed, kernels vs plain versions")
    check_step_grads(mcat_train_step_grads(dev, batch, plain=False),
                     mcat_train_step_grads(dev, batch, plain=True))
    _, state, step = make_trainer(dev, "NaCAGaT", "cesar", lean=False)
    reset_counts()
    run_steps("NaCAGaT cesar lean=False, 2 steps", step, state, batch, 2)
    counts = read_counts()
    expect_counts("NaCAGaT lean=False training", counts, coattn_plain=2, coattn_plain_bwd=2)
    for name in launches:
        launches[name] += counts[name]
    return {"launches": launches, "predictors": {True: lean, False: pred}, "trainers": trainers}


class CacheCohort:
    """A seeded survival cohort held in host memory: ``bag(i)`` [M_i, 1024]
    and the ``table`` columns ``survival_extras`` reads. Bags are ordered
    bucket by bucket (``cohort``: bucket -> number of bags)."""

    def __init__(self, cohort, seed):
        rng = np.random.default_rng(seed)
        lengths = []
        for bucket, count in cohort.items():
            lengths += list(rng.integers(bucket // 2 + 1, bucket + 1, size=count))
        self.lengths = np.array(lengths)
        # uniform draws: several times cheaper on the host than normal ones
        self.bags = [rng.random((int(n), 1024), dtype=np.float32) * 2.0 - 1.0 for n in lengths]
        n = len(lengths)
        self.table = self
        self.survival_months = rng.uniform(1, 100, n).astype(np.float32)
        self.survival_class = rng.integers(0, 4, n)
        self.censorship = rng.integers(0, 2, n).astype(np.float32)
        self.signature_names = [f"sig{j}" for j in range(len(SIZES))]
        self.signature_data = {name: rng.standard_normal((n, s), dtype=np.float32)
                               for name, s in zip(self.signature_names, SIZES)}

    def __len__(self):
        return len(self.bags)

    def bag(self, i):
        return self.bags[i]


def cache_metas(ds, cache, batches=None):
    """(bucket, meta) of each cached batch (default: CACHE_BATCHES): rows
    lo..hi of a bucket's bags."""
    from multimodal_path_omic_tpu_torch.data.device_cache import build_meta

    out = []
    for bucket, lo, hi in batches or CACHE_BATCHES:
        rows = np.flatnonzero(cache.bucket_of == bucket)[lo:hi]
        out.append((bucket, build_meta([int(r) for r in rows], B, cache)[0]))
    return out


def stage_host_batch(ds, bucket, meta, dev) -> dict:
    """The host-fed batch of the same rows: each bag copied into its row of a
    zeroed device batch, the label and omics columns from the host table."""
    import torch

    rows = meta["row"]
    wsi = torch.zeros((len(rows), bucket, 1024), device=dev)
    mask = torch.zeros((len(rows), bucket), dtype=torch.bool, device=dev)
    for j, r in enumerate(rows):
        bag = ds.bag(int(r))
        wsi[j, :len(bag)] = torch.from_numpy(bag).to(dev)
        mask[j, :len(bag)] = True
    return {
        "wsi": wsi, "mask": mask,
        "omics": [torch.from_numpy(ds.signature_data[n][rows]).to(dev)
                  for n in ds.signature_names],
        "label": torch.from_numpy(ds.survival_class[rows].astype(np.int64)).to(dev),
        "censorship": torch.from_numpy(ds.censorship[rows]).to(dev),
        "weight": torch.from_numpy(meta["weight"]).to(dev),
    }


def phase15_device_cache(dev) -> dict:
    import torch

    from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache
    from multimodal_path_omic_tpu_torch.data.pipeline import survival_extras

    t0 = time.perf_counter()
    ds = CacheCohort(CACHE_COHORT, seed=4)
    log(f"phase 15: cohort of {len(ds)} bags ({CACHE_COHORT}), made on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cache = DeviceBagCache(ds, survival_extras, BUCKETS, device=dev, lengths=ds.lengths,
                           upload_chunk=16)
    torch.cuda.synchronize()
    want = DeviceBagCache.nbytes(ds.lengths, BUCKETS, 1024)
    held = torch.cuda.memory_allocated() - before
    log(f"  uploaded once in {time.perf_counter() - t0:.1f} s: DeviceBagCache.nbytes {want} "
        f"bytes of wsi; torch.cuda.memory_allocated grew by {held} bytes (masks and the "
        f"label / omics table included)")
    if not want <= held <= want * 1.01 + (1 << 22):
        raise AssertionError("the cache holds other than its planned bytes")
    metas = cache_metas(ds, cache)
    model_c, state, step = make_trainer(dev, "MCAT", "ces", cached=True)
    reset_counts()
    losses_c = []
    for bucket, meta in metas:
        state, metrics = step(state, cache.caches[bucket], meta)
        losses_c.append(metrics.loss)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("cached MCAT steps", counts, gather_rows=len(metas))
    model_h, state, step = make_trainer(dev, "MCAT", "ces")
    losses_h = []
    for bucket, meta in metas:
        state, metrics = step(state, stage_host_batch(ds, bucket, meta, dev))
        losses_h.append(metrics.loss)
    torch.cuda.synchronize()
    losses_c, losses_h = ([float(x) for x in ls] for ls in (losses_c, losses_h))
    log(f"  cached losses   {losses_c}")
    log(f"  host-fed losses {losses_h}")
    if losses_c != losses_h or not all(math.isfinite(x) for x in losses_c):
        raise AssertionError("cached and host-fed losses differ")
    for (name, p), q in zip(model_c.named_parameters(), model_h.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"cached and host-fed parameter {name} differ")
    log(f"  {len(metas)} cached steps (batches of "
        f"{[int(m['weight'].sum()) for _, m in metas]} bags) and the same batches host-fed: "
        f"losses and all parameters bitwise equal")
    return {"launches": counts, "ds": ds, "cache": cache}


def computed_tile_keys(mask, lone=False) -> int:
    """(bag, key) pairs in the 64-key tiles the plain-K and fuse-K kernels
    compute: with a valid key in the bag, the tiles that hold one; every tile
    of a bag without one, or with ``lone`` (the export passes) none."""
    import torch

    b, m_len = mask.shape
    t = -(-m_len // 64)
    tiles = torch.zeros(b, t * 64, dtype=torch.bool, device=mask.device)
    tiles[:, :m_len] = mask
    tiles = tiles.view(b, t, 64).any(-1)
    tiles[~mask.any(-1)] = not lone
    keys = torch.full((t,), 64, dtype=torch.int64, device=mask.device)
    keys[-1] = m_len - 64 * (t - 1)
    return int((tiles.long() * keys).sum())


def plain_k_bound_ms(name, m_len, keys=None, v_keys=None) -> tuple:
    """Bounds of the plain-K kernels at B=32, N=6, D=256 (pre-gated form: its
    gate product is counted; float32 multiply-adds as 2 operations), their k
    rows read over ``keys`` (bag, key) pairs and their v rows over
    ``v_keys`` (default ``keys``; both default to every key; the backward
    writes dk and dv whole), and of the gather at B=32 rows of [m_len, 1024]
    float32."""
    d = E
    keys = B * m_len if keys is None else keys
    v_keys = keys if v_keys is None else v_keys
    if name == "coattn_plain":  # in: q, k, v, mask; out: o, l, m, ssq, sumw
        nbytes = 4 * (2 * B * N * d + (keys + v_keys) * d + 4 * B * N) + B * m_len
        ops = 2 * N * (2 * keys + v_keys) * d  # q.k, the gate, p.v
    elif name == "coattn_plain_bwd":  # + dout, l, m, di, dssq, dsumw; out: dq, dk, dv
        nbytes = (4 * (3 * B * N * d + (keys + v_keys) * d + 2 * B * m_len * d + 5 * B * N)
                  + B * m_len)
        ops = 16 * N * keys * d  # q.k, gate, dO.v, dv, two terms each of dq and dk
    else:
        nbytes, ops = 2 * B * m_len * 1024 * 4 + 8 * B, 0
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase16_timings(dev, errs, launches, p14, p15, bags, omics, batch) -> list:
    import torch
    import torch.nn.functional as F

    from multimodal_path_omic_tpu_torch.ops import coattn, gather

    def row(name, ms, plain_ms, library_ms, m_len=TRAIN_M, need=()):
        bound = plain_k_bound_ms(name, m_len, *need)
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}

    ins, (dout, dssq, dsumw) = plain_k_inputs(TRAIN_M, 23, dev)
    q, k, v, mask, dseed = ins
    # The rows of the kernels line: MCAT's form (no pre-gate, no dropout), the
    # one a single PyTorch call also computes; the other forms are logged.
    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    amask = mask[:, None, None, :]
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=amask))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q4, k4, v4)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dout[:, None],
                                                  retain_graph=True))
    zeros = torch.zeros_like(dssq)
    # byte bounds over the keys the function needs (the kernels line's): k
    # rows of the valid keys; in the forward also the v rows of a bag without
    # a valid key, whose o is their mean; then over the keys of the 64-key
    # tiles the kernels compute, and over every key; dk and dv written whole
    valid, filled, tiled = int(mask.sum()), valid_keys(mask), computed_tile_keys(mask)
    log(f"phase 16: plain-K masks of {B * TRAIN_M} keys: {valid} valid ({valid / (B * TRAIN_M):.4f}),"
        f" {filled} with every key of a bag without one ({filled / (B * TRAIN_M):.4f}), {tiled} "
        f"in computed tiles ({tiled / (B * TRAIN_M):.4f})")
    need = {"coattn_plain": (valid, filled), "coattn_plain_bwd": (valid, valid)}
    bounds = {name: [plain_k_bound_ms(name, TRAIN_M, *x)[0] for x in (need[name], (tiled,), ())]
              for name in need}

    def shares(name, ms):
        b_need, b_tile, b_every = bounds[name]
        return (f"{ms:.4f} ms (bounds {b_need:.4f} keys needed, {b_tile:.4f} computed tiles, "
                f"{b_every:.4f} every key; {b_need / ms:.3f} / {b_tile / ms:.3f} / "
                f"{b_every / ms:.3f} reached)")

    rows = []
    for pre_gate, rate in ((False, 0.0), (True, 0.0), (True, TRAIN_RATE), (False, TRAIN_RATE)):
        o, l, m, ssq, sumw = coattn.coattn_fwd_plain_k_plain(*ins, rate, pre_gate=pre_gate)
        cot = (dout, zeros, zeros) if not pre_gate else (dout, dssq, dsumw)
        di = (o * cot[0]).sum(-1) + 2.0 * cot[1] * ssq + cot[2] * sumw
        ev = cuda_ms(lambda: coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate,
                                                       train=False)) if rate == 0.0 else None
        tr = cuda_ms(lambda: coattn.coattn_fwd_plain_k(*ins, rate, pre_gate=pre_gate))
        fp = cuda_ms(lambda: coattn.coattn_fwd_plain_k_plain(*ins, rate, pre_gate=pre_gate))
        bw = cuda_ms(lambda: coattn.coattn_bwd_plain_k(*ins, rate, cot[0], l, m, di, cot[1],
                                                       cot[2], pre_gate=pre_gate))
        bp = cuda_ms(lambda: coattn.coattn_bwd_plain_k_plain(*ins, rate, *cot,
                                                             pre_gate=pre_gate))
        log(f"phase 16: plain-K B={B} N={N} M={TRAIN_M} D={E} pre_gate={pre_gate} dropout "
            f"{rate}: forward eval form {shares('coattn_plain', ev) if ev is not None else 'n/a'}, "
            f"training form {shares('coattn_plain', tr)}, plain {fp:.4f} ms; backward "
            f"{shares('coattn_plain_bwd', bw)}, plain {bp:.4f} ms")
        if not pre_gate and rate == 0.0:
            rows.append(row("coattn_plain", ev, fp, lib_fwd, need=need["coattn_plain"]))
            rows.append(row("coattn_plain_bwd", bw, bp, lib_bwd, need=need["coattn_plain_bwd"]))
            log(f"  scaled_dot_product_attention on the same inputs: forward {lib_fwd:.4f} ms, "
                f"backward {lib_bwd:.4f} ms; bounds over the keys needed "
                f"{rows[-2]['bound_ms']:.4f} / {rows[-1]['bound_ms']:.4f} ms "
                f"({rows[-1]['bound_by']})")
    del ins, q, k, v, q4, k4, v4, leaves, lib_out
    pool = p15["cache"].caches[TRAIN_M]["wsi"]
    idx = torch.randperm(pool.shape[0], device=dev)[:B]
    ms = cuda_ms(lambda: gather.gather_rows(pool, idx))
    lib = cuda_ms(lambda: torch.index_select(pool, 0, idx))
    rows.append(row("gather_rows", ms, lib, lib))
    log(f"phase 16: gather_rows pool {tuple(pool.shape)} float32, {B} rows: kernel {ms:.4f} ms, "
        f"index_select (the plain version and the library call) {lib:.4f} ms, bound "
        f"{rows[-1]['bound_ms']:.4f} ms (bytes)")

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    for is_lean, pred in p14["predictors"].items():
        pred.predict_bags(bags, omics)  # warm
        rates = [len(bags) / t for t in timed(lambda: pred.predict_bags(bags, omics), 3)]
        log(f"phase 16: MCAT predict_bags lean={is_lean}: {len(bags)} bags, 3 calls: "
            f"{', '.join(repr(r) for r in rates)} bags/s (host clock, batches of {B}, "
            f"buckets {BUCKETS})")
    for is_lean, (step, state) in p14["trainers"].items():
        box = [state]

        def one():
            box[0], _ = step(box[0], batch)

        times = [t * 1e3 for t in timed(one, 10)]
        med = float(np.median(times))
        log(f"phase 16: MCAT training step lean={is_lean}, {B} bags of the {TRAIN_M} bucket: "
            f"{', '.join(f'{t:.3f}' for t in times)} ms (host clock, synchronized); median "
            f"{med:.3f} ms = {B / med * 1e3:.1f} train bags/s")
    ds, cache = p15["ds"], p15["cache"]
    metas = cache_metas(ds, cache, CACHE_BATCHES[:2])  # the two full batches
    for cached in (True, False):
        _, state, step = make_trainer(dev, "MCAT", "ces", cached=cached)
        box = [state, 0]

        def one():
            bucket, meta = metas[box[1] % len(metas)]
            box[1] += 1
            if cached:
                box[0], _ = step(box[0], cache.caches[bucket], meta)
            else:
                box[0], _ = step(box[0], stage_host_batch(ds, bucket, meta, dev))

        timed(one, 2)  # warm
        times = [t * 1e3 for t in timed(one, 8)]
        med = float(np.median(times))
        log(f"phase 16: MCAT training step (lean) {'from the device cache' if cached else 'host-fed, staging included'}"
            f", {B} bags of the {TRAIN_M} bucket: {', '.join(f'{t:.3f}' for t in times)} ms "
            f"(host clock, synchronized); median {med:.3f} ms = {B / med * 1e3:.1f} train bags/s")
    return rows


def make_wide_ge_bags(seed):
    """Six bags of 1000..4096 patches for GE small and big (phase 17)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1000, GE_WIDE_M + 1, size=6)
    return [rng.standard_normal((int(n), 1024), dtype=np.float32) for n in lengths]


def phase17_ge_sizes(dev) -> dict:
    """GE-NaCAGaT small and big on the card: predict_bags and one training
    step, the flash kernels against their plain versions on the card, with the
    launch counts of every flash instance."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash

    bags = make_wide_ge_bags(5)
    batches = -(-len(bags) // GE_WIDE_B)
    launches = {}
    for size in ("small", "big"):
        (h1, w1), (h2, w2) = GE_SIZE_HEADS[size]
        log(f"phase 17: GE-NaCAGaT {size} Predictor (heads {h1} x {w1}, {h2} x {w2}), "
            f"{len(bags)} bags of {min(map(len, bags))}..{max(map(len, bags))} patches, bucket "
            f"{GE_WIDE_M}, batch_size {GE_WIDE_B}")
        pred = make_ge_predictor(dev, GE_WIDE_B, size, (GE_WIDE_M,))
        reset_counts()
        out = pred.predict_bags(bags)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"GE {size} serving", counts, milpool=batches,
                      **{f"flash_fwd_d{w1}": batches, f"flash_fwd_d{w2}": 2 * batches})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        y = out["y"]
        if y.shape != (len(bags), 3) or not np.isfinite(y).all():
            raise AssertionError(f"GE {size}: y {y.shape}")
        got_s, mask = ge_eval_scores(pred, bags[:2], GE_WIDE_M)
        # the same Predictor with the flash kernels' plain versions, on the card
        saved = flash.flash_fwd, flash.flash_bwd
        flash.flash_fwd, flash.flash_bwd = plain_flash()
        try:
            plain_pred = make_ge_predictor(dev, GE_WIDE_B, size, (GE_WIDE_M,))
            ref = plain_pred.predict_bags(bags)
            ref_s, _ = ge_eval_scores(plain_pred, bags[:2], GE_WIDE_M)
        finally:
            flash.flash_fwd, flash.flash_bwd = saved
        err = float(np.abs(y - ref["y"]).max())
        err_s = float((got_s - ref_s)[mask].abs().max())
        log(f"  y vs the plain versions: max_abs_err={err:.3e}; raw MIL scores of the valid "
            f"patches: {err_s:.3e} (tolerance {MODEL_ATOL:g})")
        if not (err <= MODEL_ATOL and err_s <= MODEL_ATOL):
            raise AssertionError(f"GE {size}: the kernels disagree with their plain versions")
        log(f"phase 17: GE-NaCAGaT {size}, one training step (ce, dropout {TRAIN_RATE}, Adam) "
            f"on {GE_WIDE_B - 1} bags and a filler row of the {GE_WIDE_M} bucket, kernels vs "
            f"plain versions")
        batch = stage_ge_train_batch(dev, bags, GE_WIDE_B, GE_WIDE_M, seed=6)
        reset_counts()
        got = ge_train_step_grads(dev, batch, plain=False, size=size)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"GE {size} training step", counts,
                      **{f"flash_{way}_d{w}": n for way in ("fwd", "bwd")
                         for w, n in ((w1, 1), (w2, 2))})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check_step_grads(got, ge_train_step_grads(dev, batch, plain=True, size=size))
        del pred, plain_pred, batch, got
    return launches


def phase18_refused_shapes(dev) -> None:
    """Shapes the co-attention kernels do not take, routed to attention_core
    by the kernels' predicates: on the card against the CPU, with no
    co-attention launch."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import attention, coattn
    from multimodal_path_omic_tpu_torch.serve import Predictor

    rng = np.random.default_rng(7)
    torch.manual_seed(0)
    mha = attention.MultiheadAttention(256, 8).eval()
    q = torch.from_numpy(rng.standard_normal((2, 6, 256), dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 100, 256), dtype=np.float32))
    mask = torch.arange(100)[None] < torch.tensor([[93], [0]])
    log("phase 18: cross-attention of 6 queries over 100 keys in 8 heads of width 32")
    outs = {}
    for device in (dev, torch.device("cpu")):
        reset_counts()
        with torch.no_grad():
            outs[device.type] = mha.to(device)(q.to(device), kv.to(device), kv.to(device),
                                               mask.to(device), need_weights=False)[0].cpu()
        if device.type == "cuda":
            torch.cuda.synchronize()
            expect_counts("6 queries, width 32", read_counts())
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    log(f"  card vs CPU: max_abs_err={err:.3e} (tolerance {MODEL_ATOL:g})")
    if err > MODEL_ATOL:
        raise AssertionError("6 queries at width 32: the card disagrees with the CPU")
    bags = [rng.standard_normal((n, 1024), dtype=np.float32) for n in (300, 900, 640)]
    sizes12 = tuple(range(20, 260, 20))
    for what, sizes, model_size, loss in (
            ("NaCAGaT medium, 12 signature groups, ces", sizes12, "medium", "ces"),
            ("NaCAGaT medium, 12 signature groups, cesar (the map of 12 queries)", sizes12,
             "medium", "cesar")):
        log(f"phase 18: {what}: {len(bags)} bags, bucket 1024")
        omics = [[rng.standard_normal(s_, dtype=np.float32) for s_ in sizes] for _ in bags]
        kw = dict(omic_sizes=sizes, model_size=model_size, buckets=(1024,), batch_size=4,
                  loss=loss, seed=0)
        reset_counts()
        got = Predictor("NaCAGaT", device=dev, **kw).predict_bags(bags, omics)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"  launches: { {k: v for k, v in counts.items() if v} }")
        if any(counts[k] for k in coattn.LAUNCH_COUNTS):
            raise AssertionError(f"{what}: a co-attention kernel launched on a refused shape")
        check_outputs_close("the CPU", got,
                            Predictor("NaCAGaT", device="cpu", **kw).predict_bags(bags, omics))


def phase19_nacagat_big(dev, bags, omics) -> dict:
    """NaCAGaT big (E = F = 512) serving at full width: with ces, the fuse-K
    eval kernel's E = 512 instance through the lean-V gate; with cesar, the
    export passes' D = 512 instances. Returns the launches of both runs."""
    import torch

    from multimodal_path_omic_tpu_torch.serve import Predictor

    log(f"phase 19: NaCAGaT big Predictor, loss=ces, {len(bags)} bags, buckets {BUCKETS}, "
        f"batch_size {B}")
    kw = dict(omic_sizes=SIZES, model_size="big", buckets=BUCKETS, loss="ces", seed=0)
    pred = Predictor("NaCAGaT", batch_size=B, device=dev, **kw)
    reset_counts()
    out = pred.predict_bags(bags, omics)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("NaCAGaT big, ces", counts, coattn_fwd_fused_k=n_batches(bags))
    # against the same Predictor on the CPU: 8 bags, the longest among them
    idx = sorted(set(range(7)) | {int(np.argmax([len(b) for b in bags]))})
    log(f"  against the CPU Predictor on bags {idx} ({[len(bags[i]) for i in idx]} patches)")
    ref = Predictor("NaCAGaT", batch_size=4, device="cpu", **kw).predict_bags(
        [bags[i] for i in idx], [omics[i] for i in idx])
    check_outputs_close("the CPU Predictor", out, ref, idx)
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_bags(bags, omics)
        torch.cuda.synchronize()
        rates.append(len(bags) / (time.perf_counter() - t0))
    log(f"phase 19: NaCAGaT big predict_bags loss=ces: {len(bags)} bags, 3 calls: "
        f"{', '.join(repr(r) for r in rates)} bags/s (host clock, batches of {B}, "
        f"buckets {BUCKETS})")
    del pred
    log(f"phase 19: NaCAGaT big Predictor, loss=cesar, {len(bags)} bags")
    kw["loss"] = "cesar"
    pred = Predictor("NaCAGaT", batch_size=B, device=dev, **kw)
    reset_counts()
    out = pred.predict_bags(bags, omics)
    torch.cuda.synchronize()
    cesar = read_counts()
    expect_counts("NaCAGaT big, cesar", cesar, coattn_stats=n_batches(bags),
                  coattn_weights=n_batches(bags))
    idx = [0, 1, 2]  # the CPU forward at big width costs seconds a bag
    log(f"  against the CPU Predictor on bags {idx} ({[len(bags[i]) for i in idx]} patches)")
    ref = Predictor("NaCAGaT", batch_size=4, device="cpu", **kw).predict_bags(
        [bags[i] for i in idx], [omics[i] for i in idx])
    check_outputs_close("the CPU Predictor", out, ref, idx)
    return {name: counts[name] + cesar[name] for name in counts}


def phase20_nacagat_big_training(dev, batch) -> dict:
    """NaCAGaT big (E = F = 512) training at full width on phase 5's staged
    batch: the fuse-K training forward's and backward's E = F = 512
    instances through the lean-V gate, one launch of each a step and no
    other kernel; a step's parameter gradients with the kernels and with
    their plain versions; train bags/s. Returns the launches."""
    import torch

    from multimodal_path_omic_tpu_torch.train.loop import accumulation_chunks

    log(f"phase 20: NaCAGaT big trainer, cesar, dropout {TRAIN_RATE}, Adam; batch "
        f"[{B}, {TRAIN_M}, 1024], {TRAIN_STEPS} steps")
    _, state, step = make_trainer(dev, size="big")
    reset_counts()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics.loss)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [float(x) for x in losses]
    log(f"  losses: {losses}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a NaCAGaT big training loss is not finite")
    steps = TRAIN_STEPS * accumulation_chunks(B, TRAIN_M, 262_144, "cesar")
    expect_counts("NaCAGaT big training", counts, **{name: steps for name in TRAIN_KERNELS})
    log("phase 20: one step from the same state and seed, kernels vs plain versions")
    check_step_grads(train_step_grads(dev, batch, plain=False, size="big"),
                     train_step_grads(dev, batch, plain=True, size="big"))
    times = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    log(f"phase 20: NaCAGaT big training step, {B} bags of the {TRAIN_M} bucket: "
        f"{', '.join(f'{t:.3f}' for t in times)} ms (host clock, synchronized); median "
        f"{med:.3f} ms = {B / med * 1e3:.1f} train bags/s")
    return counts


def time_train_e512(dev, errs, launches) -> list:
    """The E = F = 512 training instances (NaCAGaT big training) at B=32,
    N=6, M=8192, dropout 0.25, beside their plain versions, their bounds and
    the route they replace: k = kv wk + bk by torch.matmul, then
    ``attention_core`` with dropout and the weights' ssq and sumw (the
    lean-V gate's refusal before the instances existed), the forward alone
    beside K2, the forward and autograd's backward beside K3. Their launches
    are phase 20's."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn
    from multimodal_path_omic_tpu_torch.ops.attention import attention_core

    e = 512
    ins, (dout, l, m, di, dssq, dsumw), _ = train_kernel_inputs(TRAIN_M, dev, 5, e=e)
    q, kv, wk, bk, mask, _ = ins
    gen = torch.Generator(device=dev).manual_seed(0)

    def replaced(q_, kv_, wk_, bk_):
        k = torch.matmul(kv_, wk_) + bk_
        o, w = attention_core(q_[:, None], k[:, None], kv_[:, None], mask, pre_gate=True,
                              dropout_rate=TRAIN_RATE, generator=gen)
        return o[:, 0], (w[:, 0] * w[:, 0]).sum(-1), w[:, 0].sum(-1)

    def replaced_with_backward():
        leaves = [t.detach().requires_grad_(True) for t in (q, kv, wk, bk)]
        torch.autograd.backward(replaced(*leaves), (dout, dssq, dsumw))

    fwd, bwd = (name + "_e512" for name in TRAIN_KERNELS)
    calls = {
        fwd: (lambda: coattn.coattn_fwd_fused_k_train(*ins, TRAIN_RATE),
              lambda: coattn.coattn_fwd_fused_k_train_plain(*ins, TRAIN_RATE),
              lambda: replaced(q, kv, wk, bk), "the forward", fk_fwd_bound_ms(fwd, mask, e)),
        bwd: (lambda: coattn.coattn_bwd_fused_k(*ins, TRAIN_RATE, dout, l, m, di, dssq, dsumw),
              lambda: coattn.coattn_bwd_fused_k_plain(*ins, TRAIN_RATE, dout, dssq, dsumw),
              replaced_with_backward, "the forward and autograd's backward",
              fk_bwd_bound_ms(mask, e)),
    }
    rows = []
    for (name, (kern, plain, route, what, bounds)), base in zip(calls.items(), TRAIN_KERNELS):
        ms = cuda_ms(kern, 10, 2)
        plain_ms, route_ms = cuda_ms(plain, 3, 1), cuda_ms(route, 3, 1)
        log(f"phase 20: {name} B={B} N={N} M={TRAIN_M} F=E={e} dropout {TRAIN_RATE}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, the route it replaces (k by torch.matmul, then "
            f"attention_core; {what}) {route_ms:.4f} ms, " + fk_bound_line(ms, bounds))
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[base],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bounds[0], "bound_by": bounds[1], "library_ms": None})
    return rows


def profile_ge_serving(dev, bags, top=15) -> None:
    import torch

    pred = make_ge_predictor(dev)
    pred.predict_bags(bags)  # warm: library load, cuBLAS handles, allocator
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred.predict_bags(bags)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    split = {"flash kernel": 0.0, "MIL pool kernel": 0.0, "matmul": 0.0, "copies": 0.0,
             "other": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if "flash_fwd_kernel" in low:
            split["flash kernel"] += ms
        elif "milpool" in low:
            split["MIL pool kernel"] += ms
        elif "gemm" in low or "xmma" in low or "cutlass" in low:
            split["matmul"] += ms
        elif "memcpy" in low or "memset" in low:
            split["copies"] += ms
        else:
            split["other"] += ms
    device_ms = sum(r[1] for r in rows)
    log(f"profile: GE predict_bags; {len(bags)} bags; wall {wall_ms:.3f} ms; device "
        f"{device_ms:.3f} ms; busy share {device_ms / wall_ms:.4f}; split "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    for name, ms, count in rows[:top]:
        log(f"  {ms:10.4f} ms  x{count:<5d} {name[:100]}")
    log(json.dumps({
        "ge_serving": True, "bags": len(bags), "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms, "split_ms": split,
        "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in rows[:top]],
    }))


def device_rows(prof) -> list:
    """(name, device ms, count) of the device-side events of a trace, largest
    first: the host-side aten ops also carry their kernels' device time and
    would count it twice."""
    import torch

    rows = []
    for ev in prof.key_averages():
        # user annotations (e.g. "Optimizer.step#Adam.step") span kernels
        # already counted on the device timeline
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    return sorted(rows, key=lambda r: -r[1])


# device-kernel name fragments -> the part of a training step they belong to
TRAIN_SPLIT = (("fused_k", "coattn kernels"), ("fk_", "coattn kernels"),
               ("combine_kernel", "coattn kernels"),
               ("bwd_reduce_kernel", "coattn kernels"), ("flash_fwd_kernel", "flash forward"),
               ("flash_bwd", "flash backward"), ("gemm", "matmul"), ("xmma", "matmul"),
               ("cutlass", "matmul"), ("adam", "optimizer"), ("multi_tensor", "optimizer"),
               ("gather_rows", "row gather"), ("plain_kernel", "coattn kernels"),
               ("plain_bwd_kernel", "coattn kernels"), ("dwk_kernel", "coattn kernels"))


def profile_training(title, tag, make, batch, top=20) -> None:
    """After two warm-up steps of the trainer ``make()`` returns, the
    host-clock median of 10 steps and their peak device memory, then one
    traced step: device time by part (TRAIN_SPLIT) and by kernel."""
    import torch

    model, state, step = make()
    for _ in range(2):  # warm: library load, cuBLAS handles, allocator
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms, peak_gib = float(np.median(times)), torch.cuda.max_memory_allocated() / 2**30
    log(f"profile: {title}; 10 steps {', '.join(f'{t:.3f}' for t in times)} ms (host clock, "
        f"synchronized), median {step_ms:.3f} ms; peak device memory {peak_gib:.3f} GiB")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    split = {}
    for name, ms, _ in rows:
        part = next((part for frag, part in TRAIN_SPLIT if frag in name.lower()), "other")
        split[part] = split.get(part, 0.0) + ms
    device_ms = sum(r[1] for r in rows)
    log(f"profile: {title}; wall {wall_ms:.3f} ms; device {device_ms:.3f} ms; busy share "
        f"{device_ms / wall_ms:.4f}; split "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    for name, ms, count in rows[:top]:
        log(f"  {ms:10.4f} ms  x{count:<5d} {name[:100]}")
    log(json.dumps({
        tag: True, "rows": len(batch["weight"]), "step_ms_median": step_ms, "peak_gib": peak_gib,
        "wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
        "split_ms": split,
        "top": [{"name": n, "ms": ms, "count": c} for n, ms, c in rows[:top]],
    }))


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
    rows = device_rows(prof)  # kernels, memcpy, memset
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


def launch_ms(fn, calls=5) -> list:
    """(kernel name, device ms a call) of ``fn``'s launches over ``calls``
    calls, after one warm call (torch.profiler)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(re.sub(r"\([^()]*\)$", "", name).replace("(anonymous namespace)::", ""), ms / calls)
            for name, ms, _ in device_rows(prof)]


def profile_plain_k(dev) -> None:
    """Each launch of the plain-K kernels (tile flags, tile list, main pass,
    merge or reduction) at phase 16's inputs, and of the export passes at
    phase 3's: device ms a call over 5 calls."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    eq, _, _, _, ek, emask = make_inputs(TRAIN_M, E, 7, dev)
    el, em = coattn.coattn_stats_plain(eq, ek, emask)
    ins, (dout, _, _) = plain_k_inputs(TRAIN_M, 23, dev)
    q, k, v, mask, _ = ins
    zeros = torch.zeros(B, N, device=dev)
    o, l, m, _, _ = coattn.coattn_fwd_plain_k_plain(*ins, 0.0, pre_gate=False)
    di = (o * dout).sum(-1)
    calls = {
        "pre-gated export pass 1 (stats)": lambda: coattn.coattn_stats(eq, ek, emask),
        "pre-gated export pass 2 (weights)": lambda: coattn.coattn_weights(eq, ek, emask, el, em),
        "pre-gated export, both passes on one tile list (coattention_weights)":
            lambda: coattn.coattention_weights(eq, ek, emask, pre_gate=True),
        "export pass 1 without the pre-gate": lambda: coattn.coattn_stats(eq, ek, emask,
                                                                          pre_gate=False),
        "eval forward": lambda: coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=False,
                                                         train=False),
        "pre-gated eval forward": lambda: coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=True,
                                                                   train=False),
        "eval forward without a mask": lambda: coattn.coattn_fwd_plain_k(q, k, v, None,
                                                                        pre_gate=False,
                                                                        train=False),
        "backward": lambda: coattn.coattn_bwd_plain_k(*ins, 0.0, dout, l, m, di, zeros, zeros,
                                                      pre_gate=False),
    }
    for what, fn in calls.items():
        log(f"profile: plain-K {what} B={B} N={N} M={TRAIN_M} D={E}, device ms a call by "
            f"launch: " + ", ".join(f"{name} {ms:.4f}" for name, ms in launch_ms(fn)))
    del eq, ek, emask


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one predict_bags call per loss, one training step (medium "
                         "and big), one GE predict_bags call, one GE training step, one "
                         "cached MCAT training step and the plain-K kernels' launches "
                         "instead of phases 1-20")
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
        batch = stage_train_batch(dev, bags, omics)
        profile_training(f"training step, {B} bags of the {TRAIN_M} bucket", "training_step",
                         lambda: make_trainer(dev), batch)
        profile_training(f"NaCAGaT big training step, {B} bags of the {TRAIN_M} bucket",
                         "big_training_step", lambda: make_trainer(dev, size="big"), batch)
        del bags, omics, batch
        ge_bags = make_ge_bags(2)
        profile_ge_serving(dev, ge_bags)
        profile_training(f"GE training step, {GE_B} rows of the {GE_M} bucket",
                         "ge_training_step", lambda: make_ge_trainer(dev),
                         stage_ge_train_batch(dev, ge_bags))
        del ge_bags
        torch.cuda.empty_cache()
        from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache
        from multimodal_path_omic_tpu_torch.data.pipeline import survival_extras

        ds = CacheCohort({TRAIN_M: B}, seed=4)
        cache = DeviceBagCache(ds, survival_extras, BUCKETS, device=dev, lengths=ds.lengths,
                               upload_chunk=16)
        (bucket, meta), = cache_metas(ds, cache, ((TRAIN_M, 0, B),))

        def make_cached():
            model, state, step = make_trainer(dev, "MCAT", "ces", cached=True)
            return model, state, lambda st, m: step(st, cache.caches[bucket], m)

        profile_training(f"cached MCAT training step (lean), {B} bags of the {TRAIN_M} bucket",
                         "mcat_cached_training_step", make_cached, meta)
        profile_plain_k(dev)
        log(gpu_name_and_power())
        return 0
    errs = phase1_kernels(dev)
    p2 = phase2_predictor(dev, bags, omics)
    rows = phase3_timings(dev, errs, p2["launches"], p2["predictors"], bags, omics)
    del p2
    errs.update(phase4_train_kernels(dev))
    batch = stage_train_batch(dev, bags, omics)
    p5 = phase5_training(dev, batch)
    rows += phase6_train_timings(dev, errs, p5["launches"], p5, batch)
    del p5  # bags, omics and the staged batch serve phases 14-16 again
    torch.cuda.empty_cache()
    errs.update(phase7_ge_kernels(dev))
    ge_bags = make_ge_bags(2)
    p8 = phase8_ge_predictor(dev, ge_bags)
    rows += phase9_ge_timings(dev, errs, p8["launches"], p8["predictor"], ge_bags)
    del p8
    torch.cuda.empty_cache()
    errs.update(phase10_flash_bwd_kernels(dev))
    ge_batch = stage_ge_train_batch(dev, ge_bags)
    p11 = phase11_ge_training(dev, ge_batch)
    for row in rows:  # the flash forward is on the GE training path too
        if row["name"].startswith("flash_fwd"):
            row["launches"] += p11["launches"][row["name"]]
    rows += phase12_ge_train_timings(dev, errs, p11["launches"], p11, ge_batch)
    del p11, ge_batch, ge_bags
    torch.cuda.empty_cache()
    wide = phase17_ge_sizes(dev)
    for row in rows:  # GE small and big launch the other flash instances
        if row["name"].startswith("flash_"):
            row["launches"] += wide[row["name"]]
    phase18_refused_shapes(dev)
    big = phase19_nacagat_big(dev, bags, omics)
    for row in rows:  # NaCAGaT big serving: the E = 512 and D = 512 instances
        if row["name"] == "coattn_fwd_fused_k_e512":
            row["launches"] = big["coattn_fwd_fused_k"]
        elif row["name"] in ("coattn_stats", "coattn_weights"):
            row["launches"] += big[row["name"]]
    torch.cuda.empty_cache()
    rows += time_train_e512(dev, errs, phase20_nacagat_big_training(dev, batch))
    torch.cuda.empty_cache()
    errs.update(phase13_plain_kernels(dev))
    torch.cuda.empty_cache()
    p14 = phase14_mcat(dev, bags, omics, batch, make_predictor(dev, "ces"))
    p15 = phase15_device_cache(dev)
    launches = {**p14["launches"], "gather_rows": p15["launches"]["gather_rows"]}
    rows += phase16_timings(dev, errs, launches, p14, p15, bags, omics, batch)
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
