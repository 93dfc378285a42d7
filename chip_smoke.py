#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its NaCAGaT, GE-NaCAGaT and MCAT
serving and training paths, its device-cache training step, its training
entry point (``Trainer.fit``), its serving entry points (the CLI and the
HTTP server) and its CUDA-graphed, multi-step training on one GPU.

    python3 chip_smoke.py              # phases 1-31 below
    python3 chip_smoke.py --profile    # where one predict_bags call's and one
                                       # training step's time goes
    python3 chip_smoke.py --step-time  # a training step and a validation batch
                                       # at 50 signature groups (copy the
                                       # script beside another commit's
                                       # package to time that commit)
    python3 chip_smoke.py --bf16-flash # the bf16 flash rows beside sdpa, bf16
                                       # GE medium train and serving bags/s,
                                       # the instances' registers (the same)
    python3 chip_smoke.py --bf16-fuse-k # the bf16 fuse-K rows beside their
                                       # float32 rows, plain versions and
                                       # bounds, bf16 NaCAGaT medium and big
                                       # train bags/s, the registers (the same)

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
   co-attention kernel. ``y`` must be finite, sum to 1 per row and match
   one eval step of the same Predictor on the CPU on the two bags of the
   8192 bucket, as must the raw MIL scores of an eval step on the card.
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
    queries over 100 keys in 8 heads of width 32, and of 257 pre-gated
    queries (one past the JAX kernels' 256; with and without the map): the
    card within 1e-4 of the CPU, no co-attention launch. NaCAGaT with 12
    signature groups, refused until the slab instances (phase 31), now
    takes them (``ces``: one ``coattn_plain_slabs`` a batch; ``cesar``, whose
    map has 12 queries: one ``coattn_stats_slabs`` and one
    ``coattn_weights_slabs``): the card within 1e-4 of the CPU.
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
21. The training entry point: ``train/trainer.py``'s ``Trainer`` on a
    synthetic cohort written by the port's ``make_synthetic_cohort`` into a
    temporary directory (48 patients, six signature groups of 100 genes,
    bags of 1500..8000 patches, ~0.86 GB), ``examples/nacagat.yaml``
    (NaCAGaT medium, cesar, Adam, dropout 0.25) with buckets 4096/8192,
    batch 16, 2 epochs, every patient kept (38 training, 10 validation
    bags). (a) ``fit`` host-fed: each epoch's launches held to the
    batcher's plan (one fuse-K training forward and one backward a step,
    one export stats and one weights pass a validation batch, nothing
    else), a checkpoint saved after epoch 1; (b) the same ``fit`` from the
    device cache (plus one row gather a step and a validation batch):
    losses and validation risks bitwise equal to (a); (c) the checkpoint
    restored into a fresh Trainer whose ``fit`` runs epoch 2, bitwise equal
    to (a)'s; (d) one epoch on the card and on the CPU, dropout off (the
    two generators draw different bits): losses within 1e-4 relative, the
    validation risks within 1e-4 absolute, the c-index within one
    comparable pair; (e) GE-NaCAGaT medium (``examples/ge_nacagat.yaml``,
    10 patients, bags of 5000..14269 patches, buckets 8192/16384, batch 8)
    for one epoch: three flash launches each way a step, one MIL-pool and
    three flash forward launches a validation batch; then one GE epoch on
    the card and on the CPU, dropout off, on 10 patients' bags of
    600..2000 patches (buckets 1024/2048; the CPU takes 735 s for the
    cohort above): every GE kernel launched on the card, losses within 1e-4
    relative, the validation accuracy equal. Epoch seconds, train
    and val bags/s, launches and peak memory beside the card's name and
    power limit.
22. The serving entry points on phase 21's cohort and configuration
    (``examples/nacagat.yaml``, NaCAGaT medium, cesar): (a) the CLI in this
    process: ``train`` (one epoch, the best checkpoint by validation loss),
    ``validate --checkpoint`` printing the Trainer's last validation loss and
    c-index, ``predict`` on the card and with ``--set device=cpu`` (the same
    slides, order and columns, within 1e-4), ``predict --mc 8`` (8 K2
    training-form launches a batch), ``evaluate --json``, ``check-data``,
    and ``convert-checkpoint`` of a reference-format ``.pt`` built from the
    trained weights by the transplant rules run backwards, predicting bit
    for bit as the checkpoint; (b) ``Predictor.from_config`` behind
    ``make_server(port=0)``: 3 ``/predict_npz`` (one float16), 1 ``/predict``
    (JSON), 1 ``/predict_batch_npz`` of 8 bags, each bit for bit equal to the
    in-process call of its shape, a bag alone within 1e-5 relative of it in a
    batch, ``/metrics`` counting every request; (c) 8 concurrent clients on
    a ``--dynamic-batch 8`` server (fewer groups than bags, within 1e-5 of the
    per-bag answers; a bad request among them 400, its co-riders 200); (d)
    ``?mc=8&mc_seed=3`` twice bit for bit equal, ``mc_seed=4`` different, the
    MC step 8 K2 training-form launches and nothing else, equal bit for bit
    to 8 training-mode forwards replayed from the same generator; (e) a
    checkpoint ensemble (epoch 1 and one more epoch): ``risk_ens_std``, the
    mean survs within 1e-6 of the members'; (f) a GE-NaCAGaT medium server
    (buckets 8192/16384, batch 8) on bags of 600..2000 patches, one K5 and
    three K6 forward launches a batch, within 1e-4 of the CPU; (g)
    ``python -m multimodal_path_omic_tpu_torch.cli serve --port 0 --warmup``
    in a subprocess answering one request and exiting 0 on SIGTERM after
    ``server stopped``. Request latency, batch, dynamic-batch and sequential
    bags/s, warmup seconds and ``predict_dataset`` bags/s beside the card's
    name and power limit.
23. This slice: the steps as CUDA graphs (``train/graphs.py``), multi-step
    dispatch, partial caching, pinned staging and the bench. (a) Phase 21's
    Trainer (examples/nacagat.yaml, its cohort and settings) host-fed and
    cached, each with ``steps_per_dispatch`` auto and 1 graphed and auto
    eager: epoch 1 through ``validated_epoch`` (the graphs' warm-up and
    capture), epoch 2 as ``train_epoch`` and ``validate``; both epochs'
    losses and validation risks bit for bit equal across the six runs, the
    launches of epoch 2 equal (replays count theirs), epoch seconds, train
    and val bags/s, peak device memory and, from a traced third epoch, the
    device busy share; (b) a budget that fits the 4096 bucket and not the
    8192 one: the partially cached run bit for bit equal to host-fed; (c)
    ``train/benchmark.py::headline`` (bench.py's NaCAGaT, GE and MCAT rows,
    MCAT last), graphed against eager bags/s; (d) GE-NaCAGaT small: three
    training steps and two eval steps graphed against eager (the flash
    forward and backward, and the MIL pool, inside graphs), bit for bit; (e)
    MCAT ``lean=False``: three steps graphed against eager (the plain-K pair),
    bit for bit; (f) NaCAGaT ``ces`` ``predict_bags`` on phase 2's 40 bags,
    pinned staging overlapped with the graphed eval against pageable copies:
    bags/s and the answers bit for bit, and the graphed fuse-K eval step
    against the eager one. Every kernel of the kernels line but the E = 512
    instances runs inside a graph here and is held against its eager run.
24. Reduced precision. (a) The bfloat16 instances (the fuse-K forward in
    both forms, its backward, the export passes' stats and weights, with
    and without the pre-gate) against their plain versions at B=32, N=6,
    E=F=D=256 on phase 1's and 4's masks (M=8192 ragged with a filler bag,
    M=8192 with masked tiles mid-bag, M=1500 with a one-key bag that pools
    exactly its kv row): two runs bitwise equal, dkv and w exactly 0 at the
    masked keys of bags with a valid key; the fuse-K instances also at N=1
    and N=8 (M=4000 with masked tiles mid-bag, M=1500 with a one-key bag),
    the ends of their padding of the queries to 8; each timed beside its
    float32 row, its plain version and its bound. (b) Phase 21's Trainer
    (examples/nacagat.yaml, its cohort and settings), two epochs graphed and
    eager (bit for bit equal) in each of: bf16 compute from an int8 store;
    the same host-fed through int8 transfers (bit for bit the cached run);
    the same cached with ``ces`` (its validation on the eval form);
    with int8_matmul (within 0.05 of the dequant run); a bf16 store and,
    host-fed, bf16 transfers with float32 compute (bit for bit equal);
    epoch 2's launches held to the plan (the bf16 instances once a step
    and a validation batch under bf16 compute), train and val bags/s, the
    cache's bytes against float32's, peak memory; then ``cli train`` with
    ``--set tpu.compute_dtype=bfloat16 --set tpu.cache_dtype=int8`` for one
    epoch, its loss the first run's epoch 1. (c) One epoch of bf16
    compute from the int8 store on the card and on the CPU, dropout 0, four
    training seeds: losses within 6e-5 and 1.2e-3 relative, risks within
    6e-3 (about twice the largest reading), and each seed's run not equal
    to its float32-compute control on the card. (d) The one shape still
    without a bf16 instance, the eval fuse-K form at E = 512 with F = 256
    (no shipped configuration reaches it): ``kernels.takes`` raises
    NotImplementedError (queue 2 item 5) on the card and the wrapper
    refuses it, before any kernel launch.
25. GE-NaCAGaT under bfloat16: the flash kernels' bfloat16 instances. (a)
    Every instance (forward and backward at widths 16..512) against its
    bfloat16 plain version: GE medium's at B=8, M=16384 with phase 9's
    ragged masks, small's and big's at phase 17's B=4, M=4096, and every
    width on four bags of 1500 keys (a ragged prefix, masked key tiles
    mid-bag, one valid key, none valid) and on three bags of 1, 20 (fewer
    than a key tile) and 333 keys (a multiple of no tile; a ragged prefix,
    a bag whose one valid key is the last, none valid): o to one bfloat16
    unit of its terms' magnitude, m and l to 1e-4 relative, dq, dk, dv to
    2e-2 of each one's largest magnitude (a bag of one valid key, whose
    score gradients are float32 noise, to 2e-2 of the terms that cancel),
    two runs bitwise equal, dq and dk exactly 0 through masked keys, the bag
    without a valid key at m = -1e9, l = M; each timed at B=8, M=16384
    beside its float32 row, its plain version, its bound (bfloat16 products)
    and the bfloat16 ``scaled_dot_product_attention`` (backward). (b)
    examples/ge_nacagat.yaml (GE medium) on phase 21's GE cohort, two
    epochs graphed and eager (bit for bit equal) in bf16 from an int8
    store, host-fed through int8 transfers (bit for bit the cached run) and
    in float32: epoch 2's launches held to the plan, train and val bags/s
    and peak memory against float32; a bf16 GE medium ``Predictor``'s
    ``predict_bags`` bags/s on phase 8's 12 bags. (c) One epoch in bf16 on the card and
    on the CPU on phase 21's shorter-bag GE cohort, dropout 0, three
    training seeds: losses within 4e-4 / 2e-3 relative (about twice the
    largest reading), each run unequal to its float32-compute control on
    the card. (d) GE small and big in bf16: a Trainer epoch (every step and
    validation batch on their widths' instances) and a
    ``Predictor.from_trainer`` call each, timed after a warm call (bags/s).
26. NaCAGaT ``big`` (E = F = D = 512) under bfloat16. (a) The E = F = 512
    bf16 instances of the fuse-K forward (both forms) and backward and the
    D = 512 instances of the export passes (with and without the
    pre-gate) against their bf16 plain versions at B=32, N=6 on phase 24's
    masks (M=8192 ragged with a filler bag, M=8192 with masked tiles
    mid-bag, M=1500 with a one-key bag and a bag without a valid key), at
    phase 24's bars: two runs bitwise equal, dkv and w exactly 0 at the
    masked keys of bags with a valid key, the filler bag at l = M, m = NEG,
    w = 1/M; the fuse-K instances also at N=1 and N=8, as in phase 24;
    each timed beside its float32 row, its plain version and its bound.
    (b) examples/nacagat.yaml at ``model_size: big`` on phase 21's
    cohort and settings, two epochs: bf16 compute from an int8 store cached,
    graphed and eager (bit for bit equal), host-fed through int8 transfers
    (bit for bit the cached run), with ``ces`` validation (the eval form),
    and float32 beside them; epoch 2's launches held to the plan (each bf16
    instance once a step or a validation batch), train and val bags/s and
    peak memory against float32. (c) One epoch of bf16 from the int8 store
    on the card and on the CPU, dropout 0, two training seeds, on a cohort
    of shorter bags (48 patients, 600..2000 patches): losses and validation
    risks within the limits of ``BIG_BF16_CPU_*`` (about twice the largest
    reading), and each run unequal to its float32-compute control.
27. The plain-K pair with values at every shipped width in both types
    (MCAT and NaCAGaT ``lean=False`` at every size). (a) The bf16 instances
    at D = 128, 256, 512 and the float32 one at D = 512 against their plain
    versions at B=32, N=6 on M=8192 ragged masks with a filler bag (phase
    16's), masked tiles mid-bag, a one-key bag (M=1500) and M=5000 (not a
    multiple of 64), with and without the pre-gate: the eval form, the
    training form at dropout 0 and 0.25, the backward; float32 at phase
    13's bars (l 1e-4 relative at D = 512), bf16 o within one bf16 unit of
    its terms' magnitude, l, m, ssq, sumw 1e-4 relative, dq, dk, dv 2e-2 of
    each one's largest magnitude; two runs bitwise equal; dk and dv exactly
    0 at masked keys; each timed (MCAT's form; the pre-gated one logged)
    beside its float32 row, its plain version, ``scaled_dot_product_attention``
    and, at D = 512, the ``attention_core`` route it replaces. (b) MCAT and
    NaCAGaT ``big`` through ``Predictor(..., lean=False)`` in float32 and
    bf16 and NaCAGaT ``medium`` in bf16 on phase 2's 40 bags: one plain-K
    forward of the instance a batch and no other kernel, no
    ``attention_core`` call, hazards against the CPU Predictor on 3 bags,
    bags/s. (c) NaCAGaT ``cesar`` at ``medium``
    bf16 and ``big`` in both types, and MCAT ``ces`` at ``big`` bf16,
    ``lean=False``, dropout 0.25: three steps graphed and eager bit for bit,
    one forward and one backward launch a step, no ``attention_core`` call;
    then dropout 0, one step's loss on the card against the CPU (shorter
    bags). ~50 s.
28. Multi-GPU through the mesh layer (``parallel/``) on the one card. First
    the training forms at a bag offset (bag0 = 5, the global index of a
    data-parallel rank's first bag, a kernel argument): the fuse-K training
    forward and backward and the plain-K pair against their plain versions,
    and unequal to bag0 = 0. (a) One rank on NCCL (a world of one, joined in this
    process): NaCAGaT ``medium`` host-fed and cached, three graphed steps
    each (dropout 0.25, SGD) with the gradient all-reduce captured in the
    step's CUDA graph, bit for bit the same steps without a group; K1, K2
    and K3 launch (counted into the kernels line). (b) Two ranks spawned on
    the card over gloo (NCCL refuses two ranks on one device): NaCAGaT
    ``medium`` data 2, three steps cached (the sharded cache, its gather and
    all-to-all) and host-fed, dropout 0.25: parameters bitwise equal across
    ranks, losses and parameters within 1e-5 of one rank's on the same card;
    each rank logs its launches of K1, K2 and K3, which must not be 0
    (counted into the kernels line). (c) GE ``medium`` and MCAT ``medium``
    at seq 2 (the ring, the merged MIL pool, the stat merge): one training
    step and one ``predict_bags`` each against one rank. (d) NaCAGaT
    ``medium`` 2x2 on four ranks: one cached step against one rank. A rank
    that dies or a world past 300 s fails the phase. The wall times are
    several ranks sharing one card over host-staged gloo, not a multi-GPU
    speed.
29. The tooling, through the package and the CLI, on phase 21's cohort.
    (a) The host-fed graphed Trainer with ``tpu.use_native_pipeline`` off
    and on: the reader each reports, three epochs' losses and the
    parameters bit for bit; each reader's steady epoch (wall, bags/s) and a
    traced epoch's device time; the bag read split (cold after
    ``posix_fadvise(DONTNEED)`` of the cohort's own files, the page cache,
    memcpy), saying whether the eviction took effect. (b) ``cli profile``,
    and ``train --profile-dir`` then ``profile --trace-dir``: both reports
    have a device track naming the port's kernels, the first's among the
    second's. (c) ``cli plan`` for NaCAGaT ``medium`` and ``big`` and GE
    ``medium`` (exit 0: fits); each plan's step peaks against a graphed
    epoch's ``max_memory_allocated``. (d) ``cli cv`` (k = 2) and ``cli
    sweep`` (two points), one epoch each, finite. (e) Bundles of NaCAGaT
    ``ces`` and ``cesar``, MCAT ``lean=False`` and GE ``medium`` (random
    weights from seed 0, bucket 8192, batch 8; ``ces`` traced on the CPU
    and moved): loaded on the card, within 1e-5 of the card's Predictor on
    12 bags, each one's custom ops' kernels launched (counts from 0 before
    its calls); the bfloat16-weight bundle under 0.65 of float32's bytes;
    ``make_bundle_server``'s ``/predict_batch_npz`` within 1e-5 of the
    Predictor. (f) ``tpu.remat`` on and off for NaCAGaT ``medium`` and
    ``big`` and GE ``medium``: three graphed steps, dropout 0.25, the
    parameters, loss and generator bit for bit; peak memory and step ms.

30. The mesh settings the port first refused, on the one card with two gloo
    ranks sharing it (phase 28's cohort and NaCAGaT ``medium``): (a) the
    cox loss at data 2 (its risk sets over the global batch): three SGD
    steps host-fed and from the sharded device cache, then the eval step,
    against one rank (losses and eval loss 1e-5, risks 1e-4, parameters
    bitwise equal across ranks and within 1e-5 of one rank's), the
    gather, fuse-K training forward and backward and fuse-K eval kernels
    launched on each rank; (b) the eval step's co-attention map at seq 2
    with ``need_attention``: the export passes (``coattn_stats``,
    ``coattn_weights``) launched on each rank on merged statistics, the map
    against the one-rank kernel map (1e-4 relative), on a batch whose bag 0
    has its valid patches in rank 0's half only (0 on rank 1's keys) and
    bag 1 none (exactly 1/M over the global M); (c) ``server.main`` over
    two ranks at data 2 (rank 0 answers HTTP, rank 1 follows): single bags,
    a batch, ``?mc=4`` and two malformed bodies (400) against a one-rank
    Predictor's server (1e-4), the request latency, and SIGTERM to both
    ranks, each exiting 0.
31. The plain-K kernels past eight queries, up to the JAX kernels' 256
    signature groups (the slab instances; a Hallmark-sized signature file
    has 50 groups): (a) the forward with values (eval and training forms),
    its backward and the two export passes against their plain versions at
    4 bags of N in {9, 50, 256} queries, D in {128, 256, 512}, both types,
    with and without the pre-gate, on masks with masked tiles mid-bag, a
    one-key bag and a bag without a valid key (phase 27's and phase 1's
    bars; float32 l within 5e-5 relative, its distance from a float64 l held
    to the plain version's), two runs bitwise equal, exactly 0 through
    masked keys, the drop share; (b) at B=32, M=8192, N in {50, 256}, D in
    {256, 512} (bfloat16 at N=50, D=256) the same checks on the timed
    inputs, then CUDA-event times beside the plain versions, the
    ``attention_core`` route each replaces and ``scaled_dot_product_attention``,
    with the byte and float32-FMA bounds; (c) ``Trainer.fit`` on a 50-group
    cohort (NaCAGaT cesar and MCAT ces host-fed and cached, bit for bit;
    NaCAGaT in bfloat16), launches held to the plan with no ``attention_core`` call
    on a co-attention site, one epoch card against CPU, ``Predictor.
    from_config(...).predict_bags`` and ``cli export-attn`` against the CPU;
    (d) (run in phase 30's spawn) the seq-2 export at 50 queries on two
    gloo ranks against the one-rank kernel map.

Output: phase lines, a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``. Imports nothing of
JAX; runs only where CUDA is available and the port package sits beside it.

``--profile`` runs none of the phases. It builds the kernels, warms the
phase-2 Predictor for each loss on the same bags, and traces one
``predict_bags`` call with ``torch.profiler``: device time by kernel / copy
name, wall time and the device busy share (summed device time over wall
time), then one JSON line per loss with the same numbers; then one
``/predict_batch_npz`` request of 8 bags to a server over the ``cesar``
Predictor: its wall time beside the body's ``np.load``, the inference under
the server's lock and the device time split into host-to-device copies,
other copies and kernels. It then traces one
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
over 5 calls; and phase 21's NaCAGaT Trainer, host-fed and cached: one
traced ``train_epoch`` and one ``validate`` after a first epoch, split into
copies, co-attention kernels, matrix products, optimizer, row gather and
other.
"""

from __future__ import annotations

import argparse
import contextlib
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
# bfloat16 on the tensor cores, dense: a product whose operands are both
# bfloat16 (the bfloat16 instances' k = kv wk projection) is bounded at this
# rate, whichever MMA the kernel runs it on.
PEAK_BF16_FLOP_PER_S = 989e12

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
    # the bfloat16 instances (phase 24)
    "coattn_fwd_fused_k_bf16": "multimodal_path_omic_tpu_torch/csrc/fused_k_sm90.cuh",
    "coattn_fwd_fused_k_train_bf16": "multimodal_path_omic_tpu_torch/csrc/fused_k_sm90.cuh",
    "coattn_bwd_fused_k_bf16": "multimodal_path_omic_tpu_torch/csrc/fused_k_sm90.cuh",
    "coattn_stats_bf16": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_weights_bf16": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    # NaCAGaT big's bfloat16 instances, E = F = D = 512 (phase 26)
    "coattn_fwd_fused_k_bf16_e512": "multimodal_path_omic_tpu_torch/csrc/fused_k_sm90.cuh",
    "coattn_fwd_fused_k_train_bf16_e512": "multimodal_path_omic_tpu_torch/csrc/fused_k_sm90.cuh",
    "coattn_bwd_fused_k_bf16_e512": "multimodal_path_omic_tpu_torch/csrc/fused_k_sm90.cuh",
    "coattn_stats_bf16_d512": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    "coattn_weights_bf16_d512": "multimodal_path_omic_tpu_torch/csrc/coattn.cu",
    # the flash kernels' bfloat16 instances (phase 25)
    **{f"flash_{way}_d{w}_bf16": f"multimodal_path_omic_tpu_torch/csrc/{src}.cu"
       for way, src in (("fwd", "flash"), ("bwd", "flash_bwd"))
       for w in (16, 32, 64, 128, 256, 512)},
    # the plain-K pair with values at every width in both types (phase 27)
    **{f"coattn_plain{way}{sfx}": f"multimodal_path_omic_tpu_torch/csrc/{src}.cu"
       for way, src in (("", "coattn"), ("_bwd", "coattn_bwd"))
       for sfx in ("_bf16", "_d512", "_bf16_d512")},
    # the plain-K kernels past eight queries, in both types (phase 31)
    **{f"coattn_{name}_slabs{sfx}": f"multimodal_path_omic_tpu_torch/csrc/{src}.cu"
       for name, src in (("plain", "coattn_many"), ("plain_bwd", "coattn_bwd_many"),
                         ("stats", "coattn_many"), ("weights", "coattn_many"))
       for sfx in ("", "_bf16")},
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
    "coattn_fwd_fused_k_bf16": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_fwd_fused_k_train_bf16": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_bwd_fused_k_bf16": "multimodal_path_omic_tpu/ops/coattn.py:508",
    "coattn_stats_bf16": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_weights_bf16": "multimodal_path_omic_tpu/ops/coattn.py:908",
    "coattn_fwd_fused_k_bf16_e512": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_fwd_fused_k_train_bf16_e512": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_bwd_fused_k_bf16_e512": "multimodal_path_omic_tpu/ops/coattn.py:508",
    "coattn_stats_bf16_d512": "multimodal_path_omic_tpu/ops/coattn.py:221",
    "coattn_weights_bf16_d512": "multimodal_path_omic_tpu/ops/coattn.py:908",
    **{f"flash_{way}_d{w}_bf16": "multimodal_path_omic_tpu/ops/flash.py:44"
       for way in ("fwd", "bwd") for w in (16, 32, 64, 128, 256, 512)},
    **{f"coattn_plain{way}{sfx}": f"multimodal_path_omic_tpu/ops/coattn.py:{line}"
       for way, line in (("", 221), ("_bwd", 508)) for sfx in ("_bf16", "_d512", "_bf16_d512")},
    **{f"coattn_{name}_slabs{sfx}": f"multimodal_path_omic_tpu/ops/coattn.py:{line}"
       for name, line in (("plain", 221), ("plain_bwd", 508), ("stats", 221), ("weights", 908))
       for sfx in ("", "_bf16")},
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


def make_mask(m_len, g, kind, b=B):
    """[b, M] ragged key masks (lengths uniform in [M/5, M] from ``g``, bag 0
    full, the last bag fully masked), with :func:`make_inputs`' ``kind``."""
    import torch

    lengths = torch.randint(m_len // 5, m_len + 1, (b,), generator=g)
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
            lambda q, kv, wk, bk, mk, seed, rate, dout, l, m, di, dssq, dsumw, bag0=0:
            coattn.coattn_bwd_fused_k_plain(q, kv, wk, bk, mk, seed, rate, dout, dssq, dsumw,
                                            bag0))
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


def ge_flash_inputs(b, heads, m_len, seed, dev, e=GE_D, dtype=None):
    """q, k, v as MultiheadAttention hands them over: the head views of one
    packed [B, M, 3E] projection (strided, read in place; float32, or
    ``dtype``), q and k of std ~1.5 and 1 (scores of std ~1.5: a peaked
    softmax); ragged masks, the last bag fully masked when there is more
    than one."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(b, m_len, 3 * e, generator=g)
    qkv[..., :e] *= 1.5
    qkv = qkv.to(dev).to(dtype or torch.float32)
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
    padded into ``bucket``, the mask, and the step's class probabilities y."""
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
    return out["attention"]["path"][:, 0].cpu(), mask, out["y"].cpu()


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
    # against the plain path: the same Predictor (same seed) on the CPU, one
    # eval step on the two bags of the 8192 bucket, the batch predict_bags
    # scores them in (the CPU's chunked M x M attention is slow)
    cpu = make_ge_predictor("cpu", batch_size=2)
    t0 = time.perf_counter()
    ref_s, _, ref_y = ge_eval_scores(cpu, bags[:2])
    err = float(np.abs(y[:2] - ref_y.numpy()).max())
    log(f"  y vs CPU plain path: max_abs_err={err:.3e} (tolerance {MODEL_ATOL:g}; CPU "
        f"{time.perf_counter() - t0:.1f} s)")
    if err > MODEL_ATOL:
        raise AssertionError("GE y disagrees with the CPU plain path")
    # y is a softmax over 3 classes and hides much; the raw MIL scores of the
    # valid patches carry every layer's output
    got_s, mask, _ = ge_eval_scores(pred, bags[:2])
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
            lambda q, k, v, mk, seed=None, rate=0.0, *, pre_gate, train=True, bag0=0:
            coattn.coattn_fwd_plain_k_plain(q, k, v, mk, seed, rate, pre_gate=pre_gate,
                                            bag0=bag0))
        coattn.coattn_bwd_plain_k = (
            lambda q, k, v, mk, seed, rate, dout, l, m, di, dssq, dsumw, *, pre_gate, bag0=0:
            coattn.coattn_bwd_plain_k_plain(q, k, v, mk, seed, rate, dout, dssq, dsumw,
                                            pre_gate=pre_gate, bag0=bag0))
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


def plain_k_bound_ms(name, m_len, keys=None, v_keys=None, d=E, esize=4) -> tuple:
    """Bounds of the plain-K kernels at B=32, N=6, width ``d`` (pre-gated
    form: its gate product is counted; multiply-adds as 2 operations), their
    k rows read over ``keys`` (bag, key) pairs and their v rows over
    ``v_keys`` (default ``keys``; both default to every key; the backward
    writes dk and dv whole), q, k, v, o, dout, dq, dk, dv of ``esize`` bytes
    (2: the bfloat16 instances, whose products of bfloat16 operands are
    bounded at the bfloat16 tensor-core rate; 4: float32 FMAs), the
    statistics float32; and of the gather at B=32 rows of [m_len, 1024]
    float32."""
    keys = B * m_len if keys is None else keys
    v_keys = keys if v_keys is None else v_keys
    if name.startswith("coattn_plain_bwd"):  # + dout, l, m, di, dssq, dsumw; out: dq, dk, dv
        nbytes = (esize * (3 * B * N * d + (keys + v_keys) * d + 2 * B * m_len * d)
                  + 4 * 5 * B * N + B * m_len)
        ops = 16 * N * keys * d  # q.k, gate, dO.v, dv, two terms each of dq and dk
    elif name.startswith("coattn_plain"):  # in: q, k, v, mask; out: o, l, m, ssq, sumw
        nbytes = esize * (2 * B * N * d + (keys + v_keys) * d) + 4 * 4 * B * N + B * m_len
        ops = 2 * N * (2 * keys + v_keys) * d  # q.k, the gate, p.v
    else:
        nbytes, ops = 2 * B * m_len * 1024 * 4 + 8 * B, 0
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / (PEAK_BF16_FLOP_PER_S if esize == 2 else PEAK_F32_FLOP_PER_S) * 1e3
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
        got_s, mask, _ = ge_eval_scores(pred, bags[:2], GE_WIDE_M)
        # the same Predictor with the flash kernels' plain versions, on the card
        saved = flash.flash_fwd, flash.flash_bwd
        flash.flash_fwd, flash.flash_bwd = plain_flash()
        try:
            plain_pred = make_ge_predictor(dev, GE_WIDE_B, size, (GE_WIDE_M,))
            ref = plain_pred.predict_bags(bags)
            ref_s, _, _ = ge_eval_scores(plain_pred, bags[:2], GE_WIDE_M)
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
    co-attention launch (8 heads of width 32; 257 queries, one past the JAX
    kernels' range); and NaCAGaT at 12 signature groups, which the kernels
    refused up to eight queries and the slab instances now take (phase 31):
    the card against the CPU, one slab launch a batch."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import attention
    from multimodal_path_omic_tpu_torch.serve import Predictor

    rng = np.random.default_rng(7)
    torch.manual_seed(0)
    kv = torch.from_numpy(rng.standard_normal((2, 100, 256), dtype=np.float32))
    mask = torch.arange(100)[None] < torch.tensor([[93], [0]])
    for what, heads, pre_gate, n, need_weights in (
            ("6 queries over 100 keys in 8 heads of width 32", 8, False, 6, False),
            ("257 queries, pre-gated, one head of width 256", 1, True, 257, False),
            ("257 queries, pre-gated, the map", 1, True, 257, True)):
        log(f"phase 18: cross-attention of {what}")
        mha = attention.MultiheadAttention(256, heads, pre_gate=pre_gate).eval()
        q = torch.from_numpy(rng.standard_normal((2, n, 256), dtype=np.float32))
        outs = {}
        for device in (dev, torch.device("cpu")):
            reset_counts()
            with torch.no_grad():
                out, w = mha.to(device)(q.to(device), kv.to(device), kv.to(device),
                                        mask.to(device), need_weights=need_weights)
            outs[device.type] = [out.cpu()] + ([w.cpu()] if need_weights else [])
            if device.type == "cuda":
                torch.cuda.synchronize()
                expect_counts(what, read_counts())
        err = max(float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"]))
        log(f"  card vs CPU: max_abs_err={err:.3e} (tolerance {MODEL_ATOL:g})")
        if err > MODEL_ATOL:
            raise AssertionError(f"{what}: the card disagrees with the CPU")
    bags = [rng.standard_normal((n, 1024), dtype=np.float32) for n in (300, 900, 640)]
    sizes12 = tuple(range(20, 260, 20))
    for what, loss, want in (
            ("NaCAGaT medium, 12 signature groups, ces", "ces", {"coattn_plain_slabs": 1}),
            ("NaCAGaT medium, 12 signature groups, cesar (the map of 12 queries)", "cesar",
             {"coattn_stats_slabs": 1, "coattn_weights_slabs": 1})):
        log(f"phase 18: {what}: {len(bags)} bags, bucket 1024")
        omics = [[rng.standard_normal(s_, dtype=np.float32) for s_ in sizes12] for _ in bags]
        kw = dict(omic_sizes=sizes12, model_size="medium", buckets=(1024,), batch_size=4,
                  loss=loss, seed=0)
        reset_counts()
        got = Predictor("NaCAGaT", device=dev, **kw).predict_bags(bags, omics)
        torch.cuda.synchronize()
        expect_counts(what, {k: v for k, v in read_counts().items() if not k.startswith("flash")},
                      **want)
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


# Phase 21: the training entry point (train/trainer.py) on the card. The
# cohort is the port's make_synthetic_cohort (the only data this environment
# has), written into a temporary directory: 48 patients, six signature groups
# of 100 RNA-seq genes, bags of 1500..8000 1024-wide patches (~0.86 GB of
# npy). examples/nacagat.yaml trains on it with these overrides; every
# patient is kept (the example's tcga_only would keep the half the synthetic
# cohort marks TCGA), so the 80/20 patient split leaves 38 training and 10
# validation bags.
TRAINER_COHORT = dict(n_patients=48, n_genes=600, n_signatures=6,
                      bag_lengths=(1500, 3000, 5000, 8000), embedding_dim=1024,
                      bag_format="npy", seed=0)
TRAINER_SET = {"tpu.bag_buckets": [4096, 8192], "tpu.batch_size": 16,
               "training.epochs": 2, "training.seed": 0, "dataset.tcga_only": False}
# GE-NaCAGaT medium (examples/ge_nacagat.yaml) on its own cohort: 10 patients,
# bags of 5000..14269 patches, every patient kept (the example's
# decider_only would keep half) and no leave-one-out patient (the example's
# is not in a synthetic cohort).
GE_TRAINER_COHORT = dict(n_patients=10, bag_lengths=(5000, 7000, 10000, 14269),
                         embedding_dim=1024, bag_format="npy", seed=1)
GE_TRAINER_SET = {"tpu.bag_buckets": [8192, 16384], "tpu.batch_size": 8, "training.epochs": 1,
                  "model.gene": "G000", "dataset.decider_only": False,
                  "training.leave_one_out": None, "tpu.device_cache": "off"}
# GE against the CPU: the same model and settings on a cohort of shorter bags
# (600..2000 patches, buckets 1024/2048). The CPU's plain flash versions took
# 735 s for one epoch of the cohort above (NVIDIA H100 80GB HBM3 machine's
# host, 8 cores), beyond the smoke's time; the card's run of the full cohort
# stays in (e).
GE_CPU_COHORT = dict(n_patients=10, bag_lengths=(600, 1000, 1500, 2000), embedding_dim=1024,
                     bag_format="npy", seed=2)
GE_CPU_SET = {**GE_TRAINER_SET, "tpu.bag_buckets": [1024, 2048]}
# The card against the CPU after one epoch: losses relative, validation
# risks absolute (float32 on both sides through Adam steps, other summation
# orders, the kernels against their plain versions). Dropout is off on both
# sides for this comparison: the card's and the CPU's generators draw
# different bits for the same seed.
TRAINER_RTOL, TRAINER_ATOL = 1e-4, 1e-4


def trainer_config(example, paths, out_dir, overrides):
    """``examples/<example>`` pointed at a synthetic cohort, its checkpoints
    and outputs under ``out_dir``, with ``overrides`` (dotted keys)."""
    from multimodal_path_omic_tpu_torch.config import load_config

    csv, sig, patches = paths
    return load_config(os.path.join(HERE, "examples", example), {
        "dataset.file": csv, "dataset.signatures": sig, "dataset.patches_dir": patches,
        "model.checkpoint_dir": os.path.join(out_dir, "checkpoints"),
        "training.test_output_dir": os.path.join(out_dir, "outputs"), **overrides})


def instrument(trainer) -> list:
    """Record every ``train_epoch`` / ``validate`` call of ``trainer`` (fit
    drives both): the epoch, its metrics, its kernel launches (the counts
    after the call less those before), its seconds (synchronized), the
    validation risks. Returns the list the records go to."""
    import torch

    calls = []
    for name in ("train_epoch", "validate"):
        def wrapped(epoch, inner=getattr(trainer, name), name=name):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(epoch)
            torch.cuda.synchronize()
            after = read_counts()
            calls.append({"call": name, "epoch": epoch, "out": out,
                          "seconds": time.perf_counter() - t0,
                          "launches": {k: v - before[k] for k, v in after.items() if v - before[k]},
                          "risks": trainer.val_risks.copy() if name == "validate" else None})
            return out
        setattr(trainer, name, wrapped)
    return calls


def epoch_calls(calls, epoch) -> tuple:
    """The (train_epoch, validate) records of 0-based ``epoch``."""
    return tuple(next(c for c in calls if c["call"] == name and c["epoch"] == epoch)
                 for name in ("train_epoch", "validate"))


def report_trainer_run(what, trainer, calls, want_train, want_val, power) -> None:
    """Each epoch's launches against the plan (``want_*``: kernel -> launches
    per step or per validation batch), losses finite; the epoch's seconds,
    train and val bags/s, beside the card's name and power limit."""
    n_steps, n_val = len(trainer.train_batcher), len(trainer.val_batcher)
    for c in calls:
        if c["call"] == "train_epoch":
            want = {k: v * n_steps for k, v in want_train.items()}
            if not math.isfinite(c["out"]["train_loss"]):
                raise AssertionError(f"{what}: train loss not finite")
            log(f"  {what}, epoch {c['epoch'] + 1}: train_loss {c['out']['train_loss']:.6f}, "
                f"{c['out']['epoch_seconds']:.3f} s, {len(trainer.train_ds) / c['seconds']:.1f} "
                f"train bags/s over {n_steps} steps, launches {c['launches']} ({power})")
        else:
            want = {k: v * n_val for k, v in want_val.items()}
            metric = "val_accuracy" if trainer.ge_mode else "val_c_index"
            if not math.isfinite(c["out"]["val_loss"]):
                raise AssertionError(f"{what}: val loss not finite")
            log(f"  {what}, validate {c['epoch']}: val_loss {c['out']['val_loss']:.6f}, "
                f"{metric} {c['out'].get(metric, float('nan')):.4f}, {c['seconds']:.3f} s, "
                f"{len(trainer.val_ds) / c['seconds']:.1f} val bags/s over {n_val} batches, "
                f"launches {c['launches']} ({power})")
        if c["launches"] != want:
            raise AssertionError(f"{what} {c['call']}({c['epoch']}): launches {c['launches']}, "
                                 f"expected {want}")
    log(f"  {what}: launches as planned; {n_steps} steps and {n_val} validation batches "
        f"an epoch")


def same_bits(what, got, ref) -> None:
    """The per-epoch losses and validation risks of two runs, bit for bit."""
    for key in ("train_loss", "val_loss"):
        if got[key] != ref[key]:
            raise AssertionError(f"{what}: {key} {got[key]!r} != {ref[key]!r}")
    if not np.array_equal(got["risks"], ref["risks"]):
        raise AssertionError(f"{what}: validation risks differ")


def epoch_summary(calls, epoch) -> dict:
    train, val = epoch_calls(calls, epoch)
    return {**train["out"], **val["out"], "risks": val["risks"]}


def phase21_trainer(dev) -> dict:
    """The Trainer at full width: NaCAGaT medium (examples/nacagat.yaml)
    host-fed and cached, a checkpoint restored, the card against the CPU;
    GE-NaCAGaT medium (examples/ge_nacagat.yaml) for one epoch. Returns the
    launches of the phase's runs on the card."""
    import shutil
    import tempfile

    import torch

    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.train.metrics import concordance_index_censored
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    total = {}
    try:
        t0 = time.perf_counter()
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **TRAINER_COHORT)
        ge_paths = make_synthetic_cohort(os.path.join(root, "ge_cohort"), **GE_TRAINER_COHORT)
        ge_cpu_paths = make_synthetic_cohort(os.path.join(root, "ge_cpu_cohort"), **GE_CPU_COHORT)
        log(f"phase 21: synthetic cohorts written in {time.perf_counter() - t0:.1f} s")

        def run(what, example, overrides, want_train, want_val, **fit_kw):
            cfg = trainer_config(example, paths if example == "nacagat.yaml" else ge_paths,
                                 os.path.join(root, what.split()[0]), overrides)
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(cfg, verbose=False)
            calls = instrument(trainer)
            before = read_counts()
            hook = fit_kw.get("after_epoch")
            if hook is not None:
                inner = trainer.validated_epoch
                trainer.validated_epoch = lambda e: hook(trainer, e, inner(e))
            t0 = time.perf_counter()
            trainer.fit()
            torch.cuda.synchronize()
            for k, v in read_counts().items():
                total[k] = total.get(k, 0) + v - before[k]
            log(f"phase 21 ({what}): fit in {time.perf_counter() - t0:.2f} s, peak device "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({power})")
            report_trainer_run(what, trainer, calls, want_train, want_val, power)
            return trainer, calls

        train_k = {"coattn_fwd_fused_k_train": 1, "coattn_bwd_fused_k": 1}
        val_k = {"coattn_stats": 1, "coattn_weights": 1}
        ckpt = []

        def save_after_first(trainer, epoch, res):
            if epoch == 0:
                ckpt.append(trainer.save(epoch, res[1]["val_loss"]))
            return res

        log(f"phase 21 (a): NaCAGaT medium, examples/nacagat.yaml + {TRAINER_SET}, "
            "host-fed (tpu.device_cache=off), Trainer.fit on the card")
        ta, calls_a = run("a host-fed", "nacagat.yaml", {**TRAINER_SET, "tpu.device_cache": "off"},
                          train_k, val_k, after_epoch=save_after_first)
        log(f"  split: {len(ta.train_ds)} training and {len(ta.val_ds)} validation bags; "
            f"accumulation chunks a step: 1 ({ta.batch_size} x {max(ta.buckets)} <= 262144)")
        del ta
        log("phase 21 (b): the same run from the device cache (tpu.device_cache=on)")
        tb, calls_b = run("b cached", "nacagat.yaml", {**TRAINER_SET, "tpu.device_cache": "on"},
                          {**train_k, "gather_rows": 1}, {**val_k, "gather_rows": 1})
        del tb
        for e in range(2):
            same_bits(f"cached vs host-fed, epoch {e + 1}", epoch_summary(calls_b, e),
                      epoch_summary(calls_a, e))
        log("  cached == host-fed, bit for bit: train loss, val loss and val risks of both "
            "epochs")
        log(f"phase 21 (c): restore {os.path.basename(ckpt[0])} (saved after epoch 1) into a "
            "fresh Trainer, fit epoch 2")
        tc, calls_c = run("c restored", "nacagat.yaml",
                          {**TRAINER_SET, "tpu.device_cache": "off",
                           "model.load_from_checkpoint": ckpt[0]}, train_k, val_k)
        if tc.starting_epoch != 1:
            raise AssertionError(f"restored Trainer starts at epoch {tc.starting_epoch}")
        del tc
        same_bits("restored vs uninterrupted, epoch 2", epoch_summary(calls_c, 1),
                  epoch_summary(calls_a, 1))
        log("  restored == uninterrupted, bit for bit: epoch 2's train loss, val loss and "
            "val risks")

        def card_vs_cpu(what, example, cohort, overrides, want):
            """One epoch of ``example`` on the card and on the CPU, dropout 0 on
            both; the card's train and val loss held to the CPU's, and the
            card's epoch held to have launched each kernel of ``want``."""
            ends = {}
            for where in ("cuda", "cpu"):
                cfg = trainer_config(example, cohort, os.path.join(root, f"{what}_{where}"),
                                     {**overrides, "training.epochs": 1, "model.dropout": 0.0})
                trainer = Trainer(cfg, verbose=False, device=where)
                before = read_counts()
                t0 = time.perf_counter()
                train, val = trainer.validated_epoch(0)
                launched = {k: v - before[k] for k, v in read_counts().items() if v - before[k]}
                if where == "cuda" and not set(want) <= set(launched):
                    raise AssertionError(f"{what}: the card's epoch launched {launched}, "
                                         f"expected each of {sorted(want)}")
                ends[where] = {**train, **val, "risks": trainer.val_risks,
                               "table": trainer.val_ds.table}
                metric = "val_accuracy" if trainer.ge_mode else "val_c_index"
                log(f"  {what} {where}: epoch 1 in {time.perf_counter() - t0:.2f} s, train_loss "
                    f"{train['train_loss']:.7f}, val_loss {val['val_loss']:.7f}, {metric} "
                    f"{val[metric]:.4f}")
                del trainer
            for key in ("train_loss", "val_loss"):
                rel = abs(ends["cuda"][key] - ends["cpu"][key]) / abs(ends["cpu"][key])
                log(f"  {what} {key}: card vs CPU relative {rel:.3e} (tolerance {TRAINER_RTOL:g})")
                if rel > TRAINER_RTOL:
                    raise AssertionError(f"{what}: card {key} disagrees with the CPU")
            return ends["cuda"], ends["cpu"]

        log("phase 21 (d): NaCAGaT, one epoch on the card and on the CPU, dropout 0 on both")
        gpu, cpu = card_vs_cpu("d", "nacagat.yaml", paths,
                               {**TRAINER_SET, "tpu.device_cache": "off"}, {**train_k, **val_k})
        err = float(np.abs(gpu["risks"] - cpu["risks"]).max())
        gaps = np.diff(np.sort(cpu["risks"]))
        t = cpu["table"]
        _, con, dis, tied, _ = concordance_index_censored(
            (1 - t.censorship).astype(bool), t.survival_months, cpu["risks"])
        pairs = con + dis + tied
        c_diff = abs(gpu["val_c_index"] - cpu["val_c_index"])
        log(f"  val risks: card vs CPU max_abs_err {err:.3e} (tolerance {TRAINER_ATOL:g}); "
            f"smallest gap between two val risks {gaps.min():.3e}; val c-index card "
            f"{gpu['val_c_index']:.6f} vs CPU {cpu['val_c_index']:.6f} (tolerance 1/{pairs} "
            "comparable pairs)")
        if err > TRAINER_ATOL or c_diff > 1.0 / pairs:
            raise AssertionError("card validation disagrees with the CPU")

        log(f"phase 21 (e): GE-NaCAGaT medium, examples/ge_nacagat.yaml + {GE_TRAINER_SET}, "
            "Trainer.fit on the card")
        run("e GE", "ge_nacagat.yaml", GE_TRAINER_SET,
            {"flash_fwd_d256": 1, "flash_fwd_d32": 2, "flash_bwd_d256": 1, "flash_bwd_d32": 2},
            {"milpool": 1, "flash_fwd_d256": 1, "flash_fwd_d32": 2})
        log(f"  GE, one epoch on the card and on the CPU, dropout 0 on both, on "
            f"{GE_CPU_COHORT} + {GE_CPU_SET}")
        gpu, cpu = card_vs_cpu("e", "ge_nacagat.yaml", ge_cpu_paths, GE_CPU_SET,
                               {"flash_fwd_d256", "flash_fwd_d32", "flash_bwd_d256",
                                "flash_bwd_d32", "milpool"})
        log(f"  e val_accuracy: card {gpu['val_accuracy']:.6f} vs CPU {cpu['val_accuracy']:.6f}")
        if gpu["val_accuracy"] != cpu["val_accuracy"]:
            raise AssertionError("e: card val_accuracy disagrees with the CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s of wall time ({power})")
    return total


# Phase 22: the serving entry points (examples/nacagat.yaml on phase 21's
# cohort; the CLI's training run is one epoch, keeping the best checkpoint by
# validation loss, which the first validated epoch always is).
SERVE_SET = ["--set", "training.keep_best=true", "--set", "training.monitor=val_loss"]
# A server answer against an in-process call of the same batch shape: bit for
# bit. A bag scored alone against the same bag in a batch of 16 rows: cuBLAS
# may take other algorithms for other row counts (float32 on both sides),
# which moves outputs by ~1e-7 relative; 1e-5 relative.
SHAPE_RTOL = 1e-5
# The dynamic batcher's answers against the per-bag answers: absolute, outputs
# of magnitude <= ~4 (risk).
DYN_ATOL = 1e-5
# The ensemble's mean survs against the mean of its two members' survs: the
# same float32 numbers averaged in another order.
ENS_ATOL = 1e-6
MC_SAMPLES = 8
DYN_BATCH = 8
# request bags: lengths of the NaCAGaT requests, the latency bag (8192 bucket)
# and GE's bags (held to the CPU, as phase 21 (e) holds GE)
SERVE_LENGTHS = (1500, 8000)
LATENCY_PATCHES = 8000
GE_SERVE_LENGTHS = (600, 2000)


def cli_run(argv) -> str:
    """``cli.main(argv)`` in this process with its standard output captured;
    a non-zero exit raises."""
    import contextlib
    import io

    from multimodal_path_omic_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}:\n{out[-2000:]}")
    return out


def last_line(out: str, start: str) -> str:
    return [line for line in out.splitlines() if line.startswith(start)][-1]


def printed_metrics(out: str) -> dict:
    """The metrics dict the CLI's train and validate print last."""
    return {k: float(v) for k, v in re.findall(r"'(\w+)': ([^,}]+)", last_line(out, "{"))}


def http(url, data=None):
    """(status, parsed body) of a GET (``data`` None) or a POST of ``data``
    bytes; 4xx and 5xx answers are returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = resp.read()
            status = resp.status
    except urllib.error.HTTPError as exc:
        body, status = exc.read(), exc.code
    text = body.decode()
    return status, (json.loads(text) if text.startswith("{") else text)


def npz_bytes(bag=None, omics=None, bags=None, omics_list=None) -> bytes:
    """A ``/predict_npz`` body (``bag`` + ``omics``) or a
    ``/predict_batch_npz`` body (``bags`` + ``omics_list``)."""
    import io

    arrays = {}
    if bags is None:
        arrays["wsi"] = bag
        arrays.update({f"omic_{j}": o for j, o in enumerate(omics or [])})
    else:
        for i, b in enumerate(bags):
            arrays[f"wsi_{i}"] = b
            for j, o in enumerate((omics_list or [[]] * len(bags))[i]):
                arrays[f"omic_{i}_{j}"] = o
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def answer_keys(ge: bool) -> tuple:
    return ("y",) if ge else ("y", "risk", "hazards", "survs")


def same_answer(what, body, direct, keys) -> None:
    """A server's JSON answer (float32 values through JSON, which round-trips
    them exactly) bit for bit against an in-process answer."""
    for k in keys:
        got = np.asarray(body[k], np.float32)
        if got.shape != direct[k].shape or not np.array_equal(got, direct[k]):
            raise AssertionError(f"{what}: {k} differs from the in-process call "
                                 f"(max |diff| {np.abs(got - direct[k]).max():.3e})")


def rel_err(got, ref) -> float:
    return float((np.abs(got - ref) / np.abs(ref)).max())


def reference_state_dict(state, model_name, omic_sizes, fusion):
    """The reference's state dict of a port state dict: the transplant rules
    (``utils/transplant.py``) run backwards."""
    from multimodal_path_omic_tpu_torch.utils.transplant import transplant_rules

    ref = {}
    for ref_key, port_key, slot in transplant_rules(model_name, len(omic_sizes), fusion):
        v = state[port_key]
        if slot is not None:
            v = v[slot]
            if port_key == "G.fc1_kernel":
                v = v[:omic_sizes[slot]].t()
            elif port_key == "G.fc2_kernel":
                v = v.t()
        ref[ref_key] = v.clone().contiguous()
    return ref


def metric_value(text: str, prefix: str) -> float:
    for line in text.splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def serve_bags(rng, n, lengths, sizes):
    bags = [rng.standard_normal((int(m), 1024), dtype=np.float32)
            for m in rng.integers(lengths[0], lengths[1] + 1, size=n)]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in sizes] for _ in bags]
    return bags, omics


def phase22_serving(dev) -> dict:
    """The serving entry points on the card: the CLI (train, validate,
    predict on the card and the CPU, predict --mc, evaluate, check-data,
    convert-checkpoint), the HTTP server in-process (bitwise against
    in-process calls), dynamic batching, MC dropout, a checkpoint ensemble,
    GE-NaCAGaT serving, and ``cli serve`` in a subprocess stopped by
    SIGTERM. Returns the phase's kernel launches."""
    import concurrent.futures
    import queue
    import shutil
    import signal
    import tempfile
    import threading

    import pandas as pd
    import torch
    import yaml

    from multimodal_path_omic_tpu_torch.config import config_to_dict, load_config
    from multimodal_path_omic_tpu_torch.data.bags import bucket_for, pad_bag
    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.server import make_server
    from multimodal_path_omic_tpu_torch.train.loop import mc_generator

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    root = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    servers, procs = [], []

    def counted(fn):
        """(fn(), the kernel launches it made)."""
        before = read_counts()
        out = fn()
        torch.cuda.synchronize()
        after = read_counts()
        return out, {k: v - before[k] for k, v in after.items() if v - before[k]}

    def serve(pred, **kw):
        server = make_server(pred, port=0, **kw)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return f"http://127.0.0.1:{server.server_address[1]}"

    reset_counts()
    try:
        t0 = time.perf_counter()
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **TRAINER_COHORT)
        cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, "run"),
                             {**TRAINER_SET, "tpu.device_cache": "off"})
        cfg_path = os.path.join(root, "nacagat.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(config_to_dict(cfg), f)
        log(f"phase 22: cohort {TRAINER_COHORT} and {cfg_path} (examples/nacagat.yaml + "
            f"{TRAINER_SET}) written in {time.perf_counter() - t0:.1f} s")

        # ---- (a) the CLI on the card
        log("phase 22 (a): cli train --set training.epochs=1 (keep_best by val_loss)")
        (out, launched) = counted(lambda: cli_run(
            ["train", "--config", cfg_path, "--set", "training.epochs=1", *SERVE_SET]))
        final = printed_metrics(out)
        ck1 = os.path.join(cfg.model.checkpoint_dir, f"{cfg.model.name}_{cfg.dataset.name}_best.pt")
        log(f"  train: {final}; launches {launched}; checkpoint {os.path.basename(ck1)}")
        for k in ("coattn_fwd_fused_k_train", "coattn_bwd_fused_k", "coattn_stats",
                  "coattn_weights"):
            if not launched.get(k):
                raise AssertionError(f"cli train launched no {k}")
        val = printed_metrics(cli_run(["validate", "--config", cfg_path, "--checkpoint", ck1]))
        log(f"  validate --checkpoint: {val}")
        for k in ("val_loss", "val_c_index"):
            if val[k] != final[k] and not (math.isnan(val[k]) and math.isnan(final[k])):
                raise AssertionError(f"validate {k} {val[k]} != the Trainer's {final[k]}")
        csv = {name: os.path.join(root, f"preds_{name}.csv") for name in
               ("card", "cpu", "mc", "converted", "ensemble")}
        t0 = time.perf_counter()
        _, launched = counted(lambda: cli_run(
            ["predict", "--config", cfg_path, "--checkpoint", ck1, "--out", csv["card"]]))
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_run(["predict", "--config", cfg_path, "--checkpoint", ck1, "--out", csv["cpu"],
                 "--set", "device=cpu"])
        t_cpu = time.perf_counter() - t0
        card, cpu = pd.read_csv(csv["card"]), pd.read_csv(csv["cpu"])
        if list(card.columns) != list(cpu.columns) or list(card.slide_id) != list(cpu.slide_id):
            raise AssertionError("predict: the card's and the CPU's CSV differ in columns or order")
        num = [c for c in card.columns if c != "slide_id"]
        err = float(np.abs(card[num].to_numpy() - cpu[num].to_numpy()).max())
        log(f"  predict on the card ({t_card:.1f} s, launches {launched}) and with --set "
            f"device=cpu ({t_cpu:.1f} s): {len(card)} slides, columns {len(card.columns)}, "
            f"same order; max_abs_err {err:.3e} over {num[:3]}... (tolerance {MODEL_ATOL:g})")
        if err > MODEL_ATOL or not np.isfinite(card[num].to_numpy()).all():
            raise AssertionError("predict: the card disagrees with the CPU")
        n_batches_ds = launched.get("coattn_stats", 0)
        _, launched = counted(lambda: cli_run(
            ["predict", "--config", cfg_path, "--checkpoint", ck1, "--out", csv["mc"],
             "--mc", MC_SAMPLES]))
        mc = pd.read_csv(csv["mc"])
        log(f"  predict --mc {MC_SAMPLES}: launches {launched}; risk_mc_std "
            f"{mc.risk_mc_std.min():.3e}..{mc.risk_mc_std.max():.3e}")
        if (launched.get("coattn_fwd_fused_k_train") != MC_SAMPLES * n_batches_ds
                or not (mc.risk_mc_std > 0).all() or not np.array_equal(mc.risk, card.risk)):
            raise AssertionError("predict --mc: launches, risk_mc_std or risk unexpected")
        res = json.loads(last_line(cli_run(["evaluate", "--config", cfg_path, "--checkpoint",
                                            ck1, "--json"]), "{"))
        log(f"  evaluate --json: c_index {res['c_index']:.4f}, IBS "
            f"{res['integrated_brier_score']:.4f}, mean AUC {res['mean_auc']:.4f} on "
            f"{res['n']} validation slides")
        cli_run(["check-data", "--config", cfg_path])
        log("  check-data: exit 0")
        pred = Predictor.from_config(load_config(cfg_path), checkpoint=ck1)
        sizes = pred.omic_sizes
        payload = torch.load(ck1, map_location="cpu", weights_only=True)
        ref_pt = os.path.join(root, "reference.pt")
        torch.save({"epoch": 0, "optimizer_state_dict": payload["optimizer"],
                    "loss": torch.tensor(float(payload["loss"])),
                    "model_state_dict": reference_state_dict(
                        payload["model"], cfg.model.name, sizes, cfg.model.fusion)}, ref_pt)
        out = cli_run(["convert-checkpoint", "--config", cfg_path, "--torch-checkpoint", ref_pt,
                       "--set", f"model.checkpoint_dir={os.path.join(root, 'converted')}"])
        ck_conv = last_line(out, "Converted checkpoint written to").rsplit(" ", 1)[-1]
        cli_run(["predict", "--config", cfg_path, "--checkpoint", ck_conv, "--out",
                 csv["converted"]])
        with open(csv["converted"]) as a, open(csv["card"]) as b:
            if a.read() != b.read():
                raise AssertionError("the converted reference checkpoint predicts otherwise")
        log("  convert-checkpoint of a reference-format .pt (the trained weights under the "
            "reference's names, Adam state, a 0-d tensor loss): predictions bit for bit equal")

        # ---- (b) the server in-process
        cfg = load_config(cfg_path)
        t0 = time.perf_counter()
        warmed = pred.warmup()
        warm_s = time.perf_counter() - t0
        base = serve(pred)
        status, health = http(base + "/healthz")
        log(f"phase 22 (b): Predictor.from_config + make_server(port=0) at {base}; warmup "
            f"{warmed} in {warm_s:.2f} s; /healthz {status} {health}")
        if status != 200 or health["n_params"] != pred.n_params:
            raise AssertionError("/healthz")
        rng = np.random.default_rng(22)
        singles, single_om = serve_bags(rng, 3, SERVE_LENGTHS, sizes)
        batch_bags, batch_om = serve_bags(rng, 8, SERVE_LENGTHS, sizes)
        kinds = {}
        for i, (bag, om) in enumerate(zip(singles, single_om)):
            wire = bag.astype(np.float16) if i == 2 else bag
            (status, body), kinds["/predict_npz"] = counted(
                lambda: http(base + "/predict_npz", npz_bytes(wire, om)))
            direct = pred.predict_bag(wire.astype(np.float32), om)
            if status != 200:
                raise AssertionError(f"/predict_npz {status}: {body}")
            same_answer(f"/predict_npz {i} ({wire.dtype}, {len(bag)} patches)", body, direct,
                        answer_keys(False))
        json_bag = rng.standard_normal((200, 1024), dtype=np.float32)
        json_om = [rng.standard_normal(s, dtype=np.float32) for s in sizes]
        status, body = http(base + "/predict", json.dumps(
            {"wsi": json_bag.tolist(), "omics": [o.tolist() for o in json_om]}).encode())
        if status != 200:
            raise AssertionError(f"/predict {status}")
        same_answer("/predict (JSON, 200 patches)", body, pred.predict_bag(json_bag, json_om),
                    answer_keys(False))
        batch_body = npz_bytes(bags=batch_bags, omics_list=batch_om)
        (status, body), kinds["/predict_batch_npz"] = counted(
            lambda: http(base + "/predict_batch_npz", batch_body))
        if status != 200:
            raise AssertionError(f"/predict_batch_npz {status}")
        direct = pred.predict_bags(batch_bags, batch_om)
        same_answer("/predict_batch_npz (8 bags)", body, direct, answer_keys(False))
        worst = max(rel_err(np.asarray(body[k], np.float32)[i],
                            pred.predict_bag(batch_bags[i], batch_om[i])[k][0])
                    for i in range(len(batch_bags)) for k in answer_keys(False))
        log(f"  3 x /predict_npz (one float16), 1 x /predict (JSON), 1 x /predict_batch_npz of "
            f"8 bags: each bit for bit equal to the in-process call of its shape; a bag alone "
            f"vs in the batch: {worst:.3e} relative (tolerance {SHAPE_RTOL:g})")
        if worst > SHAPE_RTOL:
            raise AssertionError("a bag scored alone disagrees with it scored in a batch")
        status, text = http(base + "/metrics")
        want = {'/predict_npz",status="2xx"': 3, '/predict",status="2xx"': 1,
                '/predict_batch_npz",status="2xx"': 1}
        for key, n in want.items():
            got = metric_value(text, f'mpot_requests_total{{endpoint="{key}}}')
            if got != n:
                raise AssertionError(f"/metrics counts {got} requests of {key}, expected {n}")
        log(f"  /metrics counts every request: {want}")
        lat_bag = rng.standard_normal((LATENCY_PATCHES, 1024), dtype=np.float32)
        lat_body = npz_bytes(lat_bag, json_om)
        infer_key = 'mpot_inference_seconds_total{endpoint="/predict_npz"}'
        infer0 = metric_value(http(base + "/metrics")[1], infer_key)
        lat, inproc = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            if http(base + "/predict_npz", lat_body)[0] != 200:
                raise AssertionError("/predict_npz latency request failed")
            lat.append(time.perf_counter() - t0)
        infer_ms = 1e3 * (metric_value(http(base + "/metrics")[1], infer_key) - infer0) / 10
        for _ in range(10):  # the same call in this process: padding, copies, kernels, fetch
            t0 = time.perf_counter()
            pred.predict_bag(lat_bag, json_om)
            inproc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        http(base + "/predict_batch_npz", batch_body)
        batch_s = time.perf_counter() - t0

        # ---- (c) dynamic batching
        dyn = serve(pred, dynamic_batch=DYN_BATCH, batch_wait_ms=50.0)
        dyn_bags, dyn_om = serve_bags(rng, DYN_BATCH, SERVE_LENGTHS, sizes)
        bodies = [npz_bytes(b, o) for b, o in zip(dyn_bags, dyn_om)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=DYN_BATCH) as ex:
            t0 = time.perf_counter()
            answers = list(ex.map(lambda p: http(dyn + "/predict_npz", p), bodies))
            conc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p in bodies:
            http(base + "/predict_npz", p)
        seq_s = time.perf_counter() - t0
        err = 0.0
        for (status, body), b, o in zip(answers, dyn_bags, dyn_om):
            if status != 200:
                raise AssertionError(f"dynamic batch: {status} {body}")
            ref = pred.predict_bag(b, o)
            err = max(err, max(float(np.abs(np.asarray(body[k], np.float32) - ref[k]).max())
                               for k in answer_keys(False)))
        text = http(dyn + "/metrics")[1]
        groups = metric_value(text, "mpot_dynamic_batch_groups_total")
        n_bags = metric_value(text, "mpot_dynamic_batch_bags_total")
        log(f"phase 22 (c): {DYN_BATCH} concurrent clients, --dynamic-batch {DYN_BATCH}: "
            f"{n_bags:.0f} bags in {groups:.0f} groups; answers vs per-bag max_abs_err "
            f"{err:.3e} (tolerance {DYN_ATOL:g})")
        if err > DYN_ATOL or not groups < n_bags:
            raise AssertionError("dynamic batching disagrees or did not engage")
        mixed = bodies[:DYN_BATCH - 1] + [npz_bytes(dyn_bags[-1])]  # no omics: a client error
        with concurrent.futures.ThreadPoolExecutor(max_workers=DYN_BATCH) as ex:
            statuses = [s for s, _ in ex.map(lambda p: http(dyn + "/predict_npz", p), mixed)]
        log(f"  one bad request among {DYN_BATCH}: statuses {statuses}")
        if statuses != [200] * (DYN_BATCH - 1) + [400]:
            raise AssertionError("the bad request was not isolated")

        # ---- (d) MC dropout
        mc_bag, mc_om = singles[0], single_om[0]
        mc_body = npz_bytes(mc_bag, mc_om)
        (status, mc1), kinds["/predict_npz?mc=8"] = counted(
            lambda: http(base + f"/predict_npz?mc={MC_SAMPLES}&mc_seed=3", mc_body))
        status2, mc2 = http(base + f"/predict_npz?mc={MC_SAMPLES}&mc_seed=3", mc_body)
        status3, mc3 = http(base + f"/predict_npz?mc={MC_SAMPLES}&mc_seed=4", mc_body)
        if (status, status2, status3) != (200, 200, 200):
            raise AssertionError(f"MC requests {status}, {status2}, {status3}")
        mc_keys = ("risk_mean", "risk_std", "survs_mean", "survs_std", "hazards_mean",
                   "y_mean", "y_std")
        same_answer("?mc=8&mc_seed=3 twice", mc2, {k: np.asarray(mc1[k], np.float32)
                                                   for k in mc_keys}, mc_keys)
        if mc3["risk_mean"] == mc1["risk_mean"] or not mc1["risk_std"][0] > 0:
            raise AssertionError("MC: mc_seed=4 repeats mc_seed=3, or risk_std is 0")
        bucket = bucket_for(len(mc_bag), pred.buckets)
        padded, m = pad_bag(mc_bag, bucket)
        staged = pred._batch(torch.from_numpy(padded[None]).to(dev),
                             torch.from_numpy(m[None]).to(dev), [mc_om], 1)
        _, mc_only = counted(lambda: pred._mc_step(MC_SAMPLES)(staged, mc_generator(dev, 3)))
        gen = mc_generator(dev, 3)
        samples = []
        pred.model.train()
        with torch.inference_mode():
            for _ in range(MC_SAMPLES):
                out = pred.model(staged["wsi"], staged["omics"], staged["mask"],
                                 need_attention=False, generator=gen)
                samples.append(-out.survs.sum(dim=1))
        pred.model.eval()
        risks = torch.stack(samples)
        replay = {"risk_mean": risks.mean(dim=0).cpu().numpy(),
                  "risk_std": risks.std(dim=0, correction=0).cpu().numpy()}
        same_answer("MC answer vs 8 training-mode forwards of a generator in the same state",
                    mc1, replay, ("risk_mean", "risk_std"))
        log(f"phase 22 (d): ?mc={MC_SAMPLES}&mc_seed=3 twice bit for bit equal, mc_seed=4 "
            f"differs; risk {mc1['risk'][0]:.6f}, risk_mean {mc1['risk_mean'][0]:.6f}, risk_std "
            f"{mc1['risk_std'][0]:.3e}; equal bit for bit to {MC_SAMPLES} training-mode forwards "
            f"replayed; the request's launches {kinds['/predict_npz?mc=8']} (the deterministic "
            f"columns' export passes and the MC forwards), the MC step alone {mc_only}")
        if mc_only != {"coattn_fwd_fused_k_train": MC_SAMPLES}:
            raise AssertionError(f"the MC step launched {mc_only}")
        if kinds["/predict_npz?mc=8"].get("coattn_fwd_fused_k_train") != MC_SAMPLES:
            raise AssertionError("an MC request did not launch the training form 8 times")

        # ---- (e) a checkpoint ensemble
        dir2 = os.path.join(root, "run2")
        cli_run(["train", "--config", cfg_path, "--set", "training.epochs=2", *SERVE_SET,
                 "--set", f"model.load_from_checkpoint={ck1}",
                 "--set", f"model.checkpoint_dir={dir2}"])
        ck2 = os.path.join(dir2, os.path.basename(ck1))
        ens = Predictor.from_config(cfg, checkpoint=[ck1, ck2])
        second = Predictor.from_config(cfg, checkpoint=ck2)
        got = ens.predict_bags(batch_bags, batch_om)
        members = [p.predict_bags(batch_bags, batch_om) for p in (pred, second)]
        err = float(np.abs(got["survs"] - (members[0]["survs"] + members[1]["survs"]) / 2).max())
        log(f"phase 22 (e): ensemble of {os.path.basename(ck1)} (epoch 1) and the checkpoint "
            f"after one more epoch: risk_ens_std {got['risk_ens_std'].min():.3e}.."
            f"{got['risk_ens_std'].max():.3e}; mean survs vs the members' mean max_abs_err "
            f"{err:.3e} (tolerance {ENS_ATOL:g})")
        if err > ENS_ATOL or not (got["risk_ens_std"] > 0).all():
            raise AssertionError("ensemble")
        cli_run(["predict", "--config", cfg_path, "--checkpoint", ck1, "--checkpoint", ck2,
                 "--out", csv["ensemble"]])
        if "risk_ens_std" not in pd.read_csv(csv["ensemble"]).columns:
            raise AssertionError("predict with two checkpoints wrote no risk_ens_std")
        del ens, second

        # ---- (f) GE-NaCAGaT medium
        ge = make_ge_predictor(dev)
        ge_base = serve(ge)
        ge_bags, _ = serve_bags(rng, 4, GE_SERVE_LENGTHS, ())
        (status, ge_one), kinds["GE /predict_npz"] = counted(
            lambda: http(ge_base + "/predict_npz", npz_bytes(ge_bags[0])))
        (status2, ge_all), kinds["GE /predict_batch_npz"] = counted(
            lambda: http(ge_base + "/predict_batch_npz", npz_bytes(bags=ge_bags)))
        per_batch = {"milpool": 1, "flash_fwd_d256": 1, "flash_fwd_d32": 2}
        n_ge = len({bucket_for(len(b), GE_BUCKETS) for b in ge_bags})  # batches (<= GE_B bags)
        if (status, status2) != (200, 200) or kinds["GE /predict_npz"] != per_batch or \
                kinds["GE /predict_batch_npz"] != {k: n_ge * v for k, v in per_batch.items()}:
            raise AssertionError(f"GE requests: {status}, {status2}, launches {kinds}")
        cpu_ge = make_ge_predictor("cpu", 4, buckets=(1024, 2048))
        ref = cpu_ge.predict_bags(ge_bags)["y"]
        err = max(float(np.abs(np.asarray(ge_one["y"], np.float32)[0] - ref[0]).max()),
                  float(np.abs(np.asarray(ge_all["y"], np.float32) - ref).max()))
        log(f"phase 22 (f): GE-NaCAGaT medium (buckets {GE_BUCKETS}, batch {GE_B}), bags of "
            f"{[len(b) for b in ge_bags]} patches: /predict_npz and /predict_batch_npz "
            f"({n_ge} batch(es)), launches a batch {per_batch}; y vs the CPU max_abs_err {err:.3e} (tolerance "
            f"{MODEL_ATOL:g})")
        if err > MODEL_ATOL:
            raise AssertionError("GE serving disagrees with the CPU")
        del ge, cpu_ge

        # ---- (g) the real entry point, in a subprocess
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "multimodal_path_omic_tpu_torch.cli", "serve", "--config",
             cfg_path, "--checkpoint", ck1, "--port", "0", "--warmup"],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(proc)
        lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
                         daemon=True).start()
        seen, url = [], None
        while url is None:
            line = lines.get(timeout=300)
            if line is None:
                raise AssertionError(f"cli serve exited before serving: {''.join(seen)[-2000:]}")
            seen.append(line)
            if line.startswith("serving on "):
                url = line.split()[-1]
        start_s = time.perf_counter() - t0
        status, body = http(url + "/predict_npz", npz_bytes(mc_bag, mc_om))
        if status != 200:
            raise AssertionError(f"cli serve: /predict_npz {status}")
        err = max(rel_err(np.asarray(body[k], np.float32), pred.predict_bag(mc_bag, mc_om)[k])
                  for k in answer_keys(False))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        while (line := lines.get(timeout=60)) is not None:
            seen.append(line)
        log(f"phase 22 (g): python -m multimodal_path_omic_tpu_torch.cli serve --port 0 "
            f"--warmup: serving after {start_s:.1f} s ({[s.strip() for s in seen if 'warm' in s]}); "
            f"/predict_npz vs the in-process Predictor {err:.3e} relative; SIGTERM -> exit {rc}, "
            f"last line {seen[-1].strip()!r}")
        if rc != 0 or seen[-1].strip() != "server stopped" or err > SHAPE_RTOL:
            raise AssertionError("cli serve did not answer or stop cleanly")

        # ---- launches and times
        t0 = time.perf_counter()
        cols = pred.predict_dataset()
        ds_s = time.perf_counter() - t0
        for what, k in kinds.items():
            log(f"  launches of one {what}: {k}")
        log(f"phase 22 timings ({power}): /predict_npz of one {LATENCY_PATCHES}-patch bag, 10 "
            f"requests: median {1e3 * float(np.median(lat)):.1f} ms, max {1e3 * max(lat):.1f} ms "
            f"(the server's inference under its lock {infer_ms:.1f} ms a request; the same "
            f"predict_bag in this process: median {1e3 * float(np.median(inproc)):.1f} ms; the "
            "rest is the body's transfer, np.load and JSON); "
            f"/predict_batch_npz of 8 bags: {8 / batch_s:.2f} bags/s; {DYN_BATCH} concurrent "
            f"clients with --dynamic-batch {DYN_BATCH}: {DYN_BATCH / conc_s:.2f} bags/s against "
            f"{DYN_BATCH / seq_s:.2f} bags/s one after another; warmup {warm_s:.2f} s; "
            f"predict_dataset {len(cols['risk']) / ds_s:.2f} bags/s over {len(cols['risk'])} "
            "bags")
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    total = read_counts()
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s of wall time, launches "
        f"{ {k: v for k, v in total.items() if v} } ({power})")
    return total


# Phase 23: this slice on the card. The Trainer runs of (a) and (b) are phase
# 21's configuration (examples/nacagat.yaml on TRAINER_COHORT with
# TRAINER_SET); (d) and (e) step phase 17's and phase 14's models on small
# batches of their buckets; (f) scores phase 2's 40 bags.
GRAPH_RUNS = (("off", 0, True), ("off", 1, True), ("off", 0, False),
              ("on", 0, True), ("on", 1, True), ("on", 0, False))
GRAPH_STEPS = 3
PARTIAL_BUCKET = 4096  # (b): the bucket the budget fits
HEADLINE_K, HEADLINE_CALLS, HEADLINE_WINDOWS = 16, 4, 3
PINNED_CALLS = 3


def _busy_share(fn) -> tuple:
    """(wall ms, device ms, busy share) of ``fn()`` traced by torch.profiler;
    the device numbers None where the trace holds no device time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    try:
        device_ms = sum(r[1] for r in device_rows(prof))
    except AssertionError:
        return wall_ms, None, None
    return wall_ms, device_ms, device_ms / wall_ms


def _counts_delta(before, after) -> dict:
    return {k: v - before[k] for k, v in after.items() if v - before[k]}


def _trainer_run(tag, what, cfg, graphs, power, profile=False, budget_of=None) -> dict:
    """Epoch 1 through ``validated_epoch`` (the warm-up: graphs captured,
    the cache uploaded), epoch 2 as ``train_epoch`` then ``validate``, each
    timed to a device sync; with ``profile`` a third training epoch traced
    for the busy share."""
    import torch

    from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, verbose=False, graphs=graphs)
    if budget_of is not None:  # (b): a budget that fits that bucket only
        lengths = np.concatenate([trainer.train_batcher._bag_lengths(),
                                  trainer.val_batcher._bag_lengths()])
        per = DeviceBagCache.bucket_bytes(lengths, trainer.buckets, trainer.wsi_dim)
        trainer.config.tpu.device_cache_budget_bytes = per[budget_of] + 1
    t0 = time.perf_counter()
    tr0, va0 = trainer.validated_epoch(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    risks0 = trainer.val_risks.copy()
    c0 = read_counts()
    t0 = time.perf_counter()
    tr1 = trainer.train_epoch(1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    c1 = read_counts()
    t0 = time.perf_counter()
    va1 = trainer.validate(1)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    c2 = read_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    cache = trainer.device_cache
    stores = [bucket for c in (cache, trainer.device_cache_val) if c is not None
              for bucket in c.caches.values()]
    run = {"what": what, "steps": trainer.last_epoch_steps, "val_batches": len(trainer.val_batcher),
           "partial": trainer._cache_partial, "cached": cache and cache.cached_buckets,
           "epochs": [
        (tr0["train_loss"], tr0.get("train_attn_loss"), va0["val_loss"], risks0),
        (tr1["train_loss"], tr1.get("train_attn_loss"), va1["val_loss"],
         trainer.val_risks.copy())],
        "train_launches": _counts_delta(c0, c1), "val_launches": _counts_delta(c1, c2),
        "graphs": 0 if trainer.graphs is None else len(trainer.graphs), "peak_gib": peak,
        # the cache's bag bytes (wsi and its int8 row scales), and as float32
        "cache_bytes": (sum(t.numel() * t.element_size() for bucket in stores
                            for key, t in bucket.items() if key in ("wsi", "wsi_scale")),
                        sum(bucket["wsi"].numel() * 4 for bucket in stores)),
        "first_s": first_s, "train_s": train_s, "val_s": val_s,
        "n_train": len(trainer.train_ds), "n_val": len(trainer.val_ds)}
    busy = ""
    if profile:
        wall, dev_ms, share = _busy_share(lambda: trainer.train_epoch(2))
        run["busy"] = (wall, dev_ms, share)
        busy = (f", a traced training epoch {wall:.1f} ms wall, "
                + (f"{dev_ms:.1f} ms device, busy share {share:.3f}" if share is not None
                   else "device time not measured (the trace holds none)"))
    n_train, n_val = len(trainer.train_ds), len(trainer.val_ds)
    del trainer, cache, stores  # the next run starts from what this one held
    log(f"  ({tag}) {what}: epoch 1 (validated_epoch, with the warm-up) {first_s:.2f} s; epoch 2 "
        f"train {train_s:.3f} s = {n_train / train_s:.1f} train bags/s over "
        f"{run['steps']} steps, validate {val_s:.3f} s = "
        f"{n_val / val_s:.1f} val bags/s; {run['graphs']} CUDA graphs; peak device memory "
        f"{peak:.2f} GiB above the run's start{busy}; epoch 2 launches train "
        f"{run['train_launches']}, "
        f"val {run['val_launches']} ({power})")
    return run


def _same_epochs(what, got, ref) -> None:
    for e, (g, r) in enumerate(zip(got["epochs"], ref["epochs"])):
        for name, a, b in zip(("train_loss", "train_attn_loss", "val_loss"), g[:3], r[:3]):
            if a != b:
                raise AssertionError(f"{what} epoch {e + 1}: {name} {a!r} != {b!r}")
        if not np.array_equal(g[3], r[3]):
            raise AssertionError(f"{what} epoch {e + 1}: validation risks differ")


def _step_pair(what, make, batch, steps, evaluate=None) -> dict:
    """``steps`` training steps (and, with ``evaluate``, two eval steps)
    eager and graphed from the same weights and seed: parameters, metrics,
    eval results and the generator's state bit for bit, the launches equal.
    Returns the graphed run's launches."""
    import torch

    from torch.utils import _pytree as pytree

    runs = {}
    for graphs in (False, True):
        model, state, step, ev = make(graphs)
        before = read_counts()
        out = []
        for _ in range(steps):
            state, m = step(state, batch)
            out.append(m)
        if ev is not None:
            out += [ev(batch) for _ in range(2)]
        torch.cuda.synchronize()
        runs[graphs] = (model, state, out, _counts_delta(before, read_counts()))
    (m0, s0, o0, c0), (m1, s1, o1, c1) = runs[False], runs[True]
    for (name, p), q in zip(m0.named_parameters(), m1.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"{what}: graphed and eager parameter {name} differ")
    for a, b in zip(pytree.tree_leaves(o0), pytree.tree_leaves(o1)):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{what}: graphed and eager metrics or eval results differ")
    if not torch.equal(s0.generator.get_state(), s1.generator.get_state()):
        raise AssertionError(f"{what}: the generators' states differ")
    if c0 != c1:
        raise AssertionError(f"{what}: launches eager {c0}, graphed {c1}")
    log(f"  {what}: {steps} training steps" + (" and 2 eval steps" if ev is not None else "")
        + f" graphed == eager, bit for bit (parameters, metrics, generator); launches {c1}")
    return c1


def _pageable_predict_bags(pred, bags, omics) -> dict:
    """``predict_bags`` as it copied before pinned staging: each bag copied
    from pageable memory into its row of a zeroed device batch, one batch
    at a time, with the same eval step."""
    import torch

    from multimodal_path_omic_tpu_torch.data.bags import bucket_for

    by_bucket = {}
    for i, bag in enumerate(bags):
        by_bucket.setdefault(bucket_for(len(bag), pred.buckets), []).append(i)
    slots, dim = {}, bags[0].shape[1]
    for bucket, idxs in sorted(by_bucket.items()):
        for c0 in range(0, len(idxs), pred.batch_size):
            chunk = idxs[c0:c0 + pred.batch_size]
            wsi = torch.zeros((pred.batch_size, bucket, dim), device=pred.device)
            mask = torch.zeros((pred.batch_size, bucket), dtype=torch.bool, device=pred.device)
            for row, i in enumerate(chunk):
                wsi[row, :len(bags[i])] = torch.from_numpy(bags[i]).to(pred.device)
                mask[row, :len(bags[i])] = True
            out = pred._debatch(pred._eval(pred._batch(wsi, mask, [omics[i] for i in chunk],
                                                       len(chunk))), len(chunk))
            for k, v in out.items():
                slots.setdefault(k, [None] * len(bags))
                for row, i in enumerate(chunk):
                    slots[k][i] = v[row]
    return {k: np.stack(v) for k, v in slots.items()}


def phase23_graphs(dev, bags, omics) -> dict:
    """Multi-step training on CUDA graphs, partial caching, pinned staging
    and the headline bench on the card. Returns the phase's launches."""
    import shutil
    import tempfile

    import torch

    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train import loop
    from multimodal_path_omic_tpu_torch.train.benchmark import headline
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    reset_counts()
    root = tempfile.mkdtemp(prefix="chip_smoke_graphs_")
    try:
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **TRAINER_COHORT)
        log(f"phase 23 (a): examples/nacagat.yaml + {TRAINER_SET}, host-fed and cached, "
            "steps_per_dispatch auto and 1, CUDA graphs and eager")
        runs = {}
        for feed, spd, graphs in GRAPH_RUNS:
            what = (f"{'cached' if feed == 'on' else 'host-fed'}, steps_per_dispatch "
                    f"{spd or 'auto'}, {'graphed' if graphs else 'eager'}")
            cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, f"{feed}{spd}{graphs}"),
                                 {**TRAINER_SET, "tpu.device_cache": feed,
                                  "tpu.steps_per_dispatch": spd})
            runs[(feed, spd, graphs)] = _trainer_run("a", what, cfg, graphs, power,
                                                     profile=spd == 0)
        ref = runs[GRAPH_RUNS[0]]
        for key, run in runs.items():
            _same_epochs(f"{run['what']} vs {ref['what']}", run, ref)
            want = ref["train_launches"], ref["val_launches"]
            if key[0] == "on":  # one row gather more a step and a validation batch
                want = tuple({**w, "gather_rows": n} for w, n in zip(
                    want, (run["steps"], run["val_batches"])))
            if (run["train_launches"], run["val_launches"]) != want:
                raise AssertionError(f"{run['what']}: epoch 2 launches differ from {want}")
        for feed in sorted({key[0] for key in runs}):
            g, e = runs[(feed, 0, True)], runs[(feed, 0, False)]
            log(f"  {'cached' if feed == 'on' else 'host-fed'}: graphed vs eager train "
                f"{e['train_s'] / g['train_s']:.2f}x, validate {e['val_s'] / g['val_s']:.2f}x; "
                f"peak device memory graphed {g['peak_gib']:.2f} GiB vs eager "
                f"{e['peak_gib']:.2f} GiB ({power})")
        log("  all six runs: both epochs' train loss, attention loss, val loss and val risks "
            "bit for bit equal; launches as the eager host-fed run's (plus one row gather a "
            "cached step and validation batch)")

        log(f"phase 23 (b): partial caching, a budget that fits the {PARTIAL_BUCKET} bucket "
            "only")
        cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, "partial"),
                             {**TRAINER_SET, "tpu.device_cache": "auto"})
        part = _trainer_run("b", "partially cached, steps_per_dispatch auto, graphed", cfg,
                            True, power, budget_of=PARTIAL_BUCKET)
        if not part["partial"] or part["cached"] != [PARTIAL_BUCKET]:
            raise AssertionError(f"partial cache: buckets {part['cached']}")
        _same_epochs("partially cached vs host-fed", part, ref)
        log(f"  the {PARTIAL_BUCKET} bucket gathered on the card, the other host-fed: both "
            "epochs bit for bit equal to the host-fed run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    log(f"phase 23 (c): the headline bench (bench.py's workload), K = {HEADLINE_K} steps a "
        f"call, {HEADLINE_CALLS} calls a window, best of {HEADLINE_WINDOWS} windows")
    for row in headline(dev, k=HEADLINE_K, n_calls=HEADLINE_CALLS, n_windows=HEADLINE_WINDOWS,
                        verbose=False):
        log(f"  {row['metric']}: graphed {row['value']} bags/s, eager "
            f"{row['eager_bags_per_sec']} bags/s ({row['value'] / row['eager_bags_per_sec']:.2f}x)"
            f"; {json.dumps(row)} ({power})")
    torch.cuda.empty_cache()

    rng = np.random.default_rng(23)

    def ge_make(graphs):
        model = seeded_init_(build_model("GE-NaCAGaT", model_size="small", dropout=TRAIN_RATE,
                                         n_classes=3), 0).to(dev)
        opt = make_optimizer("adam", 2e-4, 1e-5)
        return (model, loop.init_train_state(model, opt, seed=0),
                loop.make_train_step(model, "ce", opt, ge_mode=True, graphs=graphs),
                loop.make_eval_step(model, "ce", ge_mode=True, graphs=graphs))

    lengths = (4096, 2500, 1000)
    wsi = torch.zeros((GE_WIDE_B, GE_WIDE_M, 1024), device=dev)
    mask = torch.zeros((GE_WIDE_B, GE_WIDE_M), dtype=torch.bool, device=dev)
    for row, n in enumerate(lengths):
        wsi[row, :n] = torch.from_numpy(rng.standard_normal((n, 1024), dtype=np.float32)).to(dev)
        mask[row, :n] = True
    ge_batch = {"wsi": wsi, "mask": mask,
                "label": torch.tensor([0, 2, 1, 0], device=dev),
                "weight": torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)}
    log(f"phase 23 (d): GE-NaCAGaT small (ce, dropout {TRAIN_RATE}, Adam) on "
        f"[{GE_WIDE_B}, {GE_WIDE_M}, 1024] (bags of {lengths} patches and a filler row)")
    ge = _step_pair("GE small", ge_make, ge_batch, GRAPH_STEPS, evaluate=True)
    for name in ("flash_fwd_d128", "flash_fwd_d16", "flash_bwd_d128", "flash_bwd_d16",
                 "milpool"):
        if not ge.get(name):
            raise AssertionError(f"GE small: {name} did not launch in the graphed run")

    def mcat_make(graphs):
        model = seeded_init_(build_model("MCAT", omic_sizes=SIZES, model_size="medium",
                                         dropout=TRAIN_RATE, lean=False), 0).to(dev)
        opt = make_optimizer("adam", 2e-4, 1e-5)
        return (model, loop.init_train_state(model, opt, seed=0),
                loop.make_train_step(model, "ces", opt, omic_sizes=SIZES, graphs=graphs), None)

    n_rows = 8
    wsi = torch.zeros((n_rows, TRAIN_M, 1024), device=dev)
    mask = torch.zeros((n_rows, TRAIN_M), dtype=torch.bool, device=dev)
    for row in range(n_rows):
        wsi[row, :len(bags[row])] = torch.from_numpy(bags[row]).to(dev)
        mask[row, :len(bags[row])] = True
    mcat_batch = {"wsi": wsi, "mask": mask,
                  "omics": [torch.from_numpy(np.stack([omics[r][j] for r in range(n_rows)]))
                            .to(dev) for j in range(len(SIZES))],
                  "label": torch.from_numpy(rng.integers(0, 4, n_rows)).to(dev),
                  "censorship": torch.from_numpy(rng.integers(0, 2, n_rows)
                                                 .astype(np.float32)).to(dev),
                  "weight": torch.ones(n_rows, device=dev)}
    log(f"phase 23 (e): MCAT medium lean=False (ces, dropout {TRAIN_RATE}, Adam) on "
        f"[{n_rows}, {TRAIN_M}, 1024] (phase 2's first bags)")
    mc = _step_pair("MCAT lean=False", mcat_make, mcat_batch, GRAPH_STEPS)
    if mc != {"coattn_plain": GRAPH_STEPS, "coattn_plain_bwd": GRAPH_STEPS}:
        raise AssertionError(f"MCAT lean=False: launches {mc}")
    del mcat_batch, ge_batch, wsi, mask
    torch.cuda.empty_cache()

    log(f"phase 23 (f): NaCAGaT ces predict_bags on phase 2's {len(bags)} bags, pinned "
        "staging overlapped with the graphed eval against pageable copies")
    pred = make_predictor(dev, "ces")
    eager_eval = loop.make_eval_step(pred.model, "ces", omic_sizes=SIZES, graphs=False)
    pred.predict_bags(bags, omics)  # the warm-up: a graph captured at each batch shape
    times = {"pinned": [], "pageable": []}
    answers = {}
    for _ in range(PINNED_CALLS):
        for way, fn in (("pinned", pred.predict_bags),
                        ("pageable", lambda b, o: _pageable_predict_bags(pred, b, o))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers[way] = fn(bags, omics)
            times[way].append(time.perf_counter() - t0)
    for key in ("risk", "hazards", "survs", "y"):
        if not np.array_equal(answers["pinned"][key], answers["pageable"][key]):
            raise AssertionError(f"pinned vs pageable predict_bags: {key} differs")
    staged = pred._staged_batch(pred._stage(
        [bag[:3000] for bag in bags[:B] if len(bag) >= 3000][:B], BUCKETS[0], B,
        omics[:B]), B)
    graphed, eager = pred.eval_step(staged), eager_eval(staged)
    for key in ("loss", "risk", "hazards", "survs", "y"):
        if not torch.equal(graphed[key], eager[key]):
            raise AssertionError(f"ces eval step: graphed and eager {key} differ")
    rate = {w: len(bags) / float(np.median(t)) for w, t in times.items()}
    log(f"  pinned {rate['pinned']:.2f} bags/s vs pageable {rate['pageable']:.2f} bags/s "
        f"({rate['pinned'] / rate['pageable']:.2f}x; median of {PINNED_CALLS} calls each, "
        f"{[round(t, 4) for t in times['pinned']]} s vs "
        f"{[round(t, 4) for t in times['pageable']]} s); answers bit for bit equal; the "
        f"graphed ces eval step == the eager one on a staged batch ({power})")
    del pred
    torch.cuda.synchronize()
    total = read_counts()
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s of wall time, launches "
        f"{ {k: v for k, v in total.items() if v} } ({power})")
    return total


# Phase 24: reduced precision. The bfloat16 instances against their plain
# versions on the card: bfloat16 outputs (o, dq, dkv; dwk and dbk cast to
# bfloat16) to one unit in the last place (2^-7 relative: both versions round
# the same float32 value, summed in another order); the float32 statistics
# and weights to 1e-2 (l relative, m, ssq, sumw absolute, w relative with
# W_ATOL's floor): where one element of k (the kernel's projection against
# cuBLAS's, ~1e-7 relative apart) or of tanh rounds to the other bfloat16
# neighbour in the two versions, that key's score moves by up to ~5e-3;
# gradients to 2e-2 of each tensor's largest magnitude (those roundings, and
# the kernel's 1 - tanh^2 of the rounded tanh where autograd takes it of the
# unrounded one). An indexing or masking fault moves any of them by O(1).
BF16_O_RTOL, BF16_STAT_TOL, BF16_GRAD_RTOL = 2.0 ** -7, 1e-2, 2e-2
BF16_CASES = ((TRAIN_M, "prefix"), (TRAIN_M, "holes"), (1500, "one"))
BF16_KERNELS = ("coattn_fwd_fused_k_bf16", "coattn_fwd_fused_k_train_bf16",
                "coattn_bwd_fused_k_bf16", "coattn_stats_bf16", "coattn_weights_bf16")
# The card's bfloat16 Trainer against the port on the CPU, one epoch at
# dropout 0 from the int8 store, for each of BF16_CPU_SEEDS: the train and
# validation losses relative, the validation risks absolute, each limit about
# twice the largest of four seeds' readings (NVIDIA H100 80GB HBM3, 700.00
# W: 2.551e-5, 5.359e-4, 2.915e-3). cuBLAS and the CPU round each bfloat16
# product at other places (a bias added before or after the rounding) and
# sum in other orders, and three Adam steps carry those differences on. A
# float32-compute control on the card lands as close to the CPU's bfloat16
# run (6.4e-6..1.5e-4, 2.5e-4..6.3e-4, 1.5e-3..2.7e-3 on the same seeds):
# no limit on this comparison tells the two apart, so each seed's bfloat16
# run is also held to differ from its float32 control on the card, which a
# run that silently computed in float32 would equal bit for bit.
BF16_CPU_TRAIN_RTOL, BF16_CPU_VAL_RTOL, BF16_CPU_ATOL = 6e-5, 1.2e-3, 6e-3
BF16_CPU_SEEDS = (0, 1, 2, 3)
# (b)'s runs: (tag, the settings over TRAINER_SET, the kernels a training
# step and a validation batch launch)
BF16_TRAIN_K = {"coattn_fwd_fused_k_train_bf16": 1, "coattn_bwd_fused_k_bf16": 1}
BF16_VAL_K = {"coattn_stats_bf16": 1, "coattn_weights_bf16": 1}
F32_TRAIN_K = {"coattn_fwd_fused_k_train": 1, "coattn_bwd_fused_k": 1}
F32_VAL_K = {"coattn_stats": 1, "coattn_weights": 1}
BF16_RUNS = (
    ("int8 store, bf16 compute", {"tpu.device_cache": "on", "tpu.cache_dtype": "int8",
                                  "tpu.compute_dtype": "bfloat16"}, BF16_TRAIN_K, BF16_VAL_K),
    ("int8 transfer, bf16 compute", {"tpu.device_cache": "off", "tpu.transfer_dtype": "int8",
                                     "tpu.compute_dtype": "bfloat16"}, BF16_TRAIN_K, BF16_VAL_K),
    # ces: its validation runs the eval form
    ("int8 store, bf16 compute, ces", {"tpu.device_cache": "on", "tpu.cache_dtype": "int8",
                                       "tpu.compute_dtype": "bfloat16", "training.loss": "ces"},
     BF16_TRAIN_K, {"coattn_fwd_fused_k_bf16": 1}),
    ("int8 store, bf16 compute, int8_matmul",
     {"tpu.device_cache": "on", "tpu.cache_dtype": "int8", "tpu.compute_dtype": "bfloat16",
      "tpu.int8_matmul": True}, BF16_TRAIN_K, BF16_VAL_K),
    ("bf16 store, f32 compute", {"tpu.device_cache": "on", "tpu.cache_dtype": "bfloat16"},
     F32_TRAIN_K, F32_VAL_K),
    ("bf16 transfer, f32 compute", {"tpu.device_cache": "off",
                                    "tpu.transfer_dtype": "bfloat16"}, F32_TRAIN_K, F32_VAL_K),
)


def bf16_bound_ms(name, mask, e=E, f=None, n=N, design=False) -> tuple:
    """(bound ms, 'bytes' | 'operations') of a bfloat16 instance at B=32,
    ``n`` queries, E=D=``e`` and F=``f`` (default E): bytes with bfloat16
    inputs and outputs where the instance reads and writes bfloat16 (each
    input read once, each output written once; the export passes read only
    the k rows of the keys they need); operations of the products the
    function needs over the keys it needs (a tile without a valid key is
    skipped) at the bfloat16 tensor-core rate: the projection k = kv wk, and
    in the backward its recompute, dk wk^T and kv^T dk (three products of 2
    keys F E); the export passes' float32 FMAs on the CUDA cores. With
    ``design``, the backward's bound as csrc/fused_k_sm90.cuh runs it: the
    dk scratch (float32) written and read once more, and dk wk^T and kv^T dk
    each on two bfloat16 parts of dk (five products)."""
    b, m_len = mask.shape
    keys = valid_keys(mask)
    f = e if f is None else f
    N = n
    if name.startswith("coattn_fwd_fused_k"):
        n_stats = 4 if "train" in name else 3
        nbytes = 2 * (b * N * e + b * m_len * f + f * e + e) + b * m_len \
            + 2 * b * N * f + 4 * n_stats * b * N
        t_ops = 2 * keys * f * e / PEAK_BF16_FLOP_PER_S * 1e3
    elif name == "coattn_bwd_fused_k_bf16":
        nbytes = 2 * (b * N * e + b * m_len * f + f * e + e + b * N * f) + 4 * 5 * b * N \
            + b * m_len + 2 * (b * N * e + b * m_len * f) + 4 * (f * e + e)
        products = 3
        if design:
            nbytes += 2 * 4 * b * m_len * e  # the dk scratch, written and read
            products = 5
        t_ops = products * 2 * keys * f * e / PEAK_BF16_FLOP_PER_S * 1e3
    else:  # the export passes: the k rows of the valid keys
        need = int(mask.sum())
        nbytes = 2 * (b * N * e + need * e) + 4 * 2 * b * N + b * m_len
        if name == "coattn_weights_bf16":
            nbytes += 4 * b * N * m_len
        t_ops = 4 * N * need * e / PEAK_F32_FLOP_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def design_note(name, mask, e, f, ms) -> str:
    """The bfloat16 fuse-K backward's bound as its design runs it
    (:func:`bf16_bound_ms` with ``design``) and the share of it reached,
    for its log line; "" for another row."""
    if name != "coattn_bwd_fused_k_bf16":
        return ""
    dms, dby = bf16_bound_ms(name, mask, e, f, design=True)
    return f"; with the dk scratch and the split, {dms:.4f} ms ({dby}; {dms / ms:.3f} of it)"


def check_bf16(name, got, ref, kind) -> float:
    """A bfloat16 instance's output against its plain version's: kind "o"
    (bfloat16, one unit), "l" (relative), "abs" (absolute), "w" (relative,
    floor W_ATOL), "grad" (of the largest magnitude). Returns the error."""
    got, ref = got.float(), ref.float()
    if kind == "grad":
        return check_rel(name, got, ref, BF16_GRAD_RTOL)
    atol, rtol = {"o": (KERNEL_ATOL, BF16_O_RTOL), "l": (0.0, BF16_STAT_TOL),
                  "abs": (BF16_STAT_TOL, 0.0), "w": (W_ATOL, BF16_STAT_TOL)}[kind]
    return check_close(name, got, ref, atol, rtol)


def bf16_row(name, e) -> str:
    """A bfloat16 instance's row in the kernels line: its count's name, with
    ``_e512`` (the fuse-K instances) or ``_d512`` (the export passes) at
    NaCAGaT big's width."""
    if e == E:
        return name
    return name + ("_d" if name.startswith(("coattn_stats", "coattn_weights")) else "_e") + str(e)


def count_of(row_name) -> str:
    """The launch count a row of the kernels line reads: its name without the
    ``_e512`` / ``_d512`` of :func:`bf16_row` (and of the float32 rows at
    E = 512), which the counts do not carry."""
    base, _, width = row_name.rpartition("_")
    return base if width in ("e512", "d512") else row_name


def bf16_fuse_k_case(fk, m_len, note) -> tuple:
    """The bfloat16 fuse-K eval and training forms and the backward on
    ``fk`` = (q, kv, wk, bk, mask) against their plain versions, with the
    BF16_* tolerances (errors into ``note``); two runs bitwise equal; dkv
    exactly 0 at masked keys; a one-key bag pools exactly its kv row.
    Returns (dout, dssq, dsumw, seed)."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    bf = torch.bfloat16
    q16, kv16, wk16, bk16, mask = fk
    b, n = q16.shape[:2]
    dev = q16.device
    got = coattn.coattn_fwd_fused_k(*fk)
    ref = coattn.coattn_fwd_fused_k_plain(*fk)
    for what, a, r, kd in zip(("o", "l", "m", "sumw"), got, ref, ("o", "l", "abs", "abs")):
        note("coattn_fwd_fused_k_bf16", check_bf16(f"fused_k_bf16.{what}", a, r, kd))
    if not all(torch.equal(a, b) for a, b in zip(got, coattn.coattn_fwd_fused_k(*fk))):
        raise AssertionError("fused_k_bf16: two runs differ")
    one = mask.sum(-1) == 1
    if bool(one.any()):  # the pooled row is that key's kv row, rounded once: itself
        row = kv16[one][torch.arange(int(one.sum()), device=dev), mask[one].float().argmax(-1)]
        if not torch.equal(got[0][one], row[:, None, :].expand_as(got[0][one])):
            raise AssertionError("fused_k_bf16: a one-key bag does not pool its kv row")
        log("  fused_k_bf16: the bag with one valid key pools exactly its kv row")
    seed = torch.tensor([m_len + 24], dtype=torch.int32, device=dev)
    fwd = coattn.coattn_fwd_fused_k_train(*fk, seed, TRAIN_RATE)
    ref = coattn.coattn_fwd_fused_k_train_plain(*fk, seed, TRAIN_RATE)
    for what, a, r, kd in zip(("o", "l", "m", "ssq", "sumw"), fwd, ref,
                              ("o", "l", "abs", "abs", "abs")):
        note("coattn_fwd_fused_k_train_bf16",
             check_bf16(f"fused_k_train_bf16.{what}", a, r, kd))
    if not all(torch.equal(a, b) for a, b in
               zip(fwd, coattn.coattn_fwd_fused_k_train(*fk, seed, TRAIN_RATE))):
        raise AssertionError("fused_k_train_bf16: two runs differ")
    g = torch.Generator(device="cpu").manual_seed(m_len)
    dout = torch.randn(b, n, kv16.shape[-1], generator=g).to(dev).to(bf)
    dssq, dsumw = (torch.randn(b, n, generator=g).to(dev) for _ in range(2))
    o, l, m, ssq, sumw = fwd
    di = (o.float() * dout.float()).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    bwd_args = (*fk, seed, TRAIN_RATE, dout, l, m, di, dssq, dsumw)
    grads = coattn.coattn_bwd_fused_k(*bwd_args)
    ref = coattn.coattn_bwd_fused_k_plain(*fk, seed, TRAIN_RATE, dout, dssq, dsumw)
    for what, a, r in zip(("dq", "dkv", "dwk", "dbk"), grads, ref):
        if what == "dq":  # a one-key bag's dq: noise on both sides (its terms cancel)
            a, r = a[~one], r[~one]
        note("coattn_bwd_fused_k_bf16", check_bf16(f"bwd_bf16.{what}", a, r, "grad"))
    if not all(torch.equal(a, b) for a, b in zip(grads, coattn.coattn_bwd_fused_k(*bwd_args))):
        raise AssertionError("bwd_bf16: two runs differ")
    has = mask.any(-1)
    if not bool((grads[1][has][~mask[has]] == 0).all()):
        raise AssertionError("bwd_bf16: dkv is not exactly 0 at a masked key")
    log("  fused_k_bf16, fused_k_train_bf16, bwd_bf16: two runs bitwise equal; dkv exactly "
        "0 at the masked keys of bags with a valid key")
    return dout, dssq, dsumw, seed


BF16_QUERY_CASES = ((4000, "holes"), (1500, "one"))  # masks of the N = 1 and N = 8 checks


def bf16_fuse_k_query_checks(dev, e, tag, note) -> None:
    """:func:`bf16_fuse_k_case` at E = F = ``e`` and 1 and 8 queries, the
    ends of the wgmma kernels' padding of the queries to 8, on masked tiles
    mid-bag and a one-key bag (BF16_QUERY_CASES)."""
    import torch

    for n in (1, 8):
        for m_len, kind in BF16_QUERY_CASES:
            log(f"{tag}: bfloat16 fuse-K B={B} N={n} E=F={e} M={m_len}, {kind} masks")
            _, kv, wk, bk, _, mask = make_inputs(m_len, e, 2700 + m_len + n, dev, e, kind,
                                                 with_k=False)
            g = torch.Generator(device="cpu").manual_seed(2800 + m_len + n)
            q = (0.7 * torch.randn(B, n, e, generator=g)).to(dev)
            bf16_fuse_k_case(tuple(t.to(torch.bfloat16) for t in (q, kv, wk, bk)) + (mask,),
                             m_len, note)


def fuse_k_row_calls(fk16, fk32, seed, dout, dssq, dsumw) -> dict:
    """{name: (bfloat16 kernel, its float32 row, its plain version)} of the
    three bfloat16 fuse-K rows on (q, kv, wk, bk, mask) in bfloat16
    (``fk16``) and float32 (``fk32``): the backward's l, m and di from each
    type's training forward, di from its o as FusedKTrain forms it."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    o, l, m, ssq, sumw = coattn.coattn_fwd_fused_k_train(*fk16, seed, TRAIN_RATE)
    di = (o.float() * dout.float()).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    f32 = coattn.coattn_fwd_fused_k_train(*fk32, seed, TRAIN_RATE)
    di32 = (f32[0] * dout.float()).sum(-1) + 2.0 * dssq * f32[3] + dsumw * f32[4]
    dout32 = dout.to(torch.float32)
    return {
        "coattn_fwd_fused_k_bf16": (
            lambda: coattn.coattn_fwd_fused_k(*fk16), lambda: coattn.coattn_fwd_fused_k(*fk32),
            lambda: coattn.coattn_fwd_fused_k_plain(*fk16)),
        "coattn_fwd_fused_k_train_bf16": (
            lambda: coattn.coattn_fwd_fused_k_train(*fk16, seed, TRAIN_RATE),
            lambda: coattn.coattn_fwd_fused_k_train(*fk32, seed, TRAIN_RATE),
            lambda: coattn.coattn_fwd_fused_k_train_plain(*fk16, seed, TRAIN_RATE)),
        "coattn_bwd_fused_k_bf16": (
            lambda: coattn.coattn_bwd_fused_k(*fk16, seed, TRAIN_RATE, dout, l, m, di, dssq,
                                              dsumw),
            lambda: coattn.coattn_bwd_fused_k(*fk32, seed, TRAIN_RATE, dout32, f32[1], f32[2],
                                              di32, dssq, dsumw),
            lambda: coattn.coattn_bwd_fused_k_plain(*fk16, seed, TRAIN_RATE, dout, dssq, dsumw)),
    }


def bf16_kernel_checks(dev, e, tag) -> tuple:
    """The bfloat16 instances at E = F = D = ``e`` against their plain
    versions at B=32, N=6 on phase 1's and 4's masks (BF16_CASES), two runs
    bitwise equal, exactly 0 through masked keys; the fuse-K instances also
    at N = 1 and 8 (:func:`bf16_fuse_k_query_checks`); then each timed beside
    its float32 row, its plain version and its bound. Returns (errors, rows
    without their launches), keyed and named by :func:`bf16_row`."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    bf = torch.bfloat16
    errs = {bf16_row(name, e): 0.0 for name in BF16_KERNELS}

    def note(name, err):
        errs[bf16_row(name, e)] = max(errs[bf16_row(name, e)], err)

    timing = None
    for m_len, kind in BF16_CASES:
        log(f"{tag}: bfloat16 instances B={B} N={N} E=F=D={e} M={m_len}, {kind} masks")
        q, kv, wk, bk, k, mask = make_inputs(m_len, e, 2400 + m_len, dev, e, kind)
        q16, kv16, wk16, bk16, k16 = (t.to(bf) for t in (q, kv, wk, bk, k))
        fk = (q16, kv16, wk16, bk16, mask)
        dout, dssq, dsumw, seed = bf16_fuse_k_case(fk, m_len, note)
        has = mask.any(-1)
        for pre_gate in (True, False):
            lk, mk = coattn.coattn_stats(q16, k16, mask, pre_gate=pre_gate)
            lp, mp = coattn.coattn_stats_plain(q16, k16, mask, pre_gate=pre_gate)
            note("coattn_stats_bf16", check_bf16(f"stats_bf16 pg={pre_gate}.l", lk, lp, "l"))
            note("coattn_stats_bf16", check_bf16(f"stats_bf16 pg={pre_gate}.m", mk, mp, "abs"))
            w = coattn.coattention_weights(q16, k16, mask, pre_gate=pre_gate)
            wp = coattn.coattn_weights_plain(q16, k16, mask, lp, mp, pre_gate=pre_gate)
            note("coattn_weights_bf16", check_bf16(f"weights_bf16 pg={pre_gate}.w", w, wp, "w"))
            if not torch.equal(w, coattn.coattention_weights(q16, k16, mask, pre_gate=pre_gate)):
                raise AssertionError("weights_bf16: two runs differ")
            masked = (~mask & has[:, None])[:, None, :].expand_as(w)
            if not (bool((w[masked] == 0).all()) and bool((w[~has] == 1.0 / m_len).all())):
                raise AssertionError("weights_bf16: masked keys not exactly 0 (or 1/M)")
            if not (bool((mk[~has] == mp[~has]).all()) and bool((lk[~has] == m_len).all())):
                raise AssertionError("stats_bf16: the filler bag is not at l = M, m = NEG")
        log("  stats_bf16, weights_bf16: two runs bitwise equal; w exactly 0 at the masked keys "
            "of bags with a valid key; the bag without one at l = M, m = NEG, w = 1/M")
        if kind == "prefix":
            timing = (q, kv, wk, bk, k, mask, q16, kv16, wk16, bk16, k16, seed, dout, dssq,
                      dsumw)
    bf16_fuse_k_query_checks(dev, e, tag, note)
    power = gpu_name_and_power()
    q, kv, wk, bk, k, mask, q16, kv16, wk16, bk16, k16, seed, dout, dssq, dsumw = timing
    l32, m32 = coattn.coattn_stats_plain(q, k, mask)
    l16, m16 = coattn.coattn_stats_plain(q16, k16, mask)
    calls = {  # (bf16 kernel, its float32 row, its plain version)
        **fuse_k_row_calls((q16, kv16, wk16, bk16, mask), (q, kv, wk, bk, mask), seed, dout,
                           dssq, dsumw),
        "coattn_stats_bf16": (
            lambda: coattn.coattn_stats(q16, k16, mask), lambda: coattn.coattn_stats(q, k, mask),
            lambda: coattn.coattn_stats_plain(q16, k16, mask)),
        "coattn_weights_bf16": (
            lambda: coattn.coattn_weights(q16, k16, mask, l16, m16),
            lambda: coattn.coattn_weights(q, k, mask, l32, m32),
            lambda: coattn.coattn_weights_plain(q16, k16, mask, l16, m16)),
    }
    rows = []
    for name, (kern, row32, plain) in calls.items():
        ms, ms32, plain_ms = cuda_ms(kern), cuda_ms(row32), cuda_ms(plain)
        bms, by = bf16_bound_ms(name, mask, e)
        row = bf16_row(name, e)
        log(f"{tag}: {row} B={B} N={N} M={TRAIN_M} E=F=D={e}: kernel {ms:.4f} ms, its float32 "
            f"row {ms32:.4f} ms ({ms32 / ms:.2f}x), plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}; {bms / ms:.3f} of it reached{design_note(name, mask, e, e, ms)}) ({power})")
        rows.append({
            "name": row, "route": "cuda", "source": SOURCES[row], "replaces": REPLACES[row],
            "launches": 0, "max_abs_err": errs[row], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
    return errs, rows


def phase24_precision(dev) -> dict:
    """(b)-(d): the Trainer in bfloat16 from an int8 store and the other
    reduced-precision settings on phase 21's cohort and configuration, each
    graphed and eager; the card against the CPU; the one bfloat16 shape
    without an instance refused (GE runs: phase 25; NaCAGaT big: phase 26;
    ``lean=False``: phase 27). Returns the launches of (b)."""
    import shutil
    import tempfile

    import torch
    import yaml

    from multimodal_path_omic_tpu_torch.config import config_to_dict
    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.ops import coattn, kernels
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    root = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    total = {}
    try:
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **TRAINER_COHORT)
        runs = {}
        for what, settings, want_train, want_val in BF16_RUNS:
            log(f"phase 24 (b): {what}: examples/nacagat.yaml + {TRAINER_SET} + {settings}")
            for graphs in (True, False):
                cfg = trainer_config("nacagat.yaml", paths,
                                     os.path.join(root, f"{len(runs)}"), {**TRAINER_SET,
                                                                         **settings})
                before = read_counts()
                run = _trainer_run("b", f"{what}, {'graphed' if graphs else 'eager'}", cfg,
                                   graphs, power)
                for k, v in _counts_delta(before, read_counts()).items():
                    total[k] = total.get(k, 0) + v
                cached = settings["tpu.device_cache"] == "on"
                want = tuple({**{k: v * n for k, v in w.items()},
                              **({"gather_rows": n} if cached else {})}
                             for w, n in ((want_train, run["steps"]),
                                          (want_val, run["val_batches"])))
                if (run["train_launches"], run["val_launches"]) != want:
                    raise AssertionError(f"{what}: epoch 2 launches {run['train_launches']}, "
                                         f"{run['val_launches']}, expected {want}")
                runs[(what, graphs)] = run
            _same_epochs(f"{what}: eager vs graphed", runs[(what, False)], runs[(what, True)])
            g, e = runs[(what, True)], runs[(what, False)]
            log(f"  {what}: graphed == eager, bit for bit (both epochs' losses and risks); "
                f"epoch 2's {g['steps']} steps graphed {g['train_s']:.3f} s vs eager "
                f"{e['train_s']:.3f} s ({e['train_s'] / g['train_s']:.2f}x)")
        for a, b in (("int8 transfer, bf16 compute", "int8 store, bf16 compute"),
                     ("bf16 transfer, f32 compute", "bf16 store, f32 compute")):
            _same_epochs(f"{a} vs {b}", runs[(a, True)], runs[(b, True)])
            log(f"  {a} == {b}, bit for bit: host-fed and cached, both epochs")
        mm, deq = runs[("int8 store, bf16 compute, int8_matmul", True)], \
            runs[("int8 store, bf16 compute", True)]
        gaps = [abs(x[0] - y[0]) for x, y in zip(mm["epochs"], deq["epochs"])]
        if not all(math.isfinite(x[0]) for x in mm["epochs"]) or max(gaps) > 0.05:
            raise AssertionError(f"int8_matmul: train losses {gaps} from the dequant run")
        log(f"  int8_matmul: train losses {[x[0] for x in mm['epochs']]} against the dequant "
            f"run's {[x[0] for x in deq['epochs']]} (within 0.05, the JAX package's bar)")
        for what in ("int8 store, bf16 compute", "bf16 store, f32 compute"):
            run = runs[(what, True)]
            got, f32_bytes = run["cache_bytes"]
            log(f"  {what}: the cache holds {got / 2**20:.1f} MiB of bags (int8: with their row "
                f"scales) against float32's {f32_bytes / 2**20:.1f} MiB ({got / f32_bytes:.3f}); peak "
                f"device memory {run['peak_gib']:.2f} GiB graphed ({power})")

        log("phase 24 (b): `cli train` (the entry point a user runs) with --set "
            "tpu.compute_dtype=bfloat16, tpu.cache_dtype=int8, tpu.device_cache=on, one epoch")
        cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, "cli"),
                             {**TRAINER_SET, "training.epochs": 1})
        cfg_path = os.path.join(root, "nacagat_cli.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(config_to_dict(cfg), f)
        before = read_counts()
        out = cli_run(["train", "--config", cfg_path, "--set", "tpu.compute_dtype=bfloat16",
                       "--set", "tpu.cache_dtype=int8", "--set", "tpu.device_cache=on"])
        launched = _counts_delta(before, read_counts())
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        got = printed_metrics(out)["train_loss"]
        ref = runs[("int8 store, bf16 compute", True)]["epochs"][0][0]
        log(f"  cli train: train_loss {got} (printed), the Trainer run's epoch 1 {ref!r}; "
            f"launches {launched}")
        if abs(got - ref) > 5e-7 or not set(BF16_TRAIN_K) | set(BF16_VAL_K) <= set(launched):
            raise AssertionError("cli train in bf16 from the int8 store: not the Trainer's run")

        log("phase 24 (c): bf16 compute from the int8 store, one epoch on the card and on the "
            f"CPU, dropout 0 on both, training seeds {BF16_CPU_SEEDS}; a float32-compute control "
            "on the card")
        for seed in BF16_CPU_SEEDS:
            ends = {}
            for tag, where, extra in (("bf16 card", "cuda", {}), ("bf16 CPU", "cpu", {}),
                                      ("f32 card", "cuda", {"tpu.compute_dtype": "float32"})):
                cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, f"c{seed}{tag[:4]}{where}"),
                                     {**TRAINER_SET, **BF16_RUNS[0][1], "training.epochs": 1,
                                      "model.dropout": 0.0, "training.seed": seed, **extra})
                trainer = Trainer(cfg, verbose=False, device=where)
                t0 = time.perf_counter()
                train, val = trainer.validated_epoch(0)
                ends[tag] = (train["train_loss"], val["val_loss"], trainer.val_risks.copy())
                log(f"  seed {seed}, {tag}: epoch 1 in {time.perf_counter() - t0:.2f} s, "
                    f"train_loss {train['train_loss']!r}, val_loss {val['val_loss']!r}, "
                    f"val_c_index {val['val_c_index']:.4f}")
                del trainer
            ref = ends["bf16 CPU"]
            for tag in ("bf16 card", "f32 card"):
                got = ends[tag]
                read = (abs(got[0] - ref[0]) / abs(ref[0]), abs(got[1] - ref[1]) / abs(ref[1]),
                        float(np.abs(got[2] - ref[2]).max()))
                log(f"  seed {seed}, {tag} vs bf16 CPU: train_loss relative {read[0]:.3e}, "
                    f"val_loss relative {read[1]:.3e}, val risks max_abs_err {read[2]:.3e}"
                    + (f" (limits {BF16_CPU_TRAIN_RTOL:g}, {BF16_CPU_VAL_RTOL:g}, "
                       f"{BF16_CPU_ATOL:g})" if tag == "bf16 card" else " (the control)"))
                if tag == "bf16 card" and not (read[0] <= BF16_CPU_TRAIN_RTOL
                                               and read[1] <= BF16_CPU_VAL_RTOL
                                               and read[2] <= BF16_CPU_ATOL):
                    raise AssertionError(f"seed {seed}: the bf16 card run disagrees with the CPU")
            gap = float(np.abs(ends["bf16 card"][2] - ends["f32 card"][2]).max())
            log(f"  seed {seed}: bf16 card vs its float32 control: val risks max_abs_err {gap:.3e}")
            if ends["bf16 card"][:2] == ends["f32 card"][:2] or gap == 0.0:
                raise AssertionError(f"seed {seed}: the bf16 card run equals float32 compute")

        log("phase 24 (d): the one bfloat16 shape still without an instance, the eval fuse-K "
            "form at E = 512, F = 256 (no shipped configuration reaches it), on the card")
        g = torch.Generator().manual_seed(24)
        bf = torch.bfloat16
        q = torch.randn(2, N, 512, generator=g).to(dev).to(bf)
        kv = torch.randn(2, 1500, 256, generator=g).to(dev).to(bf)
        wk = (torch.randn(256, 512, generator=g) / 16).to(dev).to(bf)
        bk = torch.zeros(512, device=dev, dtype=bf)
        before = read_counts()
        try:
            kernels.takes("fuse-K", coattn.fused_k_supports, dev, N, 512, 256, 1500,
                          train=False, dtype=bf)
        except NotImplementedError as exc:
            if "queue 2 item 5" not in str(exc):
                raise AssertionError(f"bf16 E=512 F=256: refused without naming its item: {exc}")
            log(f"  kernels.takes refuses it: NotImplementedError: {exc}")
        else:
            raise AssertionError("bf16 eval fuse-K at E=512, F=256 was not refused on the card")
        try:
            coattn.coattn_fwd_fused_k(q, kv, wk, bk, torch.ones(2, 1500, dtype=torch.bool,
                                                                 device=dev))
        except ValueError as exc:
            log(f"  the wrapper refuses it: ValueError: {exc}")
        else:
            raise AssertionError("the bf16 fuse-K wrapper took E=512, F=256")
        if _counts_delta(before, read_counts()):
            raise AssertionError("bf16 E=512 F=256: a kernel launched before the refusal")
        log("  refused before any launch")
        del q, kv, wk, bk
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s of wall time, launches "
        f"{ {k: v for k, v in total.items() if v} } ({power})")
    return total


# Phase 25: GE-NaCAGaT under bfloat16, on the flash kernels' bfloat16
# instances. Each instance against its plain version on the card, both
# computing in float32 from the bfloat16 values with the TPU kernel's
# roundings (p rounded against the running maximum of the same key tiles,
# ds * scale rounded). The scores' float32 sums take other orders in the two
# versions, so now and then a p lies on the other side of a bfloat16
# rounding in one of them, which moves an output by 2^-8 of that key's term
# w_j |v_j|: where the terms of o = sum_j w_j v_j cancel, that is many units
# of o's own last place. So o (bfloat16) is held within one unit
# (BF16_O_RTOL) of the magnitude of its terms, sum_j w_j |v_j| (the same
# attention over |v|); where nothing cancels that is one unit of o. The log
# also counts the elements outside the co-attention instances' per-element
# form (KERNEL_ATOL + BF16_O_RTOL |o|). m and l (float32) within 1e-4
# relative (the products of bfloat16 operands are exact in float32; what
# differs is the sums' order; m also 1e-5 absolute, for a one-key row whose
# m sits near 0), dq, dk, dv within
# BF16_GRAD_RTOL of each one's largest magnitude. An indexing, masking or
# fragment-layout fault moves any of them by O(1).
FLASH_BF16_STAT_RTOL, FLASH_BF16_M_ATOL = 1e-4, 1e-5
BF16_FLASH = tuple(f"flash_{way}_d{w}_bf16" for way in ("fwd", "bwd")
                   for _, w, _ in FLASH_INSTANCES)
# (b): GE medium (examples/ge_nacagat.yaml on phase 21's GE cohort, two
# epochs) in bfloat16 from an int8 store, host-fed through int8 transfers,
# and the float32 run beside them; a training step's and a validation
# batch's launches under each
GE_BF16_RUNS = (
    ("int8 store, bf16 compute", {"tpu.device_cache": "on", "tpu.cache_dtype": "int8",
                                  "tpu.compute_dtype": "bfloat16"}),
    ("int8 transfer, bf16 compute", {"tpu.device_cache": "off", "tpu.transfer_dtype": "int8",
                                     "tpu.compute_dtype": "bfloat16"}),
    ("float32", {"tpu.device_cache": "on"}),
)
# (c): the card's bfloat16 GE against the CPU's, one epoch on phase 21's
# shorter-bag GE cohort at dropout 0, for each of GE_BF16_SEEDS, with a
# float32-compute control on the card. Limits: about twice the largest of
# the three seeds' readings (NVIDIA H100 80GB HBM3, 700.00 W: train loss
# 1.779e-4, val loss 8.949e-4 relative). cuBLAS and the CPU round each
# bfloat16 product at other places and two Adam steps carry that on; as in
# phase 24 (c) the float32 control lands as close (3.5e-5..8.0e-5,
# 3.4e-6..1.5e-3), so each seed's bfloat16 run is also held to differ from
# its control.
GE_BF16_SEEDS = (0, 1, 2)
GE_BF16_CPU_TRAIN_RTOL, GE_BF16_CPU_VAL_RTOL = 4e-4, 2e-3


def ge_widths(size) -> tuple:
    return tuple(w for _, w in GE_SIZE_HEADS[size])


def ge_bf16_launches(size, cached, float32=False) -> tuple:
    """(a training step's, a validation batch's) launches of GE ``size``:
    the first width once and the second in each of two layers; under
    bfloat16 the pool takes its eager branch (no kernel), in float32 its
    kernel in validation; one row gather each from the cache."""
    sfx = "" if float32 else "_bf16"
    w1, w2 = ge_widths(size)
    fwd = {f"flash_fwd_d{w1}{sfx}": 1, f"flash_fwd_d{w2}{sfx}": 2}
    train = {**fwd, f"flash_bwd_d{w1}{sfx}": 1, f"flash_bwd_d{w2}{sfx}": 2}
    val = {**fwd, **({"milpool": 1} if float32 else {})}
    gather = {"gather_rows": 1} if cached else {}
    return {**train, **gather}, {**val, **gather}


def flash_bf16_masks(m_len, dev):
    """Four bags of m_len keys: a ragged prefix, whole masked key tiles
    mid-bag, one valid key in a late tile, none valid."""
    import torch

    mask = torch.zeros(4, m_len, dtype=torch.bool)
    mask[0, :m_len * 2 // 3] = True
    mask[1, 5:60] = True
    mask[1, 700:790] = True
    mask[2, ONE_KEY] = True
    return mask.to(dev)


# (a)'s edge lengths at every width: one key; fewer keys than the smallest
# tile (32); a length no tile (32, 64, 128) or block of queries (64, 128,
# 192) divides
FLASH_EDGE_LENGTHS = (1, 20, 333)


def flash_edge_masks(m_len, dev):
    """Three bags of m_len keys: a ragged prefix of about two thirds, one
    valid key (the last, in the last tile), none valid."""
    import torch

    mask = torch.zeros(3, m_len, dtype=torch.bool)
    mask[0, :max(1, m_len * 2 // 3)] = True
    mask[1, m_len - 1] = True
    return mask.to(dev)


def bf16_flash_bound_ms(way, heads, mask, e) -> tuple:
    """(bound ms, 'bytes' | 'operations') of a bfloat16 flash instance at
    B=8, M=16384, heads * width = e: the products over the valid keys (a bag
    without one needs them all) at the bfloat16 tensor-core rate, two in the
    forward, five in the backward (s, dp, dv, dq, dk); bytes with q, k, v,
    out (and dout, dq, dk, dv) in bfloat16, m and l float32 and the mask
    read once."""
    import torch

    b, m = mask.shape
    n_valid = mask.sum(dim=1)
    keys = int(torch.where(n_valid == 0, m, n_valid).sum().item())
    if way == "fwd":
        nbytes, ops = 2 * 4 * b * m * e + b * m, 4 * m * keys * e
    else:
        nbytes, ops = 2 * 8 * b * m * e + 4 * 2 * b * heads * m + b * m, 10 * m * keys * e
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The exp unit: 16 exponentials a clock an SM (H100 SXM: 132 SMs, a
# 1,980 MHz boost clock)
EXP_PER_S = 16 * 132 * 1.98e9


def bf16_flash_exp_floor_ms(way, heads, mask) -> float:
    """The exp unit's floor of a bfloat16 flash instance: one exponential a
    score over the valid keys in the forward, one in each backward pass (the
    bound's key count)."""
    import torch

    b, m = mask.shape
    n_valid = mask.sum(dim=1)
    keys = int(torch.where(n_valid == 0, m, n_valid).sum().item())
    return heads * m * keys * (1 if way == "fwd" else 2) / EXP_PER_S * 1e3


def check_flash_o(name, got, ref, terms) -> float:
    """A bfloat16 flash instance's o against its plain version's: within
    one bfloat16 unit of ``terms`` (the plain attention over |v|). Logs the
    elements outside the per-element form. Returns the largest absolute
    error."""
    import torch

    got, ref, terms = got.float(), ref.float(), terms.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - ref).abs()
    excess = float((diff / (BF16_O_RTOL * terms).clamp_min(1e-30)).max())
    outside = diff > KERNEL_ATOL + BF16_O_RTOL * ref.abs()
    log(f"  {name}: max_abs_err={float(diff.max()):.3e}, worst element at {excess:.3f} of one "
        f"bfloat16 unit of its terms' magnitude; outside the per-element form "
        f"({KERNEL_ATOL:g} + {BF16_O_RTOL:g} |o|): {int(outside.sum())} of {diff.numel()} "
        f"{'ok' if excess <= 1.0 else 'FAIL'}")
    if excess > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(diff.max())


def check_flash_bf16(tag, q, k, v, mask, errs, width) -> None:
    """One bfloat16 flash case: the forward (with m, l) and the backward
    under a random bfloat16 cotangent against their plain versions, each
    twice bitwise equal, dq and dk exactly 0 through masked keys, a bag
    without a valid key at m = -1e9 and l = M exactly."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash
    from multimodal_path_omic_tpu_torch.ops.layers import NEG_INF

    b, heads, m_len, _ = q.shape
    chunk = plain_chunk(b, heads, m_len)
    fwd, bwd = f"flash_fwd_d{width}_bf16", f"flash_bwd_d{width}_bf16"
    out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
    again = flash.flash_fwd(q, k, v, mask, need_stats=True)
    if not all(torch.equal(x, y) for x, y in zip((out, m, l), again)):
        raise AssertionError(f"{tag}: two forward runs differ")
    ref_out, ref_m, ref_l = flash.flash_attention_plain(q, k, v, mask, chunk=chunk,
                                                       return_stats=True)
    terms = flash.flash_attention_plain(q, k, v.abs(), mask, chunk=chunk)
    errs[fwd] = max(errs[fwd],
                    check_flash_o(f"{fwd}.o", out, ref_out, terms),
                    check_close(f"{fwd}.m", m, ref_m, FLASH_BF16_M_ATOL, FLASH_BF16_STAT_RTOL),
                    check_close(f"{fwd}.l", l, ref_l, 0.0, FLASH_BF16_STAT_RTOL))
    none = ~mask.any(dim=1)
    if not (bool((m[none] == NEG_INF).all()) and bool((l[none] == m_len).all())):
        raise AssertionError(f"{tag}: a bag without a valid key must have m = -1e9, l = M")
    del ref_out, ref_m, ref_l, again, terms
    g = torch.Generator(device="cpu").manual_seed(m_len + width)
    dout = torch.randn(b, m_len, heads * width, generator=g).to(q.device).to(q.dtype)
    dout = dout.reshape(b, m_len, heads, width).transpose(1, 2)
    got = flash.flash_bwd(q, k, v, mask, out, m, l, dout)
    if not all(torch.equal(x, y) for x, y in zip(got, flash.flash_bwd(q, k, v, mask, out, m, l,
                                                                        dout))):
        raise AssertionError(f"{tag}: two backward runs differ")
    ref = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, dout, chunk=chunk)
    # a bag with one valid key (every bag at L = 1) has no score gradient:
    # p is 0 or 1 and dp = delta, so dq and dk there are float32 noise of dp
    # - delta in both versions, held to BF16_GRAD_RTOL of the terms that
    # cancel (scale |delta_i| |k| for a dq row, the sum over query rows i of
    # scale |delta_i| |q_i| for dk; the float32 tests' rule). Where no bag has
    # two valid keys nothing else sets dq's and dk's scale, and the rule
    # holds them alone; elsewhere the whole tensors are held as before too.
    one, multi = mask.sum(-1) == 1, bool((mask.sum(-1) > 1).any())
    scale = width ** -0.5
    delta = (dout.float() * out.float()).sum(-1).abs()  # [B, H, L]
    floors = (scale * delta.amax(-1) * k.float().abs().amax((-2, -1)),
              scale * (delta[..., None] * q.float().abs()).sum(-2).amax(-1), None)
    for gname, a, r, floor in zip(("dq", "dk", "dv"), got, ref, floors):
        a, r = a.float(), r.float()
        if floor is not None and bool(one.any()):
            limit = BF16_GRAD_RTOL * floor[one][..., None, None]
            worst = float(torch.maximum(a[one].abs(), r[one].abs()).div(limit).max())
            log(f"  {bwd}.{gname}: one-key bags at {worst:.3e} of {BF16_GRAD_RTOL:g} of the "
                f"terms that cancel {'ok' if worst <= 1.0 else 'FAIL'}")
            if worst > 1.0:
                raise AssertionError(f"{bwd}.{gname}: a one-key bag's score gradient")
            if not multi:
                a, r = a[~one], r[~one]
        if a.numel():
            errs[bwd] = max(errs[bwd], check_rel(f"{bwd}.{gname}", a, r, BF16_GRAD_RTOL))
    dq, dk, _ = got
    pad = ~mask[:, None, :, None].expand_as(dk)
    if float(dk[pad].float().abs().max()) != 0.0 or float(dq[none].float().abs().max()) != 0.0:
        raise AssertionError(f"{tag}: a masked key passed a gradient to q or k")
    log(f"  {tag}: two runs bitwise equal; dq, dk exactly 0 through masked keys; the bag "
        "without a valid key at m = -1e9, l = M")


def time_bf16_flash_row(dev, heads, width, e, way, iters=3, plain=False) -> dict:
    """One bfloat16 flash row at phase 25 (a)'s timing inputs (phases 9's
    and 12's, B=8, M=16384, in bfloat16): the kernel's ms (CUDA events, the
    mean of ``iters``), the bfloat16 ``scaled_dot_product_attention`` call's
    (forward; backward), the plain version's where ``plain``, the bound and
    the exp unit's floor."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash

    bf = torch.bfloat16
    chunk = plain_chunk(GE_B, heads, GE_M)
    seed = 13 if way == "fwd" else 17
    q, k, v, mask = ge_flash_inputs(GE_B, heads, GE_M, seed + heads, dev, e, bf)
    if way == "fwd":
        kern = lambda: flash.flash_fwd(q, k, v, mask)  # noqa: E731
        ref = lambda: flash.flash_attention_plain(q, k, v, mask, chunk=chunk)  # noqa: E731
        lib = lambda: sdpa_ms(q, k, v, mask)[0]  # noqa: E731
    else:
        out, m, l = flash.flash_fwd(q, k, v, mask, need_stats=True)
        g = torch.Generator(device="cpu").manual_seed(seed + heads + 1)
        dout = torch.randn(GE_B, GE_M, e, generator=g).to(dev).to(bf)
        dout = dout.reshape(GE_B, GE_M, heads, width).transpose(1, 2)
        kern = lambda: flash.flash_bwd(q, k, v, mask, out, m, l, dout)  # noqa: E731
        ref = lambda: flash.flash_attention_bwd_plain(  # noqa: E731
            q, k, v, mask, out, m, l, dout, chunk=chunk)
        lib = lambda: sdpa_bwd_ms(q, k, v, mask, dout)[0]  # noqa: E731
    row = {"ms": cuda_ms(kern, iters=iters, warmup=1),
           "plain_ms": cuda_ms(ref, iters=1, warmup=1) if plain else None,
           "library_ms": lib(), "chunk": chunk,
           "exp_floor_ms": bf16_flash_exp_floor_ms(way, heads, mask)}
    row["bound_ms"], row["bound_by"] = bf16_flash_bound_ms(way, heads, mask, e)
    del q, k, v, mask, kern, ref, lib
    torch.cuda.empty_cache()
    return row


def phase25_bf16_flash_kernels(dev, f32_rows) -> tuple:
    """(a): every bfloat16 flash instance against its plain version on the
    card (GE medium at the main path's B=8, M=16384 with phase 9's ragged
    masks; small and big at phase 17's B=4, M=4096; every width on four bags
    of 1500 keys: a ragged prefix, masked tiles mid-bag, one valid key,
    none), then each timed at B=8, M=16384 beside its float32 row (phases 9
    and 12, the same inputs in bfloat16), its plain version, its bound and the
    bfloat16 ``scaled_dot_product_attention`` call (forward; backward).
    Returns (errors, rows without their launches)."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import flash

    bf = torch.bfloat16
    errs = {name: 0.0 for name in BF16_FLASH}
    for heads, width, e in FLASH_INSTANCES:
        shape = (GE_B, GE_M) if e == GE_D else (GE_WIDE_B, GE_WIDE_M)
        log(f"phase 25 (a): flash bf16 H={heads} dh={width}: B={shape[0]} M={shape[1]}, ragged "
            "masks, the last bag without a valid key; q/k/v read in place")
        q, k, v, mask = ge_flash_inputs(*shape[:1], heads, shape[1], shape[1] + heads, dev, e, bf)
        check_flash_bf16(f"flash bf16 d{width} M={shape[1]}", q, k, v, mask, errs, width)
        log(f"phase 25 (a): flash bf16 H={heads} dh={width}: B=4 M=1500, a ragged bag, masked "
            f"tiles mid-bag, one valid key ({ONE_KEY}), none valid")
        q, k, v, _ = ge_flash_inputs(4, heads, 1500, width + 25, dev, e, bf)
        check_flash_bf16(f"flash bf16 d{width} M=1500", q, k, v, flash_bf16_masks(1500, dev),
                         errs, width)
        for m_len in FLASH_EDGE_LENGTHS:
            log(f"phase 25 (a): flash bf16 H={heads} dh={width}: B=3 M={m_len} (key tile "
                f"{flash.KEY_TILE[width]}), a ragged bag, one valid key (the last), none valid")
            q, k, v, _ = ge_flash_inputs(3, heads, m_len, m_len + width, dev, e, bf)
            check_flash_bf16(f"flash bf16 d{width} M={m_len}", q, k, v,
                             flash_edge_masks(m_len, dev), errs, width)
        del q, k, v, mask
    torch.cuda.synchronize()
    power = gpu_name_and_power()
    rows = []
    for heads, width, e in FLASH_INSTANCES:  # at the medium path's B and M
        for way in ("fwd", "bwd"):
            name = f"flash_{way}_d{width}_bf16"
            t = time_bf16_flash_row(dev, heads, width, e, way, plain=True)
            ms, bms = t["ms"], t["bound_ms"]
            ms32 = f32_rows.get(f"flash_{way}_d{width}")
            log(f"phase 25 (a): {name} B={GE_B} H={heads} dh={width} M={GE_M}: kernel "
                f"{ms:.4f} ms, its float32 row {ms32:.4f} ms ({ms32 / ms:.2f}x), plain "
                f"{t['plain_ms']:.4f} ms (chunks of {t['chunk']} rows), bf16 "
                f"scaled_dot_product_attention{' backward' if way == 'bwd' else ''} "
                f"{t['library_ms']:.4f} ms, bound {bms:.4f} ms ({t['bound_by']}, bf16 products "
                f"over the valid keys; {bms / ms:.3f} of it reached); the exp unit's floor "
                f"{t['exp_floor_ms']:.4f} ms ({power})")
            rows.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": 0, "max_abs_err": errs[name], "ms": ms,
                "plain_ms": t["plain_ms"], "bound_ms": bms, "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
            })
    return errs, rows


def ge_bf16_serving(dev, power, calls=3) -> dict:
    """(b)'s serving rate: a bf16 GE medium Predictor (seed-0 weights, the
    serving buckets and batch) on phase 8's 12 bags, ``calls`` timed
    ``predict_bags`` calls after a warm one (host clock to a device sync),
    each call on the two widths' bf16 forward instances only. Returns the
    launches."""
    import torch

    from multimodal_path_omic_tpu_torch.serve import Predictor

    pred = Predictor("GE-NaCAGaT", model_size="medium", buckets=GE_BUCKETS, batch_size=GE_B,
                     seed=0, device=dev, dtype=torch.bfloat16)
    bags = make_ge_bags(0)
    pred.predict_bags(bags)
    torch.cuda.synchronize()
    before = read_counts()
    rates = []
    for _ in range(calls):
        t0 = time.perf_counter()
        pred.predict_bags(bags)
        torch.cuda.synchronize()
        rates.append(len(bags) / (time.perf_counter() - t0))
    got = _counts_delta(before, read_counts())
    if set(got) != {f"flash_fwd_d{w}_bf16" for w in ge_widths("medium")}:
        raise AssertionError(f"GE bf16 serving: launches {got}")
    log(f"  (b) GE medium bf16 predict_bags, {len(bags)} bags of 5000-16384 patches, "
        f"{calls} calls: {', '.join(f'{r:.2f}' for r in rates)} bags/s; launches {got} "
        f"({power})")
    return got


def phase25_ge_bf16(dev) -> dict:
    """(b)-(d): GE-NaCAGaT under bfloat16 through the Trainer (medium from an
    int8 store, cached and host-fed, graphed and eager, beside float32), the
    card against the CPU, and GE small and big (a Trainer epoch and a
    Predictor call each). Returns the launches of (b) and (d)."""
    import shutil
    import tempfile

    import torch

    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    root = tempfile.mkdtemp(prefix="chip_smoke_ge_bf16_")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    try:
        paths = make_synthetic_cohort(os.path.join(root, "ge"), **GE_TRAINER_COHORT)
        short = make_synthetic_cohort(os.path.join(root, "ge_short"), **GE_CPU_COHORT)
        runs = {}
        for what, settings in GE_BF16_RUNS:
            log(f"phase 25 (b): GE medium, {what}: examples/ge_nacagat.yaml + {GE_TRAINER_SET} "
                f"+ {settings}, two epochs")
            for graphs in (True, False):
                cfg = trainer_config("ge_nacagat.yaml", paths, os.path.join(root, f"b{len(runs)}"),
                                     {**GE_TRAINER_SET, "training.epochs": 2, **settings})
                before = read_counts()
                run = _trainer_run("b", f"GE {what}, {'graphed' if graphs else 'eager'}", cfg,
                                   graphs, power)
                add(_counts_delta(before, read_counts()))
                per_step, per_val = ge_bf16_launches("medium", settings["tpu.device_cache"] == "on",
                                                     float32=what == "float32")
                want = ({k: v * run["steps"] for k, v in per_step.items()},
                        {k: v * run["val_batches"] for k, v in per_val.items()})
                if (run["train_launches"], run["val_launches"]) != want:
                    raise AssertionError(f"GE {what}: epoch 2 launches {run['train_launches']}, "
                                         f"{run['val_launches']}, expected {want}")
                runs[(what, graphs)] = run
            _same_epochs(f"GE {what}: eager vs graphed", runs[(what, False)], runs[(what, True)])
            log(f"  GE {what}: graphed == eager, bit for bit (both epochs' losses)")
        _same_epochs("GE int8 transfer vs int8 store", runs[("int8 transfer, bf16 compute", True)],
                     runs[("int8 store, bf16 compute", True)])
        log("  GE int8 transfer, bf16 compute == int8 store, bf16 compute, bit for bit")
        f32 = runs[("float32", True)]
        for what in ("int8 store, bf16 compute", "int8 transfer, bf16 compute"):
            run = runs[(what, True)]
            log(f"  GE {what}, graphed, epoch 2: {run['n_train'] / run['train_s']:.2f} train "
                f"bags/s, {run['n_val'] / run['val_s']:.2f} val bags/s; float32 cached graphed "
                f"{f32['n_train'] / f32['train_s']:.2f} and {f32['n_val'] / f32['val_s']:.2f} "
                f"({f32['train_s'] / run['train_s']:.2f}x, {f32['val_s'] / run['val_s']:.2f}x); "
                f"peak device memory {run['peak_gib']:.2f} GiB against {f32['peak_gib']:.2f} GiB "
                f"({power})")
        if runs[("int8 store, bf16 compute", True)]["epochs"][0][0] == f32["epochs"][0][0]:
            raise AssertionError("GE: the bf16 run's train loss equals float32's")
        add(ge_bf16_serving(dev, power))

        log("phase 25 (c): GE medium in bf16 from the int8 store, one epoch on the card and on "
            f"the CPU, dropout 0 on both, on {GE_CPU_COHORT} + {GE_CPU_SET}, training seeds "
            f"{GE_BF16_SEEDS}; a float32-compute control on the card")
        for seed in GE_BF16_SEEDS:
            ends = {}
            for tag, where, extra in (("bf16 card", "cuda", {}), ("bf16 CPU", "cpu", {}),
                                      ("f32 card", "cuda", {"tpu.compute_dtype": "float32"})):
                cfg = trainer_config("ge_nacagat.yaml", short,
                                     os.path.join(root, f"c{seed}{tag[:4]}{where}"),
                                     {**GE_CPU_SET, **GE_BF16_RUNS[0][1], "training.epochs": 1,
                                      "model.dropout": 0.0, "training.seed": seed, **extra})
                trainer = Trainer(cfg, verbose=False, device=where)
                before = read_counts()
                t0 = time.perf_counter()
                train, val = trainer.validated_epoch(0)
                if where == "cuda":
                    add(_counts_delta(before, read_counts()))
                ends[tag] = (train["train_loss"], val["val_loss"], val["val_accuracy"])
                log(f"  seed {seed}, {tag}: epoch 1 in {time.perf_counter() - t0:.2f} s, "
                    f"train_loss {train['train_loss']!r}, val_loss {val['val_loss']!r}, "
                    f"val_accuracy {val['val_accuracy']:.4f}")
                del trainer
            ref = ends["bf16 CPU"]
            for tag in ("bf16 card", "f32 card"):
                got = ends[tag]
                read = (abs(got[0] - ref[0]) / abs(ref[0]), abs(got[1] - ref[1]) / abs(ref[1]))
                log(f"  seed {seed}, {tag} vs bf16 CPU: train_loss relative {read[0]:.3e}, "
                    f"val_loss relative {read[1]:.3e}, val_accuracy {got[2]:.4f} vs {ref[2]:.4f}"
                    + (f" (limits {GE_BF16_CPU_TRAIN_RTOL:g}, {GE_BF16_CPU_VAL_RTOL:g})"
                       if tag == "bf16 card" else " (the control)"))
                if tag == "bf16 card" and not (read[0] <= GE_BF16_CPU_TRAIN_RTOL
                                               and read[1] <= GE_BF16_CPU_VAL_RTOL):
                    raise AssertionError(f"seed {seed}: the GE bf16 card run disagrees with "
                                         "the CPU")
            if ends["bf16 card"][:2] == ends["f32 card"][:2]:
                raise AssertionError(f"seed {seed}: the GE bf16 card run equals float32 compute")

        for size in ("small", "big"):
            log(f"phase 25 (d): GE {size} in bf16 from the int8 store on {GE_CPU_COHORT}: one "
                "Trainer epoch, then Predictor.from_trainer().predict_bags on 6 bags")
            # dropout 0: below 4096 positions live attention dropout keeps
            # attention_core in training (ops/attention.py)
            cfg = trainer_config("ge_nacagat.yaml", short, os.path.join(root, f"d{size}"),
                                 {**GE_CPU_SET, **GE_BF16_RUNS[0][1], "model.model_size": size,
                                  "model.dropout": 0.0})
            trainer = Trainer(cfg, verbose=False)
            before = read_counts()
            train, val = trainer.validated_epoch(0)
            torch.cuda.synchronize()
            got = _counts_delta(before, read_counts())
            per_step, per_val = ge_bf16_launches(size, True)
            want = {k: per_step.get(k, 0) * trainer.last_epoch_steps
                    + per_val.get(k, 0) * len(trainer.val_batcher)
                    for k in set(per_step) | set(per_val)}
            add(got)
            if got != want or not (math.isfinite(train["train_loss"])
                                   and math.isfinite(val["val_loss"])):
                raise AssertionError(f"GE {size} bf16 epoch: launches {got}, expected {want}")
            pred = Predictor.from_trainer(trainer)
            rng = np.random.default_rng(25)
            bags = [rng.standard_normal((int(n), 1024), dtype=np.float32)
                    for n in rng.integers(600, 2049, size=6)]
            before = read_counts()
            y = pred.predict_bags(bags)["y"]
            torch.cuda.synchronize()
            got = _counts_delta(before, read_counts())
            add(got)
            w1, w2 = ge_widths(size)
            if not (set(got) == {f"flash_fwd_d{w1}_bf16", f"flash_fwd_d{w2}_bf16"}
                    and np.isfinite(y).all() and np.allclose(y.sum(-1), 1.0, atol=1e-5)):
                raise AssertionError(f"GE {size} bf16 Predictor: launches {got}, y {y}")
            before = read_counts()
            t0 = time.perf_counter()
            pred.predict_bags(bags)
            torch.cuda.synchronize()
            rate = len(bags) / (time.perf_counter() - t0)
            add(_counts_delta(before, read_counts()))
            log(f"  GE {size}: epoch train_loss {train['train_loss']:.6f}, val_loss "
                f"{val['val_loss']:.6f}, launches as planned; predict_bags launches {got}, y "
                f"finite, rows summing to 1; a second call {rate:.2f} bags/s ({power})")
            del trainer, pred
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s of wall time, launches "
        f"{ {k: v for k, v in total.items() if v} } ({power})")
    return total


# Phase 26: NaCAGaT big (E = F = D = 512) under bfloat16 compute, on the
# E = F = 512 bfloat16 instances of the fuse-K forward (both forms) and
# backward and the D = 512 instances of the export passes, held at phase
# 24's bars. (b): examples/nacagat.yaml at model_size big on phase 21's
# cohort and settings, two epochs: bf16 compute from an int8 store cached
# (graphed and eager), host-fed through int8 transfers, with ces validation
# (the eval form), and float32 cached beside them; (tag, settings over
# BIG_SET, a training step's and a validation batch's kernels, graphed and
# eager or graphed only).
BIG_SET = {**TRAINER_SET, "model.model_size": "big"}
BIG_BF16_RUNS = (
    ("int8 store, bf16 compute", BF16_RUNS[0][1], BF16_TRAIN_K, BF16_VAL_K, (True, False)),
    ("int8 transfer, bf16 compute", BF16_RUNS[1][1], BF16_TRAIN_K, BF16_VAL_K, (True,)),
    ("int8 store, bf16 compute, ces", BF16_RUNS[2][1], BF16_TRAIN_K,
     {"coattn_fwd_fused_k_bf16": 1}, (True,)),
    ("float32", {"tpu.device_cache": "on"}, F32_TRAIN_K, F32_VAL_K, (True,)),
)
# (c): the card's bfloat16 big Trainer against the port on the CPU, one epoch
# at dropout 0 from the int8 store, for each of BIG_BF16_SEEDS, on a cohort
# of shorter bags (BIG_CPU_COHORT: phase 21's 48 patients, 600..2000 patches,
# buckets 1024/2048) so that the CPU's epoch of the big model fits the
# smoke's time (6-8 s there); a float32-compute control on the card beside
# each. Limits as phase 24 (c)'s, about twice the largest reading of the two
# seeds (NVIDIA H100 80GB HBM3, 700.00 W: train loss 3.160e-4 and val loss
# 8.369e-4 relative, risks 6.506e-3), for the reasons given there; the
# float32 control lands as close (2.9e-4, 8.2e-4, 4.0e-3), so each seed's
# bfloat16 run is also held to differ from it.
BIG_CPU_COHORT = {**TRAINER_COHORT, "bag_lengths": (600, 1000, 1500, 2000), "seed": 3}
BIG_CPU_SET = {**BIG_SET, "tpu.bag_buckets": [1024, 2048]}
BIG_BF16_SEEDS = (0, 1)
BIG_BF16_CPU_TRAIN_RTOL, BIG_BF16_CPU_VAL_RTOL, BIG_BF16_CPU_ATOL = 7e-4, 1.7e-3, 1.3e-2


def phase26_big_bf16(dev) -> dict:
    """(b)-(c): NaCAGaT big under bfloat16 through the Trainer (from an int8
    store cached, graphed and eager; host-fed through int8 transfers; ces;
    beside float32), then the card against the CPU. Returns every launch of
    (b) and of (c)'s card runs."""
    import shutil
    import tempfile

    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    root = tempfile.mkdtemp(prefix="chip_smoke_big_bf16_")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    try:
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **TRAINER_COHORT)
        runs = {}
        for what, settings, want_train, want_val, modes in BIG_BF16_RUNS:
            log(f"phase 26 (b): NaCAGaT big, {what}: examples/nacagat.yaml + {BIG_SET} + "
                f"{settings}, two epochs")
            for graphs in modes:
                cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, f"b{len(runs)}"),
                                     {**BIG_SET, **settings})
                before = read_counts()
                run = _trainer_run("b", f"big, {what}, {'graphed' if graphs else 'eager'}", cfg,
                                   graphs, power)
                add(_counts_delta(before, read_counts()))
                cached = settings["tpu.device_cache"] == "on"
                want = tuple({**{k: v * n for k, v in w.items()},
                              **({"gather_rows": n} if cached else {})}
                             for w, n in ((want_train, run["steps"]),
                                          (want_val, run["val_batches"])))
                if (run["train_launches"], run["val_launches"]) != want:
                    raise AssertionError(f"big {what}: epoch 2 launches {run['train_launches']}, "
                                         f"{run['val_launches']}, expected {want}")
                runs[(what, graphs)] = run
        _same_epochs("big bf16: eager vs graphed", runs[(BIG_BF16_RUNS[0][0], False)],
                     runs[(BIG_BF16_RUNS[0][0], True)])
        log("  big, int8 store, bf16 compute: graphed == eager, bit for bit (both epochs' "
            "losses and risks)")
        _same_epochs("big int8 transfer vs int8 store", runs[("int8 transfer, bf16 compute", True)],
                     runs[("int8 store, bf16 compute", True)])
        log("  big, int8 transfer == int8 store (bf16 compute), bit for bit: host-fed and cached")
        f32 = runs[("float32", True)]
        for what, _, _, _, _ in BIG_BF16_RUNS[:3]:
            run = runs[(what, True)]
            log(f"  big, {what}, graphed, epoch 2: {run['n_train'] / run['train_s']:.2f} train "
                f"bags/s, {run['n_val'] / run['val_s']:.2f} val bags/s; float32 cached graphed "
                f"{f32['n_train'] / f32['train_s']:.2f} and {f32['n_val'] / f32['val_s']:.2f} "
                f"({f32['train_s'] / run['train_s']:.2f}x, {f32['val_s'] / run['val_s']:.2f}x); "
                f"peak device memory {run['peak_gib']:.2f} GiB against {f32['peak_gib']:.2f} GiB "
                f"({power})")
        if runs[("int8 store, bf16 compute", True)]["epochs"][0][0] == f32["epochs"][0][0]:
            raise AssertionError("big: the bf16 run's train loss equals float32's")

        short = make_synthetic_cohort(os.path.join(root, "short"), **BIG_CPU_COHORT)
        log("phase 26 (c): NaCAGaT big in bf16 from the int8 store, one epoch on the card and "
            f"on the CPU, dropout 0 on both, on {BIG_CPU_COHORT} + {BIG_CPU_SET}, training "
            f"seeds {BIG_BF16_SEEDS}; a float32-compute control on the card")
        for seed in BIG_BF16_SEEDS:
            ends = {}
            for tag, where, extra in (("bf16 card", "cuda", {}), ("bf16 CPU", "cpu", {}),
                                      ("f32 card", "cuda", {"tpu.compute_dtype": "float32"})):
                cfg = trainer_config("nacagat.yaml", short,
                                     os.path.join(root, f"c{seed}{tag[:4]}{where}"),
                                     {**BIG_CPU_SET, **BF16_RUNS[0][1], "training.epochs": 1,
                                      "model.dropout": 0.0, "training.seed": seed, **extra})
                trainer = Trainer(cfg, verbose=False, device=where)
                before = read_counts()
                t0 = time.perf_counter()
                train, val = trainer.validated_epoch(0)
                if where == "cuda":
                    add(_counts_delta(before, read_counts()))
                ends[tag] = (train["train_loss"], val["val_loss"], trainer.val_risks.copy())
                log(f"  seed {seed}, {tag}: epoch 1 in {time.perf_counter() - t0:.2f} s, "
                    f"train_loss {train['train_loss']!r}, val_loss {val['val_loss']!r}, "
                    f"val_c_index {val['val_c_index']:.4f}")
                del trainer
            ref = ends["bf16 CPU"]
            for tag in ("bf16 card", "f32 card"):
                got = ends[tag]
                read = (abs(got[0] - ref[0]) / abs(ref[0]), abs(got[1] - ref[1]) / abs(ref[1]),
                        float(np.abs(got[2] - ref[2]).max()))
                log(f"  seed {seed}, {tag} vs bf16 CPU: train_loss relative {read[0]:.3e}, "
                    f"val_loss relative {read[1]:.3e}, val risks max_abs_err {read[2]:.3e}"
                    + (f" (limits {BIG_BF16_CPU_TRAIN_RTOL:g}, {BIG_BF16_CPU_VAL_RTOL:g}, "
                       f"{BIG_BF16_CPU_ATOL:g})" if tag == "bf16 card" else " (the control)"))
                if tag == "bf16 card" and not (read[0] <= BIG_BF16_CPU_TRAIN_RTOL
                                               and read[1] <= BIG_BF16_CPU_VAL_RTOL
                                               and read[2] <= BIG_BF16_CPU_ATOL):
                    raise AssertionError(f"seed {seed}: the big bf16 card run disagrees with "
                                         "the CPU")
            gap = float(np.abs(ends["bf16 card"][2] - ends["f32 card"][2]).max())
            log(f"  seed {seed}: bf16 card vs its float32 control: val risks max_abs_err {gap:.3e}")
            if ends["bf16 card"][:2] == ends["f32 card"][:2] or gap == 0.0:
                raise AssertionError(f"seed {seed}: the big bf16 card run equals float32 compute")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 26: {time.perf_counter() - t_phase:.1f} s of wall time, launches "
        f"{ {k: v for k, v in total.items() if v} } ({power})")
    return total


# Phase 27: the plain-K pair with values at every shipped width in both types
# (MCAT and NaCAGaT lean=False at every size): the bfloat16 instances at D =
# 128, 256 and 512 and the float32 instance at D = 512. (a) Each instance
# against its plain version on the card. Float32 at phase 13's bars
# (KERNEL_ATOL, gradients GRAD_RTOL of each one's largest magnitude, a
# one-key bag's dq and dk held to the noise of the terms that cancel) but l,
# within PLAIN27_F32_L_RTOL relative: at D = 512 the pre-gated scores reach
# ~20 (the gate sums 512 products of tanh), and float32 sums of 512 terms in
# other orders move a score, and so l, by ~2e-5 relative (measured 1.9e-5;
# 1e-5 holds at D = 256). bfloat16: o within one bfloat16 unit (BF16_O_RTOL) of its terms'
# magnitude, sum_j w_j |v_j| (the attention over |v|, as phase 25 holds the
# flash instances' o: a tanh on the other side of a bfloat16 rounding in the
# two versions moves a key's weight, and o by that share of its term); l, m,
# ssq and sumw within PLAIN27_STAT_RTOL relative plus PLAIN27_STAT_ATOL
# (float32 sums of products of bfloat16 values in other orders); dq, dk, dv
# within BF16_GRAD_RTOL of each one's largest magnitude, a one-key bag's dq
# and dk (noise on both sides) left out. Both types: two runs bitwise equal,
# dk exactly 0 at every masked key and dv at the masked keys of bags with a
# valid key. (b) Serving: MCAT and NaCAGaT big through Predictor(...,
# lean=False) in float32 and bfloat16 and NaCAGaT medium in bfloat16 on phase
# 2's bags: one plain-K forward of the instance a batch and no other kernel
# (and no attention_core call, in (c) too);
# hazards, survs and risk against the CPU Predictor on the same weights
# (float32 within MODEL_ATOL; bfloat16 within PLAIN27_SERVE_ATOL: cuBLAS and
# the CPU round the bfloat16 projections at other places). (c) Training:
# NaCAGaT cesar (and MCAT ces at big in bfloat16), lean=False, dropout 0.25,
# Adam: GRAPH_STEPS steps graphed and eager, bit for bit, one forward and one
# backward launch a step; then, dropout 0, one step's loss and training
# hazards on the card against the CPU on shorter bags (float32 within
# PLAIN27_F32_CPU_RTOL relative and MODEL_ATOL; bfloat16 within
# PLAIN27_BF16_CPU_RTOL and PLAIN27_SERVE_ATOL).
PLAIN27_INSTANCES = ((256, "bf16"), (128, "bf16"), (512, "bf16"), (512, "f32"))
PLAIN27_CASES = ((TRAIN_M, "prefix"), (TRAIN_M, "holes"), (1500, "one"), (5000, "prefix"))
PLAIN27_STAT_RTOL, PLAIN27_STAT_ATOL = 1e-4, 1e-5
PLAIN27_F32_L_RTOL = 1e-4
PLAIN27_SERVE_ATOL = 2e-2
PLAIN27_F32_CPU_RTOL, PLAIN27_BF16_CPU_RTOL = 1e-4, 5e-3
PLAIN27_SERVE = (("MCAT", "big", "f32"), ("NaCAGaT", "big", "f32"), ("MCAT", "big", "bf16"),
                 ("NaCAGaT", "big", "bf16"), ("NaCAGaT", "medium", "bf16"))
PLAIN27_TRAIN = (("NaCAGaT", "cesar", "medium", "bf16"), ("NaCAGaT", "cesar", "big", "f32"),
                 ("NaCAGaT", "cesar", "big", "bf16"), ("MCAT", "ces", "big", "bf16"))
PLAIN27_CPU_M, PLAIN27_CPU_ROWS = 2048, 4


def plain27_rows(d, kind) -> tuple:
    """The kernels line's (forward, backward) rows of an instance: the
    bfloat16 one at D 128 and 256 shares ``coattn_plain_bf16``'s; ``_d512``
    at D = 512 (the launch counts do not carry the width: ``count_of``)."""
    sfx = ("_bf16" if kind == "bf16" else "") + ("_d512" if d == 512 else "")
    return "coattn_plain" + sfx, "coattn_plain_bwd" + sfx


def plain27_inputs(dev, m_len, d, kind, seed, b=B, n=N) -> tuple:
    """q, k, v, dout of phase 13's scale drawn on the card (float32, and the
    instance's type), make_mask's masks, a dropout seed and the side
    outputs' cotangents; ``b`` bags of ``n`` queries."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    mask = make_mask(m_len, g, kind, b).to(dev)
    gd = torch.Generator(device=dev).manual_seed(seed)
    q = 0.7 * torch.randn(b, n, d, generator=gd, device=dev)
    k = 0.7 * torch.randn(b, m_len, d, generator=gd, device=dev)
    v = 0.7 * torch.randn(b, m_len, d, generator=gd, device=dev)
    dout = torch.randn(b, n, d, generator=gd, device=dev)
    dssq, dsumw = (torch.randn(b, n, generator=gd, device=dev) for _ in range(2))
    dseed = torch.tensor([seed], dtype=torch.int32, device=dev)
    return q, k, v, dout, mask, dseed, dssq, dsumw


def plain27_check(dev, d, kind, m_len, mask_kind, pre_gate, errs, n=N, b=B, rows=None,
                  phase="27 (a)", l_rtol=PLAIN27_F32_L_RTOL, inputs=None) -> tuple:
    """One instance on one mask, one pre-gate setting: the eval form, the
    training form at dropout 0 and TRAIN_RATE, the backward at TRAIN_RATE;
    ``b`` bags of ``n`` queries, the errors noted in ``errs`` under ``rows``
    (forward, backward; default :func:`plain27_rows`); float32 l within
    ``l_rtol`` relative; ``inputs``: :func:`plain27_inputs`' tuple to use
    instead of drawing it. Returns (q, k, mask, seed) in the instance's type
    and the eval form's l, the kernel's and the plain version's, for phase
    31's export and l checks."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    bf = kind == "bf16"
    dt = torch.bfloat16 if bf else torch.float32
    q, k, v, dout, mask, seed, dssq, dsumw = inputs or plain27_inputs(
        dev, m_len, d, mask_kind, 27 * d + m_len + pre_gate + 1000 * (n - N), b, n)
    q, k, v, dout = (t.to(dt) for t in (q, k, v, dout))
    one, has = mask.sum(-1) == 1, mask.any(-1)
    fwd_row, bwd_row = rows or plain27_rows(d, kind)
    tag = f"{kind} N={n} D={d} M={m_len} {mask_kind} pre_gate={pre_gate}"
    worst = {}

    def hold(what, ratio):
        worst[what] = max(worst.get(what, 0.0), ratio)
        if not ratio <= 1.0:
            raise AssertionError(f"phase {phase} {tag}: {what} at {ratio:.3f} of its tolerance")

    def fwd_close(form, got, ref, rate):
        if got[0].dtype != dt or any(t is not None and t.dtype != torch.float32
                                     for t in got[1:]):
            raise AssertionError(f"phase {phase} {tag}: {form} output types")
        diff = (got[0].float() - ref[0].float()).abs()
        if bf:
            terms = coattn.coattn_fwd_plain_k_plain(q, k, v.abs(), mask, seed, rate,
                                                    pre_gate=pre_gate)[0].float()
            limit = BF16_O_RTOL * terms
            hold("o", float(torch.where(diff == 0, torch.zeros_like(diff),
                                        diff / limit.clamp_min(1e-30)).max()))
        else:
            hold("o", float(diff.max()) / KERNEL_ATOL)
        errs[fwd_row] = max(errs[fwd_row], float(diff.max()))
        for name, a, r in zip(("l", "m", "ssq", "sumw"), got[1:], ref[1:]):
            if a is None:
                continue
            atol, rtol = ((PLAIN27_STAT_ATOL, PLAIN27_STAT_RTOL) if bf else
                          (0.0, l_rtol) if name == "l" else (KERNEL_ATOL, 0.0))
            e = (a - r).abs()
            hold(name, float((e / (atol + rtol * r.abs())).max()))
            if not (bf or name == "l"):
                errs[fwd_row] = max(errs[fwd_row], float(e.max()))

    got = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
    again = coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate, train=False)
    if got[3] is not None or not all(torch.equal(a, c) for a, c in zip(got[:3], again[:3])):
        raise AssertionError(f"phase {phase} {tag}: the eval form's two runs differ")
    ref = coattn.coattn_fwd_plain_k_plain(q, k, v, mask, None, 0.0, pre_gate=pre_gate)
    fwd_close("eval", got, ref, 0.0)
    eval_l = got[1], ref[1]
    for rate in (0.0, TRAIN_RATE):
        got = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, rate, pre_gate=pre_gate)
        fwd_close(f"training {rate}", got, coattn.coattn_fwd_plain_k_plain(
            q, k, v, mask, seed, rate, pre_gate=pre_gate), rate)
    again = coattn.coattn_fwd_plain_k(q, k, v, mask, seed, TRAIN_RATE, pre_gate=pre_gate)
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"phase {phase} {tag}: the training form's two runs differ")
    o, l, m, ssq, sumw = fwd = got
    di = (o.float() * dout.float()).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    args = (q, k, v, mask, seed, TRAIN_RATE, dout, l, m, di, dssq, dsumw)
    grads = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
    again = coattn.coattn_bwd_plain_k(*args, pre_gate=pre_gate)
    if not all(torch.equal(a, c) for a, c in zip(grads, again)):
        raise AssertionError(f"phase {phase} {tag}: the backward's two runs differ")
    ref = coattn.coattn_bwd_plain_k_plain(q, k, v, mask, seed, TRAIN_RATE, dout, dssq, dsumw,
                                          pre_gate=pre_gate)
    if not bf and bool(one.any()):
        check_one_key_plain([t[one] for t in grads[:2]], [t[one] for t in ref[:2]], q[one],
                            k[one], [t[one] for t in fwd], dout[one], dssq[one], dsumw[one],
                            di[one])
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        if a.dtype != dt:
            raise AssertionError(f"phase {phase} {tag}: {name} is {a.dtype}")
        a, r = a.float(), r.float()
        if name != "dv":
            a, r = a[~one], r[~one]
        err = float((a - r).abs().max())
        hold(name, err / ((BF16_GRAD_RTOL if bf else GRAD_RTOL) * float(r.abs().max())))
        errs[bwd_row] = max(errs[bwd_row], err)
    if float(grads[1][~mask].float().abs().max()) != 0.0:
        raise AssertionError(f"phase {phase} {tag}: a masked key passed a gradient to k")
    if float(grads[2][has][~mask[has]].float().abs().max()) != 0.0:
        raise AssertionError(f"phase {phase} {tag}: dv is not 0 at a masked key")
    log(f"phase {phase}: {tag}: each output at its worst " + ", ".join(
        f"{k_} {v_:.3f}" for k_, v_ in worst.items()) + " of its tolerance; two runs bitwise "
        "equal; dk, dv exactly 0 at the masked keys")
    return q, k, mask, seed, eval_l


def plain27_timings(dev, errs, power) -> list:
    """Each instance at B=32, N=6, M=8192 (phase 16's masks), MCAT's form
    (no pre-gate, no dropout) for the kernels line, beside its float32 row,
    its plain version, scaled_dot_product_attention in its type and, at D =
    512, the attention_core route it replaces (with autograd's backward);
    the pre-gated form logged. Returns the rows without their launches."""
    import torch
    import torch.nn.functional as F

    from multimodal_path_omic_tpu_torch.ops import coattn
    from multimodal_path_omic_tpu_torch.ops.attention import attention_core

    rows = []
    for d, kind in PLAIN27_INSTANCES:
        bf = kind == "bf16"
        dt = torch.bfloat16 if bf else torch.float32
        q32, k32, v32, dout32, mask, seed, dssq, dsumw = plain27_inputs(dev, TRAIN_M, d,
                                                                        "prefix", 23)
        q, k, v, dout = (t.to(dt) for t in (q32, k32, v32, dout32))
        zeros = torch.zeros_like(dssq)
        valid, filled = int(mask.sum()), valid_keys(mask)
        need = {"fwd": (valid, filled), "bwd": (valid, valid)}
        fwd_row, bwd_row = plain27_rows(d, kind)
        times = {}
        for pre_gate in (False, True):
            o, l, m, ssq, sumw = coattn.coattn_fwd_plain_k_plain(q, k, v, mask, seed, 0.0,
                                                                 pre_gate=pre_gate)
            di = (o.float() * dout.float()).sum(-1)
            o32, l32, m32, _, _ = coattn.coattn_fwd_plain_k_plain(q32, k32, v32, mask, seed,
                                                                  0.0, pre_gate=pre_gate)
            di32 = (o32 * dout32).sum(-1)
            t = {
                "fwd": cuda_ms(lambda: coattn.coattn_fwd_plain_k(q, k, v, mask,
                                                                 pre_gate=pre_gate,
                                                                 train=False)),
                "fwd32": cuda_ms(lambda: coattn.coattn_fwd_plain_k(q32, k32, v32, mask,
                                                                   pre_gate=pre_gate,
                                                                   train=False)),
                "fwd_plain": cuda_ms(lambda: coattn.coattn_fwd_plain_k_plain(
                    q, k, v, mask, None, 0.0, pre_gate=pre_gate)),
                "bwd": cuda_ms(lambda: coattn.coattn_bwd_plain_k(
                    q, k, v, mask, seed, 0.0, dout, l, m, di, zeros, zeros,
                    pre_gate=pre_gate)),
                "bwd32": cuda_ms(lambda: coattn.coattn_bwd_plain_k(
                    q32, k32, v32, mask, seed, 0.0, dout32, l32, m32, di32, zeros, zeros,
                    pre_gate=pre_gate)),
                "bwd_plain": cuda_ms(lambda: coattn.coattn_bwd_plain_k_plain(
                    q, k, v, mask, seed, 0.0, dout, zeros, zeros, pre_gate=pre_gate)),
            }
            if d == 512:  # the route it replaces: attention_core, and autograd's backward
                q4, k4, v4 = (x[:, None] for x in (q, k, v))
                t["route_fwd"] = cuda_ms(lambda: attention_core(
                    q4, k4, v4, mask, pre_gate=pre_gate, need_weights=False))
                leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]
                out = attention_core(*leaves, mask, pre_gate=pre_gate, need_weights=False)[0]
                t["route_bwd"] = cuda_ms(lambda: torch.autograd.grad(
                    out, leaves, dout[:, None], retain_graph=True))
                del leaves, out
            times[pre_gate] = t
            log(f"phase 27: {kind} D={d} B={B} N={N} M={TRAIN_M} pre_gate={pre_gate}: "
                + ", ".join(f"{k_} {v_:.4f} ms" for k_, v_ in t.items()) + f" ({power})")
        q4, k4, v4 = (x[:, None] for x in (q, k, v))
        amask = mask[:, None, None, :]
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=amask))
        leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dout[:, None],
                                                      retain_graph=True))
        del leaves, lib_out
        t = times[False]
        for way, row, lib in (("fwd", fwd_row, lib_fwd), ("bwd", bwd_row, lib_bwd)):
            bms, by = plain_k_bound_ms(row, TRAIN_M, *need[way], d=d, esize=2 if bf else 4)
            every = plain_k_bound_ms(row, TRAIN_M, d=d, esize=2 if bf else 4)[0]
            log(f"phase 27: {row} (D={d}{' in the row of D 128, 256' if bf and d < 512 else ''}): "
                f"kernel {t[way]:.4f} ms, float32 row {t[way + '32']:.4f} ms "
                f"({t[way + '32'] / t[way]:.2f}x), plain {t[way + '_plain']:.4f} ms, "
                f"scaled_dot_product_attention {lib:.4f} ms"
                + (f", the replaced attention_core route {t['route_' + way]:.4f} ms "
                   f"({t['route_' + way] / t[way]:.2f}x)" if d == 512 else "")
                + f"; bound {bms:.4f} ms ({by}, keys needed; {bms / t[way]:.3f} reached), "
                f"{every:.4f} every key ({power})")
            if d != 128:
                rows.append({
                    "name": row, "route": "cuda", "source": SOURCES[row],
                    "replaces": REPLACES[row], "launches": 0, "max_abs_err": errs[row],
                    "ms": t[way], "plain_ms": t[way + "_plain"], "bound_ms": bms,
                    "bound_by": by, "library_ms": lib,
                })
        del q, k, v, q32, k32, v32, dout, dout32, q4, k4, v4
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def no_attention_core(what):
    """Fail where the block calls ``ops/attention.py::attention_core`` (the
    route the plain-K kernels replace, which launches no kernel of its own,
    so the launch counts cannot show it)."""
    from multimodal_path_omic_tpu_torch.ops import attention

    core, calls = attention.attention_core, []
    attention.attention_core = lambda *a, **k: calls.append(1) or core(*a, **k)
    try:
        yield
    finally:
        attention.attention_core = core
    if calls:
        raise AssertionError(f"phase 27 {what}: {len(calls)} attention_core call(s)")


def plain27_batch(dev, bags, omics, rows, m_len):
    """``rows`` of phase 2's bags, cut to ``m_len`` patches, with labels from
    a numpy seed, on ``dev``."""
    import torch

    rng = np.random.default_rng(27)
    wsi = torch.zeros((rows, m_len, bags[0].shape[1]))
    mask = torch.zeros((rows, m_len), dtype=torch.bool)
    for row in range(rows):
        n = min(len(bags[row]), m_len)
        wsi[row, :n] = torch.from_numpy(bags[row][:n])
        mask[row, :n] = True
    batch = {"wsi": wsi, "mask": mask,
             "omics": [torch.from_numpy(np.stack([omics[r][j] for r in range(rows)]))
                       for j in range(len(SIZES))],
             "label": torch.from_numpy(rng.integers(0, 4, rows)),
             "censorship": torch.from_numpy(rng.integers(0, 2, rows).astype(np.float32)),
             "weight": torch.ones(rows)}
    return {k_: ([t.to(dev) for t in v_] if k_ == "omics" else v_.to(dev))
            for k_, v_ in batch.items()}


def phase27_plain_k(dev) -> list:
    """(a)-(c) of the phase 27 notes above. Returns the six rows of the
    kernels line, their launches those of (b) and (c)."""
    import torch

    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.train import loop
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    errs = {name: 0.0 for d, kind in PLAIN27_INSTANCES for name in plain27_rows(d, kind)}
    for d, kind in PLAIN27_INSTANCES:
        for m_len, mask_kind in PLAIN27_CASES:
            for pre_gate in (False, True):
                plain27_check(dev, d, kind, m_len, mask_kind, pre_gate, errs)
        torch.cuda.empty_cache()
    rows = plain27_timings(dev, errs, power)
    launches = {row["name"]: 0 for row in rows}

    def credit(counts, d, kind, what):
        fwd_row, bwd_row = plain27_rows(d, kind)
        sfx = "_bf16" if kind == "bf16" else ""
        want_bwd = counts.get("coattn_plain_bwd" + sfx, 0)
        if set(counts) - {"coattn_plain" + sfx, "coattn_plain_bwd" + sfx}:
            raise AssertionError(f"phase 27 {what}: launches {counts}")
        launches[fwd_row] += counts.get("coattn_plain" + sfx, 0)
        if want_bwd:
            launches[bwd_row] += want_bwd

    bags, omics = make_bags(0)
    for model_name, size, kind in PLAIN27_SERVE:
        dt = torch.bfloat16 if kind == "bf16" else None
        d = {"medium": 256, "big": 512}[size]
        what = f"(b): {model_name} {size} {kind}, lean=False, ces"
        kw = dict(omic_sizes=SIZES, model_size=size, buckets=BUCKETS, loss="ces", seed=0,
                  lean=False, dtype=dt)
        pred = Predictor(model_name, batch_size=B, device=dev, **kw)
        reset_counts()
        with no_attention_core(what):
            out = pred.predict_bags(bags, omics)
        torch.cuda.synchronize()
        counts = {k_: v_ for k_, v_ in read_counts().items() if v_}
        sfx = "_bf16" if kind == "bf16" else ""
        if counts != {"coattn_plain" + sfx: n_batches(bags)}:
            raise AssertionError(f"phase 27 {what}: launches {counts}")
        credit(counts, d, kind, what)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_bags(bags, omics)
        torch.cuda.synchronize()
        rate = len(bags) / (time.perf_counter() - t0)
        idx = [0, 1, 2]  # the CPU forward at big width costs seconds a bag
        ref = Predictor(model_name, batch_size=4, device="cpu", **kw).predict_bags(
            [bags[i] for i in idx], [omics[i] for i in idx])
        tol = MODEL_ATOL if dt is None else PLAIN27_SERVE_ATOL
        reads = {}
        for key in ("hazards", "survs", "risk"):
            a = out[key][idx]
            if not np.isfinite(out[key]).all():
                raise AssertionError(f"phase 27 {what}: non-finite {key}")
            reads[key] = float(np.abs(a - ref[key]).max())
            if reads[key] > tol:
                raise AssertionError(f"phase 27 {what}: {key} {reads[key]:.3e} from the CPU")
        log(f"phase 27 {what}: {len(bags)} bags, one {'coattn_plain' + sfx} launch a batch "
            f"({counts}), nothing else, no attention_core call; against the CPU Predictor "
            f"on bags {idx}: "
            + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in reads.items()) + f" (tolerance {tol:g}); "
            f"{rate:.2f} bags/s (host clock, second call) ({power})")
        del pred
        torch.cuda.empty_cache()

    batch = plain27_batch(dev, bags, omics, 8, TRAIN_M)
    short = plain27_batch("cpu", bags, omics, PLAIN27_CPU_ROWS, PLAIN27_CPU_M)
    for model_name, loss, size, kind in PLAIN27_TRAIN:
        dt = torch.bfloat16 if kind == "bf16" else None
        d = {"medium": 256, "big": 512}[size]
        what = f"(c): {model_name} {size} {kind} {loss}, lean=False"

        def make(graphs, rate=TRAIN_RATE, where=dev):
            model = seeded_init_(build_model(model_name, omic_sizes=SIZES, model_size=size,
                                             dropout=rate, lean=False, dtype=dt), 0).to(where)
            opt = make_optimizer("adam", 2e-4, 1e-5)
            return (model, loop.init_train_state(model, opt, seed=0),
                    loop.make_train_step(model, loss, opt, omic_sizes=SIZES,
                                         graphs=graphs and where != "cpu"), None)

        log(f"phase 27 {what}: dropout {TRAIN_RATE}, Adam, [8, {TRAIN_M}, 1024] (phase 2's "
            f"first bags)")
        with no_attention_core(what):
            counts = _step_pair(f"{model_name} {size} {kind}", make, batch, GRAPH_STEPS)
        sfx = "_bf16" if kind == "bf16" else ""
        if counts != {"coattn_plain" + sfx: GRAPH_STEPS, "coattn_plain_bwd" + sfx: GRAPH_STEPS}:
            raise AssertionError(f"phase 27 {what}: launches {counts}")
        credit({k_: 2 * v_ for k_, v_ in counts.items()}, d, kind, what)  # eager and graphed
        ends = {}
        for where in (dev, "cpu"):
            model, state, step, _ = make(False, 0.0, where)
            b = short if where == "cpu" else {
                k_: ([t.to(dev) for t in v_] if k_ == "omics" else v_.to(dev))
                for k_, v_ in short.items()}
            before = read_counts()
            with no_attention_core(what):
                state, metrics = step(state, b)
            if where != "cpu":
                torch.cuda.synchronize()
                credit(_counts_delta(before, read_counts()), d, kind, what)
            ends[where] = float(metrics.loss)
            del model, state, step
        rel = abs(ends[dev] - ends["cpu"]) / abs(ends["cpu"])
        tol = PLAIN27_F32_CPU_RTOL if dt is None else PLAIN27_BF16_CPU_RTOL
        log(f"phase 27 {what}: dropout 0, one step on [{PLAIN27_CPU_ROWS}, {PLAIN27_CPU_M}, "
            f"1024]: loss card {ends[dev]!r}, CPU {ends['cpu']!r}, relative {rel:.3e} "
            f"(tolerance {tol:g})")
        if not (math.isfinite(ends[dev]) and rel <= tol):
            raise AssertionError(f"phase 27 {what}: the card's loss disagrees with the CPU's")
        torch.cuda.empty_cache()
    del bags, omics, batch, short
    for row in rows:
        row["launches"] = launches[row["name"]]
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on phase 27's main-path runs")
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s of wall time, launches "
        f"{launches} ({power})")
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
    """(name, device ms, count) of a trace's device-side events, largest
    first (the package's parser, ``train/profiling.py::device_rows``)."""
    from multimodal_path_omic_tpu_torch.train.profiling import device_rows as rows_of

    return rows_of(prof)


def profile_training(title, tag, make, batch, top=20) -> None:
    """After two warm-up steps of the trainer ``make()`` returns, the
    host-clock median of 10 steps and their peak device memory, then one
    traced step: device time by category (``train/profiling.py``) and by
    kernel."""
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
    from multimodal_path_omic_tpu_torch.train.profiling import split_ms

    rows = device_rows(prof)
    split = split_ms(rows)  # the package's categories (train/profiling.py)
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


def profile_trainer(dev, top=12) -> None:
    """Phase 21's NaCAGaT configuration, host-fed and cached: after a first
    epoch (the warm-up and, cached, the upload), one traced ``train_epoch``
    and one traced ``validate`` through the package's tracer
    (``train/profiling.py::trace_call``): wall time, device time by category
    and by kernel, and the device busy share."""
    import shutil
    import tempfile

    import torch

    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.train.profiling import trace_call
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **TRAINER_COHORT)
        for feed in ("off", "on"):
            cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, feed),
                                 {**TRAINER_SET, "tpu.device_cache": feed})
            trainer = Trainer(cfg, verbose=False)
            trainer.validated_epoch(0)
            for what, call in (("train_epoch", trainer.train_epoch),
                               ("validate", trainer.validate)):
                tr = trace_call(call, 1)
                title = f"Trainer {what}, device_cache={feed}, {trainer.bag_reader} reader"
                log(f"profile: {title}; wall {tr['wall_ms']:.3f} ms; device "
                    f"{tr['device_ms']:.3f} ms; busy share {tr['busy_share']:.4f}; split "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in tr["split_ms"].items()))
                for name, ms, count in tr["rows"][:top]:
                    log(f"  {ms:10.4f} ms  x{count:<5d} {name[:100]}")
                log(json.dumps({"trainer": what, "device_cache": feed,
                                "reader": trainer.bag_reader, "wall_ms": tr["wall_ms"],
                                "device_ms": tr["device_ms"], "busy_share": tr["busy_share"],
                                "split_ms": tr["split_ms"]}))
            del trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


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


def profile_http(dev, top=12) -> None:
    """Where one ``/predict_batch_npz`` request of 8 bags goes: the client's
    wall time, the body's ``np.load`` (the handler's parse, repeated in this
    process), the server's inference under its lock (``/metrics``), and the
    trace's device time split into host-to-device copies, other copies and
    kernels. Phase 2's NaCAGaT ``cesar`` Predictor (batch 16) behind
    ``make_server``."""
    import io
    import threading

    import torch

    from multimodal_path_omic_tpu_torch.server import make_server

    pred = make_predictor(dev, "cesar", batch_size=16)
    bags, omics = serve_bags(np.random.default_rng(22), 8, SERVE_LENGTHS, SIZES)
    body = npz_bytes(bags=bags, omics_list=omics)
    server = make_server(pred, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    key = 'mpot_inference_seconds_total{endpoint="/predict_batch_npz"}'
    try:
        http(base + "/predict_batch_npz", body)  # warm
        t0 = time.perf_counter()
        with np.load(io.BytesIO(body)) as z:
            _ = [np.asarray(z[k], np.float32) for k in z.files]
        parse_ms = (time.perf_counter() - t0) * 1e3
        infer0 = metric_value(http(base + "/metrics")[1], key)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if http(base + "/predict_batch_npz", body)[0] != 200:
                raise AssertionError("profiled /predict_batch_npz failed")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        infer_ms = (metric_value(http(base + "/metrics")[1], key) - infer0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
    rows = device_rows(prof)
    split = {"host-to-device copies": 0.0, "other copies": 0.0, "kernels": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        part = ("host-to-device copies" if "htod" in low else
                "other copies" if "memcpy" in low or "memset" in low else "kernels")
        split[part] += ms
    device_ms = sum(split.values())
    log(f"profile: /predict_batch_npz of 8 bags ({len(body) / 2**20:.1f} MiB body): wall "
        f"{wall_ms:.3f} ms; np.load of the body {parse_ms:.3f} ms; inference under the lock "
        f"{infer_ms:.3f} ms; device {device_ms:.3f} ms "
        f"({', '.join(f'{k} {v:.3f}' for k, v in split.items())}); busy share "
        f"{device_ms / wall_ms:.4f} ({gpu_name_and_power()})")
    for name, ms, count in rows[:top]:
        log(f"  {ms:10.4f} ms  x{count:<5d} {name[:100]}")
    log(json.dumps({"request": "/predict_batch_npz", "bags": 8, "wall_ms": wall_ms,
                    "parse_ms": parse_ms, "inference_ms": infer_ms, "device_ms": device_ms,
                    "split": split, "busy_share": device_ms / wall_ms}))


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


# Multi-GPU (phase 28): the mesh layer (parallel/) on the one card. (a) one
# rank on NCCL in this process; (b)-(d) several ranks spawned on the card
# over gloo (NCCL refuses two ranks on one device), each on cuda:0. Batches:
# MESH_B bags of the MESH_M bucket from a seeded cohort (CacheCohort),
# NaCAGaT and MCAT medium, dropout 0.25 at every site; GE medium on
# MESH_GE_B rows of the MESH_GE_M bucket. SGD (lr MESH_LR): a parameter's
# difference from one rank then stays the size of its gradient's rounding
# (Adam's first steps are sign steps, which make a zero gradient's noise a
# full step).
MESH_B, MESH_M, MESH_STEPS, MESH_LR = 8, 4096, 3, 1e-2
MESH_COHORT = {MESH_M: 16}
MESH_ROWS = ((0, 8), (8, 16), (4, 12))  # the rows of the cohort each step takes
MESH_GE_B, MESH_GE_M = 2, 8192
MESH_TIMEOUT_S = 300
# Against one rank on the same card: the sharded step runs the same kernels
# on half the rows (other split merges inside them) and sums gradients over
# the ranks in another order; seq meshes run the ring and the stat merge in
# plain float32 where one rank runs the kernels. Losses and outputs move by
# ~1e-6 relative, a parameter after SGD steps by far less than 1e-5 of its
# tensor's largest magnitude; a fault (a wrong slice, a missing all-reduce,
# a mask drawn for other rows) moves them by O(1e-2) or more.
MESH_RTOL = 1e-5
MESH_OUT_ATOL = 1e-4  # predict_bags outputs (hazards, survs, y: magnitude <= 1)


def mesh_cohort():
    return CacheCohort(MESH_COHORT, seed=11)


def mesh_host_batch(ds, rows, dev) -> dict:
    """The global host-fed batch of cohort rows ``rows`` (phase 15's
    stage_host_batch), survival months included."""
    import torch

    meta = {"row": np.asarray(rows), "weight": np.ones(len(rows), np.float32)}
    batch = stage_host_batch(ds, MESH_M, meta, dev)
    batch["survival_months"] = torch.from_numpy(ds.survival_months[rows]).to(dev)
    return batch


def mesh_model(dev, name, mesh, size="medium"):
    """(model, state, optimizer) of phase 28: random weights from seed 0,
    dropout 0.25, SGD, dropout generator seeded with 0; the mesh (or None)
    on the model's patch-axis modules."""
    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    ge = name.startswith("GE")
    net = build_model(name, omic_sizes=None if ge else SIZES, model_size=size,
                      dropout=TRAIN_RATE, mesh=mesh)
    net = seeded_init_(net, 0).to(dev)
    opt = make_optimizer("sgd", MESH_LR)
    return net, init_train_state(net, opt, seed=0), opt


def mesh_steps(dev, mesh, cached: bool, graphs=False, steps=MESH_STEPS, model="NaCAGaT",
               loss=None):
    """``steps`` NaCAGaT (cesar) or MCAT (ces) steps on MESH_ROWS, host-fed
    (each rank's slice of the global batch) or from a DeviceBagCache (this
    rank's chunk of every bag, with mesh), from the same start; returns the
    losses, each step's wall seconds (synchronized; the first captures or
    warms up) and the final parameters (on the host). ``loss`` names
    another loss (phase 30: cox); then the eval step's loss and risks on
    the first batch follow the steps (``eval_loss``, ``eval_risk``)."""
    import torch

    from multimodal_path_omic_tpu_torch.data.device_cache import DeviceBagCache, build_meta
    from multimodal_path_omic_tpu_torch.data.pipeline import survival_extras
    from multimodal_path_omic_tpu_torch.parallel.mesh import shard_batch
    from multimodal_path_omic_tpu_torch.train import loop

    ds = mesh_cohort()
    net, state, opt = mesh_model(dev, model, mesh)
    with_eval = loss is not None
    loss = loss or ("cesar" if model == "NaCAGaT" else "ces")
    kw = dict(omic_sizes=SIZES, mesh=mesh, graphs=graphs, patch_budget=None)
    losses, secs = [], []
    if cached:
        cache = DeviceBagCache(ds, survival_extras, (MESH_M,), device=dev, lengths=ds.lengths,
                               mesh=mesh, upload_chunk=8)
        step = loop.make_cached_train_step(net, loss, opt, **kw)
        inputs = [(cache.caches[MESH_M], build_meta(list(range(lo, hi)), MESH_B, cache)[0])
                  for lo, hi in MESH_ROWS[:steps]]
    else:
        step = loop.make_train_step(net, loss, opt, **kw)
        inputs = []
        for lo, hi in MESH_ROWS[:steps]:
            batch = mesh_host_batch(ds, list(range(lo, hi)), dev)
            inputs.append((batch if mesh is None else shard_batch(batch, mesh,
                                                                  process_local=False),))
    for args in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *args)
        losses.append(m.loss)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out = {"losses": [float(x) for x in losses], "step_s": secs,
           "params": {k: p.detach().cpu() for k, p in net.named_parameters()}}
    if with_eval:
        kw.pop("patch_budget")
        res = loop.make_eval_step(net, loss, cached=cached, **kw)(*inputs[0])
        out["eval_loss"], out["eval_risk"] = float(res["loss"]), res["risk"].cpu()
    return out


def mesh_ge_batch(dev, seed=21) -> dict:
    """MESH_GE_B rows of the MESH_GE_M bucket, ragged, from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    lengths = (MESH_GE_M, MESH_GE_M // 2 + MESH_GE_M // 10)
    wsi = torch.zeros((MESH_GE_B, MESH_GE_M, 1024))
    mask = torch.zeros((MESH_GE_B, MESH_GE_M), dtype=torch.bool)
    for row, n in enumerate(lengths):
        wsi[row, :n] = torch.from_numpy(rng.standard_normal((n, 1024), dtype=np.float32))
        mask[row, :n] = True
    return {"wsi": wsi.to(dev), "mask": mask.to(dev), "weight": torch.ones(MESH_GE_B, device=dev),
            "label": torch.from_numpy(rng.integers(0, 3, MESH_GE_B)).to(dev)}


def mesh_seq_runs(dev, mesh) -> dict:
    """(c): GE medium (ce) and MCAT medium (ces): one training step and one
    predict_bags each, on ``mesh`` (seq 2) or one rank (None)."""
    import torch

    from multimodal_path_omic_tpu_torch.parallel.mesh import shard_batch
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.train import loop

    out = {}
    net, state, opt = mesh_model(dev, "GE-NaCAGaT", mesh)
    step = loop.make_train_step(net, "ce", opt, ge_mode=True, mesh=mesh, graphs=False,
                                patch_budget=None)
    batch = mesh_ge_batch(dev)
    state, m = step(state, batch if mesh is None else shard_batch(batch, mesh,
                                                                  process_local=False))
    out["ge_loss"] = float(m.loss)
    out["ge_params"] = {k: p.detach().cpu() for k, p in net.named_parameters()}
    del net, state, batch
    ge_bags = make_ge_bags(5)[:3]
    pred = Predictor("GE-NaCAGaT", model_size="medium", buckets=(MESH_GE_M, 16384),
                     batch_size=2, seed=0, device=dev, mesh=mesh)
    out["ge_y"] = pred.predict_bags(ge_bags)["y"]
    del pred
    out.update({f"mcat_{k}": v for k, v in
                mesh_steps(dev, mesh, cached=False, steps=1, model="MCAT").items()})
    bags, omics = make_bags(9)
    bags, omics = bags[:6], omics[:6]
    pred = Predictor("MCAT", omic_sizes=SIZES, model_size="medium", buckets=BUCKETS,
                     batch_size=4, loss="ces", seed=0, device=dev, mesh=mesh)
    out["mcat_pred"] = pred.predict_bags(bags, omics)
    torch.cuda.synchronize()
    return out


def _mesh_rank(rank, world, port, data, seq, job, out_dir):
    """One spawned rank of phases 28 (b)-(d): a gloo process group on the
    card, the mesh, the job; its results (and its kernel launches) to
    ``out_dir``."""
    import datetime

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    import torch
    import torch.distributed as dist

    from multimodal_path_omic_tpu_torch.device import resolve_device
    from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device("cuda:0")
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    mesh = make_mesh(data, seq, device=dev, backend="gloo")
    reset_counts()
    if job == "data":
        res = {"cached": mesh_steps(dev, mesh, cached=True),
               "host": mesh_steps(dev, mesh, cached=False)}
    elif job == "seq":
        res = mesh_seq_runs(dev, mesh)
    else:
        res = mesh_steps(dev, mesh, cached=True, steps=1)
    torch.cuda.synchronize()
    res["launches"] = {k: v for k, v in read_counts().items() if v}
    log(f"  rank {rank} of {world} ({mesh.d}, {mesh.s}): kernel launches {res['launches']}")
    dist.barrier()
    torch.save(res, os.path.join(out_dir, f"{rank}.pt"))
    dist.destroy_process_group()


def mesh_world(data, seq, job) -> list:
    """Spawn data x seq ranks on the card for ``job``; their results in rank
    order. A rank that dies, or a world past MESH_TIMEOUT_S, raises."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world = data * seq
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_mesh_rank, args=(world, port, data, seq, job, out_dir),
                                 nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    raise TimeoutError(f"phase 28 {data}x{seq} {job}: ranks still running "
                                       f"after {MESH_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        log(f"  {data}x{seq} {job}: {world} ranks in {time.perf_counter() - t0:.1f} s")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def mesh_close(what, got, ref, rtol=MESH_RTOL) -> float:
    """|got - ref| <= rtol of ref's largest magnitude (tensors, arrays or
    floats); returns the error."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    if not err <= rtol * scale:
        raise AssertionError(f"phase 28 {what}: {err} > {rtol} x {scale}")
    return err


def mesh_params_close(what, got, ref) -> float:
    worst = 0.0
    for name, p in ref.items():
        worst = max(worst, mesh_close(f"{what} {name}", got[name], p) / max(
            float(p.abs().max()), 1e-30))
    return worst


def mesh_same_across_ranks(what, results, key) -> None:
    import torch

    for r, res in enumerate(results[1:], 1):
        for name, p in res[key].items():
            if not torch.equal(p, results[0][key][name]):
                raise AssertionError(f"phase 28 {what}: {name} differs between rank 0 and "
                                     f"rank {r}")


def mesh_bag0_checks(dev) -> dict:
    """The training forms at a bag offset (the ``bag0`` a data-parallel rank
    passes): the fuse-K training forward and backward and the plain-K pair
    at bag0 = 5 against their plain versions at the same offset, and
    against the kernel at bag0 = 0 on the same inputs (the bits must
    move). Returns the largest error a kernel."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    errs = {}
    ins, (dout, _, _, _, dssq, dsumw), _ = train_kernel_inputs(4096, dev, 311, "prefix")
    q, kv, wk, bk, mask, dseed = ins
    bag0 = 5
    got = coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, dseed, TRAIN_RATE, bag0)
    ref = coattn.coattn_fwd_fused_k_train_plain(q, kv, wk, bk, mask, dseed, TRAIN_RATE, bag0)
    errs["coattn_fwd_fused_k_train"] = max(
        check_close("phase 28 bag0 fwd_train.o", got[0], ref[0], KERNEL_ATOL),
        check_close("phase 28 bag0 fwd_train.ssq", got[3], ref[3], KERNEL_ATOL))
    zero = coattn.coattn_fwd_fused_k_train(q, kv, wk, bk, mask, dseed, TRAIN_RATE)
    if max_err(zero[0], got[0]) < 1e-3:
        raise AssertionError("phase 28: bag0 = 5 drew the bits of bag0 = 0")
    _, l, m, ssq, sumw = got
    di = (got[0] * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    bwd = coattn.coattn_bwd_fused_k(q, kv, wk, bk, mask, dseed, TRAIN_RATE, dout, l, m, di,
                                    dssq, dsumw, bag0)
    bref = coattn.coattn_bwd_fused_k_plain(q, kv, wk, bk, mask, dseed, TRAIN_RATE, dout, dssq,
                                           dsumw, bag0)
    errs["coattn_bwd_fused_k"] = max(check_rel(f"phase 28 bag0 bwd.{n}", a, r, GRAD_RTOL)
                                     for n, a, r in zip(("dq", "dkv", "dwk", "dbk"), bwd, bref))
    k = torch.matmul(kv, wk) + bk
    got = coattn.coattn_fwd_plain_k(q, k, kv, mask, dseed, TRAIN_RATE, pre_gate=True, bag0=bag0)
    ref = coattn.coattn_fwd_plain_k_plain(q, k, kv, mask, dseed, TRAIN_RATE, pre_gate=True,
                                          bag0=bag0)
    errs["coattn_plain"] = check_close("phase 28 bag0 plain_fwd.o", got[0], ref[0], KERNEL_ATOL)
    _, l, m, ssq, sumw = got
    di = (got[0] * dout).sum(-1) + 2.0 * dssq * ssq + dsumw * sumw
    bwd = coattn.coattn_bwd_plain_k(q, k, kv, mask, dseed, TRAIN_RATE, dout, l, m, di, dssq,
                                    dsumw, pre_gate=True, bag0=bag0)
    bref = coattn.coattn_bwd_plain_k_plain(q, k, kv, mask, dseed, TRAIN_RATE, dout, dssq, dsumw,
                                           pre_gate=True, bag0=bag0)
    errs["coattn_plain_bwd"] = max(check_rel(f"phase 28 bag0 plain_bwd.{n}", a, r, GRAD_RTOL)
                                   for n, a, r in zip(("dq", "dk", "dv"), bwd, bref))
    return errs


def phase28_mesh(dev) -> dict:
    """Multi-GPU through the mesh layer on the one card; returns (a)'s
    kernel launches and (b)'s, summed over its ranks."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist

    from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    log("phase 28: the training forms at a bag offset (bag0 = 5) against their plain versions")
    mesh_bag0_checks(dev)
    log("phase 28 (a): one rank on NCCL, the gradient all-reduce captured in the step's "
        "CUDA graph, against the step without a group")
    ref = {"host": mesh_steps(dev, None, cached=False, graphs=True),
           "cached": mesh_steps(dev, None, cached=True, graphs=True)}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=dev if dev.index is not None
                            else torch.device("cuda", 0),
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh(1, 1, device=dev)
        if mesh.backend != "nccl" or mesh.world.local:
            raise AssertionError(f"phase 28 (a): the world is not an NCCL group: {mesh}")
        reset_counts()
        one = {"host": mesh_steps(dev, mesh, cached=False, graphs=True),
               "cached": mesh_steps(dev, mesh, cached=True, graphs=True)}
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        dist.destroy_process_group()
    for way in ("host", "cached"):
        if one[way]["losses"] != ref[way]["losses"]:
            raise AssertionError(f"phase 28 (a) {way}: losses {one[way]['losses']} != "
                                 f"{ref[way]['losses']} without a group")
        for name, p in ref[way]["params"].items():
            if not torch.equal(one[way]["params"][name], p):
                raise AssertionError(f"phase 28 (a) {way}: {name} differs from the step "
                                     "without a group")
    for name in ("gather_rows", "coattn_fwd_fused_k_train", "coattn_bwd_fused_k"):
        if not launches.get(name):
            raise AssertionError(f"phase 28 (a): {name} did not launch")
    log(f"  host-fed and cached, {MESH_STEPS} steps each, graphed: losses "
        f"{one['host']['losses']} / {one['cached']['losses']}, bit for bit the steps without "
        f"a group; launches {({k: v for k, v in launches.items() if v})}")
    for way in ("host", "cached"):
        log(f"  {way} step s (the first captures): with the NCCL group "
            f"{[round(x, 5) for x in one[way]['step_s']]}, without "
            f"{[round(x, 5) for x in ref[way]['step_s']]}")

    log(f"phase 28 (b): NaCAGaT medium data 2, two ranks on the card over gloo, "
        f"{MESH_STEPS} steps cached and host-fed, dropout {TRAIN_RATE}")
    res = mesh_world(2, 1, "data")
    for way in ("host", "cached"):
        mesh_same_across_ranks(f"(b) {way}", [r[way] for r in res], "params")
        for r in res:
            mesh_close(f"(b) {way} losses", r[way]["losses"], ref[way]["losses"])
        worst = mesh_params_close(f"(b) {way}", res[0][way]["params"], ref[way]["params"])
        log(f"  {way}: losses {res[0][way]['losses']} (one rank {ref[way]['losses']}); "
            f"parameters bitwise equal across ranks, within {worst:.2e} of each tensor's "
            f"largest magnitude of one rank's; step s on rank 0 (eager, gloo) "
            f"{[round(x, 4) for x in res[0][way]['step_s']]}, one rank graphed "
            f"{[round(x, 5) for x in ref[way]['step_s']]}")
    b_launches = {}
    for r, rr in enumerate(res):
        for name in ("gather_rows", "coattn_fwd_fused_k_train", "coattn_bwd_fused_k"):
            if not rr["launches"].get(name):
                raise AssertionError(f"phase 28 (b): {name} did not launch on rank {r}")
        for name, v in rr["launches"].items():
            b_launches[name] = b_launches.get(name, 0) + v
    del ref

    log("phase 28 (c): GE medium and MCAT medium at seq 2 (the ring, the merged MIL pool, "
        "the stat merge): a training step and predict_bags each, against one rank")
    seq_ref = mesh_seq_runs(dev, None)
    torch.cuda.empty_cache()
    res = mesh_world(1, 2, "seq")
    mesh_same_across_ranks("(c) GE", res, "ge_params")
    mesh_same_across_ranks("(c) MCAT", res, "mcat_params")
    for r in res:
        mesh_close("(c) GE loss", r["ge_loss"], seq_ref["ge_loss"])
        mesh_close("(c) MCAT loss", r["mcat_losses"], seq_ref["mcat_losses"])
        check_close("phase 28 (c) GE y", torch.from_numpy(r["ge_y"]),
                    torch.from_numpy(seq_ref["ge_y"]), MESH_OUT_ATOL)
        for col, v in seq_ref["mcat_pred"].items():
            check_close(f"phase 28 (c) MCAT {col}", torch.from_numpy(r["mcat_pred"][col]),
                        torch.from_numpy(v), MESH_OUT_ATOL)
    worst = max(mesh_params_close("(c) GE", res[0]["ge_params"], seq_ref["ge_params"]),
                mesh_params_close("(c) MCAT", res[0]["mcat_params"], seq_ref["mcat_params"]))
    log(f"  GE loss {res[0]['ge_loss']} (one rank {seq_ref['ge_loss']}), MCAT loss "
        f"{res[0]['mcat_losses']} (one rank {seq_ref['mcat_losses']}); parameters within "
        f"{worst:.2e}; predict_bags within {MESH_OUT_ATOL}")
    del seq_ref

    log("phase 28 (d): NaCAGaT medium 2x2 on four ranks, one cached step against one rank")
    one_step = mesh_steps(dev, None, cached=True, steps=1)
    res = mesh_world(2, 2, "2x2")
    mesh_same_across_ranks("(d)", res, "params")
    for r in res:
        mesh_close("(d) loss", r["losses"], one_step["losses"])
    worst = mesh_params_close("(d)", res[0]["params"], one_step["params"])
    log(f"  loss {res[0]['losses']} (one rank {one_step['losses']}); parameters bitwise equal "
        f"across ranks, within {worst:.2e} of one rank's")
    log(f"phase 28: {time.perf_counter() - t_phase:.1f} s ({gpu_name_and_power()}; several "
        "ranks share one card over host-staged gloo: not a multi-GPU speed)")
    return {"a": launches, "b": b_launches}


# Phase 29: the tooling on the card, through the package and the CLI: the
# native bag reader, profile, plan, cv and sweep, deployment bundles, remat.
# Its cohort is phase 21's (48 patients, bags of 1500..8000 1024-wide
# patches, examples/nacagat.yaml with TRAINER_SET), host-fed.
TOOL_SET = {**TRAINER_SET, "tpu.device_cache": "off"}
BUNDLE_BUCKET, BUNDLE_B = 8192, 8  # one program a bundle: its bags fill two batches
REMAT_STEPS = 3


def tool_yaml(root, name, example, paths, overrides) -> str:
    """``trainer_config``'s config written as a YAML file (the CLI's input)."""
    import yaml

    from multimodal_path_omic_tpu_torch.config import config_to_dict

    path = os.path.join(root, f"{name}.yaml")
    cfg = trainer_config(example, paths, os.path.join(root, name), overrides)
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f)
    return path


def cli_out(argv) -> str:
    """``cli.main(argv)`` in this process; its standard output (rc 0 or raise)."""
    import contextlib
    import io

    from multimodal_path_omic_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv[:1])} exited {rc}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue()


def p29_native(dev, root, paths, power, add) -> dict:
    """(a) The host-fed, graphed Trainer with the native reader off and on:
    losses and parameters bit for bit; each reader's steady epoch (wall,
    device time from a traced epoch, bags/s); the bag read split."""
    import torch

    from multimodal_path_omic_tpu_torch.data.native import NativeBagStore
    from multimodal_path_omic_tpu_torch.train.profiling import trace_call
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    runs = {}
    for on in (False, True):
        cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, f"native_{on}"),
                             {**TOOL_SET, "tpu.use_native_pipeline": on})
        trainer = Trainer(cfg, verbose=False)
        if trainer.bag_reader != ("native" if on else "python"):
            raise AssertionError(f"use_native_pipeline={on}: reader {trainer.bag_reader} "
                                 f"({trainer.train_batcher.reader_note})")
        before = read_counts()
        losses = [trainer.train_epoch(0)["train_loss"]]  # graph capture, pinned buffers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses.append(trainer.train_epoch(1)["train_loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        tr = trace_call(trainer.train_epoch, 2)
        losses.append(tr["out"]["train_loss"])
        add(read_counts(), before)
        runs[on] = dict(losses=losses, wall=wall, peak=peak, device_ms=tr["device_ms"],
                        traced_wall_ms=tr["wall_ms"], n=len(trainer.train_ds),
                        params=[p.detach().clone() for p in trainer.model.parameters()])
        log(f"phase 29 (a): {trainer.bag_reader} reader: epoch 2 {wall * 1e3:.1f} ms wall, "
            f"{runs[on]['n'] / wall:.1f} train bags/s; traced epoch 3: device "
            f"{tr['device_ms']:.1f} ms of {tr['wall_ms']:.1f} ms wall (busy share "
            f"{tr['busy_share']:.3f}), copies {tr['split_ms'].get('copies', 0.0):.1f} ms; "
            f"losses {losses}; peak {peak / 2**30:.2f} GiB ({power})")
        del trainer
        torch.cuda.empty_cache()
    if runs[True]["losses"] != runs[False]["losses"] or not all(
            torch.equal(a, b) for a, b in zip(runs[True]["params"], runs[False]["params"])):
        raise AssertionError(f"native reader: losses {runs[True]['losses']} against "
                             f"{runs[False]['losses']}, or parameters differ")
    log("  native == Python reader, bit for bit: three epochs' losses and the parameters")
    # the bag read split over the cohort's own files: cold (evicted with
    # posix_fadvise after an fsync), from the page cache, and a memcpy of the
    # same bytes between two arrays in memory
    patches = paths[2]
    names = sorted(f[:-4] for f in os.listdir(patches) if f.endswith(".npy"))
    files = [os.path.join(patches, n + ".npy") for n in names]
    store = NativeBagStore(patches)
    nbytes = sum(store.length(n) * store.dim(n) * 4 for n in names)
    for f in files:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    def read_all():  # one bag at a time, each array dropped before the next
        t0 = time.perf_counter()
        for n in names:
            store.get(n)
        return time.perf_counter() - t0

    cold = read_all()
    warm = read_all()
    src = store.get(names[-1])
    dst = np.empty_like(src)
    np.copyto(dst, src)  # touch the destination pages first
    t0 = time.perf_counter()
    for n in names:  # the same bytes, bag by bag, memory to memory
        rows = store.length(n)
        np.copyto(dst[:rows], src[:rows]) if rows <= len(src) else np.copyto(
            np.empty((rows, src.shape[1]), np.float32), 0.0)
    copy = time.perf_counter() - t0
    gb = nbytes / 1e9
    split = {"bytes": nbytes, "cold_s": cold, "page_cache_s": warm, "memcpy_s": copy,
             "cold_gbps": gb / cold, "page_cache_gbps": gb / warm, "memcpy_gbps": gb / copy,
             "eviction_took_effect": cold > 1.5 * warm}
    log(f"phase 29 (a): bag reads, {len(names)} bags, {gb:.3f} GB: cold {cold * 1e3:.1f} ms "
        f"({split['cold_gbps']:.2f} GB/s), page cache {warm * 1e3:.1f} ms "
        f"({split['page_cache_gbps']:.2f} GB/s), memcpy {copy * 1e3:.1f} ms "
        f"({split['memcpy_gbps']:.2f} GB/s); eviction by posix_fadvise "
        f"{'took effect' if split['eviction_took_effect'] else 'did not take effect'}; "
        "reads one bag at a time into a fresh array")
    log(json.dumps({"phase29_native": {str(k): {kk: vv for kk, vv in v.items() if kk != "params"}
                                       for k, v in runs.items()}, "read_split": split}))
    return runs


def p29_profile(dev, root, paths, power, add) -> None:
    """(b) ``cli profile`` and ``train --profile-dir`` then ``profile
    --trace-dir``: both reports name the port's kernels, and agree: every
    kernel of the training epochs is in the fit's report."""
    from multimodal_path_omic_tpu_torch.train.profiling import CATEGORIES, parse_trace

    port_cats = {part for frag, part in CATEGORIES if "kernel" in part or "flash" in part}
    cfg = tool_yaml(root, "profile", "nacagat.yaml", paths, {**TOOL_SET, "training.epochs": 1})
    before = read_counts()
    d1, d2 = os.path.join(root, "trace_profile"), os.path.join(root, "trace_train")
    t0 = time.perf_counter()
    rep1 = cli_out(["profile", "--config", cfg, "--trace-dir", d1, "--epochs", "1", "--top", "12"])
    t1 = time.perf_counter()
    cli_out(["train", "--config", cfg, "--profile-dir", d2])
    rep2 = cli_out(["profile", "--trace-dir", d2, "--top", "12"])
    add(read_counts(), before)
    kernels = []
    for d in (d1, d2):
        s = parse_trace(d)
        if s["fallback_track"]:
            raise AssertionError(f"{d}: the trace has no device track")
        kernels.append({r["name"] for r in s["ops"] if r["category"] in port_cats})
    # cli profile traces training epochs; train --profile-dir the whole fit,
    # whose validation adds the export passes
    if not kernels[0] or not kernels[0] <= kernels[1]:
        raise AssertionError(f"profile reports: port kernels {sorted(kernels[0])} not among "
                             f"{sorted(kernels[1])}")
    for line in rep1.splitlines()[:6]:
        log(f"  cli profile: {line}")
    log(f"phase 29 (b): cli profile {t1 - t0:.1f} s, train --profile-dir + profile --trace-dir "
        f"{time.perf_counter() - t1:.1f} s; both name the port's kernels "
        f"{sorted(k[:40] for k in kernels[0])} ({power})")
    log(f"  profile --trace-dir: {rep2.splitlines()[2] if len(rep2.splitlines()) > 2 else rep2}")


def p29_plan(dev, root, paths, power, add, medium_peak) -> None:
    """(c) ``cli plan`` for NaCAGaT medium and big and GE medium (exit 0:
    fits); each plan's worst step peak against a real epoch's
    ``max_memory_allocated`` (medium: (a)'s)."""
    import re

    import torch

    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    ge_set = {**GE_TRAINER_SET, "tpu.bag_buckets": list(BUCKETS), "tpu.device_cache": "off"}
    cases = (("NaCAGaT medium", "nacagat.yaml", TOOL_SET),
             ("NaCAGaT big", "nacagat.yaml", {**TOOL_SET, "model.model_size": "big"}),
             ("GE medium", "ge_nacagat.yaml", ge_set))
    for what, example, overrides in cases:
        cfg = tool_yaml(root, "plan_" + what.replace(" ", "_"), example, paths,
                        {**overrides, "training.epochs": 1})
        before = read_counts()
        t0 = time.perf_counter()
        report = cli_out(["plan", "--config", cfg])
        plan_s = time.perf_counter() - t0
        peaks = [float(m.replace(",", "")) * 2**20
                 for m in re.findall(r"peak ([\d,\.]+) MiB", report)]
        if not peaks:
            raise AssertionError(f"plan {what}: no step peak in\n{report}")
        real = medium_peak
        if real is None:
            from multimodal_path_omic_tpu_torch.config import load_config

            trainer = Trainer(load_config(cfg), verbose=False)
            trainer.train_epoch(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer.train_epoch(1)
            torch.cuda.synchronize()
            real = torch.cuda.max_memory_allocated()
            del trainer
            torch.cuda.empty_cache()
        add(read_counts(), before)
        medium_peak = None
        log(f"phase 29 (c): plan {what} in {plan_s:.1f} s: step peaks "
            f"{[round(p / 2**30, 3) for p in peaks]} GiB (eager, one step), a graphed epoch's "
            f"peak {real / 2**30:.3f} GiB (ratio {max(peaks) / real:.3f}); "
            f"{report.splitlines()[-1]} ({power})")


def p29_cv_sweep(dev, root, paths, power, add) -> None:
    """(d) ``cv`` (k = 2) and ``sweep`` (two points), one epoch each."""
    cfg = tool_yaml(root, "cv", "nacagat.yaml", paths, {**TOOL_SET, "training.epochs": 1})
    before = read_counts()
    t0 = time.perf_counter()
    cv_out = os.path.join(root, "cv.json")
    cli_out(["cv", "--config", cfg, "--folds", "2", "--out", cv_out])
    t1 = time.perf_counter()
    sw_out = os.path.join(root, "sweep.json")
    cli_out(["sweep", "--config", cfg, "--grid", "training.lr=0.0001,0.0002", "--out", sw_out])
    add(read_counts(), before)
    cv, sw = json.load(open(cv_out)), json.load(open(sw_out))
    if len(cv["folds"]) != 2 or len(sw["rows"]) != 2 or not all(
            math.isfinite(r["val_loss"]) for r in cv["folds"] + sw["rows"]):
        raise AssertionError(f"cv {cv} / sweep {sw}: not two finite runs each")
    log(f"phase 29 (d): cv k=2 in {t1 - t0:.1f} s ({cv['metric']} {cv['mean']:.4f} ± "
        f"{cv['std']:.4f}), sweep of 2 points in {time.perf_counter() - t1:.1f} s (best "
        f"{sw['best']['point']}) ({power})")


def p29_bundles(dev, root, power, add) -> None:
    """(e) Bundles of NaCAGaT ces and cesar, MCAT lean=False and GE (medium,
    random weights from seed 0): each exported, loaded on the card and held
    against the card's Predictor within 1e-5 at the same batch size, its
    custom ops' kernels launched (counts from 0 before the bundle's calls);
    NaCAGaT ces exported on the CPU and moved; the bfloat16-weight bundle's
    bytes; ``server --bundle``'s HTTP answers against the Predictor."""
    import threading

    import torch

    from multimodal_path_omic_tpu_torch.deploy import ExportedModel, export_model
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.server import make_bundle_server

    rng = np.random.default_rng(29)
    bags, omics = serve_bags(rng, 12, (1500, BUNDLE_BUCKET), SIZES)
    kw = dict(omic_sizes=SIZES, model_size="medium", buckets=(BUNDLE_BUCKET,),
              batch_size=BUNDLE_B, seed=0)
    cases = (("NaCAGaT ces", dict(model_name="NaCAGaT", loss="ces"), WANT["ces"]),
             ("NaCAGaT cesar", dict(model_name="NaCAGaT", loss="cesar"), WANT["cesar"]),
             ("MCAT lean=False", dict(model_name="MCAT", loss="ces", lean=False),
              ("coattn_plain",)),
             ("GE medium", dict(model_name="GE-NaCAGaT"), ("milpool", "flash_fwd")))
    dirs = {}
    for what, args, want in cases:
        ge = args["model_name"].startswith("GE")
        ckw = {k: v for k, v in kw.items() if not (ge and k == "omic_sizes")}
        pred = Predictor(**args, **ckw, device=dev)
        out_dir = os.path.join(root, "bundle_" + what.split()[0] + "_" + what.split()[1])
        t0 = time.perf_counter()
        if what == "NaCAGaT ces":  # traced on the CPU, moved to the card on load
            export_model(Predictor(**args, **ckw, device="cpu"), out_dir, buckets=(BUNDLE_BUCKET,),
                         batch_sizes=(BUNDLE_B,), platforms=("cuda",))
        else:
            export_model(pred, out_dir, buckets=(BUNDLE_BUCKET,), batch_sizes=(BUNDLE_B,),
                         platforms=("cuda",))
        export_s = time.perf_counter() - t0
        dirs[what] = out_dir
        bundle = ExportedModel(out_dir, device=dev)
        bundle.warmup()
        ref = pred.predict_bags(bags, None if ge else omics)
        torch.cuda.synchronize()
        reset_counts()
        got = bundle.predict_bags(bags, None if ge else omics)
        counts = {k: v for k, v in read_counts().items() if v}
        add(counts, {})
        missing = [w for w in want if not any(k.startswith(w) for k in counts)]
        if missing:
            raise AssertionError(f"bundle {what}: no launch of {missing} ({counts})")
        err = max(float(np.abs(got[k] - ref[k]).max()) for k in got)
        if not err <= 1e-5 or not all(np.isfinite(v).all() for v in got.values()):
            raise AssertionError(f"bundle {what}: {err:.3e} from the card's Predictor")
        man = bundle.manifest
        log(f"phase 29 (e): bundle {what}: exported on {man['exported_on']} in {export_s:.1f} s, "
            f"{os.path.getsize(os.path.join(out_dir, man['artifacts'][f'{BUNDLE_BUCKET}:{BUNDLE_B}'])) / 2**20:.1f}"
            f" MiB; on the card {err:.2e} from the Predictor over {len(bags)} bags; launches "
            f"{counts} ({power})")
        del pred, bundle
        torch.cuda.empty_cache()
    # the bfloat16-weight bundle of NaCAGaT ces
    pred = Predictor(model_name="NaCAGaT", loss="ces", **kw, device=dev)
    b16 = os.path.join(root, "bundle_bf16")
    export_model(pred, b16, buckets=(BUNDLE_BUCKET,), batch_sizes=(BUNDLE_B,),
                 platforms=("cuda",), weights_dtype="bfloat16")
    name = f"b{BUNDLE_BUCKET}_n{BUNDLE_B}.pt2"
    s32 = os.path.getsize(os.path.join(dirs["NaCAGaT ces"], name))
    s16 = os.path.getsize(os.path.join(b16, name))
    got16 = ExportedModel(b16, device=dev).predict_bags(bags, omics)
    ref = pred.predict_bags(bags, omics)
    d16 = float(np.abs(got16["risk"] - ref["risk"]).max())
    if not s16 < 0.65 * s32:
        raise AssertionError(f"bf16 bundle {s16} bytes against {s32}")
    log(f"phase 29 (e): bfloat16-weight bundle {s16 / 2**20:.1f} MiB against {s32 / 2**20:.1f} "
        f"MiB (float32); risk within {d16:.3e} of the float32 Predictor")
    # server --bundle over HTTP
    server = make_bundle_server(dirs["NaCAGaT ces"], port=0, device=dev)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        before = read_counts()
        status, body = http(base + "/predict_batch_npz", npz_bytes(bags=bags, omics_list=omics))
        add(read_counts(), before)
    finally:
        server.shutdown()
        server.server_close()
    if status != 200:
        raise AssertionError(f"server --bundle: {status} {body}")
    err = float(np.abs(np.asarray(body["risk"]) - ref["risk"]).max())
    if not err <= 1e-5:
        raise AssertionError(f"server --bundle: risk {err:.3e} from the Predictor")
    log(f"phase 29 (e): server --bundle /predict_batch_npz of {len(bags)} bags: risk within "
        f"{err:.2e} of the card's Predictor")


def p29_remat(dev, power, add) -> None:
    """(f) NaCAGaT medium and big and GE medium: three graphed training steps
    with remat on and off, dropout 0.25: parameters bit for bit; each one's
    peak memory and step ms (steps 2-3, CUDA events)."""
    import torch

    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train.loop import init_train_state, make_train_step
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    rng = np.random.default_rng(30)
    bags, omics = serve_bags(rng, 16, (1500, TRAIN_M), SIZES)
    nb = {"wsi": torch.zeros((16, TRAIN_M, 1024), device=dev),
          "mask": torch.zeros((16, TRAIN_M), dtype=torch.bool, device=dev)}
    for r, b in enumerate(bags):
        nb["wsi"][r, :len(b)] = torch.from_numpy(b).to(dev)
        nb["mask"][r, :len(b)] = True
    nb.update(omics=[torch.from_numpy(np.stack([o[j] for o in omics])).to(dev)
                     for j in range(len(SIZES))],
              label=torch.from_numpy(rng.integers(0, 4, 16)).to(dev),
              censorship=torch.from_numpy(rng.integers(0, 2, 16).astype(np.float32)).to(dev),
              survival_months=torch.from_numpy(rng.uniform(1, 100, 16).astype(np.float32)).to(dev),
              weight=torch.ones(16, device=dev))
    ge_batch = stage_ge_train_batch(dev, [b[:7000] for b in bags[:GE_B]], m_len=TRAIN_M)
    for what, name, size, loss, batch in (("NaCAGaT medium", "NaCAGaT", "medium", "cesar", nb),
                                           ("NaCAGaT big", "NaCAGaT", "big", "cesar", nb),
                                           ("GE medium", "GE-NaCAGaT", "medium", "ce", ge_batch)):
        res = {}
        for on in (False, True):
            ge = name.startswith("GE")
            model = seeded_init_(build_model(name, omic_sizes=() if ge else SIZES,
                                             model_size=size, dropout=TRAIN_RATE), 0).to(dev)
            opt = make_optimizer("adam", 2e-4, 1e-5)
            state = init_train_state(model, opt, seed=0)
            step = make_train_step(model, loss, opt, ge_mode=ge,
                                   omic_sizes=None if ge else SIZES, remat=on)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = read_counts()
            state, _ = step(state, batch)  # warm-up and capture
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REMAT_STEPS - 1):
                state, m = step(state, batch)
            stop.record()
            torch.cuda.synchronize()
            add(read_counts(), before)
            res[on] = dict(ms=start.elapsed_time(stop) / (REMAT_STEPS - 1),
                           peak=torch.cuda.max_memory_allocated(), loss=float(m.loss),
                           params=[p.detach().clone() for p in model.parameters()],
                           gen=state.generator.get_state())
            del model, state, step
        if res[True]["loss"] != res[False]["loss"] or not all(
                torch.equal(a, b) for a, b in zip(res[True]["params"], res[False]["params"])) \
                or not torch.equal(res[True]["gen"], res[False]["gen"]):
            raise AssertionError(f"remat {what}: not bit for bit the step without it")
        log(f"phase 29 (f): remat {what}, {REMAT_STEPS} graphed steps, dropout {TRAIN_RATE}: "
            f"parameters and generator bit for bit; peak {res[False]['peak'] / 2**30:.3f} -> "
            f"{res[True]['peak'] / 2**30:.3f} GiB, step {res[False]['ms']:.2f} -> "
            f"{res[True]['ms']:.2f} ms ({power})")
        log(json.dumps({"phase29_remat": what, **{f"{k}_{on}": v for on in (False, True)
                                                  for k, v in res[on].items()
                                                  if k in ("ms", "peak", "loss")}}))
        del res
        torch.cuda.empty_cache()


def phase29_tooling(dev, parts: str = "abcdef") -> dict:
    """The tooling on the card (see the module doc); ``parts``: which of
    (a)-(f) to run. Returns the launches of the phase's runs on the card."""
    import shutil
    import tempfile

    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    total = {}

    def add(after, before):
        for k, v in after.items():
            if v - before.get(k, 0):
                total[k] = total.get(k, 0) + v - before.get(k, 0)

    root = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    try:
        t0 = time.perf_counter()
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **TRAINER_COHORT)
        log(f"phase 29: cohort written in {time.perf_counter() - t0:.1f} s")
        steps, native = [], {}
        for part, run in (("a", lambda: p29_native(dev, root, paths, power, add)),
                          ("b", lambda: p29_profile(dev, root, paths, power, add)),
                          ("c", lambda: p29_plan(dev, root, paths, power, add,
                                                 native.get(False, {}).get("peak"))),
                          ("d", lambda: p29_cv_sweep(dev, root, paths, power, add)),
                          ("e", lambda: p29_bundles(dev, root, power, add)),
                          ("f", lambda: p29_remat(dev, power, add))):
            if part not in parts:
                continue
            t0 = time.perf_counter()
            out = run()
            if part == "a":
                native = out
            steps.append(f"({part}) {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 29: {time.perf_counter() - t_phase:.1f} s ({', '.join(steps)}; {power})")
    return total


# Phase 30: the mesh settings the port first refused, on the one card with gloo
# ranks sharing it (NCCL refuses two ranks on one device), phase 28's
# cohort and model (NaCAGaT medium, random weights from seed 0). (a) cox at
# data 2: MESH_STEPS SGD steps host-fed and cached, then the eval step,
# against one rank; (b) the attention-map export at seq 2: the eval step's
# co-attention map with need_attention, the export passes per rank on
# merged statistics, against the one-rank kernel map, on a batch whose bag
# 0 has its valid patches in seq rank 0's half only and bag 1 none; (c)
# ``server.main`` over two ranks at data 2 (rank 0 answers HTTP, rank 1
# follows), its answers against a one-rank Predictor in this process, then
# SIGTERM to both.
P30_SERVE_COHORT = dict(n_patients=8, n_genes=600, n_signatures=6, bag_lengths=(1500, 4000),
                        embedding_dim=1024, bag_format="npy", seed=3)
P30_SERVE_SET = {"tpu.bag_buckets": [4096], "tpu.batch_size": 4, "training.seed": 0,
                 "dataset.tcga_only": False, "training.loss": "ces"}
P30_LATENCY_CALLS = 5
P30_BAD = ("malformed", "wrong width")  # (c)'s requests answered 400; every other one 200
P30_MAP_RTOL, P30_MAP_ATOL = 1e-4, 1e-7  # the export passes' w against their plain version


def p30_export_batch(dev):
    """Phase 28's first host batch with bag 0's valid patches in seq rank
    0's half only and bag 1 without a valid patch."""
    batch = mesh_host_batch(mesh_cohort(), list(range(*MESH_ROWS[0])), dev)
    mask = batch["mask"].clone()
    mask[0, MESH_M // 2 - 100:] = False
    mask[1] = False
    batch["mask"] = mask
    return batch


def p30_export(dev, mesh):
    """(b): the eval step's co-attention map (``need_attention``, loss ces),
    on the CPU host; the kernel launches of that call."""
    import torch

    from multimodal_path_omic_tpu_torch.parallel.mesh import shard_batch
    from multimodal_path_omic_tpu_torch.train import loop

    net, _, _ = mesh_model(dev, "NaCAGaT", mesh)
    batch = p30_export_batch(dev)
    if mesh is not None:
        batch = shard_batch(batch, mesh, process_local=False)
    step = loop.make_eval_step(net, "ces", need_attention=True, omic_sizes=SIZES, mesh=mesh,
                               graphs=False)
    torch.cuda.synchronize()
    reset_counts()
    res = step(batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    return {"map": res["attention"]["coattn"].cpu(), "risk": res["risk"].cpu(),
            "launches": launches}


def p31_export(dev, mesh):
    """Phase 31 (d): :func:`p30_export` at P31_GROUPS signature groups (a
    NaCAGaT medium of P31_SIZES, phase 30's export batch with omics of those
    widths from a numpy seed): the map and the launches of that call."""
    import torch

    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.parallel.mesh import shard_batch
    from multimodal_path_omic_tpu_torch.train import loop
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    net = seeded_init_(build_model("NaCAGaT", omic_sizes=P31_SIZES, model_size="medium",
                                   dropout=TRAIN_RATE, mesh=mesh), 0).to(dev)
    batch = p30_export_batch(dev)
    rng = np.random.default_rng(31)
    batch["omics"] = [torch.from_numpy(rng.standard_normal((MESH_B, s), dtype=np.float32)).to(dev)
                      for s in P31_SIZES]
    if mesh is not None:
        batch = shard_batch(batch, mesh, process_local=False)
    step = loop.make_eval_step(net, "ces", need_attention=True, omic_sizes=P31_SIZES, mesh=mesh,
                               graphs=False)
    torch.cuda.synchronize()
    reset_counts()
    res = step(batch)
    torch.cuda.synchronize()
    return {"map": res["attention"]["coattn"].cpu(),
            "launches": {k: v for k, v in read_counts().items() if v}}


def _p30_rank(rank, world, port, job, arg, out_dir):
    """One spawned rank of phase 30: a gloo process group on the card, then
    (a) and (b) (``job`` "steps") or ``server.main`` (``job`` "serve",
    ``arg`` its argv); the results and kernel launches to ``out_dir``."""
    import datetime

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    import torch
    import torch.distributed as dist

    from multimodal_path_omic_tpu_torch.device import resolve_device
    from multimodal_path_omic_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device("cuda:0")
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    res = {}
    if job == "steps":
        mesh = make_mesh(2, 1, device=dev, backend="gloo")
        reset_counts()
        res["host"] = mesh_steps(dev, mesh, cached=False, loss="cox")
        res["cached"] = mesh_steps(dev, mesh, cached=True, loss="cox")
        torch.cuda.synchronize()
        res["cox_launches"] = {k: v for k, v in read_counts().items() if v}
        res["export"] = p30_export(dev, make_mesh(1, 2, device=dev, backend="gloo"))
        res["export50"] = p31_export(dev, make_mesh(1, 2, device=dev, backend="gloo"))
    else:
        from multimodal_path_omic_tpu_torch import server

        reset_counts()
        res["rc"] = server.main(arg)
        torch.cuda.synchronize()
        res["launches"] = {k: v for k, v in read_counts().items() if v}
    dist.barrier()
    torch.save(res, os.path.join(out_dir, f"{rank}.pt"))
    dist.destroy_process_group()


def p30_world(job, arg=None, client=None) -> list:
    """Spawn two ranks on the card for ``job``; ``client(processes)`` runs
    in this process meanwhile (the HTTP client of (c)). Their results in
    rank order; a rank that dies, exits non-zero or outlives MESH_TIMEOUT_S
    raises."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_p30_rank, args=(2, port, job, arg, out_dir), nprocs=2,
                                 join=False, start_method="spawn")
        try:
            if client is not None:
                client(ctx.processes)
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    raise TimeoutError(f"phase 30 {job}: ranks still running after "
                                       f"{MESH_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        codes = [p.exitcode for p in ctx.processes]
        if codes != [0, 0]:
            raise AssertionError(f"phase 30 {job}: rank exit codes {codes}")
        log(f"  {job}: 2 ranks in {time.perf_counter() - t0:.1f} s, exit codes {codes}")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(2)]


def p30_requests(rng, sizes):
    """(name, path, body) of (c)'s requests: single bags, a batch, MC
    dropout, two malformed bodies (named in ``P30_BAD``), the health line;
    ``sizes``: the model's signature widths."""
    bags = [rng.standard_normal((int(n), 1024), dtype=np.float32) for n in (1800, 3900, 2500)]
    omics = [[rng.standard_normal(s, dtype=np.float32) for s in sizes] for _ in bags]
    reqs = [("healthz", "/healthz", None)]
    reqs += [(f"predict_npz {i}", "/predict_npz", npz_bytes(bags[i % 2], omics[i % 2]))
             for i in range(P30_LATENCY_CALLS)]
    reqs += [("predict_batch_npz", "/predict_batch_npz", npz_bytes(bags=bags,
                                                                  omics_list=omics)),
             ("mc", "/predict_npz?mc=4&mc_seed=7", npz_bytes(bags[2], omics[2])),
             ("malformed", "/predict_npz", b"not an npz"),
             ("wrong width", "/predict_npz", npz_bytes(bags[0][:, :1000], omics[0])),
             ("after", "/predict_npz", npz_bytes(bags[0], omics[0]))]
    return reqs


def p30_serve(dev, root) -> dict:
    """(c): two ranks run ``server.main`` at data 2 over gloo; this process
    sends the requests, holds each answer to a one-rank Predictor's on the
    same config (a single bag padded to two rows, as on the mesh: the MC
    draws are the padded batch's), then SIGTERMs both ranks."""
    import signal

    import torch

    from multimodal_path_omic_tpu_torch.config import load_config
    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.server import make_server

    paths = make_synthetic_cohort(os.path.join(root, "p30_cohort"), **P30_SERVE_COHORT)
    cfg = tool_yaml(root, "p30", "nacagat.yaml", paths, P30_SERVE_SET)
    mesh_cfg = tool_yaml(root, "p30_mesh", "nacagat.yaml", paths,
                         {**P30_SERVE_SET, "tpu.data_axis": 2})
    http_port = free_port()
    argv = ["--config", mesh_cfg, "--port", str(http_port)]
    pred = Predictor.from_config(load_config(cfg))
    pred.min_rows = 2
    reqs = p30_requests(np.random.default_rng(30), pred.omic_sizes)
    answers, latency = {}, []

    def client(processes):
        url = f"http://127.0.0.1:{http_port}"
        t0 = time.perf_counter()
        while True:
            try:
                http(url + "/healthz")
                break
            except OSError:
                if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    raise
                time.sleep(0.2)
        log(f"  rank 0 serving after {time.perf_counter() - t0:.1f} s")
        try:
            for name, path, body in reqs:
                t1 = time.perf_counter()
                answers[name] = http(url + path, body)
                if name.startswith("predict_npz"):
                    latency.append(time.perf_counter() - t1)
        finally:
            for p in processes:  # as torchrun signals every rank
                os.kill(p.pid, signal.SIGTERM)

    ranks = p30_world("serve", argv, client)
    if [r["rc"] for r in ranks] != [0, 0]:
        raise AssertionError(f"phase 30 (c): server.main returned {[r['rc'] for r in ranks]}")
    for r, rr in enumerate(ranks):
        if not rr["launches"].get("coattn_fwd_fused_k"):
            raise AssertionError(f"phase 30 (c): coattn_fwd_fused_k did not launch on rank {r}")
        log(f"  rank {r} launches {rr['launches']}")
    srv = make_server(pred, port=0)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ref = {name: http(f"http://127.0.0.1:{srv.server_address[1]}{path}", body)
               for name, path, body in reqs}
    finally:
        srv.shutdown()
        srv.server_close()
    for name, (code, body) in answers.items():
        ref_code, ref_body = ref[name]
        want = 400 if name in P30_BAD else 200
        if not code == ref_code == want:
            raise AssertionError(f"phase 30 (c) {name}: status {code}, one rank {ref_code}, "
                                 f"want {want}: {str(body)[:300]}")
        if code != 200 or name == "healthz":
            continue
        for key, want in ref_body.items():
            check_close(f"phase 30 (c) {name} {key}", torch.tensor(body[key]),
                        torch.tensor(want), MESH_OUT_ATOL)
    log(f"  answers equal one rank's within {MESH_OUT_ATOL}; /predict_npz latency (client "
        f"clock, 2 ranks over gloo on one card) {[round(x * 1e3, 1) for x in latency]} ms; "
        f"both ranks exited 0 after SIGTERM")
    return {k: ranks[0]["launches"].get(k, 0) + ranks[1]["launches"].get(k, 0)
            for k in set(ranks[0]["launches"]) | set(ranks[1]["launches"])}


def free_port() -> int:
    """A free localhost port (released before use)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase30_mesh_settings(dev) -> dict:
    """(a)-(c); returns the kernel launches of every rank's main-path runs,
    summed."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    log("phase 30 (a): NaCAGaT medium, the cox loss at data 2 (risk sets over the global "
        f"batch), {MESH_STEPS} SGD steps host-fed and cached and the eval step, two ranks on "
        "the card over gloo, against one rank; (b) the co-attention map at seq 2")
    ref = {"host": mesh_steps(dev, None, cached=False, loss="cox"),
           "cached": mesh_steps(dev, None, cached=True, loss="cox")}
    ref_map = p30_export(dev, None)
    ref_map50 = p31_export(dev, None)
    res = p30_world("steps")
    total = {}
    for r, rr in enumerate(res):
        for name in ("gather_rows", "coattn_fwd_fused_k_train", "coattn_bwd_fused_k",
                     "coattn_fwd_fused_k"):
            if not rr["cox_launches"].get(name):
                raise AssertionError(f"phase 30 (a): {name} did not launch on rank {r}")
        for name in ("coattn_stats", "coattn_weights"):
            if not rr["export"]["launches"].get(name):
                raise AssertionError(f"phase 30 (b): {name} did not launch on rank {r}")
        for part in (rr["cox_launches"], rr["export"]["launches"]):
            for name, v in part.items():
                total[name] = total.get(name, 0) + v
        log(f"  rank {r}: cox launches {rr['cox_launches']}; export launches "
            f"{rr['export']['launches']}")
    for way in ("host", "cached"):
        mesh_same_across_ranks(f"30 (a) {way}", [r[way] for r in res], "params")
        for r in res:
            mesh_close(f"30 (a) {way} losses", r[way]["losses"], ref[way]["losses"])
            mesh_close(f"30 (a) {way} eval loss", r[way]["eval_loss"], ref[way]["eval_loss"])
            check_close(f"phase 30 (a) {way} eval risk", r[way]["eval_risk"],
                        ref[way]["eval_risk"], MESH_OUT_ATOL)
        worst = mesh_params_close(f"30 (a) {way}", res[0][way]["params"], ref[way]["params"])
        log(f"  cox {way}: losses {res[0][way]['losses']} (one rank {ref[way]['losses']}), eval "
            f"loss {res[0][way]['eval_loss']} ({ref[way]['eval_loss']}); parameters bitwise "
            f"equal across ranks, within {worst:.2e} of one rank's; step s on rank 0 (eager, "
            f"gloo) {[round(x, 4) for x in res[0][way]['step_s']]}")
    for r, rr in enumerate(res):
        got = rr["export"]["map"]
        check_close(f"phase 30 (b) rank {r} map", got, ref_map["map"], P30_MAP_ATOL,
                    P30_MAP_RTOL)
        if float(got[0, :, MESH_M // 2:].abs().max()) != 0.0:
            raise AssertionError("phase 30 (b): bag 0 has weight on rank 1's masked keys")
        if not torch.equal(got[1], torch.full_like(got[1], 1.0 / MESH_M)):
            raise AssertionError("phase 30 (b): the bag without a valid key is not uniform "
                                 "over the global M")
    log(f"  map [{', '.join(map(str, res[0]['export']['map'].shape))}] equal on both ranks' "
        "checks; bag 1 exactly 1/M")
    for r, rr in enumerate(res):  # phase 31 (d): the same at P31_GROUPS queries
        got, launched = rr["export50"]["map"], rr["export50"]["launches"]
        check_close(f"phase 31 (d) rank {r} map of {P31_GROUPS} queries", got,
                    ref_map50["map"], P30_MAP_ATOL, P30_MAP_RTOL)
        if not (launched.get("coattn_stats_slabs") and launched.get("coattn_weights_slabs")):
            raise AssertionError(f"phase 31 (d): rank {r} launched {launched}")
        if float(got[0, :, MESH_M // 2:].abs().max()) != 0.0 or not torch.equal(
                got[1], torch.full_like(got[1], 1.0 / MESH_M)):
            raise AssertionError("phase 31 (d): bag 0 off rank 0's keys or bag 1 not 1/M")
        for name, v in launched.items():
            total[name] = total.get(name, 0) + v
        log(f"  phase 31 (d) rank {r}: the seq-2 map [{', '.join(map(str, got.shape))}] at "
            f"{P31_GROUPS} queries against the one-rank kernel map; launches {launched}")
    del ref, ref_map, ref_map50, res
    torch.cuda.empty_cache()
    log("phase 30 (c): server.main over two ranks at data 2 (rank 0 answers HTTP, rank 1 "
        "follows), against a one-rank Predictor, then SIGTERM")
    with tempfile.TemporaryDirectory() as root:
        for name, v in p30_serve(dev, root).items():
            total[name] = total.get(name, 0) + v
    log(f"phase 30: {time.perf_counter() - t_phase:.1f} s ({gpu_name_and_power()}; two ranks "
        "share one card over host-staged gloo: not a multi-GPU speed)")
    return total


# Phase 31: the plain-K kernels past eight queries, the JAX kernels' range of
# signature groups (the slab instances: csrc/coattn_many.cu, csrc/coattn_bwd_many.cu;
# a Hallmark-sized signature file has 50 groups).
# (a) The forward with values (eval and training forms), its backward and
# the two export passes against their plain versions at P31_B bags of N in
# P31_NS queries, D in P31_DS, in both types, with and without the pre-gate,
# on P31_CASES' masks (masked 64-key tiles mid-bag; a bag with one valid
# key; each batch's last bag without a valid key): the forward and backward
# at phase 27's bars (plain27_check), the export passes at phase 1's (m
# KERNEL_ATOL; w W_RTOL relative above W_ATOL; bfloat16 check_bf16's), float32
# l within P31_F32_L_RTOL relative, with a float64 witness (p31_l_witness:
# the kernels' l no farther from the float64 l than P31_WITNESS times the
# plain version's, and a TF32 control past the bar), two runs bitwise equal,
# exactly 0 through masked keys, a bag without a valid key at l = M, m =
# NEG, w = 1/M; the drop share of the Philox bits where a batch holds >=
# 800,000 draws. (b) At B = 32, M = 8192 (phase 16's ragged prefix masks), N
# in P31_TIME_NS, D in P31_TIME_DS, float32, and bfloat16 at N = 50, D =
# 256: the four kernels held to their plain versions on the inputs they are
# timed on, as in (a); then CUDA-event times of each kernel, its plain
# version, the attention_core route it replaces (the map for the export
# passes; autograd's backward for the backward) and, without the pre-gate,
# scaled_dot_product_attention; the byte bound, the operations bound (the
# forward with values and its backward on the tensor cores: 3xTF32, in
# bfloat16 bf16 and 2xTF32 products; the export passes float32 FMA) and the
# float32-FMA bound of each. (c) The entry points at full width (medium) on
# a P31_GROUPS-group synthetic cohort: Trainer.fit of NaCAGaT cesar and
# MCAT ces host-fed and cached (graphed, bit for bit) and NaCAGaT cesar in
# bfloat16 cached, each epoch's co-attention launches held to the
# plan (one slab kernel a step and a validation batch, no other co-attention
# kernel), the eval transformers on flash_fwd_d32 at L = 50, no
# attention_core call on a co-attention site; one epoch on the card and on
# the CPU (dropout 0, P31_CPU_COHORT's shorter bags) within phase 21's
# gates; Predictor.from_config(...).predict_bags (cesar) against the CPU
# Predictor within MODEL_ATOL; cli export-attn on the card against --set
# device=cpu's map within W_RTOL. (d), in phase 30's two-rank spawn: the
# seq-2 export at P31_GROUPS queries against the one-rank kernel map.
P31_NS, P31_DS, P31_B = (9, 50, 256), (128, 256, 512), 4
P31_CASES = ((4000, "holes"), (1500, "one"))
P31_TIME_NS, P31_TIME_DS = (50, 256), (256, 512)
P31_GROUPS = 50
P31_SIZES = tuple(24 + 4 * (j % 8) for j in range(P31_GROUPS))  # (d)'s signature groups
P31_KERNELS = ("coattn_plain_slabs", "coattn_plain_bwd_slabs", "coattn_stats_slabs",
               "coattn_weights_slabs")
P31_COHORT = dict(n_patients=24, n_genes=600, n_signatures=P31_GROUPS,
                  bag_lengths=(1500, 3000, 5000, 8000), embedding_dim=1024, bag_format="npy",
                  seed=6)
P31_SET = {"tpu.bag_buckets": [4096, 8192], "tpu.batch_size": 16, "training.epochs": 1,
           "training.seed": 0, "dataset.tcga_only": False}
P31_CPU_COHORT = {**P31_COHORT, "n_patients": 16, "bag_lengths": (600, 1000, 1500, 2000),
                  "seed": 7}
P31_CPU_SET = {**P31_SET, "tpu.bag_buckets": [1024, 2048], "tpu.device_cache": "off"}
P31_ITERS = 5  # CUDA-event iterations a time in (b): N = 256 calls take milliseconds
# float32 l of the slab instances within P31_F32_L_RTOL relative of the plain
# version, and no farther from the float64 l than P31_WITNESS times the plain
# version's distance (p31_l_witness). The bar is about twice the largest
# reading of sound runs (H100: 2.1e-5 in (a), 2.7e-5 in (b), where the plain
# version sits 2.2e-5 / 2.5e-5 from the float64 l and the kernels 2.8e-6 /
# 8.8e-6), far under the TF32 control's 5.7e-3 / 6.6e-3.
P31_F32_L_RTOL, P31_WITNESS = 5e-5, 2.0


def p31_rows(kind) -> tuple:
    """The kernels line's rows (and count names) of the slab instances."""
    return tuple(name + ("_bf16" if kind == "bf16" else "") for name in P31_KERNELS)


def p31_export_check(q, k, mask, pre_gate, d, bf, errs, rows, tag) -> tuple:
    """The export passes past eight queries against their plain versions
    (check_export's bars, float32 l within P31_F32_L_RTOL; bfloat16:
    check_bf16's). Returns stats' l, the kernel's and the plain version's."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    m_len, has = mask.shape[1], mask.any(-1)
    l, m = coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)
    lp, mp = coattn.coattn_stats_plain(q, k, mask, pre_gate=pre_gate)
    w = coattn.coattn_weights(q, k, mask, lp, mp, pre_gate=pre_gate)
    wp = coattn.coattn_weights_plain(q, k, mask, lp, mp, pre_gate=pre_gate)
    both = coattn.coattention_weights(q, k, mask, pre_gate=pre_gate)
    if bf:
        check_bf16(f"{tag} stats.l", l, lp, "l")
        e_m = check_bf16(f"{tag} stats.m", m, mp, "abs")
        e_w = max(check_bf16(f"{tag} weights.w", w, wp, "w"),
                  check_bf16(f"{tag} coattention_weights", both, wp, "w"))
    else:
        check_close(f"{tag} stats.l", l, lp, 0.0, P31_F32_L_RTOL)
        e_m = check_close(f"{tag} stats.m", m, mp, KERNEL_ATOL)
        e_w = max(check_close(f"{tag} weights.w", w, wp, W_ATOL, W_RTOL),
                  check_close(f"{tag} coattention_weights", both, wp, W_ATOL, W_RTOL))
    errs[rows[2]] = max(errs[rows[2]], e_m)
    errs[rows[3]] = max(errs[rows[3]], e_w)
    again = (*coattn.coattn_stats(q, k, mask, pre_gate=pre_gate),
             coattn.coattn_weights(q, k, mask, lp, mp, pre_gate=pre_gate),
             coattn.coattention_weights(q, k, mask, pre_gate=pre_gate))
    if not all(torch.equal(a, b) for a, b in zip((l, m, w, both), again)):
        raise AssertionError(f"phase 31 {tag}: two runs of the export passes differ")
    masked = (~mask & has[:, None])[:, None, :].expand_as(w)
    if not (bool((w[masked] == 0).all()) and bool((both[masked] == 0).all())):
        raise AssertionError(f"phase 31 {tag}: w is not 0 at a masked key")
    empty = ~has
    if not (bool((l[empty] == m_len).all()) and bool((m[empty] == mp[empty]).all())
            and bool((w[empty] == 1.0 / m_len).all())
            and bool((both[empty] == 1.0 / m_len).all())):
        raise AssertionError(f"phase 31 {tag}: a bag without a valid key is not uniform")
    return l, lp


def p31_l_witness(readings, tag, kernel_ls, plain_l, q, k, mask, pre_gate) -> None:
    """Float32 l against float64's: the largest relative distance from the
    float64 plain version's l of the kernels' l (the forward's and export
    pass 1's), of the float32 plain version's, and of a TF32 control (the
    plain version with its products on TF32 tensor cores, as a kernel that
    rounded its operands to 10 mantissa bits would compute); and the
    kernels' and the control's distance from the float32 plain version,
    the quantity P31_F32_L_RTOL bounds. Largest of each kept in
    ``readings``."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    def rel(a, r):
        return float(((a.double() - r.double()).abs() / r.double().abs()).max())

    l64 = coattn.coattn_fwd_plain_k_plain(q.double(), k.double(), k[..., :1].double(), mask,
                                          None, 0.0, pre_gate=pre_gate)[1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = coattn.coattn_stats_plain(q, k, mask, pre_gate=pre_gate)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got = {"kernel_f64": max(rel(x, l64) for x in kernel_ls), "plain_f64": rel(plain_l, l64),
           "control_f64": rel(ctl, l64), "kernel_plain": max(rel(x, plain_l) for x in kernel_ls),
           "control_plain": rel(ctl, plain_l)}
    for key, val in got.items():
        readings[key] = max(readings.get(key, 0.0), val)
    log(f"  {tag} float32 l, relative: from float64 kernels {got['kernel_f64']:.2e}, plain "
        f"{got['plain_f64']:.2e}, TF32 control {got['control_f64']:.2e}; from the plain "
        f"version kernels {got['kernel_plain']:.2e}, control {got['control_plain']:.2e} "
        f"(bar {P31_F32_L_RTOL:g})")


def p31_hold_witness(readings, what) -> None:
    """The float64 witness over a part's float32 cases: the kernels no
    farther from float64's l than P31_WITNESS times the plain version's
    largest distance, and the TF32 control past P31_F32_L_RTOL (the bar
    tells such a kernel from a sound one)."""
    log(f"phase 31 {what}: float32 l, largest relative distances: from float64 kernels "
        f"{readings['kernel_f64']:.3e}, plain version {readings['plain_f64']:.3e}, TF32 "
        f"control {readings['control_f64']:.3e}; from the plain version kernels "
        f"{readings['kernel_plain']:.3e} (bar {P31_F32_L_RTOL:g}), control "
        f"{readings['control_plain']:.3e}")
    if not readings["kernel_f64"] <= P31_WITNESS * readings["plain_f64"]:
        raise AssertionError(f"phase 31 {what}: the kernels' l sits farther from float64 than "
                             f"{P31_WITNESS}x the plain version's")
    if not readings["control_plain"] > P31_F32_L_RTOL:
        raise AssertionError(f"phase 31 {what}: the TF32 control passes the l bar")


def p31_kernel_checks(dev, errs) -> None:
    """(a)."""
    import torch

    from multimodal_path_omic_tpu_torch.ops import coattn

    readings = {}
    for kind in ("f32", "bf16"):
        rows = p31_rows(kind)
        for n in P31_NS:
            for d in P31_DS:
                for m_len, mask_kind in P31_CASES:
                    for pre_gate in (False, True):
                        tag = f"(a) {kind} N={n} D={d} M={m_len} {mask_kind} pre_gate={pre_gate}"
                        q, k, mask, seed, (lk, lp) = plain27_check(
                            dev, d, kind, m_len, mask_kind, pre_gate, errs, n=n, b=P31_B,
                            rows=rows[:2], phase="31 (a)", l_rtol=P31_F32_L_RTOL)
                        ls, _ = p31_export_check(q, k, mask, pre_gate, d, kind == "bf16", errs,
                                                 rows, tag)
                        if kind == "f32":
                            p31_l_witness(readings, tag, (lk, ls), lp, q, k, mask, pre_gate)
                        if kind == "f32" and d == 128 and pre_gate and n * P31_B * m_len >= 8e5:
                            keep = coattn.dropout_bits(seed, (P31_B, n, m_len), dev) >= \
                                coattn.dropout_threshold(TRAIN_RATE)
                            drop = 1.0 - float(keep.double().mean())
                            log(f"  drop share of the Philox bits over {keep.numel()} draws "
                                f"(N={n}): {drop:.6f} (tolerance {TRAIN_RATE} +- {DROP_TOL})")
                            if abs(drop - TRAIN_RATE) > DROP_TOL:
                                raise AssertionError("phase 31 (a): the dropout bits miss the rate")
                torch.cuda.empty_cache()
    p31_hold_witness(readings, "(a)")


def p31_bounds(name, mask, n, d, pre_gate, esize=4) -> tuple:
    """((bytes ms, operations ms, float32-FMA ms), the larger of the first
    two's name) of a slab kernel at this run's inputs: each input read once
    and each output written once, the k rows over the keys needed (the valid
    keys; the forms with values every key of a bag without one, the export
    passes none) and v alike; the products over the same keys, a
    multiply-add as 2 operations: q.k, the gate with the pre-gate, p.v
    (forward); q.k, the gate, dO.v, dv and two terms each of dq and dk with
    the pre-gate, one each without (backward); q.k and the gate (export
    passes). The operations bound of the forward with values and its
    backward (on the tensor cores): float32 3xTF32, three TF32 products
    each at 495 TFLOP/s; bfloat16 the products of two bfloat16 operands
    (q.k, the gate, dO.v) at 989 TFLOP/s and those of a float32 operand
    (p.v; dv, dq, dk) as the two TF32 products that keep it at float32
    accuracy. The export passes' (CUDA cores): float32 FMA at 67 TFLOP/s,
    in bfloat16 every product at the bfloat16 rate. The float32-FMA time
    of every product rides beside."""
    b, m_len = mask.shape
    valid, filled = int(mask.sum()), valid_keys(mask)
    per = 2 if pre_gate else 1
    if name.startswith("coattn_plain_bwd"):  # + dout, l, m, di, dssq, dsumw; out: dq, dk, dv
        nbytes = esize * (3 * b * n * d + 2 * valid * d + 2 * b * m_len * d) + 4 * 5 * b * n \
            + b * m_len
        scores, values = 2 * n * valid * d * (per + 1), 2 * n * valid * d * (2 * per + 1)
    elif name.startswith("coattn_plain"):  # in: q, k, v, mask; out: o, l, m
        nbytes = esize * (2 * b * n * d + (valid + filled) * d) + 4 * 2 * b * n + b * m_len
        scores, values = 2 * n * d * per * valid, 2 * n * d * filled
    else:  # export: q, k (valid keys), mask; l, m out (stats) or in, and w out (weights)
        nbytes = esize * (b * n * d + valid * d) + 4 * 2 * b * n + b * m_len
        if name.startswith("coattn_weights"):
            nbytes += 4 * b * n * m_len
        scores, values = 2 * per * n * valid * d, 0
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fma = (scores + values) / PEAK_F32_FLOP_PER_S * 1e3
    if not name.startswith("coattn_plain"):
        t_ops = ((scores / PEAK_BF16_FLOP_PER_S * 1e3) if esize == 2 else t_fma)
    elif esize == 2:
        t_ops = (scores / PEAK_BF16_FLOP_PER_S + 2 * values / PEAK_TF32_FLOP_PER_S) * 1e3
    else:
        t_ops = 3 * (scores + values) / PEAK_TF32_FLOP_PER_S * 1e3
    return (t_bytes, t_ops, t_fma), ("bytes" if t_bytes >= t_ops else "operations")


def p31_timings(dev, errs, power) -> list:
    """(b): at each timed shape and pre-gate setting, the four kernels first
    held to their plain versions on the inputs they are timed on (as in
    (a), with the float64 witness), then timed. Returns the kernels line's
    rows (N = 50, D = 256: the forward and backward without the pre-gate,
    MCAT's form; the export passes pre-gated, NaCAGaT cesar's), their
    launches still 0."""
    import torch
    import torch.nn.functional as F

    from multimodal_path_omic_tpu_torch.ops import coattn
    from multimodal_path_omic_tpu_torch.ops.attention import attention_core

    def ms(fn):
        return cuda_ms(fn, iters=P31_ITERS, warmup=1)

    rows, readings = [], {}
    shapes = [(n, d, "f32") for n in P31_TIME_NS for d in P31_TIME_DS] + [(50, 256, "bf16")]
    for n, d, kind in shapes:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        inputs = plain27_inputs(dev, TRAIN_M, d, "prefix", 31, b=B, n=n)
        q, k, v, dout, mask, seed, dssq, dsumw = inputs = tuple(
            t.to(dt) if i < 4 else t for i, t in enumerate(inputs))
        zeros = torch.zeros_like(dssq)
        names = p31_rows(kind)
        t_all = {}
        for pre_gate in (False, True):
            tag = f"(b) {kind} N={n} D={d} M={TRAIN_M} prefix pre_gate={pre_gate}"
            *_, (lk, lp) = plain27_check(dev, d, kind, TRAIN_M, "prefix", pre_gate, errs, n=n,
                                         b=B, rows=names[:2], phase="31 (b)",
                                         l_rtol=P31_F32_L_RTOL, inputs=inputs)
            ls, _ = p31_export_check(q, k, mask, pre_gate, d, kind == "bf16", errs, names, tag)
            if kind == "f32":
                p31_l_witness(readings, tag, (lk, ls), lp, q, k, mask, pre_gate)
            del lk, lp, ls
            torch.cuda.empty_cache()
            o, l, m, _, _ = coattn.coattn_fwd_plain_k_plain(q, k, v, mask, seed, 0.0,
                                                            pre_gate=pre_gate)
            di = (o.float() * dout.float()).sum(-1)
            q4, k4, v4 = (x[:, None] for x in (q, k, v))
            t = {
                names[0]: ms(lambda: coattn.coattn_fwd_plain_k(q, k, v, mask, pre_gate=pre_gate,
                                                                 train=False)),
                names[1]: ms(lambda: coattn.coattn_bwd_plain_k(
                    q, k, v, mask, seed, 0.0, dout, l, m, di, zeros, zeros, pre_gate=pre_gate)),
                names[2]: ms(lambda: coattn.coattn_stats(q, k, mask, pre_gate=pre_gate)),
                names[3]: ms(lambda: coattn.coattn_weights(q, k, mask, l, m, pre_gate=pre_gate)),
                "plain " + names[0]: ms(lambda: coattn.coattn_fwd_plain_k_plain(
                    q, k, v, mask, None, 0.0, pre_gate=pre_gate)),
                "plain " + names[1]: ms(lambda: coattn.coattn_bwd_plain_k_plain(
                    q, k, v, mask, seed, 0.0, dout, zeros, zeros, pre_gate=pre_gate)),
                "plain " + names[2]: ms(lambda: coattn.coattn_stats_plain(q, k, mask,
                                                                         pre_gate=pre_gate)),
                "plain " + names[3]: ms(lambda: coattn.coattn_weights_plain(
                    q, k, mask, l, m, pre_gate=pre_gate)),
                "route " + names[0]: ms(lambda: attention_core(q4, k4, v4, mask,
                                                               pre_gate=pre_gate,
                                                               need_weights=False)),
                "route " + names[2]: ms(lambda: attention_core(q4, k4, v4, mask,
                                                               pre_gate=pre_gate,
                                                               need_weights=True)),
            }
            leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]
            out = attention_core(*leaves, mask, pre_gate=pre_gate, need_weights=False)[0]
            t["route " + names[1]] = ms(lambda: torch.autograd.grad(out, leaves, dout[:, None],
                                                                    retain_graph=True))
            del leaves, out
            if not pre_gate:
                amask = mask[:, None, None, :]
                t["sdpa " + names[0]] = ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=amask))
                leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]
                lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
                t["sdpa " + names[1]] = ms(lambda: torch.autograd.grad(
                    lib_out, leaves, dout[:, None], retain_graph=True))
                del leaves, lib_out
            del q4, k4, v4
            for name in names:
                (tb, to, tf), by = p31_bounds(name, mask, n, d, pre_gate,
                                              2 if kind == "bf16" else 4)
                tc = name.startswith("coattn_plain")  # the tensor-core pair
                rate = (("3xTF32" if kind == "f32" else "bf16 and 2xTF32") if tc else
                        ("bf16 rate" if kind == "bf16" else "float32 FMA"))
                log(f"phase 31 (b): {name} {kind} B={B} N={n} M={TRAIN_M} D={d} "
                    f"pre_gate={pre_gate}: kernel {t[name]:.4f} ms, plain "
                    f"{t['plain ' + name]:.4f} ms, the attention_core route "
                    + (f"{t['route ' + name]:.4f} ms ({t['route ' + name] / t[name]:.2f}x)"
                       if 'route ' + name in t else "(the map's, above)")
                    + (f", scaled_dot_product_attention {t['sdpa ' + name]:.4f} ms "
                       f"({t['sdpa ' + name] / t[name]:.2f}x)" if "sdpa " + name in t else "")
                    + f"; bounds {tb:.4f} ms bytes, {to:.4f} ms {rate}"
                    + (f", {tf:.4f} ms float32 FMA" if tc else "")
                    + f": {by}, {max(tb, to) / t[name]:.3f} reached ({power})")
            t_all[pre_gate] = t
        if n == 50 and d == 256:
            for i, name in enumerate(names):
                pre_gate = i >= 2  # the export rows: NaCAGaT cesar's pre-gated passes
                t = t_all[pre_gate]
                (tb, to, _), by = p31_bounds(name, mask, n, d, pre_gate,
                                             2 if kind == "bf16" else 4)
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": 0, "max_abs_err": errs[name],
                    "ms": t[name], "plain_ms": t["plain " + name], "bound_ms": max(tb, to),
                    "bound_by": by, "library_ms": t.get("sdpa " + name),
                })
        del q, k, v, dout, mask, inputs
        torch.cuda.empty_cache()
    p31_hold_witness(readings, "(b)")
    return rows


@contextlib.contextmanager
def no_coattention_core(what):
    """Fail where a co-attention site (queries and keys of other lengths)
    calls ``ops/attention.py::attention_core``; the transformers'
    self-attention (with dropout: attention_core, as in JAX) may."""
    from multimodal_path_omic_tpu_torch.ops import attention

    core, calls = attention.attention_core, []

    def spy(q, k, *a, **kw):
        if q.shape[-2] != k.shape[-2]:
            calls.append(tuple(q.shape))
        return core(q, k, *a, **kw)

    attention.attention_core = spy
    try:
        yield
    finally:
        attention.attention_core = core
    if calls:
        raise AssertionError(f"phase 31 {what}: attention_core on a co-attention site {calls}")


def p31_fit(what, cfg, want_train, want_val, power):
    """``Trainer.fit`` of ``cfg`` on the card: each epoch's co-attention and
    gather launches held to the plan (a kernel -> launches a step or a
    validation batch), the validation's flash_fwd_d32 launches (the
    transformers at L = P31_GROUPS), no attention_core on a co-attention
    site. Returns (per-epoch summaries, the launches of the run)."""
    import torch

    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, verbose=False)
    calls = instrument(trainer)
    before = read_counts()
    t0 = time.perf_counter()
    with no_coattention_core(what):
        trainer.fit()
    torch.cuda.synchronize()
    launched = _counts_delta(before, read_counts())
    n_steps, n_val = len(trainer.train_batcher), len(trainer.val_batcher)
    for c in calls:
        per = n_steps if c["call"] == "train_epoch" else n_val
        want = {k_: v_ * per for k_, v_ in (want_train if c["call"] == "train_epoch"
                                            else want_val).items()}
        got = {k_: v_ for k_, v_ in c["launches"].items()
               if k_.startswith("coattn_") or k_ == "gather_rows"}
        if got != want:
            raise AssertionError(f"phase 31 {what} {c['call']}: co-attention launches {got}, "
                                 f"expected {want}")
        loss = c["out"]["train_loss" if c["call"] == "train_epoch" else "val_loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"phase 31 {what}: {c['call']} loss not finite")
    val = [c for c in calls if c["call"] == "validate"]
    if not all(any(k_.startswith("flash_fwd_d32") for k_ in c["launches"]) for c in val):
        raise AssertionError(f"phase 31 {what}: the eval transformers at L = {P31_GROUPS} "
                             "did not run flash_fwd_d32")
    log(f"phase 31 (c) {what}: fit in {time.perf_counter() - t0:.2f} s, {n_steps} steps and "
        f"{n_val} validation batches an epoch, launches {launched} as planned, no "
        f"attention_core on a co-attention site; "
        + ", ".join(f"{c['call']}({c['epoch']}) {c['seconds']:.3f} s" for c in calls)
        + f" ({power})")
    return [epoch_summary(calls, e) for e in range(cfg.training.epochs)], launched


def p31_entry_points(dev, power) -> dict:
    """(c). Returns the launches of its runs on the card."""
    import shutil
    import tempfile

    import torch
    import yaml

    from multimodal_path_omic_tpu_torch.config import config_to_dict, load_config
    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort
    from multimodal_path_omic_tpu_torch.serve import Predictor
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_p31_")
    total = {}

    def add(counts):
        for k_, v_ in counts.items():
            total[k_] = total.get(k_, 0) + v_

    try:
        t0 = time.perf_counter()
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **P31_COHORT)
        cpu_paths = make_synthetic_cohort(os.path.join(root, "cpu_cohort"), **P31_CPU_COHORT)
        log(f"phase 31 (c): {P31_GROUPS}-group cohorts written in {time.perf_counter() - t0:.1f} s")
        train_k = {"coattn_plain_slabs": 1, "coattn_plain_bwd_slabs": 1}
        val_k = {"coattn_stats_slabs": 1, "coattn_weights_slabs": 1}
        gather = {"gather_rows": 1}
        runs = (
            ("NaCAGaT cesar host-fed", "nacagat.yaml", {"tpu.device_cache": "off"}, train_k, val_k),
            ("NaCAGaT cesar cached", "nacagat.yaml", {"tpu.device_cache": "on"},
             {**train_k, **gather}, {**val_k, **gather}),
            ("MCAT ces host-fed", "mcat.yaml", {"tpu.device_cache": "off"}, train_k,
             {"coattn_plain_slabs": 1}),
            ("MCAT ces cached", "mcat.yaml", {"tpu.device_cache": "on"}, {**train_k, **gather},
             {"coattn_plain_slabs": 1, **gather}),
            ("NaCAGaT cesar bfloat16 cached", "nacagat.yaml",
             {"tpu.device_cache": "on", "tpu.compute_dtype": "bfloat16"},
             {**{k_ + "_bf16": v_ for k_, v_ in train_k.items()}, **gather},
             {**{k_ + "_bf16": v_ for k_, v_ in val_k.items()}, **gather}),
        )
        ends = {}
        for what, example, over, want_train, want_val in runs:
            cfg = trainer_config(example, paths, os.path.join(root, what.replace(" ", "_")),
                                 {**P31_SET, **over})
            ends[what], launched = p31_fit(what, cfg, want_train, want_val, power)
            add(launched)
            torch.cuda.empty_cache()
        for model in ("NaCAGaT cesar", "MCAT ces"):
            same_bits(f"phase 31 (c) {model} cached vs host-fed", ends[model + " cached"][0],
                      ends[model + " host-fed"][0])
        log("  NaCAGaT cesar and MCAT ces cached == host-fed, bit for bit (losses, validation "
            "risks)")

        log("phase 31 (c): NaCAGaT cesar, one epoch on the card and on the CPU, dropout 0, "
            f"{P31_CPU_COHORT['n_patients']} patients of {P31_CPU_COHORT['bag_lengths']} patches")
        res = {}
        for where in ("cuda", "cpu"):
            cfg = trainer_config("nacagat.yaml", cpu_paths, os.path.join(root, "cpu_" + where),
                                 {**P31_CPU_SET, "model.dropout": 0.0})
            trainer = Trainer(cfg, verbose=False, device=where)
            before = read_counts()
            with no_coattention_core("(c) card vs CPU"):
                train, val = trainer.validated_epoch(0)
            if where == "cuda":
                torch.cuda.synchronize()
                add(_counts_delta(before, read_counts()))
            res[where] = {**train, **val, "risks": trainer.val_risks}
            del trainer
        for key in ("train_loss", "val_loss"):
            rel = abs(res["cuda"][key] - res["cpu"][key]) / abs(res["cpu"][key])
            log(f"  {key}: card {res['cuda'][key]!r}, CPU {res['cpu'][key]!r}, relative "
                f"{rel:.3e} (tolerance {TRAINER_RTOL:g})")
            if not rel <= TRAINER_RTOL:
                raise AssertionError(f"phase 31 (c): the card's {key} disagrees with the CPU")
        err = float(np.abs(res["cuda"]["risks"] - res["cpu"]["risks"]).max())
        log(f"  val risks: card vs CPU max_abs_err {err:.3e} (tolerance {TRAINER_ATOL:g})")
        if not err <= TRAINER_ATOL:
            raise AssertionError("phase 31 (c): the card's validation risks disagree")

        cfg = trainer_config("nacagat.yaml", paths, os.path.join(root, "serve"),
                             {**P31_SET, "tpu.device_cache": "off"})
        cfg_path = os.path.join(root, "nacagat50.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(config_to_dict(cfg), f)
        pred = Predictor.from_config(load_config(cfg_path))
        rng = np.random.default_rng(31)
        sizes = pred.omic_sizes
        bags = [rng.standard_normal((n_, 1024), dtype=np.float32) for n_ in (1500, 8000, 3000, 5000)]
        omics = [[rng.standard_normal(s_, dtype=np.float32) for s_ in sizes] for _ in bags]
        reset_before = read_counts()
        with no_coattention_core("(c) predict_bags"):
            got = pred.predict_bags(bags, omics)
        torch.cuda.synchronize()
        counts = _counts_delta(reset_before, read_counts())
        add(counts)
        co = {k_: v_ for k_, v_ in counts.items() if k_.startswith("coattn_")}
        if set(co) != {"coattn_stats_slabs", "coattn_weights_slabs"}:
            raise AssertionError(f"phase 31 (c) predict_bags: co-attention launches {co}")
        ref = Predictor.from_config(load_config(cfg_path, {"device": "cpu"})).predict_bags(
            bags, omics)
        log(f"phase 31 (c): Predictor.from_config({os.path.basename(cfg_path)}).predict_bags, "
            f"{len(bags)} bags of {P31_GROUPS} signature groups: launches {counts}")
        check_outputs_close("the CPU Predictor", got, ref)

        maps = {}
        for where in ("cuda", "cpu"):
            out_dir = os.path.join(root, "attn_" + where)
            before = read_counts()
            with no_coattention_core("(c) export-attn"):
                cli_run(["export-attn", "--config", cfg_path, "--patient", "P000", "--epoch", "0",
                         "--set", f"training.test_output_dir={out_dir}", "--set",
                         f"device={where}"])
            if where == "cuda":
                torch.cuda.synchronize()
                counts = _counts_delta(before, read_counts())
                add(counts)
                if not (counts.get("coattn_stats_slabs") and counts.get("coattn_weights_slabs")):
                    raise AssertionError(f"phase 31 (c) export-attn: launches {counts}")
            files = sorted(f for f in os.listdir(out_dir) if f.endswith(".npy"))
            maps[where] = np.load(os.path.join(out_dir, files[0]))
        a, r = maps["cuda"], maps["cpu"]
        if a.shape != r.shape or a.shape[0] != P31_GROUPS or not np.isfinite(a).all():
            raise AssertionError(f"phase 31 (c) export-attn: map {a.shape} against {r.shape}")
        excess = float((np.abs(a - r) / (W_ATOL + W_RTOL * np.abs(r))).max())
        log(f"phase 31 (c): cli export-attn --patient P000: map {list(a.shape)} on the card, "
            f"rows summing to {a.sum(-1).min():.6f}..{a.sum(-1).max():.6f}; against --set "
            f"device=cpu at {excess:.3f} of W_RTOL {W_RTOL:g} (floor {W_ATOL:g})")
        if not excess <= 1.0:
            raise AssertionError("phase 31 (c) export-attn: the card's map disagrees with the CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def phase31_many_queries(dev, p30_export50) -> list:
    """(a)-(c) of the phase 31 notes above, and (d)'s check on phase 30's
    ranks' maps (``p30_export50``). Returns the eight rows of the kernels
    line, their launches (c)'s and (d)'s."""
    import torch

    t_phase = time.perf_counter()
    power = gpu_name_and_power()
    errs = {name: 0.0 for kind in ("f32", "bf16") for name in p31_rows(kind)}
    p31_kernel_checks(dev, errs)
    log(f"phase 31 (a): {time.perf_counter() - t_phase:.1f} s")
    rows = p31_timings(dev, errs, power)
    torch.cuda.empty_cache()
    launches = p31_entry_points(dev, power)
    for name, v in p30_export50.items():
        launches[name] = launches.get(name, 0) + v
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on phase 31's main-path runs")
    log(f"phase 31: {time.perf_counter() - t_phase:.1f} s of wall time, launches "
        f"{ {k: v for k, v in launches.items() if v} } ({power})")
    return rows


# --step-time: a training step and a validation batch of NaCAGaT cesar and
# MCAT ces at P31_GROUPS signature groups (medium, P31_SIZES), STEP_TIME_B
# bags of the TRAIN_M bucket (phase 31 (c)'s Trainer batch), graphed as the
# Trainer runs them, CUDA-event means over STEP_TIME_ITERS calls after the
# warm-up and capture. Copied beside another commit's package, the script
# times that commit's route (before the slab instances: attention_core) on
# the same card, so two commits compare within one call.
STEP_TIME_B, STEP_TIME_ITERS = 16, 20


def step_time(dev) -> None:
    import torch

    from multimodal_path_omic_tpu_torch.models import build_model
    from multimodal_path_omic_tpu_torch.train import loop
    from multimodal_path_omic_tpu_torch.train.optim import make_optimizer
    from multimodal_path_omic_tpu_torch.utils.weights import seeded_init_

    power = gpu_name_and_power()
    g = torch.Generator(device=dev).manual_seed(31)
    lengths = torch.randint(TRAIN_M // 5, TRAIN_M + 1, (STEP_TIME_B,), generator=g, device=dev)
    lengths[0] = TRAIN_M
    batch = {
        "wsi": torch.randn(STEP_TIME_B, TRAIN_M, 1024, generator=g, device=dev),
        "mask": torch.arange(TRAIN_M, device=dev)[None, :] < lengths[:, None],
        "omics": [torch.randn(STEP_TIME_B, s_, generator=g, device=dev) for s_ in P31_SIZES],
        "label": torch.randint(0, 4, (STEP_TIME_B,), generator=g, device=dev),
        "censorship": torch.randint(0, 2, (STEP_TIME_B,), generator=g, device=dev).float(),
        "weight": torch.ones(STEP_TIME_B, device=dev),
    }
    for model, loss in (("NaCAGaT", "cesar"), ("MCAT", "ces")):
        net = seeded_init_(build_model(model, omic_sizes=P31_SIZES, model_size="medium",
                                       dropout=TRAIN_RATE), 0).to(dev)
        opt = make_optimizer("adam", 2e-4, 1e-5)
        state = loop.init_train_state(net, opt, seed=0)
        train = loop.make_train_step(net, loss, opt, omic_sizes=P31_SIZES)
        evaluate = loop.make_eval_step(net, loss, need_attention=loss == "cesar",
                                       omic_sizes=P31_SIZES)
        box = [state]

        def train_call():
            box[0], _ = train(box[0], batch)

        out = {}
        for what, call in (("training step", train_call),
                           ("validation batch", lambda: evaluate(batch))):
            for _ in range(3):  # eager warm-up, capture, a replay
                call()
            torch.cuda.synchronize()
            reset_counts()
            call()
            torch.cuda.synchronize()
            launches = {k_: v_ for k_, v_ in read_counts().items() if v_}
            out[what] = (cuda_ms(call, iters=STEP_TIME_ITERS, warmup=1), launches)
        log(f"step-time: {model} {loss} medium, {P31_GROUPS} signature groups, "
            f"{STEP_TIME_B} bags of the {TRAIN_M} bucket, graphed: " + "; ".join(
                f"{what} {ms_:.4f} ms (mean of {STEP_TIME_ITERS}, CUDA events), launches {la}"
                for what, (ms_, la) in out.items()) + f" ({power})")
        del net, state, train, evaluate, box
        torch.cuda.empty_cache()


def ptxas_lines(libs, kinds):
    """(kernel, mangled entry, ptxas's register and spill line) of each
    instance in the kernel libraries ``libs`` whose entry's name matches the
    pattern ``kinds`` (its first group names the kernel)."""
    from multimodal_path_omic_tpu_torch.ops import kernels

    for name in libs:
        entry = ""
        for line in kernels.BUILD_LOGS.get(name, "").splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = found.group(1)
            kind = re.search(kinds, entry)
            if kind and ("Used" in line or "spill" in line):
                yield kind.group(1), entry, line.split("info    :")[-1].strip()


TRAIN_WINDOW_S, VAL_WINDOW_S = 4.0, 1.0  # the Trainer rates' windows


def trainer_window(cfg) -> dict:
    """The graphed Trainer on ``cfg``: epoch 1 through ``validated_epoch``
    (the warm-up: graphs captured, the cache uploaded), then training epochs
    until TRAIN_WINDOW_S have passed and validations until VAL_WINDOW_S,
    each timed to a device sync. Returns, for "train" and "val", (bags/s
    over the window; the median, slowest and fastest epoch's; epochs; those
    under half the median)."""
    import torch

    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, verbose=False, graphs=True)
    trainer.validated_epoch(0)
    torch.cuda.synchronize()
    out = {}
    for what, call, bags, window in (("train", trainer.train_epoch, len(trainer.train_ds),
                                      TRAIN_WINDOW_S),
                                     ("val", trainer.validate, len(trainer.val_ds),
                                      VAL_WINDOW_S)):
        times = []
        while sum(times) < window:
            t0 = time.perf_counter()
            call(len(times) + 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rates = np.sort(bags / np.array(times))
        med = float(np.median(rates))
        out[what] = (bags * len(times) / sum(times), med, rates[0], rates[-1], len(times),
                     int((rates < med / 2).sum()))
    del trainer
    torch.cuda.empty_cache()
    return out


def trainer_rates(tag, yaml_name, cohort, runs, power) -> None:
    """:func:`trainer_window` on a synthetic ``cohort`` for each (label,
    settings) of ``runs`` under ``yaml_name``; one log line each."""
    import shutil
    import tempfile

    from multimodal_path_omic_tpu_torch.data.synthetic import make_synthetic_cohort

    root = tempfile.mkdtemp(prefix="chip_smoke_rates_")
    try:
        paths = make_synthetic_cohort(os.path.join(root, "cohort"), **cohort)
        for i, (label, settings) in enumerate(runs):
            cfg = trainer_config(yaml_name, paths, os.path.join(root, str(i)),
                                 {**settings, "training.epochs": 10_000})
            r = trainer_window(cfg)
            log(f"{tag}: {label}, graphed, after the first epoch: " + "; ".join(
                f"{what} {rate:.2f} bags/s over {n} epochs (epochs: median {med:.2f}, "
                f"{lo:.2f}-{hi:.2f}, {slow} under half the median)"
                for what, (rate, med, lo, hi, n, slow) in r.items())
                + f" ({power})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bf16_flash_times(dev) -> None:
    """``--bf16-flash``: the twelve bfloat16 flash rows at phase 25 (a)'s
    timing inputs (B=8, M=16384; CUDA events) beside the bfloat16
    ``scaled_dot_product_attention`` call, their bounds and, at
    widths 16 and 32, the exp unit's floor; GE medium in bfloat16 from an
    int8 store through the graphed Trainer (phase 25 (b)'s first run:
    :func:`trainer_rates`); phase 25 (b)'s serving rate; and the flash
    libraries' ptxas registers and spills by instance. Copy the script beside
    another commit's package to time that commit."""
    power = gpu_name_and_power()
    for kind, entry, info in ptxas_lines(("flash", "flash_bwd"), r"(flash_\w+?kernel)"):
        if "bfloat16" in entry or "wg_kernel" in entry:
            args = ", ".join(re.findall(r"Li(\d+)E", entry))
            log(f"bf16-flash: ptxas {kind}<{args}>: {info}")
    for heads, width, e in FLASH_INSTANCES:
        for way in ("fwd", "bwd"):  # phase 25 (a)'s timing inputs
            t = time_bf16_flash_row(dev, heads, width, e, way, iters=5)
            ms, bms = t["ms"], t["bound_ms"]
            log(f"bf16-flash: flash_{way}_d{width}_bf16 B={GE_B} H={heads} M={GE_M}: {ms:.4f} ms, "
                f"sdpa {t['library_ms']:.4f} ms, bound {bms:.4f} ms ({t['bound_by']}; "
                f"{bms / ms:.3f} of it), the exp unit's floor {t['exp_floor_ms']:.4f} ms ({power})")
    what, settings = GE_BF16_RUNS[0]
    trainer_rates("bf16-flash", "ge_nacagat.yaml", GE_TRAINER_COHORT,
                  ((f"GE medium {what}", {**GE_TRAINER_SET, **settings}),), power)
    ge_bf16_serving(dev, power)


BF16_FK_TIMED = ((128, 128), (256, 256), (512, 512), (256, 128))  # (E, F) of --bf16-fuse-k
FK_KINDS = r"(fused_k_kernel|fused_k_bwd_kernel|fk_fwd_wg_kernel|fk_bwd_wg_kernel|" \
    r"dwk_wg_kernel|dwk_kernel)"


def bf16_fuse_k_times(dev) -> None:
    """``--bf16-fuse-k``: the bfloat16 fuse-K rows (eval form, training form
    at dropout TRAIN_RATE, backward) at B=32, N=6, M=8192 on phase 24 (a)'s
    prefix masks, at each (E, F) of BF16_FK_TIMED, each beside its float32
    row, its plain version and its bound (CUDA events); the fuse-K
    libraries' ptxas registers and spills by instance; NaCAGaT medium and
    big in bfloat16 from an int8 store through the cached graphed Trainer
    (phase 24 (b)'s and 26 (b)'s first run: :func:`trainer_rates`). Copy
    the script beside another commit's package to time that commit."""
    import torch

    power = gpu_name_and_power()
    for kind, entry, info in ptxas_lines(("coattn", "coattn_bwd"), FK_KINDS):
        targs = re.search(kind + r"I(.*?)EEv", entry)
        targs = targs.group(1) if targs else ""
        args = ", ".join(re.findall(r"L[ib](\d+)E", targs))
        bf = "bf16" if "bfloat16" in targs or "wg_kernel" in kind else "f32"
        log(f"bf16-fuse-k: ptxas {kind}<{args}> ({bf}): {info}")
    bf = torch.bfloat16

    def row_calls(e, f):
        """(mask, :func:`fuse_k_row_calls`) at (E, F) = (e, f), the inputs
        drawn from the same seeds each time."""
        q, kv, wk, bk, _, mask = make_inputs(TRAIN_M, f, 7700 + e + f, dev, e, "prefix",
                                             with_k=False)
        seed = torch.tensor([e + f], dtype=torch.int32, device=dev)
        g = torch.Generator(device="cpu").manual_seed(e + f)
        dout = torch.randn(B, N, f, generator=g).to(dev).to(bf)
        dssq, dsumw = (torch.randn(B, N, generator=g).to(dev) for _ in range(2))
        fk16 = tuple(t.to(bf) for t in (q, kv, wk, bk)) + (mask,)
        return mask, fuse_k_row_calls(fk16, (q, kv, wk, bk, mask), seed, dout, dssq, dsumw)

    # every float32 row first, before any bfloat16 kernel has run, so that a
    # float32 row's time does not depend on the bfloat16 kernels timed
    # before it
    ms32 = {}
    for e, f in BF16_FK_TIMED:
        _, calls = row_calls(e, f)
        for name, (_, row32, _) in calls.items():
            ms32[name, e, f] = cuda_ms(row32, iters=20)
        del calls
        torch.cuda.empty_cache()
    for e, f in BF16_FK_TIMED:
        mask, calls = row_calls(e, f)
        for name, (kern, _, plain) in calls.items():
            ms = cuda_ms(kern, iters=20)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            bms, by = bf16_bound_ms(name, mask, e, f)
            row32 = ms32[name, e, f]
            log(f"bf16-fuse-k: {name} B={B} N={N} M={TRAIN_M} E={e} F={f}: kernel {ms:.4f} ms, "
                f"its float32 row {row32:.4f} ms ({row32 / ms:.2f}x), plain {plain_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by}; {bms / ms:.3f} of it reached"
                f"{design_note(name, mask, e, f, ms)}) ({power})")
        del mask, calls
        torch.cuda.empty_cache()
    what, settings = BF16_RUNS[0][:2]
    trainer_rates("bf16-fuse-k", "nacagat.yaml", TRAINER_COHORT,
                  [(f"NaCAGaT {size} {what}, cached", {**base, **settings})
                   for size, base in (("medium", TRAINER_SET), ("big", BIG_SET))], power)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one predict_bags call per loss, one /predict_batch_npz "
                         "request, one training step (medium "
                         "and big), one GE predict_bags call, one GE training step, one "
                         "cached MCAT training step, the plain-K kernels' launches and a "
                         "Trainer epoch host-fed and cached instead of phases 1-31")
    ap.add_argument("--step-time", action="store_true",
                    help="time a graphed training step and validation batch of NaCAGaT cesar "
                         "and MCAT ces at 50 signature groups instead of phases 1-31")
    ap.add_argument("--bf16-fuse-k", action="store_true",
                    help="time the bfloat16 fuse-K rows (eval, training, backward at four "
                         "(E, F)) beside their float32 rows, plain versions and bounds, "
                         "NaCAGaT medium's and big's bf16 training bags/s, and print the "
                         "fuse-K instances' registers, instead of phases 1-31")
    ap.add_argument("--bf16-flash", action="store_true",
                    help="time the twelve bfloat16 flash instances beside sdpa, GE medium's "
                         "bf16 training and serving bags/s, and print the flash instances' "
                         "registers, instead of phases 1-31")
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

    if args.step_time:
        step_time(dev)
        return 0
    if args.bf16_flash:
        bf16_flash_times(dev)
        return 0
    if args.bf16_fuse_k:
        bf16_fuse_k_times(dev)
        return 0
    bags, omics = make_bags(0)
    if args.profile:
        for loss in WANT:
            profile_serving(dev, loss, bags, omics)
        profile_http(dev)
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
        profile_trainer(dev)
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
    del p14, p15, batch  # phase 23 scores the bags again
    torch.cuda.empty_cache()
    p21 = phase21_trainer(dev)
    for row in rows:  # the Trainer's main path runs these kernels (no E = 512 instance)
        row["launches"] += p21.get(row["name"], 0)
    torch.cuda.empty_cache()
    p22 = phase22_serving(dev)
    for row in rows:  # the serving entry points run these kernels (no E = 512 instance)
        row["launches"] += p22.get(row["name"], 0)
    torch.cuda.empty_cache()
    p23 = phase23_graphs(dev, bags, omics)
    del bags, omics
    for row in rows:  # phase 23's runs: every kernel but the E = 512 instances
        row["launches"] += p23.get(row["name"], 0)
    torch.cuda.empty_cache()
    errs24, rows24 = bf16_kernel_checks(dev, E, "phase 24 (a)")
    errs.update(errs24)
    torch.cuda.empty_cache()
    reset_counts()  # phase 24 (b), the reduced-precision Trainer, is the bf16 rows' main path
    p24 = phase24_precision(dev)
    for row in rows24:
        row["launches"] = p24.get(row["name"], 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on phase 24's Trainer runs")
    for row in rows:  # the float32 kernels of the bfloat16-store runs
        row["launches"] += p24.get(row["name"], 0)
    rows += rows24
    torch.cuda.empty_cache()
    errs25, rows25 = phase25_bf16_flash_kernels(
        dev, {row["name"]: row["ms"] for row in rows if row["name"].startswith("flash_")})
    errs.update(errs25)
    torch.cuda.empty_cache()
    reset_counts()  # phase 25 (b)-(d), GE through the Trainer in bf16: the rows' main path
    p25 = phase25_ge_bf16(dev)
    for row in rows25:
        row["launches"] = p25.get(row["name"], 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on phase 25's Trainer runs")
    for row in rows:  # the float32 GE kernels of (b)'s float32 run and (c)'s control
        row["launches"] += p25.get(row["name"], 0)
    rows += rows25
    torch.cuda.empty_cache()
    errs26, rows26 = bf16_kernel_checks(dev, 512, "phase 26 (a)")
    errs.update(errs26)
    torch.cuda.empty_cache()
    reset_counts()  # phase 26 (b)-(c), NaCAGaT big through the Trainer in bf16: the rows' main path
    p26 = phase26_big_bf16(dev)
    for row in rows26:
        row["launches"] = p26.get(count_of(row["name"]), 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on phase 26's Trainer runs")
    for row in rows:  # the float32 big run and controls: the E = 512 rows, the export passes
        if row["name"].endswith("_e512") or row["name"] in (
                "coattn_stats", "coattn_weights", "gather_rows"):
            row["launches"] += p26.get(count_of(row["name"]), 0)
    rows += rows26
    torch.cuda.empty_cache()
    rows += phase27_plain_k(dev)  # its rows' launches: its own serving and training runs
    torch.cuda.empty_cache()
    p28 = phase28_mesh(dev)
    for row in rows:  # (a) in this process and (b)'s ranks: the gather, the fuse-K pair
        row["launches"] += p28["a"].get(row["name"], 0) + p28["b"].get(row["name"], 0)
    torch.cuda.empty_cache()
    p29 = phase29_tooling(dev)
    for row in rows:  # the tooling's runs: the Trainer, the bundles' custom ops, remat steps
        row["launches"] += p29.get(count_of(row["name"]), 0)
    torch.cuda.empty_cache()
    p30 = phase30_mesh_settings(dev)
    for row in rows:  # every rank's cox steps, seq-2 export and mesh server (medium only)
        row["launches"] += p30.get(row["name"], 0)
    torch.cuda.empty_cache()
    rows += phase31_many_queries(dev, p30)  # its rows' launches: (c)'s runs and (d)'s ranks
    log(f"chip_smoke: phases 1-31 in {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
