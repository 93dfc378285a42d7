// Pre-gated few-query co-attention kernels for Hopper (sm_90a), float32,
// with bfloat16 instances of the fuse-K forward (both forms), the export
// passes and the plain-K forward with values (the _bf16 entry points; see
// "bfloat16 instances" below).
//
// Replaces the Pallas TPU kernels of multimodal_path_omic_tpu/ops/coattn.py:
//   * mpo_coattn_fwd_fused_k  <- _coattn_fwd_impl with _make_fwd_kernel(
//       fuse_k=True, pre_gate=True, emit_sumw=True), no dropout (lean-V eval)
//   * mpo_coattn_fwd_fused_k_train <- the same with dropout_rate > 0,
//       emit_ssq=True, emit_sumw=True, l and m kept for the backward (lean-V
//       training; the backward is csrc/coattn_bwd.cu)
//   * mpo_coattn_stats        <- _coattn_fwd_impl with the plain K operand,
//       used for the (l, m) statistics in coattention_weights (export pass 1),
//       with or without the pre-gate
//   * mpo_coattn_weights      <- _make_weights_kernel / coattention_weights
//       (export pass 2)
//   * mpo_coattn_plain_fwd    <- _coattn_fwd_impl with the plain K operand and
//       values (coattention / _coattn: attention off the lean routes), with or
//       without the pre-gate, eval form and training form (dropout, ssq, sumw)
// The plain-K and export kernels (and combine_kernel) are in plain_k_fwd.cuh;
// this source holds their instances at up to eight queries, and
// csrc/coattn_many.cu those past eight ("Past eight queries" below).
//
// Semantics shared by all of them (N queries, M keys, one bag per b):
//   s[n, m]  = (q[n] . k[m]) / sqrt(E) * (tanh(q[n]) . tanh(k[m]) + 1) / 2
//   s[n, m]  = NEG where the key mask is false (finite NEG, as the TPU kernel:
//              a fully-masked row gets uniform weights, never NaN)
//   m[n]     = max_m s,  l[n] = sum_m exp(s - m[n]),  w = exp(s - m[n]) / l[n]
// Keys at index >= M do not exist (no padding of M is ever counted), so a
// fully-masked row is uniform over exactly M keys, like the JAX package's
// plain attention_core path. The training form drops the normalized weights
// (torch semantics): pd = keep * w / (1 - rate), keep iff
// dropout_bits(seed, b, n, key) >= threshold; l sums the undropped weights,
// o = sum pd kv, ssq = sum pd^2, sumw = sum pd.
//
// What bounds them on an H100, and what the design does about it:
//   * fused_k: k = kv @ wk + bk is 2*B*M*F*E float32 operations (34 GFLOP at
//     B=32, M=8192, F=E=256, NaCAGaT medium, where kv is the 256-wide patch
//     embedding; 137 GFLOP at E=F=512, NaCAGaT big), against 268 MB of kv
//     read at medium (0.08 ms at 3.35 TB/s): bound by operations. The
//     projection runs on the tensor cores as 3xTF32 mma.sync at float32
//     accuracy (flash_common.cuh: three TF32 products each, 3 x 34 GFLOP /
//     495 TFLOP/s = 0.21 ms over every key), and only for the key tiles that
//     need it. Four launches, no atomics:
//     - fk_tiles_kernel / fk_list_kernel (fused_k_common.cuh, shared with
//       the backward) flag the 64-key tiles to compute (with a valid key in
//       the bag, a tile without one adds exactly 0 to o, l, ssq and sumw; a
//       bag without a valid key computes every tile) and list them.
//     - fused_k_kernel: one block an SM, block g an even share of the list
//       across bags (a full bag and a short one cost the same per tile).
//       Per tile and per chunk of at most 256 E columns: the k chunk = kv wk
//       in 32-deep steps, each step's kv slice [64][32] and wk slice
//       [32][EC] through a three-slot cp.async ring issued two
//       steps ahead (across tiles too, so the next tile's first slices land
//       during this tile's softmax); the [64 x EC] product over a 2 x 4 warp
//       grid, + bk, into shared memory; then the chunk's share of q.k and
//       tanh(q).tanh(k) for the N <= 8 queries on the CUDA cores (a warp's 8
//       keys, summed by a transposing butterfly), carried in registers
//       across chunks: a chunk changes only the summation order, so E = 512
//       is one more instance. Then the pre-gate, the mask, an online softmax
//       (one warp a query; the training form's Philox dropout, ssq and sumw)
//       and o += p kv on the CUDA cores, 2 N F operations a key (2% of the
//       projection's at N=6, E=256), the kv rows re-read from L2 (the ring
//       brought them in just before): copied into shared memory during the
//       softmax where F <= EC, read in place otherwise, so every F <= 1024
//       is taken. The [B, M, E] k never reaches device memory.
//     - combine_kernel merges a bag's partials (m, l, o and, in training,
//       ssq, sumw: one per block that held the bag, written at block + bag)
//       in block order: two runs give the same bits.
//   * stats / weights (the export passes): read k [B, M, D] once (268 MB at
//     B=32, M=8192, D=256: 0.08 ms at 3.35 TB/s over every key) and do under
//     2 GFLOP, so they are bound by bytes, and only the k rows of the key
//     tiles that need them: a tile without a valid key in a bag with one
//     adds exactly 0 to l and m and has weights exactly 0, and a bag without
//     a valid key has m = NEG, l = M and weights 1 / M whatever k holds, so
//     its k is not read at all (the tile list's lone unit). Launches, no
//     atomics:
//     - fk_tiles_kernel / fk_list_kernel (with lone filler bags), once for
//       both passes where coattention_weights runs them together.
//     - stats_kernel / weights_kernel over the blocks resident at once (two
//       an SM: at most 128 registers, 84,480 bytes of shared memory at
//       D = 256), each an even share of the list across bags. A tile's 64
//       keys go 8 to a warp, two a step, scored as the forward with values
//       scores them (pk_key_sums; tanh(k) once per element, only with the
//       pre-gate). Each warp streams its own k rows through its own
//       cp.async ring (8 KB), issued ahead across tiles and bags, and waits
//       for them alone: the block meets at a barrier only where the bag
//       changes (a block-wide ring of 16-key sub-steps, a barrier each,
//       measured slower). Stats: each owner lane runs an
//       online (m, l) over its key slot; a bag's lanes merge in lane, then
//       warp order into one partial per (block, bag), and combine_kernel
//       merges those in block order. Weights: a warp stages exp(s - m) / l
//       of its 8 keys in shared memory and stores them as row pieces, a
//       float4 a lane; the skipped tiles' keys and a lone bag's get
//       exp(NEG - m) / l (0, and 1 / M) from the block holding the computed
//       tile before them.
//   * plain (plain-K with values): reads k and v [B, M, D] once each (537 MB at
//     B=32, M=8192, D=256: 0.16 ms over every key; twice that at D = 512,
//     half of it in bfloat16) for 2.4 GFLOP of products (0.04 ms): bound by
//     bytes, and only the key tiles that need it. Four
//     launches, no atomics:
//     - fk_tiles_kernel / fk_list_kernel flag and list the 64-key tiles, as
//       for the fuse-K form (a tile without a valid key adds exactly 0).
//     - plain_kernel over the blocks resident at once (at most two an SM),
//       each an even share of the list across bags. A tile's k and v rows
//       come in sub-steps of 16 keys through a cp.async ring
//       (plain_k_common.cuh: 96 KB at D <= 256, three slots of 32 KB at D =
//       256, six of 16 KB at 128, issued ahead across tiles and bags). Per
//       sub-step: warp w scores keys 2w, 2w + 1 against every query on the
//       CUDA cores (each lane its groups of four columns; tanh(k) once per
//       element; one transposing butterfly sums the warp's 32 (query, key,
//       product) values at once), then one warp a query runs the online
//       softmax (the training form's Philox dropout, ssq and sumw; lanes
//       0..15 one key each), then each thread adds p v into its o columns
//       from the v rows in shared memory: at D <= 256 column tid % D of the
//       queries tid / D + QG j, at D = 512 (MCAT and NaCAGaT big) columns tid
//       and tid + 256 of every query. The scores as 3xTF32 mma.sync (C[16
//       keys x 8 queries], warp w over depth slice w, partials summed in
//       warp order) measured slower on the H100 (PERF.md, section 6): the
//       products are 2% of the work.
//       D = 512: a 16-key sub-step of k and v is 64 KB in float32, so the
//       96 KB ring of D <= 256 would hold one slot and overlap nothing. The
//       ring keeps 16-key sub-steps (the score layout is unchanged) in two
//       slots, one issued ahead: float32 164,384 bytes of shared memory
//       (one block an SM), bfloat16 98,848 (two an SM where the registers
//       allow). ptxas: 174 / 122 registers (pre-gate on / off), no spill, in
//       float32; 168-172 / 121-122 in bfloat16.
//     - combine_kernel merges the (block, bag) partials in block order.
//   * Past eight queries (plain, stats and weights at 9 <= N <= 256 =
//     NQ_MAX, the JAX kernels' range: kernel_eligible; the fuse-K forms stay
//     at N <= 8; the SLABS instances, csrc/coattn_many.cu, built beside this
//     source so that the instances at N <= 8 keep their code and
//     registers): pk_key_sums' score layout holds NMAX = 8 queries a warp,
//     and the forward's o of a bag (N x D floats: 256 KB at N = 256, D =
//     256) does not fit one block, so the queries go in slabs of eight, one
//     slab a block. Grid (per_slab, S), S = ceil(N / 8), per_slab = max(1,
//     resident / S): block (g, y) runs the kernel above on slab y (queries
//     8y .. 8y + 7) over block g's share of the same tile list (skipped
//     tiles, lone units), its partials at index g + b in the slab's rows of
//     o_part, ml_part, sq_part [per_slab + B, N, *] (o_part at N = 256, D =
//     512, per_slab 4 in float32: 36 x 256 x 512 x 4 bytes = 18.9 MB), and
//     combine_kernel merges each (bag, query) over per_slab blocks. The
//     dropout counter takes the query's index in the bag, so the bits do
//     not depend on the grouping. Cost, chosen over a loop of slabs on a
//     resident sub-step (whose o accumulators would not fit): every slab
//     re-reads the k (and v) tiles and takes tanh(k) again, bytes x S
//     through L2 (the slabs of a share run at once, the grid being the
//     blocks resident at once), from device memory once where L2 keeps a
//     tile until the last slab has read it. The scores and p v are 2 (3 with
//     the pre-gate) N D FMAs a key, so past N ~ 16 the functions are bound
//     by operations: at B = 32, M = 8192, D = 256, N = 256 the pre-gated
//     scores are 2 x 2 B M N D = 69 GFLOP (1.03 ms of float32 FMA) against
//     0.16 ms of k and v bytes; the weights pass writes B N M floats (268
//     MB: 0.08 ms) as part of its bound.
//
// bfloat16 instances (tpu.compute_dtype bfloat16; the JAX kernels take
// bfloat16 tiles, multimodal_path_omic_tpu/ops/coattn.py:138-150, 186, 210):
// plain_kernel with T = __nv_bfloat16 (D 128, 256, 512: lean=False at every
// size) keeps its ring in bfloat16: the k and v rows are copied raw by
// cp.async, 16 bytes at a time, as the flash instances' tiles are, and
// widened to float32 where pk_key_sums and the p v loop read them. That
// halves the bytes read and the ring's shared memory (the D = 512 slots
// take what the float32 D = 256 ones take), needs no register prefetch
// (none is free at D = 512: 168-172 registers with the pre-gate) and leaves
// the arithmetic the float32 instance's: q.k and tanh(q).tanh(k) summed in
// float32, tanh(q) and tanh(k) rounded to bfloat16, p v in float32, o
// written in bfloat16 by combine_kernel<bf16>; l, m, ssq, sumw float32.
// stats_kernel and weights_kernel with T = __nv_bfloat16 read bfloat16 q
// and k and compute what the JAX kernel computes from them (float32 sums,
// tanh(q) and tanh(k) rounded to bfloat16, l, m and the weights float32):
// the float32 instances with their input type a template parameter, values
// widened to float32 where they are read (D in {128, 256, 512}). The
// bfloat16 fuse-K forward (both forms, (E, F) in {128, 256}^2 and (512,
// 512)) is a design of its own on Hopper's warpgroup MMA, fk_fwd_wg_kernel
// in fused_k_sm90.cuh (its notes there): wk resident in shared memory where
// it fits, k = kv wk by wgmma into registers, the scores from k's
// fragments, o += p kv in float32, the tile list, dropout and merges of
// fused_k_kernel; o written in bfloat16 by combine_kernel<bf16>.
//
// Interface: plain C, called through ctypes. Every function returns
// cudaGetLastError() after its launches (0 = success); nothing allocates,
// everything runs on the caller's stream.

#include "fused_k_sm90.cuh"
#include "plain_k_fwd.cuh"

namespace {

using namespace mpo;

constexpr int FK_FMAX = 1024;  // widest kv row (4 columns per thread)

// ---------------------------------------------------------------------------
// K2, fuse-K form. Shared memory of one block: the ring of chunk steps (a kv
// slice [64][WC] and a wk slice [WC][EC] each), the current E chunk of the k
// tile (then, where F <= EC, the tile's kv rows for o += p kv), the bag's q
// and tanh(q), the tile's scores: 231,968 bytes at E = 512.
// ---------------------------------------------------------------------------
template <int E>
struct FkFwdSmem {
  static constexpr int EC = E < 256 ? E : 256;  // E columns a chunk
  static constexpr int NEC = E / EC;            // E chunks a tile
  static constexpr int WC = 32;                 // depth a chunk step
  static constexpr int KVS = WC + 8;            // kv slice: acc-product A, 8 mod 32
  static constexpr int RS = EC + 4;             // wk slice: acc-product B, 4 mod 32
  static constexpr int KS = EC + 4;             // k chunk: float4 rows
  static constexpr int SLOT = FK_BM * KVS + WC * RS;
  static constexpr int NT = EC / 32;            // column tiles a warp (4 column quarters)
  static constexpr int G = NT < 4 ? NT : 4;     // column tiles in flight
  alignas(16) float ring[3][SLOT];
  alignas(16) float k[FK_BM][KS];  // k chunk, then (F <= EC) kv rows
  alignas(16) float q[NMAX][E];
  alignas(16) float tq[NMAX][E];
  alignas(16) float s[NMAX][FK_BM];  // scores, then the weights p
  float alpha[NMAX];
};

// One block walks an even share of the computed (bag, tile) units in list
// order (fused_k_common.cuh). For each bag it visits it writes one
// unnormalized partial at index block + bag: o_part [G + B, N, F], ml_part
// [G + B, N, 2] (m, l); TRAIN adds sq_part [G + B, N, 2] (ssq, sumw of the
// dropped weights). TRAIN: attention dropout after normalization (l sums the
// undropped p; o, ssq and sumw take the dropped pd = keep * p / (1 - rate)),
// bits from dropout_bits(seed, b, n, key) with keep iff bits >= thresh
// (thresh 0: no dropout). Thread tid owns the o columns tid + 256 c, c < FC.
template <int E, int FC, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
fused_k_kernel(const float* __restrict__ q, const float* __restrict__ kv,
               const float* __restrict__ wk, const float* __restrict__ bk,
               const uint8_t* __restrict__ mask, const int* __restrict__ list,
               const int* __restrict__ off, float* __restrict__ o_part,
               float* __restrict__ ml_part, float* __restrict__ sq_part,
               const int* __restrict__ seed_ptr, uint32_t thresh, float keep_scale,
               uint32_t bag0, int B,
               int N, int M, int F, float scale) {
  using S_ = FkFwdSmem<E>;
  constexpr int EC = S_::EC, NEC = S_::NEC, WC = S_::WC, KVS = S_::KVS, RS = S_::RS;
  constexpr int KS = S_::KS, NT = S_::NT, EPT = EC / 32;
  static_assert(FK_RPW == 8, "sum8: 8 keys a warp");
  extern __shared__ float4 smem4[];
  S_& S = *reinterpret_cast<S_*>(smem4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 1, wc = warp >> 1;  // the product's warp grid: rows 32 wr, quarter wc
  const int t4 = lane & 3;
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int NCF = (F + WC - 1) / WC, NC = NEC * NCF;  // chunk steps an E chunk, a unit
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const uint32_t seed = TRAIN ? (uint32_t)seed_ptr[0] : 0u;

  // chunk step s of the block's sequence (NC a unit: E chunk c / NCF, depth
  // slice c % NCF) into ring slot s % 3; zeros past M and past F (F % 16 ==
  // 0, so a 32-deep step may hold only 16 columns)
  auto issue_chunk = [&](int s) {
    const int i = i0 + s / NC;
    if (i >= i1) return;
    const int u = list[i], c = s % NC, ec = c / NCF, f0 = (c % NCF) * WC;
    const int r0 = (u % n_tiles) * FK_BM;
    const float* src = kv + (size_t)(u / n_tiles) * M * F;
    float* slot = S.ring[s % 3];
    for (int idx = tid; idx < FK_BM * WC / 4; idx += THREADS) {
      const int row = idx / (WC / 4), col = 4 * (idx % (WC / 4));
      const bool ok = r0 + row < M && f0 + col < F;
      cp_async16(slot + row * KVS + col, ok ? src + (size_t)(r0 + row) * F + f0 + col : src, ok);
    }
    load_tile_async<WC, EC, RS>(slot + FK_BM * KVS, wk + ec * EC, E, f0, F);
  };
  issue_chunk(0);
  cp_async_commit();
  issue_chunk(1);
  cp_async_commit();
  float oacc[NMAX][FC];  // set when the first bag begins
  float m_run = NEG, l_run = 0.f;       // the softmax state of query `warp`
  float ssq_run = 0.f, sumw_run = 0.f;  // TRAIN: sums of pd^2 and pd
  int b = -1;
  // the partial of bag b at index block + b
  auto flush = [&]() {
    const size_t pb = (size_t)blockIdx.x + b;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
#pragma unroll
        for (int c = 0; c < FC; ++c) {
          const int f = tid + THREADS * c;
          if (f < F) o_part[(pb * N + n) * F + f] = oacc[n][c];
        }
      }
    }
    if (warp < N && lane == 0) {
      ml_part[(pb * N + warp) * 2 + 0] = m_run;
      ml_part[(pb * N + warp) * 2 + 1] = l_run;
      if constexpr (TRAIN) {
        sq_part[(pb * N + warp) * 2 + 0] = ssq_run;
        sq_part[(pb * N + warp) * 2 + 1] = sumw_run;
      }
    }
  };

  const int ri = warp * FK_RPW + sum8_index(lane);  // the key this lane's sums belong to
  int s = 0;  // the block's chunk step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, m0 = (u % n_tiles) * FK_BM;
    if (ub != b) {  // a new bag: flush the last one's partial, load this one's queries
      if (b >= 0) flush();
      b = ub;
      // the last unit's score pass is done with S.q (two barriers since)
      for (int j = tid; j < N * E; j += THREADS) {
        const float v = q[(size_t)b * N * E + j];
        S.q[j / E][j % E] = v;
        S.tq[j / E][j % E] = tanhf(v);
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
#pragma unroll
        for (int c = 0; c < FC; ++c) oacc[n][c] = 0.f;
      m_run = NEG;
      l_run = ssq_run = sumw_run = 0.f;
    }

    // ---- per E chunk: k = kv wk + bk, then its share of q.k and tanh(q).tanh(k) ----
    float a_acc[NMAX], u_acc[NMAX];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) a_acc[n] = u_acc[n] = 0.f;
#pragma unroll 1
    for (int ec = 0; ec < NEC; ++ec) {
      {
        float c[2][NT][4];
        zero_c<NT>(c[0]);
        zero_c<NT>(c[1]);
#pragma unroll 1
        for (int ch = 0; ch < NCF; ++ch, ++s) {
          cp_async_wait<1>();
          __syncthreads();  // chunk s landed; slot (s + 2) % 3 is free
          issue_chunk(s + 2);
          cp_async_commit();
          const float* slot = S.ring[s % 3];
          acc_product_rows<2, NT, WC, S_::G>(c, slot, KVS, slot + FK_BM * KVS, RS, 32 * wr,
                                             8 * NT * wc, lane);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = ec * EC + 8 * NT * wc + 8 * j + 2 * t4;
          const float b0 = bk[col], b1 = bk[col + 1];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            c[r][j][0] += b0; c[r][j][1] += b1;
            c[r][j][2] += b0; c[r][j][3] += b1;
          }
        }
        // S.k is free: the last chunk's score pass ended before this chunk's
        // first step barrier
        store_c<NT>(c[0], &S.k[0][0], KS, 32 * wr, 8 * NT * wc, lane);
        store_c<NT>(c[1], &S.k[0][0], KS, 32 * wr + 16, 8 * NT * wc, lane);
      }
      __syncthreads();
      float kr[FK_RPW][EPT];
#pragma unroll
      for (int r = 0; r < FK_RPW; ++r)
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4) {
          const float4 v = *reinterpret_cast<const float4*>(&S.k[warp * FK_RPW + r][j4 * 128 + 4 * lane]);
          kr[r][4 * j4] = v.x; kr[r][4 * j4 + 1] = v.y; kr[r][4 * j4 + 2] = v.z; kr[r][4 * j4 + 3] = v.w;
        }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        float qv[EPT], p[FK_RPW];
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4) {  // lane_col's order, one float4 a group
          const float4 v = *reinterpret_cast<const float4*>(&S.q[n][ec * EC + j4 * 128 + 4 * lane]);
          qv[4 * j4] = v.x; qv[4 * j4 + 1] = v.y; qv[4 * j4 + 2] = v.z; qv[4 * j4 + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < FK_RPW; ++r) {
          p[r] = 0.f;
#pragma unroll
          for (int j = 0; j < EPT; ++j) p[r] = fmaf(kr[r][j], qv[j], p[r]);
        }
        a_acc[n] += sum8(p, lane);
      }
#pragma unroll
      for (int r = 0; r < FK_RPW; ++r)
#pragma unroll
        for (int j = 0; j < EPT; ++j) kr[r][j] = tanhf(kr[r][j]);
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        float tv[EPT], p[FK_RPW];
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4) {  // lane_col's order, one float4 a group
          const float4 v = *reinterpret_cast<const float4*>(&S.tq[n][ec * EC + j4 * 128 + 4 * lane]);
          tv[4 * j4] = v.x; tv[4 * j4 + 1] = v.y; tv[4 * j4 + 2] = v.z; tv[4 * j4 + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < FK_RPW; ++r) {
          p[r] = 0.f;
#pragma unroll
          for (int j = 0; j < EPT; ++j) p[r] = fmaf(kr[r][j], tv[j], p[r]);
        }
        u_acc[n] += sum8(p, lane);
      }
    }

    // ---- pre-gate and mask -> S.s[n][key] (one lane of the four that hold a key's sums) ----
    if ((lane & 3) == 0) {
      const int key = m0 + ri;
      const bool exists = key < M;  // keys past M do not exist: weight exactly 0
      const bool valid = exists && (mask == nullptr || mask[(size_t)b * M + key]);
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        float sv = a_acc[n] * scale;
        sv = sv * (u_acc[n] + 1.f) * 0.5f;
        S.s[n][ri] = !exists ? -INFINITY : (valid ? sv : NEG);
      }
    }
    __syncthreads();
    // F <= EC: the tile's kv rows (in L2: the ring just read them) into S.k,
    // which the score pass is done with, during the softmax
    const bool kv_in_smem = F <= EC;
    if (kv_in_smem) {
      const float* src = kv + ((size_t)b * M + m0) * F;
      for (int idx = tid; idx < FK_BM * F / 4; idx += THREADS) {
        const int row = idx / (F / 4), c4 = idx % (F / 4);
        const bool ok = m0 + row < M;
        cp_async16(&S.k[row][4 * c4], ok ? src + (size_t)row * F + 4 * c4 : src, ok);
      }
      cp_async_commit();
    }

    // ---- online softmax, one warp per query ----
    if (warp < N) {
      const float s0 = S.s[warp][lane], s1 = S.s[warp][lane + 32];
      const float m_new = fmaxf(m_run, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_run - m_new);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l_run = l_run * alpha + warp_sum(p0 + p1);
      m_run = m_new;
      if constexpr (TRAIN) {
        if (thresh != 0u) {
          const uint32_t key = (uint32_t)(m0 + lane);
          p0 = dropout_bits(seed, bag0 + b, warp, key) >= thresh ? p0 * keep_scale : 0.f;
          p1 = dropout_bits(seed, bag0 + b, warp, key + 32u) >= thresh ? p1 * keep_scale : 0.f;
        }
        ssq_run = ssq_run * (alpha * alpha) + warp_sum(p0 * p0 + p1 * p1);
        sumw_run = sumw_run * alpha + warp_sum(p0 + p1);
      }
      S.s[warp][lane] = p0;
      S.s[warp][lane + 32] = p1;
      if (lane == 0) S.alpha[warp] = alpha;
    }
    __syncthreads();

    // ---- o[n, f] = alpha o + sum_r p[n, r] kv[r, f] (kv rows from S.k, else from L2) ----
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float a = S.alpha[n];
#pragma unroll
        for (int c = 0; c < FC; ++c) oacc[n][c] *= a;
      }
    }
    const int rows = min(FK_BM, M - m0);
    const float* kv_t = kv + ((size_t)b * M + m0) * F;
    if (kv_in_smem) {
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      float x[FC];
#pragma unroll
      for (int c = 0; c < FC; ++c) {
        const int f = tid + THREADS * c;
        x[c] = f < F ? (kv_in_smem ? S.k[r][f] : kv_t[(size_t)r * F + f]) : 0.f;
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          const float p = S.s[n][r];
#pragma unroll
          for (int c = 0; c < FC; ++c) oacc[n][c] = fmaf(p, x[c], oacc[n][c]);
        }
      }
    }
    // S.s and S.alpha are rewritten after the next unit's chunk barriers
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
}


// The fuse-K forward's launches: the tile flags and list, fused_k_kernel
// over `blocks` blocks, combine_kernel. sq_part and ssq are used by the
// TRAIN form only.
template <int E, int FC, bool TRAIN>
int launch_fk_instance(const float* q, const float* kv, const float* wk, const float* bk,
                       const uint8_t* mask, const int* list, const int* off, float* o_part,
                       float* ml_part, float* sq_part, const int* seed, uint32_t thresh,
                       float keep_scale, uint32_t bag0, int B, int N, int M, int F, int blocks,
                       float scale,
                       cudaStream_t st) {
  static bool allowed[64] = {};
  constexpr int smem = (int)sizeof(FkFwdSmem<E>);
  static_assert(smem <= 232448, "shared memory of one block");
  const int err = allow_dynamic_smem(fused_k_kernel<E, FC, TRAIN>, smem, allowed);
  if (err) return err;
  fused_k_kernel<E, FC, TRAIN><<<blocks, THREADS, smem, st>>>(
      q, kv, wk, bk, mask, list, off, o_part, ml_part, sq_part, seed, thresh, keep_scale, bag0,
      B, N,
      M, F, scale);
  return (int)cudaGetLastError();
}

template <bool TRAIN, typename T>
int launch_fused_k(const T* q, const T* kv, const T* wk, const T* bk,
                   const uint8_t* mask, const int* seed, uint32_t thresh, float keep_scale,
                   uint32_t bag0,
                   T* o, float* l, float* m, float* ssq, float* sumw, float* o_part,
                   float* ml_part, float* sq_part, uint8_t* flags, int* list, int* off, int B,
                   int N, int M, int F, int E, int blocks, float scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || F < 16 || F % 16 != 0 || F > FK_FMAX ||
      blocks < 1 || blocks > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int fc = F <= 256 ? 1 : (F <= 512 ? 2 : 4);  // o columns a thread
#define MPO_FK(E_, FC_)                                                                    \
  if (E == E_ && fc == FC_)                                                                \
    err = launch_fk_instance<E_, FC_, TRAIN>(q, kv, wk, bk, mask, list, off, o_part,         \
                                                ml_part, sq_part, seed, thresh, keep_scale, \
                                                bag0, B, \
                                                N, M, F, blocks, scale, st);
  if constexpr (IS_BF16<T>) {  // E, F in {128, 256}, or E = F = 512 (ops/coattn.py BF16_EF), both forms
#define MPO_FKW(E_, F_)                                                                        \
  if (E == E_ && F == F_)                                                                      \
    err = fk90::launch_fwd<E_, F_, TRAIN>(q, kv, wk, bk, mask, list, off, o_part, ml_part,     \
                                          sq_part, seed, thresh, keep_scale, bag0, B, N, M,    \
                                          blocks, scale, st);
    MPO_FKW(256, 256) else MPO_FKW(128, 128) else MPO_FKW(256, 128) else MPO_FKW(128, 256)
    else MPO_FKW(512, 512) else return (int)cudaErrorInvalidValue;
#undef MPO_FKW
  } else if constexpr (TRAIN) {  // E, F in {128, 256}, or E = F = 512 (ops/coattn.py FUSED_K_TRAIN_EF)
    MPO_FK(256, 1) else MPO_FK(128, 1) else MPO_FK(512, 2)
    else return (int)cudaErrorInvalidValue;
  } else {
    MPO_FK(256, 1) else MPO_FK(256, 2) else MPO_FK(256, 4)
    else MPO_FK(128, 1) else MPO_FK(128, 2) else MPO_FK(128, 4)
    else MPO_FK(512, 1) else MPO_FK(512, 2) else MPO_FK(512, 4)
    else return (int)cudaErrorInvalidValue;
  }
#undef MPO_FK
  if (err) return err;
  combine_kernel<T><<<dim3(B, N), THREADS, 0, st>>>(o_part, ml_part, sq_part, o, l, m, ssq, sumw,
                                                 N, F, blocks, off);
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// q [B, N, E], kv [B, M, F], wk [F, E], bk [E], mask [B, M] bool or NULL.
// Out: o [B, N, F], l, m, sumw [B, N]. blocks: the main pass's grid (one
// block an SM). Scratch: o_part [blocks + B, N, F], ml_part [blocks + B, N,
// 2], flags [B * T] uint8, list [B * T] and off [B + 1] int32 (T = ceil(M /
// 64) key tiles a bag). E in {128, 256, 512}; F % 16 == 0, F <= 1024; N <= 8.
int mpo_coattn_fwd_fused_k(const float* q, const float* kv, const float* wk,
                           const float* bk, const uint8_t* mask, float* o, float* l,
                           float* m, float* sumw, float* o_part, float* ml_part,
                           uint8_t* flags, int* list, int* off, int B, int N, int M, int F,
                           int E, int blocks, float scale, void* stream) {
  return launch_fused_k<false>(q, kv, wk, bk, mask, nullptr, 0u, 1.f, 0u, o, l, m, nullptr,
                               sumw, o_part, ml_part, nullptr, flags, list, off, B, N, M, F,
                               E, blocks, scale, stream);
}

// The training form: as above plus attention dropout (seed: one int32 on the
// device; bag0: the global index of bag 0, added to every bag's index in the
// dropout counter, so that a data-parallel rank draws the one-device run's
// bits; keep iff dropout_bits >= thresh, kept weights times keep_scale;
// thresh 0 = no dropout) and the ssq side output. Out: o [B, N, F], l, m
// (saved for the backward), ssq, sumw [B, N]. Extra scratch: sq_part
// [blocks + B, N, 2]. E, F in {128, 256}, or E = F = 512.
int mpo_coattn_fwd_fused_k_train(const float* q, const float* kv, const float* wk,
                                 const float* bk, const uint8_t* mask, const int* seed,
                                 float* o, float* l, float* m, float* ssq, float* sumw,
                                 float* o_part, float* ml_part, float* sq_part, uint8_t* flags,
                                 int* list, int* off, int B, int N, int M, int F, int E,
                                 int blocks, float scale, uint32_t thresh, float keep_scale,
                                 uint32_t bag0,
                                 void* stream) {
  return launch_fused_k<true>(q, kv, wk, bk, mask, seed, thresh, keep_scale, bag0, o, l, m, ssq,
                              sumw, o_part, ml_part, sq_part, flags, list, off, B, N, M, F, E,
                              blocks, scale, stream);
}

// The bfloat16 instances of both forms: q, kv, wk, bk and o bfloat16,
// everything else as above; E, F in {128, 256}, or E = F = 512.
int mpo_coattn_fwd_fused_k_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kv,
                                const __nv_bfloat16* wk, const __nv_bfloat16* bk,
                                const uint8_t* mask, __nv_bfloat16* o, float* l, float* m,
                                float* sumw, float* o_part, float* ml_part, uint8_t* flags,
                                int* list, int* off, int B, int N, int M, int F, int E,
                                int blocks, float scale, void* stream) {
  return launch_fused_k<false>(q, kv, wk, bk, mask, nullptr, 0u, 1.f, 0u, o, l, m, nullptr,
                               sumw, o_part, ml_part, nullptr, flags, list, off, B, N, M, F,
                               E, blocks, scale, stream);
}

int mpo_coattn_fwd_fused_k_train_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kv,
                                      const __nv_bfloat16* wk, const __nv_bfloat16* bk,
                                      const uint8_t* mask, const int* seed, __nv_bfloat16* o,
                                      float* l, float* m, float* ssq, float* sumw,
                                      float* o_part, float* ml_part, float* sq_part,
                                      uint8_t* flags, int* list, int* off, int B, int N, int M,
                                      int F, int E, int blocks, float scale, uint32_t thresh,
                                      float keep_scale, uint32_t bag0, void* stream) {
  return launch_fused_k<true>(q, kv, wk, bk, mask, seed, thresh, keep_scale, bag0, o, l, m, ssq,
                              sumw, o_part, ml_part, sq_part, flags, list, off, B, N, M, F, E,
                              blocks, scale, stream);
}

// Export pass 1: q [B, N, D], k [B, M, D], mask [B, M] bool or NULL -> l, m
// [B, N]; also leaves the mask's tile list with lone filler bags in flags
// [B * T] uint8, list [B * T] and off [B + 1] int32 (T = ceil(M / 64) key
// tiles a bag), which pass 2 may take. max_blocks: the most main-pass
// blocks (it runs the blocks resident at once, up to that). Scratch: ml_part
// [max_blocks + B, N, 2]. N <= 8 (past eight: csrc/coattn_many.cu), D in
// {128, 256, 512}, with or without the pre-gate.
int mpo_coattn_stats(const float* q, const float* k, const uint8_t* mask, float* l, float* m,
                     float* ml_part, uint8_t* flags, int* list, int* off, int B, int N, int M,
                     int D, int pre_gate, int max_blocks, float scale, void* stream) {
  return export_stats<float, false>(q, k, mask, l, m, ml_part, flags, list, off, B, N, M, D,
                                    pre_gate, max_blocks, scale, stream);
}

// Export pass 2: q, k, mask as pass 1, l, m [B, N] -> w [B, N, M]. list_ready
// != 0: flags, list and off hold the tile list a pass-1 call left for this
// mask; else this call builds it there.
int mpo_coattn_weights(const float* q, const float* k, const uint8_t* mask, const float* l,
                       const float* m, float* w, uint8_t* flags, int* list, int* off, int B,
                       int N, int M, int D, int pre_gate, int max_blocks, int list_ready,
                       float scale, void* stream) {
  return export_weights<float, false>(q, k, mask, l, m, w, flags, list, off, B, N, M, D,
                                      pre_gate, max_blocks, list_ready, scale, stream);
}

// The bfloat16 instances of both passes: q, k bfloat16, everything else as
// mpo_coattn_stats / mpo_coattn_weights (l, m, w float32); D in {128, 256,
// 512} (ops/coattn.py BF16_EXPORT_D).
int mpo_coattn_stats_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const uint8_t* mask,
                          float* l, float* m, float* ml_part, uint8_t* flags, int* list,
                          int* off, int B, int N, int M, int D, int pre_gate, int max_blocks,
                          float scale, void* stream) {
  return export_stats<__nv_bfloat16, false>(q, k, mask, l, m, ml_part, flags, list, off, B, N,
                                            M, D, pre_gate, max_blocks, scale, stream);
}

int mpo_coattn_weights_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const uint8_t* mask, const float* l, const float* m, float* w,
                            uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
                            int pre_gate, int max_blocks, int list_ready, float scale,
                            void* stream) {
  return export_weights<__nv_bfloat16, false>(q, k, mask, l, m, w, flags, list, off, B, N, M, D,
                                              pre_gate, max_blocks, list_ready, scale, stream);
}

// The tile flag and list passes alone, as the kernels run them: mask [B, M]
// bool or NULL -> flags [B * T] uint8, list [B * T] and off [B + 1] int32;
// lone != 0: with lone filler bags (the export passes), else as the fuse-K
// and plain-K kernels.
int mpo_coattn_tiles(const uint8_t* mask, uint8_t* flags, int* list, int* off, int B, int M,
                     int lone, void* stream) {
  if (M < 1 || B < 1) return (int)cudaErrorInvalidValue;
  launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0,
                   static_cast<cudaStream_t>(stream), lone != 0);
  return (int)cudaGetLastError();
}

// The plain-K form with values: q [B, N, D], k, v [B, M, D], mask [B, M] bool
// or NULL -> o [B, N, D], l, m [B, N]. train != 0: the training form, with
// attention dropout (seed, thresh, keep_scale, bag0 as mpo_coattn_fwd_fused_k_train)
// and ssq, sumw [B, N] of the dropped weights; else seed, ssq, sumw and
// sq_part may be NULL. max_blocks: the most main-pass blocks (it runs the
// blocks resident at once, up to that). Scratch: o_part [max_blocks + B, N,
// D], ml_part and sq_part [max_blocks + B, N, 2], flags [B * T] uint8, list
// [B * T] and off [B + 1] int32 (T = ceil(M / 64) key tiles a bag). D in
// {128, 256, 512}; N <= 8 (past eight: csrc/coattn_many.cu).
int mpo_coattn_plain_fwd(const float* q, const float* k, const float* v,
                         const uint8_t* mask, const int* seed, float* o, float* l, float* m,
                         float* ssq, float* sumw, float* o_part, float* ml_part,
                         float* sq_part, uint8_t* flags, int* list, int* off, int B, int N,
                         int M, int D, int pre_gate, int max_blocks, int train, float scale,
                         uint32_t thresh, float keep_scale, uint32_t bag0, void* stream) {
  return plain_fwd<float>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part, ml_part, sq_part,
                          flags, list, off, B, N, M, D, pre_gate, max_blocks, train, scale,
                          thresh, keep_scale, bag0, stream);
}

// The bfloat16 instances: q, k, v and o bfloat16, everything else as above.
int mpo_coattn_plain_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const uint8_t* mask, const int* seed,
                              __nv_bfloat16* o, float* l, float* m, float* ssq, float* sumw,
                              float* o_part, float* ml_part, float* sq_part, uint8_t* flags,
                              int* list, int* off, int B, int N, int M, int D, int pre_gate,
                              int max_blocks, int train, float scale, uint32_t thresh,
                              float keep_scale, uint32_t bag0, void* stream) {
  return plain_fwd<__nv_bfloat16>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part, ml_part,
                                  sq_part, flags, list, off, B, N, M, D, pre_gate, max_blocks,
                                  train, scale, thresh, keep_scale, bag0, stream);
}

}  // extern "C"
