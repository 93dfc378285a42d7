// Pre-gated few-query co-attention kernels for Hopper (sm_90a), float32.
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
//     B=32, M=8192, D=256: 0.16 ms over every key) for 2.4 GFLOP of products
//     (0.04 ms): bound by bytes, and only the key tiles that need it. Four
//     launches, no atomics:
//     - fk_tiles_kernel / fk_list_kernel flag and list the 64-key tiles, as
//       for the fuse-K form (a tile without a valid key adds exactly 0).
//     - plain_kernel over the blocks resident at once (two an SM), each an
//       even share of the list across bags. A tile's k and v rows come in
//       sub-steps of 16 keys through a cp.async ring (plain_k_common.cuh:
//       three slots of 32 KB at D = 256, six of 16 KB at 128, issued ahead
//       across tiles and bags). Per sub-step: warp w scores keys 2w, 2w + 1
//       against every query on the CUDA cores (each lane its float4 columns;
//       tanh(k) once per element; one transposing butterfly sums the warp's
//       32 (query, key, product) values at once), then one warp a query
//       runs the online softmax (the training form's Philox dropout, ssq
//       and sumw; lanes 0..15 one key each), then thread tid adds p v into
//       its o column tid % D of the queries tid / D + QG j, from the v rows
//       in shared memory. The scores as 3xTF32 mma.sync (C[16 keys x 8
//       queries], warp w over depth slice w, partials summed in warp order)
//       measured slower on the H100 (PERF.md, section 6): the products are
//       2% of the work.
//     - combine_kernel merges the (block, bag) partials in block order.
//
// Interface: plain C, called through ctypes. Every function returns
// cudaGetLastError() after its launches (0 = success); nothing allocates,
// everything runs on the caller's stream.

#include "plain_k_common.cuh"

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
               const int* __restrict__ seed_ptr, uint32_t thresh, float keep_scale, int B,
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
          p0 = dropout_bits(seed, b, warp, key) >= thresh ? p0 * keep_scale : 0.f;
          p1 = dropout_bits(seed, b, warp, key + 32u) >= thresh ? p1 * keep_scale : 0.f;
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

// ---------------------------------------------------------------------------
// Merge a bag's partial (m, l[, o]) states per (bag, query), in order:
//   m = max_p m_p;  l = sum_p l_p e^(m_p - m);  o = sum_p o_p e^(m_p - m) / l
// with the l == 0 guard of the TPU kernel. Without sq_part, sumw = l / l (the
// weight mass of the final row; no dropout in eval); with it (training form)
//   ssq = sum_p ssq_p e^(2 (m_p - m)) / l^2,  sumw = sum_p sumw_p e^(m_p - m) / l.
// Partials [*, N, F] (o) and [*, N, 2]: with off == NULL bag b's are
// b * P .. b * P + P - 1; with off (the fuse-K and plain-K forwards' unit
// list over P blocks, fused_k_common.cuh) those of the blocks g that held its
// units, at g + b.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
               const float* __restrict__ sq_part, float* __restrict__ o,
               float* __restrict__ l_out, float* __restrict__ m_out,
               float* __restrict__ ssq, float* __restrict__ sumw, int N, int F, int P,
               const int* __restrict__ off) {
  __shared__ float fac[MAX_PARTS];
  __shared__ float red[WARPS], red_sq[WARPS], red_sw[WARPS];
  const int b = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  size_t base = (size_t)b * P;  // bag b's first partial
  if (off != nullptr) {
    const int per = units_per_block(off, gridDim.x, P), g0 = off[b] / per;
    base = (size_t)g0 + b;
    P = (off[b + 1] - 1) / per - g0 + 1;
  }
  const float* ml = ml_part + (base * N + n) * 2;  // stride N*2 per part

  float mx = NEG;
  for (int p = tid; p < P; p += THREADS) mx = fmaxf(mx, ml[(size_t)p * N * 2]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();

  float lsum = 0.f, sq = 0.f, sw = 0.f;
  for (int p = tid; p < P; p += THREADS) {
    const float e = expf(ml[(size_t)p * N * 2] - mx);
    fac[p] = e;
    lsum += ml[(size_t)p * N * 2 + 1] * e;
    if (sq_part != nullptr) {
      const size_t i = ((base + p) * N + n) * 2;  // ml_part's layout
      sq += sq_part[i] * (e * e);
      sw += sq_part[i + 1] * e;
    }
  }
  lsum = warp_sum(lsum);
  sq = warp_sum(sq);
  sw = warp_sum(sw);
  if (lane == 0) {
    red[warp] = lsum;
    red_sq[warp] = sq;
    red_sw[warp] = sw;
  }
  __syncthreads();
  float l = 0.f;
  sq = 0.f;
  sw = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    l += red[w];
    sq += red_sq[w];
    sw += red_sw[w];
  }
  const float l_inv = l == 0.f ? 1.f : 1.f / l;

  if (o != nullptr) {
    for (int f = tid; f < F; f += THREADS) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p)
        acc = fmaf(o_part[((base + p) * N + n) * F + f], fac[p], acc);
      o[((size_t)b * N + n) * F + f] = acc * l_inv;
    }
  }
  if (tid == 0) {
    l_out[(size_t)b * N + n] = l;
    m_out[(size_t)b * N + n] = mx;
    if (sq_part != nullptr) {
      ssq[(size_t)b * N + n] = sq * (l_inv * l_inv);
      sumw[(size_t)b * N + n] = sw * l_inv;
    } else if (sumw != nullptr) {
      sumw[(size_t)b * N + n] = l * l_inv;
    }
  }
}

// K2, plain-K form with values (design notes at the top). One block walks
// an even share of the computed (bag, tile) units in list order, in
// sub-steps of PK_KEYS keys whose k and v rows come through the cp.async
// ring (plain_k_common.cuh). For each bag it visits it writes one
// unnormalized partial at index block + bag: o_part [G + B, N, D], ml_part
// [G + B, N, 2] (m, l); TRAIN adds sq_part [G + B, N, 2] (ssq, sumw of the
// dropped weights), with fused_k_kernel's dropout rule (keep iff
// dropout_bits >= thresh; thresh 0: no dropout). Thread tid owns o column
// tid % D of the queries n = tid / D + QG j.
template <int D>
struct PkFwdSmem {
  static constexpr int SLOT = 2 * PK_KEYS * D;          // k rows, then v rows
  static constexpr int NSLOT = 98304 / (4 * SLOT);      // 3 at D = 256, 6 at 128
  alignas(16) float ring[NSLOT][SLOT];
  alignas(16) float q[NMAX][D];
  alignas(16) float tq[NMAX][D];
  alignas(16) float s[NMAX][PK_KEYS];  // scores, then the (dropped) weights
  float alpha[NMAX];
};

template <int D, bool PG, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
plain_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const uint8_t* __restrict__ mask,
             const int* __restrict__ list, const int* __restrict__ off,
             float* __restrict__ o_part, float* __restrict__ ml_part,
             float* __restrict__ sq_part, const int* __restrict__ seed_ptr, uint32_t thresh,
             float keep_scale, int B, int N, int M, float scale) {
  using S_ = PkFwdSmem<D>;
  constexpr int NSLOT = S_::NSLOT, QG = THREADS / D, NQ = NMAX / QG;
  static_assert(QG >= 1 && THREADS % D == 0, "a thread owns whole o columns");
  extern __shared__ float4 smem4[];
  S_& S = *reinterpret_cast<S_*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = tid % D, grp = tid / D;
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const uint32_t seed = TRAIN ? (uint32_t)seed_ptr[0] : 0u;

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    pk_issue<D>(S.ring[s], k, v, list, n_tiles, M, i1, cur);
    cp_async_commit();
  }

  float oacc[NQ];
  float m_run = NEG, l_run = 0.f, ssq_run = 0.f, sumw_run = 0.f;  // query `warp`'s state
  int b = -1;
  auto flush = [&]() {  // the partial of bag b at index block + b
    const size_t pb = (size_t)blockIdx.x + b;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int n = grp + QG * j;
      if (n < N) o_part[(pb * N + n) * D + col] = oacc[j];
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

  int s = 0;  // the block's sub-step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles, subs = pk_subs(t, M);
    for (int j = 0; j < subs; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncthreads();  // sub-step s landed; the slot of s - 1 is free
      pk_issue<D>(S.ring[(s + NSLOT - 1) % NSLOT], k, v, list, n_tiles, M, i1, cur);
      cp_async_commit();
      if (ub != b) {  // a new bag: flush the last one's partial, load this one's queries
        if (b >= 0) flush();
        b = ub;
        for (int x = tid; x < N * D; x += THREADS) {
          const float val = q[(size_t)b * N * D + x];
          S.q[x / D][x % D] = val;
          if (PG) S.tq[x / D][x % D] = tanhf(val);
        }
#pragma unroll
        for (int j2 = 0; j2 < NQ; ++j2) oacc[j2] = 0.f;
        m_run = NEG;
        l_run = ssq_run = sumw_run = 0.f;
        __syncthreads();
      }
      const float* slot = S.ring[s % NSLOT];
      const int r0 = t * FK_BM + j * PK_KEYS;  // the sub-step's first key

      // ---- scores of the warp's two keys against every query ----
      {
        float second, unused;
        const float a = pk_key_sums<D, PG, false>(slot, S.q, S.tq, nullptr, nullptr, N, warp,
                                                  lane, second, unused);
        const int n = pk_query(lane), row = warp * PK_KPW + pk_key(lane), key = r0 + row;
        if ((lane & 1) == 0 && n < N) {
          const float sv = pk_score<PG>(a, second, scale);
          const bool exists = key < M;  // keys past M do not exist: weight exactly 0
          const bool valid = exists && (mask == nullptr || mask[(size_t)b * M + key]);
          S.s[n][row] = !exists ? -INFINITY : (valid ? sv : NEG);
        }
      }
      __syncthreads();

      // ---- online softmax, one warp a query (lanes 0..15 one key each) ----
      if (warp < N) {
        const float sv = lane < PK_KEYS ? S.s[warp][lane] : -INFINITY;
        const float m_new = fmaxf(m_run, warp_max(sv));
        const float alpha = expf(m_run - m_new);
        float p = expf(sv - m_new);
        l_run = l_run * alpha + warp_sum(p);
        m_run = m_new;
        if constexpr (TRAIN) {
          if (thresh != 0u && lane < PK_KEYS)
            p = dropout_bits(seed, (uint32_t)b, (uint32_t)warp, (uint32_t)(r0 + lane)) >= thresh
                    ? p * keep_scale : 0.f;
          ssq_run = ssq_run * (alpha * alpha) + warp_sum(p * p);
          sumw_run = sumw_run * alpha + warp_sum(p);
        }
        if (lane < PK_KEYS) S.s[warp][lane] = p;
        if (lane == 0) S.alpha[warp] = alpha;
      }
      __syncthreads();

      // ---- o[n, col] = alpha o + sum_r p[n, r] v[r, col] (rows past M are zeros) ----
      const float* vs = slot + PK_KEYS * D;
#pragma unroll
      for (int j2 = 0; j2 < NQ; ++j2) {
        const int n = grp + QG * j2;
        if (n < N) oacc[j2] *= S.alpha[n];
      }
#pragma unroll
      for (int r = 0; r < PK_KEYS; r += 4) {
        const float x0 = vs[r * D + col], x1 = vs[(r + 1) * D + col];
        const float x2 = vs[(r + 2) * D + col], x3 = vs[(r + 3) * D + col];
#pragma unroll
        for (int j2 = 0; j2 < NQ; ++j2) {
          const int n = grp + QG * j2;
          if (n < N) {
            const float4 p = *reinterpret_cast<const float4*>(&S.s[n][r]);
            oacc[j2] = fmaf(p.x, x0, oacc[j2]);
            oacc[j2] = fmaf(p.y, x1, oacc[j2]);
            oacc[j2] = fmaf(p.z, x2, oacc[j2]);
            oacc[j2] = fmaf(p.w, x3, oacc[j2]);
          }
        }
      }
      // S.s, S.alpha and this slot are rewritten after the next sub-step's barrier
    }
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
}

// ---------------------------------------------------------------------------
// K2 plain-K stats form and K4 weights: the export passes (design notes at
// the top). Both walk the tile list built with lone filler bags
// (fused_k_common.cuh), an even share of the units a block, and split each
// 64-key tile over the 8 warps: warp w takes keys 8w .. 8w + 7 in four
// steps of two keys, scored against every query by pk_key_sums (its warp
// argument 0: the two rows of the warp's own slot). Each warp streams its
// own k rows through its own cp.async ring (8 KB: eight slots at D = 128,
// four at 256, two at 512), issued ahead across tiles and bags, so a warp
// waits for its own copies alone (__syncwarp) and the block meets at a
// barrier only where the bag changes. Lane 2r + 4n (r < 2, n < N) then holds
// the score of query n against the step's key r: the stats pass runs an
// online (m, l) in that lane, the weights pass stages that weight.
// ---------------------------------------------------------------------------
constexpr int EX_KPS = PK_KPW;               // keys a warp step (pk_key_sums' two)
constexpr int EX_WKEYS = FK_BM / WARPS;      // keys of a tile a warp takes
constexpr int EX_STEPS = EX_WKEYS / EX_KPS;  // warp steps a tile

template <int D>
struct PkExportSmem {
  static constexpr int SLOT = EX_KPS * D;           // a warp step's k rows
  static constexpr int NSLOT = 8192 / (4 * SLOT);   // 8 at D = 128, 4 at 256, 2 at 512
  alignas(16) float ring[WARPS][NSLOT][SLOT];
  alignas(16) float q[NMAX][D];
  alignas(16) float tq[NMAX][D];
  alignas(16) float w[WARPS][NMAX][EX_WKEYS];  // weights: a warp's keys of a tile
  float red[WARPS][NMAX][2];                   // stats: each warp's (m, l) of a bag
};

// The next warp step of the block's share into the warp's `slot`,
// asynchronously (zero rows past M): list position c.i, step c.j of its
// tile; the lone units have none. Past the share (i >= i1) issues nothing.
template <int D>
__device__ __forceinline__ void ex_issue(float* __restrict__ slot, const float* __restrict__ k,
                                         const uint8_t* __restrict__ flags,
                                         const int* __restrict__ list, int n_tiles, int M,
                                         int i1, int warp, int lane, PkCursor& c) {
  while (c.i < i1 && flags[list[c.i]] == FK_LONE) ++c.i;  // c.j == 0 at a unit's start
  if (c.i >= i1) return;
  const int u = list[c.i], r0 = (u % n_tiles) * FK_BM + warp * EX_WKEYS + c.j * EX_KPS;
  const float* src = k + (size_t)(u / n_tiles) * M * D;
  constexpr int V4 = D / 4;
#pragma unroll
  for (int x = lane; x < EX_KPS * V4; x += 32) {
    const int row = x / V4, col = 4 * (x % V4);
    const bool ok = r0 + row < M;
    cp_async16(slot + row * D + col, ok ? src + (size_t)(r0 + row) * D + col : src, ok);
  }
  if (++c.j == EX_STEPS) {
    c.j = 0;
    ++c.i;
  }
}

// The bag's queries (and tanh of them, with the pre-gate) into shared memory.
template <int D, bool PG>
__device__ __forceinline__ void ex_load_queries(const float* __restrict__ q, int b, int N,
                                                float (*q_s)[D], float (*tq_s)[D]) {
  for (int x = threadIdx.x; x < N * D; x += THREADS) {
    const float val = q[(size_t)b * N * D + x];
    q_s[x / D][x % D] = val;
    if (PG) tq_s[x / D][x % D] = tanhf(val);
  }
}

__device__ __forceinline__ float inv_l(float l) { return l == 0.f ? 1.f : 1.f / l; }

// w[b, n, key] = exp(NEG - m[b, n]) / l[b, n], the weight of a masked key
// (exactly 0 in a bag with a valid key; 1 / M in a bag without one, whose
// l = M, m = NEG), for n < N and the keys of tiles t0 .. t1 - 1; every
// thread a share of each row, float4 stores where the rows are 16-byte
// aligned.
__device__ __forceinline__ void fill_masked(float* __restrict__ w, const float* __restrict__ l,
                                            const float* __restrict__ m, int b, int N, int M,
                                            int t0, int t1) {
  const int k0 = t0 * FK_BM, len = min(t1 * FK_BM, M) - k0;
  for (int n = 0; n < N && len > 0; ++n) {
    const int i = b * N + n;
    const float z = expf(NEG - m[i]) * inv_l(l[i]);
    float* row = w + (size_t)i * M + k0;
    if ((M & 3) == 0) {  // k0 % 64 == 0 and len % 4 == 0
      for (int x = threadIdx.x; x < len / 4; x += THREADS)
        reinterpret_cast<float4*>(row)[x] = make_float4(z, z, z, z);
    } else {
      for (int x = threadIdx.x; x < len; x += THREADS) row[x] = z;
    }
  }
}

// K2, plain-K stats form (export pass 1). For each bag it visits, a block
// writes one partial (m, l) at index block + bag of ml_part [G + B, N, 2]:
// the owner lanes' states merged in lane, then warp order; combine_kernel
// merges a bag's partials in block order. A lone unit (a bag without a
// valid key) writes m = NEG, l = M and reads no k.
template <int D, bool PG>
__global__ void __launch_bounds__(THREADS, 2)
stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const uint8_t* __restrict__ mask, const uint8_t* __restrict__ flags,
             const int* __restrict__ list, const int* __restrict__ off,
             float* __restrict__ ml_part, int B, int N, int M, float scale) {
  using S_ = PkExportSmem<D>;
  constexpr int NSLOT = S_::NSLOT;
  extern __shared__ float4 smem4[];
  S_& S = *reinterpret_cast<S_*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const int n = pk_query(lane), r = pk_key(lane);
  const bool owner = (lane & 1) == 0 && n < N;  // holds query n's score of the step's key r
  float(*ring)[S_::SLOT] = S.ring[warp];

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    ex_issue<D>(ring[s], k, flags, list, n_tiles, M, i1, warp, lane, cur);
    cp_async_commit();
  }

  float m_run = NEG, l_run = 0.f;  // the owner lane's online state
  int b = -1;
  auto flush = [&]() {  // the partial of bag b at index block + b (every thread calls it)
    const float m2 = __shfl_xor_sync(0xffffffffu, m_run, 2);
    const float l2 = __shfl_xor_sync(0xffffffffu, l_run, 2);
    if ((lane & 3) == 0 && n < N) {  // the step's two keys: lanes 4n and 4n + 2
      const float mw = fmaxf(m_run, m2);
      S.red[warp][n][0] = mw;
      S.red[warp][n][1] = l_run * expf(m_run - mw) + l2 * expf(m2 - mw);
    }
    __syncthreads();  // also: no warp reads S.q of bag b any more
    if (tid < N) {
      float mx = NEG, lx = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, S.red[w][tid][0]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) lx += S.red[w][tid][1] * expf(S.red[w][tid][0] - mx);
      const size_t pb = (size_t)blockIdx.x + b;
      ml_part[(pb * N + tid) * 2 + 0] = mx;
      ml_part[(pb * N + tid) * 2 + 1] = lx;
    }
    // S.red is rewritten by the next flush, after the next bag's barrier
  };

  int s = 0;  // the warp's step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles;
    if (flags[u] == FK_LONE) {
      if (b >= 0) flush();
      b = -1;
      if (tid < N) {
        const size_t pb = (size_t)blockIdx.x + ub;
        ml_part[(pb * N + tid) * 2 + 0] = NEG;
        ml_part[(pb * N + tid) * 2 + 1] = (float)M;
      }
      continue;
    }
    if (ub != b) {  // a new bag: flush the last one's partial, load this one's queries
      if (b >= 0) flush();
      b = ub;
      ex_load_queries<D, PG>(q, b, N, S.q, S.tq);
      m_run = NEG;
      l_run = 0.f;
      __syncthreads();
    }
    for (int j = 0; j < EX_STEPS; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncwarp();  // step s landed for the whole warp; the slot of s - 1 is free
      ex_issue<D>(ring[(s + NSLOT - 1) % NSLOT], k, flags, list, n_tiles, M, i1, warp, lane,
                  cur);
      cp_async_commit();
      float g, unused;
      const float a = pk_key_sums<D, PG, false>(ring[s % NSLOT], S.q, S.tq, nullptr, nullptr, N,
                                                0, lane, g, unused);
      const int key = t * FK_BM + warp * EX_WKEYS + j * EX_KPS + r;
      if (owner && key < M) {  // keys past M do not exist
        const float sv = mask == nullptr || mask[(size_t)b * M + key]
                             ? pk_score<PG>(a, g, scale) : NEG;
        const float m_new = fmaxf(m_run, sv);
        l_run = l_run * expf(m_run - m_new) + expf(sv - m_new);
        m_run = m_new;
      }
    }
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
}

// K4: w [B, N, M] = exp(s - m) / l from pass 1's l, m (l == 0: 1 / l taken
// as 1). A warp stages the weights of its 8 keys of a tile in shared memory
// and then stores them as row pieces, lane 2n + h the keys 4h .. 4h + 3 of
// query n (a float4 where the rows are 16-byte aligned). The keys of the
// skipped tiles (and of a lone bag) get exp(NEG - m) / l from fill_masked,
// written by the block that holds the computed tile before them (or the
// bag's last computed tile, for those after it).
template <int D, bool PG>
__global__ void __launch_bounds__(THREADS, 2)
weights_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const uint8_t* __restrict__ mask, const uint8_t* __restrict__ flags,
               const int* __restrict__ list, const int* __restrict__ off,
               const float* __restrict__ l, const float* __restrict__ m,
               float* __restrict__ w, int B, int N, int M, float scale) {
  using S_ = PkExportSmem<D>;
  constexpr int NSLOT = S_::NSLOT;
  extern __shared__ float4 smem4[];
  S_& S = *reinterpret_cast<S_*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const int n = pk_query(lane), r = pk_key(lane);
  const bool owner = (lane & 1) == 0 && n < N;
  float(*ring)[S_::SLOT] = S.ring[warp];
  float(*ws)[EX_WKEYS] = S.w[warp];

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    ex_issue<D>(ring[s], k, flags, list, n_tiles, M, i1, warp, lane, cur);
    cp_async_commit();
  }

  float mv = 0.f, linv = 1.f;  // the owner lane's query of bag b
  int b = -1, s = 0;
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles;
    if (flags[u] == FK_LONE) {
      fill_masked(w, l, m, ub, N, M, 0, n_tiles);
      continue;
    }
    fill_masked(w, l, m, ub, N, M, i > off[ub] ? list[i - 1] % n_tiles + 1 : 0, t);
    if (ub != b) {
      __syncthreads();  // no warp reads S.q of the last bag any more
      b = ub;
      ex_load_queries<D, PG>(q, b, N, S.q, S.tq);
      if (owner) {
        mv = m[(size_t)b * N + n];
        linv = inv_l(l[(size_t)b * N + n]);
      }
      __syncthreads();
    }
    const int k0 = t * FK_BM + warp * EX_WKEYS;  // the warp's first key of the tile
    for (int j = 0; j < EX_STEPS; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncwarp();
      ex_issue<D>(ring[(s + NSLOT - 1) % NSLOT], k, flags, list, n_tiles, M, i1, warp, lane,
                  cur);
      cp_async_commit();
      float g, unused;
      const float a = pk_key_sums<D, PG, false>(ring[s % NSLOT], S.q, S.tq, nullptr, nullptr, N,
                                                0, lane, g, unused);
      const int key = k0 + j * EX_KPS + r;
      if (owner) {  // a key past M gets a value that is never stored
        const bool valid = key < M && (mask == nullptr || mask[(size_t)b * M + key]);
        ws[n][j * EX_KPS + r] = expf((valid ? pk_score<PG>(a, g, scale) : NEG) - mv) * linv;
      }
    }
    __syncwarp();  // the warp's 8 weights of each query staged
    const int sn = lane >> 1, c = 4 * (lane & 1), key = k0 + c;
    if (sn < N && key < M) {
      float* dst = w + ((size_t)b * N + sn) * M + key;
      if ((M & 3) == 0) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&ws[sn][c]);
      } else {
        for (int x = 0; x < 4 && key + x < M; ++x) dst[x] = ws[sn][c + x];
      }
    }
    // ws is rewritten after the next tile's first __syncwarp
    if (i + 1 == off[ub + 1]) fill_masked(w, l, m, ub, N, M, t + 1, n_tiles);
  }
  cp_async_wait<0>();
}

// The export passes' main kernels over the blocks resident at once (at most
// max_blocks), with their dynamic shared memory allowed once per device.
template <typename Kernel>
int export_grid(Kernel kernel, int smem, int max_blocks, bool (&allowed)[64],
                int (&resident)[64], int* blocks) {
  const int err = allow_dynamic_smem(kernel, smem, allowed);
  return err ? err : resident_blocks(kernel, smem, max_blocks, resident, blocks);
}

template <int D, bool PG>
int launch_stats(const float* q, const float* k, const uint8_t* mask, float* l, float* m,
                 float* ml_part, uint8_t* flags, int* list, int* off, int B, int N, int M,
                 int max_blocks, float scale, cudaStream_t st) {
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = (int)sizeof(PkExportSmem<D>);
  int blocks = 0;
  int err = export_grid(stats_kernel<D, PG>, smem, max_blocks, allowed, resident, &blocks);
  if (err) return err;
  launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st, true);
  stats_kernel<D, PG><<<blocks, THREADS, smem, st>>>(q, k, mask, flags, list, off, ml_part, B,
                                                      N, M, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<<<dim3(B, N), THREADS, 0, st>>>(nullptr, ml_part, nullptr, nullptr, l, m,
                                                 nullptr, nullptr, N, 0, blocks, off);
  return (int)cudaGetLastError();
}

template <int D, bool PG>
int launch_weights(const float* q, const float* k, const uint8_t* mask, const float* l,
                   const float* m, float* w, uint8_t* flags, int* list, int* off, int B, int N,
                   int M, int max_blocks, bool list_ready, float scale, cudaStream_t st) {
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = (int)sizeof(PkExportSmem<D>);
  int blocks = 0;
  const int err = export_grid(weights_kernel<D, PG>, smem, max_blocks, allowed, resident, &blocks);
  if (err) return err;
  if (!list_ready) launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st, true);
  weights_kernel<D, PG><<<blocks, THREADS, smem, st>>>(q, k, mask, flags, list, off, l, m, w, B,
                                                        N, M, scale);
  return (int)cudaGetLastError();
}

// The fuse-K forward's launches: the tile flags and list, fused_k_kernel
// over `blocks` blocks, combine_kernel. sq_part and ssq are used by the
// TRAIN form only.
template <int E, int FC, bool TRAIN>
int launch_fk_instance(const float* q, const float* kv, const float* wk, const float* bk,
                       const uint8_t* mask, const int* list, const int* off, float* o_part,
                       float* ml_part, float* sq_part, const int* seed, uint32_t thresh,
                       float keep_scale, int B, int N, int M, int F, int blocks, float scale,
                       cudaStream_t st) {
  static bool allowed[64] = {};
  constexpr int smem = (int)sizeof(FkFwdSmem<E>);
  static_assert(smem <= 232448, "shared memory of one block");
  const int err = allow_dynamic_smem(fused_k_kernel<E, FC, TRAIN>, smem, allowed);
  if (err) return err;
  fused_k_kernel<E, FC, TRAIN><<<blocks, THREADS, smem, st>>>(
      q, kv, wk, bk, mask, list, off, o_part, ml_part, sq_part, seed, thresh, keep_scale, B, N,
      M, F, scale);
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int launch_fused_k(const float* q, const float* kv, const float* wk, const float* bk,
                   const uint8_t* mask, const int* seed, uint32_t thresh, float keep_scale,
                   float* o, float* l, float* m, float* ssq, float* sumw, float* o_part,
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
    err = launch_fk_instance<E_, FC_, TRAIN>(q, kv, wk, bk, mask, list, off, o_part, ml_part, \
                                             sq_part, seed, thresh, keep_scale, B, N, M, F,  \
                                             blocks, scale, st);
  if constexpr (TRAIN) {  // E, F in {128, 256}, or E = F = 512 (ops/coattn.py FUSED_K_TRAIN_EF)
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
  combine_kernel<<<dim3(B, N), THREADS, 0, st>>>(o_part, ml_part, sq_part, o, l, m, ssq, sumw,
                                                 N, F, blocks, off);
  return (int)cudaGetLastError();
}

// The plain-K forward's launches: the tile flags and list, plain_kernel over
// the blocks resident at once (at most max_blocks), combine_kernel.
template <int D, bool PG, bool TRAIN>
int launch_plain(const float* q, const float* k, const float* v, const uint8_t* mask,
                 const int* seed, float* o, float* l, float* m, float* ssq, float* sumw,
                 float* o_part, float* ml_part, float* sq_part, uint8_t* flags, int* list,
                 int* off, int B, int N, int M, int max_blocks, float scale, uint32_t thresh,
                 float keep_scale, cudaStream_t st) {
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = (int)sizeof(PkFwdSmem<D>);
  static_assert(smem <= 232448, "shared memory of one block");
  int err = allow_dynamic_smem(plain_kernel<D, PG, TRAIN>, smem, allowed);
  if (err) return err;
  int blocks = 0;
  err = resident_blocks(plain_kernel<D, PG, TRAIN>, smem, max_blocks, resident, &blocks);
  if (err) return err;
  launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st);
  plain_kernel<D, PG, TRAIN><<<blocks, THREADS, smem, st>>>(
      q, k, v, mask, list, off, o_part, ml_part, sq_part, seed, thresh, keep_scale, B, N, M,
      scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<<<dim3(B, N), THREADS, 0, st>>>(o_part, ml_part, TRAIN ? sq_part : nullptr, o,
                                                 l, m, ssq, TRAIN ? sumw : nullptr, N, D,
                                                 blocks, off);
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
  return launch_fused_k<false>(q, kv, wk, bk, mask, nullptr, 0u, 1.f, o, l, m, nullptr,
                               sumw, o_part, ml_part, nullptr, flags, list, off, B, N, M, F,
                               E, blocks, scale, stream);
}

// The training form: as above plus attention dropout (seed: one int32 on the
// device; keep iff dropout_bits >= thresh, kept weights times keep_scale;
// thresh 0 = no dropout) and the ssq side output. Out: o [B, N, F], l, m
// (saved for the backward), ssq, sumw [B, N]. Extra scratch: sq_part
// [blocks + B, N, 2]. E, F in {128, 256}, or E = F = 512.
int mpo_coattn_fwd_fused_k_train(const float* q, const float* kv, const float* wk,
                                 const float* bk, const uint8_t* mask, const int* seed,
                                 float* o, float* l, float* m, float* ssq, float* sumw,
                                 float* o_part, float* ml_part, float* sq_part, uint8_t* flags,
                                 int* list, int* off, int B, int N, int M, int F, int E,
                                 int blocks, float scale, uint32_t thresh, float keep_scale,
                                 void* stream) {
  return launch_fused_k<true>(q, kv, wk, bk, mask, seed, thresh, keep_scale, o, l, m, ssq,
                              sumw, o_part, ml_part, sq_part, flags, list, off, B, N, M, F, E,
                              blocks, scale, stream);
}

// The export passes take N <= 8 queries, D in {128, 256, 512}, with or
// without the pre-gate.
#define MPO_EXPORT(LAUNCH, ...)                                                        \
  if (pre_gate) {                                                                      \
    if (D == 128) return LAUNCH<128, true>(__VA_ARGS__);                               \
    if (D == 256) return LAUNCH<256, true>(__VA_ARGS__);                               \
    if (D == 512) return LAUNCH<512, true>(__VA_ARGS__);                               \
  } else {                                                                             \
    if (D == 128) return LAUNCH<128, false>(__VA_ARGS__);                              \
    if (D == 256) return LAUNCH<256, false>(__VA_ARGS__);                              \
    if (D == 512) return LAUNCH<512, false>(__VA_ARGS__);                              \
  }                                                                                    \
  return (int)cudaErrorInvalidValue;

// Export pass 1: q [B, N, D], k [B, M, D], mask [B, M] bool or NULL -> l, m
// [B, N]; also leaves the mask's tile list with lone filler bags in flags
// [B * T] uint8, list [B * T] and off [B + 1] int32 (T = ceil(M / 64) key
// tiles a bag), which pass 2 may take. max_blocks: the most main-pass
// blocks (it runs the blocks resident at once, up to that). Scratch: ml_part
// [max_blocks + B, N, 2].
int mpo_coattn_stats(const float* q, const float* k, const uint8_t* mask, float* l, float* m,
                     float* ml_part, uint8_t* flags, int* list, int* off, int B, int N, int M,
                     int D, int pre_gate, int max_blocks, float scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || max_blocks < 1 || max_blocks > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MPO_EXPORT(launch_stats, q, k, mask, l, m, ml_part, flags, list, off, B, N, M, max_blocks,
             scale, st)
}

// Export pass 2: q, k, mask as pass 1, l, m [B, N] -> w [B, N, M]. list_ready
// != 0: flags, list and off hold the tile list a pass-1 call left for this
// mask; else this call builds it there.
int mpo_coattn_weights(const float* q, const float* k, const uint8_t* mask, const float* l,
                       const float* m, float* w, uint8_t* flags, int* list, int* off, int B,
                       int N, int M, int D, int pre_gate, int max_blocks, int list_ready,
                       float scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MPO_EXPORT(launch_weights, q, k, mask, l, m, w, flags, list, off, B, N, M, max_blocks,
             list_ready != 0, scale, st)
}
#undef MPO_EXPORT

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
// attention dropout (seed, thresh, keep_scale as mpo_coattn_fwd_fused_k_train)
// and ssq, sumw [B, N] of the dropped weights; else seed, ssq, sumw and
// sq_part may be NULL. max_blocks: the most main-pass blocks (it runs the
// blocks resident at once, up to that). Scratch: o_part [max_blocks + B, N,
// D], ml_part and sq_part [max_blocks + B, N, 2], flags [B * T] uint8, list
// [B * T] and off [B + 1] int32 (T = ceil(M / 64) key tiles a bag). D in
// {128, 256}; N <= 8.
int mpo_coattn_plain_fwd(const float* q, const float* k, const float* v,
                         const uint8_t* mask, const int* seed, float* o, float* l, float* m,
                         float* ssq, float* sumw, float* o_part, float* ml_part,
                         float* sq_part, uint8_t* flags, int* list, int* off, int B, int N,
                         int M, int D, int pre_gate, int max_blocks, int train, float scale,
                         uint32_t thresh, float keep_scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || max_blocks < 1 || max_blocks > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPO_PLAIN(D_, PG_, TRAIN_)                                                           \
  if (D == D_ && (pre_gate != 0) == PG_ && (train != 0) == TRAIN_)                           \
    return launch_plain<D_, PG_, TRAIN_>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part,     \
                                         ml_part, sq_part, flags, list, off, B, N, M,         \
                                         max_blocks, scale, thresh, keep_scale, st);
  MPO_PLAIN(256, false, false) MPO_PLAIN(256, true, false) MPO_PLAIN(256, false, true)
  MPO_PLAIN(256, true, true) MPO_PLAIN(128, false, false) MPO_PLAIN(128, true, false)
  MPO_PLAIN(128, false, true) MPO_PLAIN(128, true, true)
#undef MPO_PLAIN
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
