// Pre-gated few-query co-attention kernels for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of multimodal_path_omic_tpu/ops/coattn.py:
//   * mpo_coattn_fwd_fused_k  <- _coattn_fwd_impl with _make_fwd_kernel(
//       fuse_k=True, pre_gate=True, emit_sumw=True), no dropout (lean-V eval)
//   * mpo_coattn_fwd_fused_k_train <- the same with dropout_rate > 0,
//       emit_ssq=True, emit_sumw=True, l and m kept for the backward (lean-V
//       training; the backward is csrc/coattn_bwd.cu)
//   * mpo_coattn_stats        <- _coattn_fwd_impl with the plain K operand,
//       used for the (l, m) statistics in coattention_weights (export pass 1)
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
//     embedding), so it is bound by the float32 rate of the CUDA cores
//     (67 TFLOP/s: 0.51 ms), not by the 268 MB of kv it reads (0.08 ms at
//     3.35 TB/s). Each block streams 64-key tiles of kv, projects them with a
//     register-tiled SIMT GEMM (8x8 outputs per thread for E=256) through
//     shared memory (the next F chunk prefetched into registers while the
//     current one is multiplied; 128-bit shared reads in the inner loop), so
//     the [B, M, E] k never reaches device memory; the
//     pre-gate and key mask are applied in the epilogue with warp-shuffle
//     reductions (one warp owns 8 keys across all E columns), then an online
//     softmax (one warp per query) and o += p * kv re-read from L2. The M
//     axis is split over several blocks per bag so B=32 bags fill the 132
//     SMs; a second small kernel merges the per-split (m, l, o) partials.
//     Tensor cores (TF32 wgmma) are left out on purpose: TF32 breaks the
//     float32 parity the port is held to. The training form is the same
//     kernel (template flag): the Philox bits, ssq and sumw cost a few
//     instructions per key in the softmax step, outside the GEMM, and the
//     per-split (ssq, sumw) partials are merged by rescaling with the split's
//     e^(m_p - m) (squared for ssq).
//   * stats / weights: read k [B, M, D] once (268 MB at B=32, M=8192,
//     D=256: 0.08 ms at 3.35 TB/s) and do under 2 GFLOP, so they are bound
//     by bytes. One warp scores one key at a time with coalesced float4
//     loads (the whole D row in one or two instructions per lane) and many
//     blocks per bag keep enough loads in flight; the stats partials of every
//     warp are merged by the same combine kernel.
//   * plain (plain-K with values): reads k and v [B, M, D] once each (537 MB at
//     B=32, M=8192, D=256: 0.16 ms) for 2.4 GFLOP of products (0.04 ms): bound
//     by bytes. One warp owns a contiguous run of keys: it loads a key's k and
//     v rows with coalesced float4 loads (the next key's rows are requested
//     before the current one is scored), scores it against all N queries
//     (score_row), and keeps an online softmax and the N x D output sums in
//     registers, rescaling them only when a row maximum moves (the branch is
//     uniform over the warp). The dropout bits of the N queries are drawn by
//     lanes 0..N-1 and shared by a ballot. A block merges its 8 warps in
//     shared memory in warp order, writes one unnormalized partial per (bag,
//     split), and combine_kernel merges the splits: a fixed order throughout,
//     so two runs give the same bits.
//
// Interface: plain C, called through ctypes. Every function returns
// cudaGetLastError() after its launches (0 = success); nothing allocates,
// everything runs on the caller's stream.

#include "coattn_common.cuh"

namespace {

using namespace mpo;

constexpr int FK_FMAX = 1024;  // widest kv row (4 columns per thread)

// ---------------------------------------------------------------------------
// K2, fuse-K form: one block = (bag b, split of the key tiles).
// Writes unnormalized partials: o_part [B, P, N, F], ml_part [B, P, N, 2]
// (m, l); TRAIN adds sq_part [B, P, N, 2] (ssq, sumw of the dropped
// weights). TRAIN: attention dropout after normalization (l sums the
// undropped p; o, ssq and sumw take the dropped pd = keep * p / (1 - rate)),
// bits from dropout_bits(seed, b, n, key) with keep iff bits >= thresh
// (thresh 0: no dropout).
// ---------------------------------------------------------------------------
template <int E, int FC, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
fused_k_kernel(const float* __restrict__ q, const float* __restrict__ kv,
               const float* __restrict__ wk, const float* __restrict__ bk,
               const uint8_t* __restrict__ mask, float* __restrict__ o_part,
               float* __restrict__ ml_part, float* __restrict__ sq_part,
               const int* __restrict__ seed_ptr, uint32_t thresh, float keep_scale,
               int N, int M, int F, int tiles_per_split, float scale) {
  // Lane `lane` owns the E columns col(j) = (j / 4) * 128 + 4 * lane + j % 4
  // (float4 groups: conflict-free 128-bit shared-memory reads); warp w owns
  // key rows 8w .. 8w + 7 of the tile. kv_s is stored transposed, so a
  // warp's 8 rows at one depth are two broadcast float4 reads.
  constexpr int EPT = E / 32;                     // E columns per lane
  constexpr int WK_V4 = FK_BF * E / 4 / THREADS;  // wk float4s per thread per chunk
  __shared__ __align__(16) float kv_s[FK_BF][FK_BM + 4];
  __shared__ __align__(16) float wk_s[FK_BF][E];
  __shared__ __align__(16) float q_s[NMAX][E];
  __shared__ __align__(16) float tq_s[NMAX][E];
  __shared__ float s_s[NMAX][FK_BM];
  __shared__ float alpha_s[NMAX];

  const int b = blockIdx.x, split = blockIdx.y, P = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < N * E; i += THREADS) {
    const float v = q[(size_t)b * N * E + i];
    q_s[i / E][i % E] = v;
    tq_s[i / E][i % E] = tanhf(v);
  }
  float bias[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) bias[j] = bk[(j >> 2) * 128 + 4 * lane + (j & 3)];

  float m_run = NEG, l_run = 0.f;  // the softmax state of query `warp`
  float ssq_run = 0.f, sumw_run = 0.f;  // TRAIN: sums of pd^2 and pd
  const uint32_t seed = TRAIN ? (uint32_t)seed_ptr[0] : 0u;
  float oacc[NMAX][FC];
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
#pragma unroll
    for (int c = 0; c < FC; ++c) oacc[n][c] = 0.f;

  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  const float* kv_b = kv + (size_t)b * M * F;
  const int kv_row = tid >> 2, kv_c4 = tid & 3;  // this thread's kv float4 per chunk
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int m0 = t * FK_BM;
    // ---- k tile = kv[m0:m0+64] @ wk, register-tiled over (key rows, E);
    //      the next F chunk is prefetched into registers during the math ----
    float acc[FK_RPW][EPT];
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
      for (int j = 0; j < EPT; ++j) acc[i][j] = 0.f;

    const bool kv_ok = m0 + kv_row < M;  // zero rows past M
    const float* kv_src = kv_b + (size_t)(m0 + kv_row) * F + kv_c4 * 4;
    float4 kreg = kv_ok ? *reinterpret_cast<const float4*>(kv_src) : zero4;
    float4 wreg[WK_V4];
#pragma unroll
    for (int v = 0; v < WK_V4; ++v) {
      const int idx = tid + v * THREADS, r = idx / (E / 4), c = idx % (E / 4);
      wreg[v] = reinterpret_cast<const float4*>(wk + (size_t)r * E)[c];
    }
    for (int f0 = 0; f0 < F; f0 += FK_BF) {
      kv_s[kv_c4 * 4 + 0][kv_row] = kreg.x;
      kv_s[kv_c4 * 4 + 1][kv_row] = kreg.y;
      kv_s[kv_c4 * 4 + 2][kv_row] = kreg.z;
      kv_s[kv_c4 * 4 + 3][kv_row] = kreg.w;
#pragma unroll
      for (int v = 0; v < WK_V4; ++v) {
        const int idx = tid + v * THREADS, r = idx / (E / 4), c = idx % (E / 4);
        reinterpret_cast<float4*>(&wk_s[r][0])[c] = wreg[v];
      }
      __syncthreads();
      if (f0 + FK_BF < F) {  // prefetch the next chunk; lands during the math
        kreg = kv_ok ? *reinterpret_cast<const float4*>(kv_src + f0 + FK_BF) : zero4;
#pragma unroll
        for (int v = 0; v < WK_V4; ++v) {
          const int idx = tid + v * THREADS, r = idx / (E / 4), c = idx % (E / 4);
          wreg[v] = reinterpret_cast<const float4*>(wk + (size_t)(f0 + FK_BF + r) * E)[c];
        }
      }
#pragma unroll
      for (int kk = 0; kk < FK_BF; ++kk) {
        float a[FK_RPW], w[EPT];
        const float4 a0 = *reinterpret_cast<const float4*>(&kv_s[kk][warp * FK_RPW]);
        const float4 a1 = *reinterpret_cast<const float4*>(&kv_s[kk][warp * FK_RPW + 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4) {
          const float4 wv = *reinterpret_cast<const float4*>(&wk_s[kk][j4 * 128 + 4 * lane]);
          w[4 * j4 + 0] = wv.x; w[4 * j4 + 1] = wv.y; w[4 * j4 + 2] = wv.z; w[4 * j4 + 3] = wv.w;
        }
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
          for (int j = 0; j < EPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }

    // ---- epilogue: bias, q.k, pre-gate, mask -> s_s[n][key] ----
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
      for (int j = 0; j < EPT; ++j) acc[i][j] += bias[j];
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < EPT; ++j)
          p = fmaf(acc[i][j], q_s[n][(j >> 2) * 128 + 4 * lane + (j & 3)], p);
        p = warp_sum(p);
        if (lane == i) s_s[n][warp * FK_RPW + i] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
      for (int j = 0; j < EPT; ++j) acc[i][j] = tanhf(acc[i][j]);
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        float g = 0.f;
#pragma unroll
        for (int j = 0; j < EPT; ++j)
          g = fmaf(acc[i][j], tq_s[n][(j >> 2) * 128 + 4 * lane + (j & 3)], g);
        g = warp_sum(g);
        if (lane == i) {  // the same lane wrote q.k above: no barrier needed
          const int row = warp * FK_RPW + i, key = m0 + row;
          float s = s_s[n][row] * scale;
          s = s * (g + 1.f) * 0.5f;
          if (key >= M) s = -INFINITY;  // does not exist: weight exactly 0
          else if (mask != nullptr && !mask[(size_t)b * M + key]) s = NEG;
          s_s[n][row] = s;
        }
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per query ----
    if (warp < N) {
      const float s0 = s_s[warp][lane], s1 = s_s[warp][lane + 32];
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
      s_s[warp][lane] = p0;
      s_s[warp][lane + 32] = p1;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    // ---- o[n, f] = alpha * o + sum_r p[n, r] * kv[r, f] (kv re-read, L2) ----
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float a = alpha_s[n];
#pragma unroll
        for (int c = 0; c < FC; ++c) oacc[n][c] *= a;
      }
    }
    const int rows = min(FK_BM, M - m0);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const float* kvr = kv_b + (size_t)(m0 + r) * F;
      float x[FC];
#pragma unroll
      for (int c = 0; c < FC; ++c) {
        const int f = tid + THREADS * c;
        x[c] = f < F ? kvr[f] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          const float p = s_s[n][r];
#pragma unroll
          for (int c = 0; c < FC; ++c) oacc[n][c] = fmaf(p, x[c], oacc[n][c]);
        }
      }
    }
    __syncthreads();  // s_s / alpha_s are rewritten by the next tile
  }

  const size_t pb = (size_t)b * P + split;
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
}

// ---------------------------------------------------------------------------
// Merge P partial (m, l[, o]) states per (bag, query):
//   m = max_p m_p;  l = sum_p l_p e^(m_p - m);  o = sum_p o_p e^(m_p - m) / l
// with the l == 0 guard of the TPU kernel. Without sq_part, sumw = l / l (the
// weight mass of the final row; no dropout in eval); with it (training form)
//   ssq = sum_p ssq_p e^(2 (m_p - m)) / l^2,  sumw = sum_p sumw_p e^(m_p - m) / l.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
               const float* __restrict__ sq_part, float* __restrict__ o,
               float* __restrict__ l_out, float* __restrict__ m_out,
               float* __restrict__ ssq, float* __restrict__ sumw, int N, int F, int P) {
  __shared__ float fac[MAX_PARTS];
  __shared__ float red[WARPS], red_sq[WARPS], red_sw[WARPS];
  const int b = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* ml = ml_part + ((size_t)b * P * N + n) * 2;  // stride N*2 per part

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
      const size_t i = (((size_t)b * P + p) * N + n) * 2;  // ml_part's layout
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
        acc = fmaf(o_part[(((size_t)b * P + p) * N + n) * F + f], fac[p], acc);
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

// ---------------------------------------------------------------------------
// Per-key scores for the plain-K forms: one warp scores one key against all
// N queries. Lane `lane` holds k[c*128 + 4*lane .. +3] for c < DV (D = 128*DV).
// ---------------------------------------------------------------------------
template <int DV>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int lane,
                                         float4 (&x)[DV]) {
#pragma unroll
  for (int c = 0; c < DV; ++c) x[c] = *reinterpret_cast<const float4*>(row + c * 128 + 4 * lane);
}

// Scores of one key row held in registers (kx, load_row's layout) against all
// N queries; tk receives tanh(kx) when pre_gate.
template <int DV>
__device__ __forceinline__ void score_row(const float4 (&kx)[DV], float4 (&tk)[DV],
                                          const float (*q_s)[DV * 128],
                                          const float (*tq_s)[DV * 128], int N,
                                          bool pre_gate, float scale, int lane,
                                          float (&s)[NMAX]) {
  if (pre_gate) {
#pragma unroll
    for (int c = 0; c < DV; ++c)
      tk[c] = make_float4(tanhf(kx[c].x), tanhf(kx[c].y), tanhf(kx[c].z), tanhf(kx[c].w));
  }
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    if (n < N) {
      float d = 0.f, g = 0.f;
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[n][c * 128 + 4 * lane]);
        d = fmaf(qv.x, kx[c].x, fmaf(qv.y, kx[c].y, fmaf(qv.z, kx[c].z, fmaf(qv.w, kx[c].w, d))));
        if (pre_gate) {
          const float4 tv = *reinterpret_cast<const float4*>(&tq_s[n][c * 128 + 4 * lane]);
          g = fmaf(tv.x, tk[c].x, fmaf(tv.y, tk[c].y, fmaf(tv.z, tk[c].z, fmaf(tv.w, tk[c].w, g))));
        }
      }
      float v = warp_sum(d) * scale;
      if (pre_gate) v = v * (warp_sum(g) + 1.f) * 0.5f;
      s[n] = v;
    }
  }
}

template <int DV>
__device__ __forceinline__ void score_key(const float* __restrict__ krow,
                                          const float (*q_s)[DV * 128],
                                          const float (*tq_s)[DV * 128], int N,
                                          bool pre_gate, float scale, int lane,
                                          float (&s)[NMAX]) {
  float4 kx[DV], tk[DV];
  load_row<DV>(krow, lane, kx);
  score_row<DV>(kx, tk, q_s, tq_s, N, pre_gate, scale, lane, s);
}

template <int DV>
__device__ __forceinline__ void load_queries(const float* __restrict__ q, int b, int N,
                                             float (*q_s)[DV * 128],
                                             float (*tq_s)[DV * 128]) {
  constexpr int D = DV * 128;
  for (int i = threadIdx.x; i < N * D; i += THREADS) {
    const float v = q[(size_t)b * N * D + i];
    q_s[i / D][i % D] = v;
    tq_s[i / D][i % D] = tanhf(v);
  }
  __syncthreads();
}

// K2, plain-K stats form: every warp runs an online (m, l) over a contiguous
// chunk of keys and writes one partial; combine_kernel merges them.
template <int DV>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const uint8_t* __restrict__ mask, float* __restrict__ ml_part, int N,
             int M, int pre_gate, float scale) {
  constexpr int D = DV * 128;
  __shared__ __align__(16) float q_s[NMAX][D];
  __shared__ __align__(16) float tq_s[NMAX][D];
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int gw = blockIdx.y * WARPS + (threadIdx.x >> 5), W = gridDim.y * WARPS;
  load_queries<DV>(q, b, N, q_s, tq_s);

  float mr[NMAX], lr[NMAX], s[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) { mr[n] = NEG; lr[n] = 0.f; }
  const int chunk = (M + W - 1) / W;
  const int k0 = gw * chunk, k1 = min(M, k0 + chunk);
  for (int key = k0; key < k1; ++key) {
    score_key<DV>(k + ((size_t)b * M + key) * D, q_s, tq_s, N, pre_gate != 0, scale, lane, s);
    const bool valid = mask == nullptr || mask[(size_t)b * M + key];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float v = valid ? s[n] : NEG;
        const float m_new = fmaxf(mr[n], v);
        lr[n] = lr[n] * expf(mr[n] - m_new) + expf(v - m_new);
        mr[n] = m_new;
      }
    }
  }
  if (lane == 0) {
    const size_t base = ((size_t)b * W + gw) * N;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        ml_part[(base + n) * 2 + 0] = mr[n];
        ml_part[(base + n) * 2 + 1] = lr[n];
      }
    }
  }
}

// K4: w[b, n, key] = exp(s - m) / l from the final pass-1 statistics.
template <int DV>
__global__ void __launch_bounds__(THREADS)
weights_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const uint8_t* __restrict__ mask, const float* __restrict__ l,
               const float* __restrict__ m, float* __restrict__ w, int N, int M,
               int pre_gate, float scale) {
  constexpr int D = DV * 128;
  __shared__ __align__(16) float q_s[NMAX][D];
  __shared__ __align__(16) float tq_s[NMAX][D];
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int gw = blockIdx.y * WARPS + (threadIdx.x >> 5), W = gridDim.y * WARPS;
  load_queries<DV>(q, b, N, q_s, tq_s);

  float mv[NMAX], linv[NMAX], s[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    if (n < N) {
      const float lv = l[(size_t)b * N + n];
      mv[n] = m[(size_t)b * N + n];
      linv[n] = lv == 0.f ? 1.f : 1.f / lv;
    }
  }
  const int chunk = (M + W - 1) / W;
  const int k0 = gw * chunk, k1 = min(M, k0 + chunk);
  for (int key = k0; key < k1; ++key) {
    score_key<DV>(k + ((size_t)b * M + key) * D, q_s, tq_s, N, pre_gate != 0, scale, lane, s);
    const bool valid = mask == nullptr || mask[(size_t)b * M + key];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N && lane == n) {
        const float v = valid ? s[n] : NEG;
        w[((size_t)b * N + n) * M + key] = expf(v - mv[n]) * linv[n];
      }
    }
  }
}

// K2, plain-K form with values: one block = (bag b, split of the keys), one
// warp = a contiguous run of keys. Writes one unnormalized partial per block:
// o_part [B, P, N, D], ml_part [B, P, N, 2] (m, l); TRAIN adds sq_part
// [B, P, N, 2] (ssq, sumw of the dropped weights), with the dropout rule of
// fused_k_kernel (keep iff dropout_bits >= thresh; thresh 0: no dropout).
template <int DV, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
plain_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const uint8_t* __restrict__ mask,
             float* __restrict__ o_part, float* __restrict__ ml_part,
             float* __restrict__ sq_part, const int* __restrict__ seed_ptr, uint32_t thresh,
             float keep_scale, int N, int M, int pre_gate, float scale) {
  constexpr int D = DV * 128;
  __shared__ __align__(16) float q_s[NMAX][D];
  __shared__ __align__(16) float tq_s[NMAX][D];
  __shared__ __align__(16) float o_s[NMAX][D];
  __shared__ float m_s[WARPS][NMAX];
  __shared__ float st_s[3][NMAX];  // l, ssq, sumw of the block
  const int b = blockIdx.x, split = blockIdx.y, P = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = split * WARPS + warp, W = P * WARPS;
  load_queries<DV>(q, b, N, q_s, tq_s);

  float mr[NMAX], lr[NMAX], sq[NMAX], sw[NMAX], s[NMAX];
  float4 o[NMAX][DV];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    mr[n] = NEG;
    lr[n] = sq[n] = sw[n] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) o[n][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const uint32_t seed = TRAIN ? (uint32_t)seed_ptr[0] : 0u;
  const int chunk = (M + W - 1) / W;
  const int k0 = gw * chunk, k1 = min(M, k0 + chunk);
  const float* k_b = k + (size_t)b * M * D;
  const float* v_b = v + (size_t)b * M * D;
  float4 kx[DV], vx[DV], kn[DV], vn[DV], tk[DV];
  if (k0 < k1) {
    load_row<DV>(k_b + (size_t)k0 * D, lane, kn);
    load_row<DV>(v_b + (size_t)k0 * D, lane, vn);
  }
  for (int key = k0; key < k1; ++key) {
#pragma unroll
    for (int c = 0; c < DV; ++c) { kx[c] = kn[c]; vx[c] = vn[c]; }
    if (key + 1 < k1) {  // the next key's rows land while this one is scored
      load_row<DV>(k_b + (size_t)(key + 1) * D, lane, kn);
      load_row<DV>(v_b + (size_t)(key + 1) * D, lane, vn);
    }
    score_row<DV>(kx, tk, q_s, tq_s, N, pre_gate != 0, scale, lane, s);
    const bool valid = mask == nullptr || mask[(size_t)b * M + key];
    uint32_t keep = 0xffffffffu;
    if constexpr (TRAIN) {
      if (thresh != 0u)  // lane n draws query n's bits
        keep = __ballot_sync(0xffffffffu, dropout_bits(seed, (uint32_t)b,
                                                       (uint32_t)(lane < N ? lane : 0),
                                                       (uint32_t)key) >= thresh);
    }
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float sv = valid ? s[n] : NEG;
        if (sv > mr[n]) {  // the same in every lane: warp_sum leaves all lanes equal
          const float alpha = expf(mr[n] - sv);
          mr[n] = sv;
          lr[n] *= alpha;
          if constexpr (TRAIN) {
            sq[n] *= alpha * alpha;
            sw[n] *= alpha;
          }
#pragma unroll
          for (int c = 0; c < DV; ++c) {
            o[n][c].x *= alpha; o[n][c].y *= alpha; o[n][c].z *= alpha; o[n][c].w *= alpha;
          }
        }
        float p = expf(sv - mr[n]);
        lr[n] += p;
        if constexpr (TRAIN) {
          p = (keep >> n) & 1u ? p * keep_scale : 0.f;
          sq[n] = fmaf(p, p, sq[n]);
          sw[n] += p;
        }
#pragma unroll
        for (int c = 0; c < DV; ++c) {
          o[n][c].x = fmaf(p, vx[c].x, o[n][c].x); o[n][c].y = fmaf(p, vx[c].y, o[n][c].y);
          o[n][c].z = fmaf(p, vx[c].z, o[n][c].z); o[n][c].w = fmaf(p, vx[c].w, o[n][c].w);
        }
      }
    }
  }

  // ---- merge the block's warps in warp order (a fixed order) ----
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) m_s[warp][n] = mr[n];
  }
  __syncthreads();
  float fac[NMAX], mb[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    if (n < N) {
      float mx = m_s[0][n];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][n]);
      mb[n] = mx;
      fac[n] = expf(mr[n] - mx);
    }
  }
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
#pragma unroll
          for (int c = 0; c < DV; ++c) {
            float4* dst = reinterpret_cast<float4*>(&o_s[n][c * 128 + 4 * lane]);
            float4 acc = w == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *dst;
            acc.x = fmaf(o[n][c].x, fac[n], acc.x); acc.y = fmaf(o[n][c].y, fac[n], acc.y);
            acc.z = fmaf(o[n][c].z, fac[n], acc.z); acc.w = fmaf(o[n][c].w, fac[n], acc.w);
            *dst = acc;
          }
          if (lane == 0) {
            const float l0 = w == 0 ? 0.f : st_s[0][n];
            st_s[0][n] = fmaf(lr[n], fac[n], l0);
            if constexpr (TRAIN) {
              const float q0 = w == 0 ? 0.f : st_s[1][n], w0 = w == 0 ? 0.f : st_s[2][n];
              st_s[1][n] = fmaf(sq[n], fac[n] * fac[n], q0);
              st_s[2][n] = fmaf(sw[n], fac[n], w0);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t pb = (size_t)b * P + split;
  for (int i = threadIdx.x; i < N * D; i += THREADS)
    o_part[pb * N * D + i] = o_s[i / D][i % D];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        ml_part[(pb * N + n) * 2 + 0] = mb[n];
        ml_part[(pb * N + n) * 2 + 1] = st_s[0][n];
        if constexpr (TRAIN) {
          sq_part[(pb * N + n) * 2 + 0] = st_s[1][n];
          sq_part[(pb * N + n) * 2 + 1] = st_s[2][n];
        }
      }
    }
  }
}

template <int DV>
int launch_stats(const float* q, const float* k, const uint8_t* mask, float* ml_part,
                 int B, int N, int M, int pre_gate, float scale, int splits,
                 cudaStream_t st) {
  stats_kernel<DV><<<dim3(B, splits), THREADS, 0, st>>>(q, k, mask, ml_part, N, M,
                                                          pre_gate, scale);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_weights(const float* q, const float* k, const uint8_t* mask, const float* l,
                   const float* m, float* w, int B, int N, int M, int pre_gate,
                   float scale, int splits, cudaStream_t st) {
  weights_kernel<DV><<<dim3(B, splits), THREADS, 0, st>>>(q, k, mask, l, m, w, N, M,
                                                            pre_gate, scale);
  return (int)cudaGetLastError();
}

// fused_k_kernel over (B, splits) blocks, then combine_kernel. sq_part and
// ssq are used by the TRAIN form only.
template <bool TRAIN>
int launch_fused_k(const float* q, const float* kv, const float* wk, const float* bk,
                   const uint8_t* mask, const int* seed, uint32_t thresh, float keep_scale,
                   float* o, float* l, float* m, float* ssq, float* sumw, float* o_part,
                   float* ml_part, float* sq_part, int B, int N, int M, int F, int E,
                   int splits, float scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || F % FK_BF != 0 || F > FK_FMAX || splits < 1 ||
      splits > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = (n_tiles + splits - 1) / splits;
  const dim3 grid(B, splits);
  const int fc = F <= 256 ? 1 : (F <= 512 ? 2 : 4);  // kv columns per thread in o += p kv
#define MPO_FK(E_, FC_)                                                           \
  if (E == E_ && fc == FC_)                                                       \
    fused_k_kernel<E_, FC_, TRAIN><<<grid, THREADS, 0, st>>>(                     \
        q, kv, wk, bk, mask, o_part, ml_part, sq_part, seed, thresh, keep_scale, N, \
        M, F, per, scale);
  MPO_FK(256, 1) else MPO_FK(256, 2) else MPO_FK(256, 4)
  else MPO_FK(128, 1) else MPO_FK(128, 2) else MPO_FK(128, 4)
  else return (int)cudaErrorInvalidValue;
#undef MPO_FK
  int err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<<<dim3(B, N), THREADS, 0, st>>>(o_part, ml_part, sq_part, o, l, m, ssq,
                                                 sumw, N, F, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, N, E], kv [B, M, F], wk [F, E], bk [E], mask [B, M] bool or NULL.
// Out: o [B, N, F], l, m, sumw [B, N]. Scratch: o_part [B, splits, N, F],
// ml_part [B, splits, N, 2]. E in {128, 256}; F % 16 == 0, F <= 1024; N <= 8.
int mpo_coattn_fwd_fused_k(const float* q, const float* kv, const float* wk,
                           const float* bk, const uint8_t* mask, float* o, float* l,
                           float* m, float* sumw, float* o_part, float* ml_part, int B,
                           int N, int M, int F, int E, int splits, float scale,
                           void* stream) {
  return launch_fused_k<false>(q, kv, wk, bk, mask, nullptr, 0u, 1.f, o, l, m, nullptr,
                               sumw, o_part, ml_part, nullptr, B, N, M, F, E, splits,
                               scale, stream);
}

// The training form: as above plus attention dropout (seed: one int32 on the
// device; keep iff dropout_bits >= thresh, kept weights times keep_scale;
// thresh 0 = no dropout) and the ssq side output. Out: o [B, N, F], l, m
// (saved for the backward), ssq, sumw [B, N]. Extra scratch: sq_part
// [B, splits, N, 2].
int mpo_coattn_fwd_fused_k_train(const float* q, const float* kv, const float* wk,
                                 const float* bk, const uint8_t* mask, const int* seed,
                                 float* o, float* l, float* m, float* ssq, float* sumw,
                                 float* o_part, float* ml_part, float* sq_part, int B,
                                 int N, int M, int F, int E, int splits, float scale,
                                 uint32_t thresh, float keep_scale, void* stream) {
  return launch_fused_k<true>(q, kv, wk, bk, mask, seed, thresh, keep_scale, o, l, m, ssq,
                              sumw, o_part, ml_part, sq_part, B, N, M, F, E, splits,
                              scale, stream);
}

// q [B, N, D], k [B, M, D], mask [B, M] bool or NULL -> l, m [B, N].
// Scratch ml_part [B, splits * 8, N, 2]. D in {128, 256, 512}; N <= 8.
int mpo_coattn_stats(const float* q, const float* k, const uint8_t* mask, float* l,
                     float* m, float* ml_part, int B, int N, int M, int D, int pre_gate,
                     int splits, float scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || splits < 1 || splits * WARPS > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (D == 128) err = launch_stats<1>(q, k, mask, ml_part, B, N, M, pre_gate, scale, splits, st);
  else if (D == 256) err = launch_stats<2>(q, k, mask, ml_part, B, N, M, pre_gate, scale, splits, st);
  else if (D == 512) err = launch_stats<4>(q, k, mask, ml_part, B, N, M, pre_gate, scale, splits, st);
  else return (int)cudaErrorInvalidValue;
  if (err) return err;
  combine_kernel<<<dim3(B, N), THREADS, 0, st>>>(nullptr, ml_part, nullptr, nullptr, l, m,
                                                 nullptr, nullptr, N, 0, splits * WARPS);
  return (int)cudaGetLastError();
}

// q [B, N, D], k [B, M, D], mask, l, m [B, N] -> w [B, N, M].
int mpo_coattn_weights(const float* q, const float* k, const uint8_t* mask,
                       const float* l, const float* m, float* w, int B, int N, int M,
                       int D, int pre_gate, int splits, float scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_weights<1>(q, k, mask, l, m, w, B, N, M, pre_gate, scale, splits, st);
  if (D == 256) return launch_weights<2>(q, k, mask, l, m, w, B, N, M, pre_gate, scale, splits, st);
  if (D == 512) return launch_weights<4>(q, k, mask, l, m, w, B, N, M, pre_gate, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}

// The plain-K form with values: q [B, N, D], k, v [B, M, D], mask [B, M] bool
// or NULL -> o [B, N, D], l, m [B, N]. train != 0: the training form, with
// attention dropout (seed, thresh, keep_scale as mpo_coattn_fwd_fused_k_train)
// and ssq, sumw [B, N] of the dropped weights; else seed, ssq, sumw and
// sq_part may be NULL. Scratch: o_part [B, splits, N, D], ml_part and sq_part
// [B, splits, N, 2]. D in {128, 256}; N <= 8.
int mpo_coattn_plain_fwd(const float* q, const float* k, const float* v,
                         const uint8_t* mask, const int* seed, float* o, float* l, float* m,
                         float* ssq, float* sumw, float* o_part, float* ml_part,
                         float* sq_part, int B, int N, int M, int D, int pre_gate,
                         int splits, int train, float scale, uint32_t thresh,
                         float keep_scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || splits < 1 || splits > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, splits);
#define MPO_PLAIN(DV_, TRAIN_)                                                      \
  plain_kernel<DV_, TRAIN_><<<grid, THREADS, 0, st>>>(q, k, v, mask, o_part, ml_part, \
                                                      sq_part, seed, thresh, keep_scale, \
                                                      N, M, pre_gate, scale)
  if (D == 128 && train) MPO_PLAIN(1, true);
  else if (D == 128) MPO_PLAIN(1, false);
  else if (D == 256 && train) MPO_PLAIN(2, true);
  else if (D == 256) MPO_PLAIN(2, false);
  else return (int)cudaErrorInvalidValue;
#undef MPO_PLAIN
  int err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<<<dim3(B, N), THREADS, 0, st>>>(o_part, ml_part, train ? sq_part : nullptr, o,
                                                 l, m, ssq, train ? sumw : nullptr, N, D,
                                                 splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
