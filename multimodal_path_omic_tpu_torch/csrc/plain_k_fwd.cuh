// Shared by csrc/coattn.cu (the instances at up to eight queries, and the
// fuse-K forward's merge) and csrc/coattn_many.cu (the export passes past
// eight queries, SLABS, and the merge of plain_k_tiles.cuh's forward): the
// plain-K forward with values at up to eight queries, the export passes,
// their launches and the fixed-order merge of partials. The design notes
// are csrc/coattn.cu's. The kernels are templates: each source builds its
// own library with its own instances.
#pragma once

#include "plain_k_common.cuh"

namespace mpo {

// The query counts an instance set takes: SLABS 9..NQ_MAX, else 1..NMAX.
template <bool SLABS>
inline bool queries_taken(int N) {
  return SLABS ? N > NMAX && N <= NQ_MAX : N >= 1 && N <= NMAX;
}

// ---------------------------------------------------------------------------
// Merge a bag's partial (m, l[, o]) states per (bag, query), in order:
//   m = max_p m_p;  l = sum_p l_p e^(m_p - m);  o = sum_p o_p e^(m_p - m) / l
// with the l == 0 guard of the TPU kernel; o written in TO (bfloat16: the
// float32 o rounded once). Without sq_part, sumw = l / l (the
// weight mass of the final row; no dropout in eval); with it (training form)
//   ssq = sum_p ssq_p e^(2 (m_p - m)) / l^2,  sumw = sum_p sumw_p e^(m_p - m) / l.
// Partials [*, N, F] (o) and [*, N, 2]: with off == NULL bag b's are
// b * P .. b * P + P - 1; with off (the fuse-K and plain-K forwards' unit
// list over P blocks, fused_k_common.cuh) those of the blocks g that held its
// units, at g + b.
// ---------------------------------------------------------------------------
template <typename TO = float>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
               const float* __restrict__ sq_part, TO* __restrict__ o,
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
      store1(o + ((size_t)b * N + n) * F + f, acc * l_inv);
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
// ring (plain_k_common.cuh) in T. For each bag it visits it writes one
// unnormalized partial at index block + bag: o_part [G + B, N, D], ml_part
// [G + B, N, 2] (m, l); TRAIN adds sq_part [G + B, N, 2] (ssq, sumw of the
// dropped weights), with fused_k_kernel's dropout rule (keep iff
// dropout_bits >= thresh; thresh 0: no dropout). Thread tid owns o columns
// col + DC c (c < CPT) of the queries n = grp + QG j: at D <= 256 one column
// (col = tid % D) of queries tid / D + QG j, at D = 512 two columns (tid,
// tid + 256) of every query. Past NMAX queries the forward with values is
// plain_k_tiles.cuh's tile_fwd_kernel.
template <int D, typename T>
struct PkFwdSmem {
  static constexpr int SLOT = 2 * PK_KEYS * D;  // k rows, then v rows (values of T)
  static constexpr int SLOT_BYTES = SLOT * (int)sizeof(T);
  // a 96 KB ring at D <= 256 (two blocks an SM): six, three slots (float32,
  // D = 128, 256), twelve, six (bfloat16); two at D = 512 (float32: 64 KB
  // slots, one block an SM; bfloat16: 32 KB slots, two blocks an SM)
  static constexpr int NSLOT = D < 512 ? 98304 / SLOT_BYTES : 2;
  alignas(16) T ring[NSLOT][SLOT];
  alignas(16) float q[NMAX][D];
  alignas(16) float tq[NMAX][D];
  alignas(16) float s[NMAX][PK_KEYS];  // scores, then the (dropped) weights
  float alpha[NMAX];
};

template <int D, bool PG, bool TRAIN, typename T>
__global__ void __launch_bounds__(THREADS)
plain_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const uint8_t* __restrict__ mask,
             const int* __restrict__ list, const int* __restrict__ off,
             float* __restrict__ o_part, float* __restrict__ ml_part,
             float* __restrict__ sq_part, const int* __restrict__ seed_ptr, uint32_t thresh,
             float keep_scale, uint32_t bag0, int B, int N, int M, float scale) {
  using S_ = PkFwdSmem<D, T>;
  constexpr int NSLOT = S_::NSLOT;
  constexpr int CPT = D > THREADS ? D / THREADS : 1;  // o columns a thread
  constexpr int DC = D / CPT;                         // threads a query row
  constexpr int QG = THREADS / DC, NQ = NMAX / QG;
  static_assert(THREADS % DC == 0 && D % DC == 0, "a thread owns whole o columns");
  extern __shared__ float4 smem4[];
  S_& S = *reinterpret_cast<S_*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = tid % DC, grp = tid / DC;
  const int n0 = 0, NS = N;  // every query, N <= NMAX
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const uint32_t seed = TRAIN ? (uint32_t)seed_ptr[0] : 0u;

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    pk_issue<D, T>(S.ring[s], k, v, list, n_tiles, M, i1, cur);
    cp_async_commit();
  }

  float oacc[NQ][CPT];
  float m_run = NEG, l_run = 0.f, ssq_run = 0.f, sumw_run = 0.f;  // query `warp`'s state
  int b = -1;
  auto flush = [&]() {  // the partial of bag b at index block + b
    const size_t pb = (size_t)blockIdx.x + b;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int n = grp + QG * j;
      if (n < NS) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) o_part[(pb * N + n0 + n) * D + col + DC * c] = oacc[j][c];
      }
    }
    if (warp < NS && lane == 0) {
      const size_t i = (pb * N + n0 + warp) * 2;
      ml_part[i + 0] = m_run;
      ml_part[i + 1] = l_run;
      if constexpr (TRAIN) {
        sq_part[i + 0] = ssq_run;
        sq_part[i + 1] = sumw_run;
      }
    }
  };

  int s = 0;  // the block's sub-step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles, subs = pk_subs(t, M);
    for (int j = 0; j < subs; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncthreads();  // sub-step s landed; the slot of s - 1 is free
      pk_issue<D, T>(S.ring[(s + NSLOT - 1) % NSLOT], k, v, list, n_tiles, M, i1, cur);
      cp_async_commit();
      if (ub != b) {  // a new bag: flush the last one's partial, load this one's queries
        if (b >= 0) flush();
        b = ub;
        for (int x = tid; x < NS * D; x += THREADS) {
          const float val = to_f32(q[((size_t)b * N + n0) * D + x]);
          S.q[x / D][x % D] = val;
          if (PG) S.tq[x / D][x % D] = round_to<T>(tanhf(val));
        }
#pragma unroll
        for (int j2 = 0; j2 < NQ; ++j2) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) oacc[j2][c] = 0.f;
        }
        m_run = NEG;
        l_run = ssq_run = sumw_run = 0.f;
        __syncthreads();
      }
      const T* slot = S.ring[s % NSLOT];
      const int r0 = t * FK_BM + j * PK_KEYS;  // the sub-step's first key

      // ---- scores of the warp's two keys against every query ----
      {
        float second, unused;
        const float a = pk_key_sums<D, PG, false, IS_BF16<T>>(slot, S.q, S.tq, nullptr,
                                                              nullptr, NS, warp, lane, second,
                                                              unused);
        const int n = pk_query(lane), row = warp * PK_KPW + pk_key(lane), key = r0 + row;
        if ((lane & 1) == 0 && n < NS) {
          const float sv = pk_score<PG>(a, second, scale);
          const bool exists = key < M;  // keys past M do not exist: weight exactly 0
          const bool valid = exists && (mask == nullptr || mask[(size_t)b * M + key]);
          S.s[n][row] = !exists ? -INFINITY : (valid ? sv : NEG);
        }
      }
      __syncthreads();

      // ---- online softmax, one warp a query (lanes 0..15 one key each) ----
      if (warp < NS) {
        const float sv = lane < PK_KEYS ? S.s[warp][lane] : -INFINITY;
        const float m_new = fmaxf(m_run, warp_max(sv));
        const float alpha = expf(m_run - m_new);
        float p = expf(sv - m_new);
        l_run = l_run * alpha + warp_sum(p);
        m_run = m_new;
        if constexpr (TRAIN) {
          if (thresh != 0u && lane < PK_KEYS)
            p = dropout_bits(seed, bag0 + (uint32_t)b, (uint32_t)(n0 + warp),
                             (uint32_t)(r0 + lane)) >= thresh ? p * keep_scale : 0.f;
          ssq_run = ssq_run * (alpha * alpha) + warp_sum(p * p);
          sumw_run = sumw_run * alpha + warp_sum(p);
        }
        if (lane < PK_KEYS) S.s[warp][lane] = p;
        if (lane == 0) S.alpha[warp] = alpha;
      }
      __syncthreads();

      // ---- o[n, col] = alpha o + sum_r p[n, r] v[r, col] (rows past M are zeros) ----
      const T* vs = slot + PK_KEYS * D;
#pragma unroll
      for (int j2 = 0; j2 < NQ; ++j2) {
        const int n = grp + QG * j2;
        if (n < NS) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) oacc[j2][c] *= S.alpha[n];
        }
      }
#pragma unroll
      for (int r = 0; r < PK_KEYS; r += 4) {
        float x[CPT][4];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
#pragma unroll
          for (int y = 0; y < 4; ++y) x[c][y] = to_f32(vs[(r + y) * D + col + DC * c]);
        }
#pragma unroll
        for (int j2 = 0; j2 < NQ; ++j2) {
          const int n = grp + QG * j2;
          if (n < NS) {
            const float4 p = *reinterpret_cast<const float4*>(&S.s[n][r]);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              oacc[j2][c] = fmaf(p.x, x[c][0], oacc[j2][c]);
              oacc[j2][c] = fmaf(p.y, x[c][1], oacc[j2][c]);
              oacc[j2][c] = fmaf(p.z, x[c][2], oacc[j2][c]);
              oacc[j2][c] = fmaf(p.w, x[c][3], oacc[j2][c]);
            }
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
template <int D, typename T>
__device__ __forceinline__ void ex_issue(float* __restrict__ slot, const T* __restrict__ k,
                                         const uint8_t* __restrict__ flags,
                                         const int* __restrict__ list, int n_tiles, int M,
                                         int i1, int warp, int lane, PkCursor& c) {
  while (c.i < i1 && flags[list[c.i]] == FK_LONE) ++c.i;  // c.j == 0 at a unit's start
  if (c.i >= i1) return;
  const int u = list[c.i], r0 = (u % n_tiles) * FK_BM + warp * EX_WKEYS + c.j * EX_KPS;
  const T* src = k + (size_t)(u / n_tiles) * M * D;
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

// The bfloat16 instances' counterpart of ex_issue: the warp step's k rows
// fetched into registers (pre: lane's D / 64 groups of four values), stored
// into the warp's slot by ex_store after the step they overlap. Returns
// whether a step was fetched.
template <int D>
__device__ __forceinline__ bool ex_fetch(uint2 (&pre)[D / 64], const __nv_bfloat16* __restrict__ k,
                                         const uint8_t* __restrict__ flags,
                                         const int* __restrict__ list, int n_tiles, int M, int i1,
                                         int warp, int lane, PkCursor& c) {
  static_assert(EX_KPS * D / 4 == 32 * (D / 64), "whole groups a lane");
  while (c.i < i1 && flags[list[c.i]] == FK_LONE) ++c.i;
  if (c.i >= i1) return false;
  const int u = list[c.i], r0 = (u % n_tiles) * FK_BM + warp * EX_WKEYS + c.j * EX_KPS;
  const __nv_bfloat16* src = k + (size_t)(u / n_tiles) * M * D;
  constexpr int V4 = D / 4;
#pragma unroll
  for (int x = 0; x < D / 64; ++x) {
    const int e = lane + 32 * x, row = e / V4;
    pre[x] = fetch_bf16x4(src + (size_t)(r0 + row) * D + 4 * (e % V4), r0 + row < M);
  }
  if (++c.j == EX_STEPS) {
    c.j = 0;
    ++c.i;
  }
  return true;
}

template <int D>
__device__ __forceinline__ void ex_store(float* __restrict__ slot, const uint2 (&pre)[D / 64],
                                         int lane) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int x = 0; x < D / 64; ++x) {
    const int e = lane + 32 * x;
    store_bf16x4(slot + (e / V4) * D + 4 * (e % V4), pre[x]);
  }
}

// The ns queries of a slab from qs (its first query's row; tanh of them,
// with the pre-gate, in T's precision) into shared memory.
template <int D, bool PG, typename T>
__device__ __forceinline__ void ex_load_queries(const T* __restrict__ qs, int ns,
                                                float (*q_s)[D], float (*tq_s)[D]) {
  for (int x = threadIdx.x; x < ns * D; x += THREADS) {
    const float val = to_f32(qs[x]);
    q_s[x / D][x % D] = val;
    if (PG) tq_s[x / D][x % D] = round_to<T>(tanhf(val));
  }
}

__device__ __forceinline__ float inv_l(float l) { return l == 0.f ? 1.f : 1.f / l; }

// w[b, n, key] = exp(NEG - m[b, n]) / l[b, n], the weight of a masked key
// (exactly 0 in a bag with a valid key; 1 / M in a bag without one, whose
// l = M, m = NEG), for the slab's queries n0 <= n < n0 + ns and the keys of
// tiles t0 .. t1 - 1; every thread a share of each row, float4 stores where
// the rows are 16-byte aligned.
__device__ __forceinline__ void fill_masked(float* __restrict__ w, const float* __restrict__ l,
                                            const float* __restrict__ m, int b, int N, int n0,
                                            int ns, int M, int t0, int t1) {
  const int k0 = t0 * FK_BM, len = min(t1 * FK_BM, M) - k0;
  for (int n = n0; n < n0 + ns && len > 0; ++n) {
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
// valid key) writes m = NEG, l = M and reads no k. SLABS: block (g, y) takes
// query slab y over block g's share, as plain_kernel.
template <int D, bool PG, typename T, bool SLABS>
__global__ void __launch_bounds__(THREADS, 2)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  const int n0 = SLABS ? (int)blockIdx.y * NMAX : 0, NS = SLABS ? min(NMAX, N - n0) : N;
  const int n = pk_query(lane), r = pk_key(lane);
  const bool owner = (lane & 1) == 0 && n < NS;  // holds query n's score of the step's key r
  float(*ring)[S_::SLOT] = S.ring[warp];

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    ex_issue<D, T>(ring[s], k, flags, list, n_tiles, M, i1, warp, lane, cur);
    cp_async_commit();
  }
  uint2 pre[D / 64];  // bfloat16: the step in flight through registers (ex_fetch)

  float m_run = NEG, l_run = 0.f;  // the owner lane's online state
  int b = -1;
  auto flush = [&]() {  // the partial of bag b at index block + b (every thread calls it)
    const float m2 = __shfl_xor_sync(0xffffffffu, m_run, 2);
    const float l2 = __shfl_xor_sync(0xffffffffu, l_run, 2);
    if ((lane & 3) == 0 && n < NS) {  // the step's two keys: lanes 4n and 4n + 2
      const float mw = fmaxf(m_run, m2);
      S.red[warp][n][0] = mw;
      S.red[warp][n][1] = l_run * expf(m_run - mw) + l2 * expf(m2 - mw);
    }
    __syncthreads();  // also: no warp reads S.q of bag b any more
    if (tid < NS) {
      float mx = NEG, lx = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, S.red[w][tid][0]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) lx += S.red[w][tid][1] * expf(S.red[w][tid][0] - mx);
      const size_t pb = (size_t)blockIdx.x + b;
      ml_part[(pb * N + n0 + tid) * 2 + 0] = mx;
      ml_part[(pb * N + n0 + tid) * 2 + 1] = lx;
    }
    // S.red is rewritten by the next flush, after the next bag's barrier
  };

  int s = 0;  // the warp's step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles;
    if (flags[u] == FK_LONE) {
      if (b >= 0) flush();
      b = -1;
      if (tid < NS) {
        const size_t pb = (size_t)blockIdx.x + ub;
        ml_part[(pb * N + n0 + tid) * 2 + 0] = NEG;
        ml_part[(pb * N + n0 + tid) * 2 + 1] = (float)M;
      }
      continue;
    }
    if (ub != b) {  // a new bag: flush the last one's partial, load this one's queries
      if (b >= 0) flush();
      b = ub;
      ex_load_queries<D, PG, T>(q + ((size_t)b * N + n0) * D, NS, S.q, S.tq);
      m_run = NEG;
      l_run = 0.f;
      __syncthreads();
    }
    for (int j = 0; j < EX_STEPS; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncwarp();  // step s landed for the whole warp; the slot of s - 1 is free
      bool fetched = false;
      if constexpr (IS_BF16<T>)  // registers now, the slot after this step's sums
        fetched = ex_fetch<D>(pre, k, flags, list, n_tiles, M, i1, warp, lane, cur);
      else
        ex_issue<D, T>(ring[(s + NSLOT - 1) % NSLOT], k, flags, list, n_tiles, M, i1, warp,
                       lane, cur);
      cp_async_commit();
      float g, unused;
      const float a = pk_key_sums<D, PG, false, IS_BF16<T>>(ring[s % NSLOT], S.q, S.tq, nullptr,
                                                            nullptr, NS, 0, lane, g, unused);
      if (fetched) ex_store<D>(ring[(s + NSLOT - 1) % NSLOT], pre, lane);
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
// bag's last computed tile, for those after it). SLABS: block (g, y) takes
// query slab y, as plain_kernel.
template <int D, bool PG, typename T, bool SLABS>
__global__ void __launch_bounds__(THREADS, 2)
weights_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  const int n0 = SLABS ? (int)blockIdx.y * NMAX : 0, NS = SLABS ? min(NMAX, N - n0) : N;
  const int n = pk_query(lane), r = pk_key(lane);
  const bool owner = (lane & 1) == 0 && n < NS;
  float(*ring)[S_::SLOT] = S.ring[warp];
  float(*ws)[EX_WKEYS] = S.w[warp];

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    ex_issue<D, T>(ring[s], k, flags, list, n_tiles, M, i1, warp, lane, cur);
    cp_async_commit();
  }
  uint2 pre[D / 64];  // bfloat16: the step in flight through registers (ex_fetch)

  float mv = 0.f, linv = 1.f;  // the owner lane's query of bag b
  int b = -1, s = 0;
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles;
    if (flags[u] == FK_LONE) {
      fill_masked(w, l, m, ub, N, n0, NS, M, 0, n_tiles);
      continue;
    }
    fill_masked(w, l, m, ub, N, n0, NS, M, i > off[ub] ? list[i - 1] % n_tiles + 1 : 0, t);
    if (ub != b) {
      __syncthreads();  // no warp reads S.q of the last bag any more
      b = ub;
      ex_load_queries<D, PG, T>(q + ((size_t)b * N + n0) * D, NS, S.q, S.tq);
      if (owner) {
        mv = m[(size_t)b * N + n0 + n];
        linv = inv_l(l[(size_t)b * N + n0 + n]);
      }
      __syncthreads();
    }
    const int k0 = t * FK_BM + warp * EX_WKEYS;  // the warp's first key of the tile
    for (int j = 0; j < EX_STEPS; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncwarp();
      bool fetched = false;
      if constexpr (IS_BF16<T>)
        fetched = ex_fetch<D>(pre, k, flags, list, n_tiles, M, i1, warp, lane, cur);
      else
        ex_issue<D, T>(ring[(s + NSLOT - 1) % NSLOT], k, flags, list, n_tiles, M, i1, warp,
                       lane, cur);
      cp_async_commit();
      float g, unused;
      const float a = pk_key_sums<D, PG, false, IS_BF16<T>>(ring[s % NSLOT], S.q, S.tq, nullptr,
                                                            nullptr, NS, 0, lane, g, unused);
      if (fetched) ex_store<D>(ring[(s + NSLOT - 1) % NSLOT], pre, lane);
      const int key = k0 + j * EX_KPS + r;
      if (owner) {  // a key past M gets a value that is never stored
        const bool valid = key < M && (mask == nullptr || mask[(size_t)b * M + key]);
        ws[n][j * EX_KPS + r] = expf((valid ? pk_score<PG>(a, g, scale) : NEG) - mv) * linv;
      }
    }
    __syncwarp();  // the warp's 8 weights of each query staged
    const int sn = lane >> 1, c = 4 * (lane & 1), key = k0 + c;
    if (sn < NS && key < M) {
      float* dst = w + ((size_t)b * N + n0 + sn) * M + key;
      if ((M & 3) == 0) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&ws[sn][c]);
      } else {
        for (int x = 0; x < 4 && key + x < M; ++x) dst[x] = ws[sn][c + x];
      }
    }
    // ws is rewritten after the next tile's first __syncwarp
    if (i + 1 == off[ub + 1]) fill_masked(w, l, m, ub, N, n0, NS, M, t + 1, n_tiles);
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

template <int D, bool PG, typename T, bool SLABS>
int launch_stats(const T* q, const T* k, const uint8_t* mask, float* l, float* m,
                 float* ml_part, uint8_t* flags, int* list, int* off, int B, int N, int M,
                 int max_blocks, float scale, cudaStream_t st) {
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = (int)sizeof(PkExportSmem<D>);
  int blocks = 0;
  int err = export_grid(stats_kernel<D, PG, T, SLABS>, smem, max_blocks, allowed, resident,
                        &blocks);
  if (err) return err;
  launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st, true);
  const int slabs = SLABS ? (N + NMAX - 1) / NMAX : 1, per_slab = max(1, blocks / slabs);
  stats_kernel<D, PG, T, SLABS><<<dim3(per_slab, slabs), THREADS, smem, st>>>(
      q, k, mask, flags, list, off, ml_part, B, N, M, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<float><<<dim3(B, N), THREADS, 0, st>>>(nullptr, ml_part, nullptr, nullptr, l,
                                                        m, nullptr, nullptr, N, 0, per_slab, off);
  return (int)cudaGetLastError();
}

template <int D, bool PG, typename T, bool SLABS>
int launch_weights(const T* q, const T* k, const uint8_t* mask, const float* l,
                   const float* m, float* w, uint8_t* flags, int* list, int* off, int B, int N,
                   int M, int max_blocks, bool list_ready, float scale, cudaStream_t st) {
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = (int)sizeof(PkExportSmem<D>);
  int blocks = 0;
  const int err = export_grid(weights_kernel<D, PG, T, SLABS>, smem, max_blocks, allowed,
                              resident, &blocks);
  if (err) return err;
  if (!list_ready) launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st, true);
  const int slabs = SLABS ? (N + NMAX - 1) / NMAX : 1, per_slab = max(1, blocks / slabs);
  weights_kernel<D, PG, T, SLABS><<<dim3(per_slab, slabs), THREADS, smem, st>>>(
      q, k, mask, flags, list, off, l, m, w, B, N, M, scale);
  return (int)cudaGetLastError();
}

// The plain-K forward's launches: the tile flags and list, plain_kernel over
// the blocks resident at once (at most max_blocks), combine_kernel (o in T).
template <int D, bool PG, bool TRAIN, typename T>
int launch_plain(const T* q, const T* k, const T* v, const uint8_t* mask,
                 const int* seed, T* o, float* l, float* m, float* ssq, float* sumw,
                 float* o_part, float* ml_part, float* sq_part, uint8_t* flags, int* list,
                 int* off, int B, int N, int M, int max_blocks, float scale, uint32_t thresh,
                 float keep_scale, uint32_t bag0, cudaStream_t st) {
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = (int)sizeof(PkFwdSmem<D, T>);
  static_assert(smem <= 232448, "shared memory of one block");
  int err = allow_dynamic_smem(plain_kernel<D, PG, TRAIN, T>, smem, allowed);
  if (err) return err;
  int blocks = 0;
  err = resident_blocks(plain_kernel<D, PG, TRAIN, T>, smem, max_blocks, resident, &blocks);
  if (err) return err;
  launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st);
  plain_kernel<D, PG, TRAIN, T><<<blocks, THREADS, smem, st>>>(
      q, k, v, mask, list, off, o_part, ml_part, sq_part, seed, thresh, keep_scale, bag0, B, N, M,
      scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<T><<<dim3(B, N), THREADS, 0, st>>>(o_part, ml_part, TRAIN ? sq_part : nullptr, o,
                                                 l, m, ssq, TRAIN ? sumw : nullptr, N, D, blocks,
                                                 off);
  return (int)cudaGetLastError();
}

// The entry points of the plain-K forward at N <= NMAX queries
// (csrc/coattn.cu): D in {128, 256, 512}, with or without the pre-gate, eval
// or training form.
template <typename T>
int plain_fwd(const T* q, const T* k, const T* v, const uint8_t* mask, const int* seed, T* o,
              float* l, float* m, float* ssq, float* sumw, float* o_part, float* ml_part,
              float* sq_part, uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
              int pre_gate, int max_blocks, int train, float scale, uint32_t thresh,
              float keep_scale, uint32_t bag0, void* stream) {
  if (!queries_taken<false>(N) || M < 1 || B < 1 || max_blocks < 1 || max_blocks > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPO_PLAIN(D_, PG_, TRAIN_)                                                           \
  if (D == D_ && (pre_gate != 0) == PG_ && (train != 0) == TRAIN_)                           \
    return launch_plain<D_, PG_, TRAIN_, T>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part,   \
                                            ml_part, sq_part, flags, list, off, B, N, M,       \
                                            max_blocks, scale, thresh, keep_scale, bag0, st);
#define MPO_PLAIN_D(D_)                                                                      \
  MPO_PLAIN(D_, false, false) MPO_PLAIN(D_, true, false) MPO_PLAIN(D_, false, true)          \
  MPO_PLAIN(D_, true, true)
  MPO_PLAIN_D(256) MPO_PLAIN_D(128) MPO_PLAIN_D(512)
#undef MPO_PLAIN_D
#undef MPO_PLAIN
  return (int)cudaErrorInvalidValue;
}

// The export passes' entry points: D in {128, 256, 512}, with or without
// the pre-gate, the query counts of SLABS (queries_taken).
#define MPO_EXPORT(LAUNCH, ...)                                                        \
  if (pre_gate) {                                                                      \
    if (D == 128) return LAUNCH<128, true, T, SLABS>(__VA_ARGS__);                     \
    if (D == 256) return LAUNCH<256, true, T, SLABS>(__VA_ARGS__);                     \
    if (D == 512) return LAUNCH<512, true, T, SLABS>(__VA_ARGS__);                     \
  } else {                                                                             \
    if (D == 128) return LAUNCH<128, false, T, SLABS>(__VA_ARGS__);                    \
    if (D == 256) return LAUNCH<256, false, T, SLABS>(__VA_ARGS__);                    \
    if (D == 512) return LAUNCH<512, false, T, SLABS>(__VA_ARGS__);                    \
  }                                                                                    \
  return (int)cudaErrorInvalidValue;

template <typename T, bool SLABS>
int export_stats(const T* q, const T* k, const uint8_t* mask, float* l, float* m,
                 float* ml_part, uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
                 int pre_gate, int max_blocks, float scale, void* stream) {
  if (!queries_taken<SLABS>(N) || M < 1 || B < 1 || max_blocks < 1 || max_blocks > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MPO_EXPORT(launch_stats, q, k, mask, l, m, ml_part, flags, list, off, B, N, M, max_blocks,
             scale, st)
}

template <typename T, bool SLABS>
int export_weights(const T* q, const T* k, const uint8_t* mask, const float* l, const float* m,
                   float* w, uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
                   int pre_gate, int max_blocks, int list_ready, float scale, void* stream) {
  if (!queries_taken<SLABS>(N) || M < 1 || B < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MPO_EXPORT(launch_weights, q, k, mask, l, m, w, flags, list, off, B, N, M, max_blocks,
             list_ready != 0, scale, st)
}
#undef MPO_EXPORT

}  // namespace mpo
