// Shared by csrc/coattn_bwd.cu (the plain-K backward at up to eight queries,
// and the fuse-K backward's reduce) and csrc/coattn_bwd_many.cu (the reduce
// of plain_k_tiles.cuh's backward past eight queries): the fixed-order
// partial reduce and the plain-K backward's main kernel at up to eight
// queries. The kernels are templates: each source builds its own library
// with its own instances.
#pragma once

#include "plain_k_common.cuh"

namespace mpo {

// dq [B, N, E] = sum of bag b's partials g + b over the main pass's blocks g
// that held its units (off: the tile list's bag offsets), in g order; with
// dwk != NULL (the fuse-K form) also dwk [F, E] = sum of the W partials
// dwk_part and dbk [E] = sum of the PB partials dbk_part (float32: the P
// main blocks'; bfloat16: the W dwk blocks'). Each output
// element is summed by one thread in a fixed order (no atomics:
// deterministic).
template <typename TQ = float>
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const float* __restrict__ dq_part, const float* __restrict__ dwk_part,
                  const float* __restrict__ dbk_part, const int* __restrict__ off,
                  TQ* __restrict__ dq, float* __restrict__ dwk, float* __restrict__ dbk,
                  int B, int P, int W, int PB, int N, int E, int F) {
  const size_t nq = (size_t)B * N * E, nw = (size_t)F * E;
  const size_t total = dwk != nullptr ? nq + nw + E : nq;
  const size_t ne = (size_t)N * E;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < nq) {
      const size_t b = i / ne, j = i % ne;
      const int per = units_per_block(off, B, P);
      for (int g = off[b] / per; g <= (off[b + 1] - 1) / per; ++g)
        acc += dq_part[(g + b) * ne + j];
      store1(dq + i, acc);
    } else if (i < nq + nw) {
      const size_t j = i - nq;
      for (int k = 0; k < W; ++k) acc += dwk_part[(size_t)k * nw + j];
      dwk[j] = acc;
    } else {
      const size_t j = i - nq - nw;
      for (int k = 0; k < PB; ++k) acc += dbk_part[(size_t)k * E + j];
      dbk[j] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// K3, plain-K form: q [B, N, D], k, v [B, M, D]; per key r and query n, from
// the forward's (l, m) and dropout bits:
//   a = q.k / sqrt(D),  g = (tanh(q).tanh(k) + 1) / 2 (1 without the pre-gate),
//   s = a g (NEG where masked),  p = exp(s - m) / l,  pd = keep p / (1 - rate),
//   dp = dO.v_r,  ds = pd dp - p di + 2 dssq pd^2 + dsumw pd (0 where masked),
//   da = ds g,  du = ds a / 2,
//   dq_n += da k_r / sqrt(D) + (1 - tanh(q_n)^2) (du tanh(k_r)),
//   dk_r  = sum_n da q_n / sqrt(D) + (1 - tanh(k_r)^2) (du tanh(q_n)),
//   dv_r  = sum_n pd dO_n.
// What bounds it on an H100: it reads k and v and writes dk and dv once each
// (1.07 GB at B=32, M=8192, D=256: 0.32 ms at 3.35 TB/s over every key) for
// 6 GFLOP of products (0.09 ms): bound by bytes. Design, as the forward
// (csrc/coattn.cu plain_kernel): the tile flags and list (fused_k_common.cuh;
// the flag pass writes dk = dv = 0 on the skipped tiles, where ds and p are
// exactly 0); the main pass over the blocks resident at once, each an even
// share of the listed tiles, their k and v rows in sub-steps of 16 keys
// through the cp.async ring (plain_k_common.cuh). Per sub-step: warp w sums
// a, u (pre-gate) and dp of its two keys against every query in one
// transposing butterfly and turns them into pd, da, du (the Philox bits
// regenerated per element), tanh(k) stored once in shared memory; then
// thread tid takes column tid % D of the keys r = tid / D + QG x (D = 512:
// columns tid and tid + 256 of every key): dk_r and dv_r are written once,
// coalesced, and dq's two sums over keys are carried in registers. A block
// writes bag b's dq partial at index block + b when it leaves the bag, and
// bwd_reduce_kernel sums a bag's partials in block order: no atomics, two
// runs give the same bits.
// D = 512 (MCAT and NaCAGaT big): 16-key sub-steps in two ring slots (one
// issued ahead) beside q, tanh(q), dout and the sub-step's tanh(k): float32
// 214,688 bytes of shared memory, bfloat16 149,152, one block an SM
// (__launch_bounds__(THREADS, 1): ptxas 231 / 165 registers with the
// pre-gate on / off in float32, 234 / 167 in bfloat16, no spill).
// The bfloat16 instances (T = __nv_bfloat16, D 128, 256, 512): q, k, v and
// dout are read as bfloat16 and dq, dk, dv written in bfloat16 (the JAX
// kernel's dv_tile / dk_tile / dq_scr astype, ops/coattn.py:430, 499, 503);
// the ring holds the raw bfloat16 k and v rows (cp.async, widened where
// read), tanh(q) and tanh(k) are rounded to bfloat16, every sum is float32.
// The one rounding kept in float32: 1 - tanh^2, which the JAX kernel forms
// from the bfloat16 tanh in bfloat16 arithmetic, is taken in float32 from
// the rounded tanh. The pre-gated D = 256 instance sits at the 128-register
// cap of two blocks an SM and spills 124 bytes (its float32 sibling 76).
// ---------------------------------------------------------------------------
template <int D, typename T>
struct PkBwdSmem {
  static constexpr int SLOT = 2 * PK_KEYS * D;  // k rows, then v rows (values of T)
  static constexpr int SLOT_BYTES = SLOT * (int)sizeof(T);
  // a 64 KB ring at D <= 256 (two blocks an SM): four, two slots (float32,
  // D = 128, 256), eight, four (bfloat16); two at D = 512 (one block an SM)
  static constexpr int NSLOT = D < 512 ? 65536 / SLOT_BYTES : 2;
  alignas(16) T ring[NSLOT][SLOT];
  alignas(16) float q[NMAX][D];
  alignas(16) float tq[NMAX][D];
  alignas(16) float dout[NMAX][D];
  alignas(16) float tk[PK_KEYS][D];  // tanh(k) of the sub-step; the flush's merge of groups
  alignas(16) float da[PK_KEYS][NMAX];
  alignas(16) float du[PK_KEYS][NMAX];
  alignas(16) float pd[PK_KEYS][NMAX];
  float stat[5][NMAX];  // m, 1/l, di, dssq, dsumw per query
};

// Eight per-query values of sub-step key r, from a [PK_KEYS][NMAX] row.
__device__ __forceinline__ void load8(const float* __restrict__ row, float (&x)[NMAX]) {
  const float4 lo = *reinterpret_cast<const float4*>(row);
  const float4 hi = *reinterpret_cast<const float4*>(row + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// Query slab n0 .. n0 + ns - 1 of bag b into shared memory: q, tanh(q) (in
// T's precision; 0 without the pre-gate), dout, and the slab's m, 1/l, di,
// dssq, dsumw.
template <int D, bool PG, typename T>
__device__ __forceinline__ void pk_bwd_load_slab(PkBwdSmem<D, T>& S, const T* __restrict__ q,
                                                 const T* __restrict__ dout,
                                                 const float* __restrict__ l,
                                                 const float* __restrict__ m,
                                                 const float* __restrict__ di,
                                                 const float* __restrict__ dssq,
                                                 const float* __restrict__ dsumw, int b, int N,
                                                 int n0, int ns) {
  const size_t base = ((size_t)b * N + n0) * D;
  for (int x = threadIdx.x; x < ns * D; x += THREADS) {
    const float val = to_f32(q[base + x]);
    S.q[x / D][x % D] = val;
    S.tq[x / D][x % D] = PG ? round_to<T>(tanhf(val)) : 0.f;
    S.dout[x / D][x % D] = to_f32(dout[base + x]);
  }
  if ((int)threadIdx.x < ns) {
    const int n = threadIdx.x;
    const size_t bn = (size_t)b * N + n0 + n;
    const float lv = l[bn];
    S.stat[0][n] = m[bn];
    S.stat[1][n] = lv == 0.f ? 1.f : 1.f / lv;
    S.stat[2][n] = di[bn];
    S.stat[3][n] = dssq != nullptr ? dssq[bn] : 0.f;
    S.stat[4][n] = dsumw != nullptr ? dsumw[bn] : 0.f;
  }
}

// pd, da, du of the warp's two keys of the sub-step in `slot` (first key
// r0) against the slab's ns queries in shared memory (query n is n0 + n of
// the bag, for the dropout bits) into rows of S.da, S.du, S.pd; with tk_s,
// the sub-step's tanh(k) rows are stored there.
template <int D, bool PG, typename T>
__device__ __forceinline__ void pk_bwd_scores(PkBwdSmem<D, T>& S, const T* __restrict__ slot,
                                              float* __restrict__ tk_s,
                                              const uint8_t* __restrict__ mask, int b, int M,
                                              int r0, int n0, int ns, uint32_t seed,
                                              uint32_t thresh, float keep_scale, uint32_t bag0,
                                              float scale, int warp, int lane) {
  float second, dpv;
  const float dot = pk_key_sums<D, PG, true, IS_BF16<T>>(slot, S.q, S.tq, S.dout, tk_s, ns, warp,
                                                         lane, second, dpv);
  const int n = pk_query(lane), row = warp * PK_KPW + pk_key(lane), key = r0 + row;
  if ((lane & 1) == 0 && n < ns) {
    const float a = dot * scale;
    const float g = PG ? (second + 1.f) * 0.5f : 1.f;
    const float dp = PG ? dpv : second;
    const bool exists = key < M;  // keys past M do not exist: no gradient
    const bool valid = exists && (mask == nullptr || mask[(size_t)b * M + key]);
    float pd = 0.f, da = 0.f, du = 0.f;
    if (exists) {
      const float p = expf((valid ? a * g : NEG) - S.stat[0][n]) * S.stat[1][n];
      pd = p;
      if (thresh != 0u)
        pd = dropout_bits(seed, bag0 + (uint32_t)b, (uint32_t)(n0 + n), (uint32_t)key) >= thresh
                 ? p * keep_scale : 0.f;
      const float ds = valid ? pd * dp - p * S.stat[2][n] + 2.f * S.stat[3][n] * pd * pd +
                                   S.stat[4][n] * pd
                             : 0.f;
      da = ds * g;
      du = ds * a * 0.5f;
    }
    S.da[row][n] = da;
    S.du[row][n] = du;
    S.pd[row][n] = pd;
  }
}

// Thread tid owns columns col + DC c (c < CPT) of the keys grp + QG x: at
// D = 128 one column of every other key (two column groups), at D = 256 one
// column of every key, at D = 512 two (tid, tid + 256). Up to NMAX
// queries: dk and dv written, and dq's partials.
template <int D, bool PG, typename T>
__global__ void __launch_bounds__(THREADS, D < 512 ? 2 : 1)
plain_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 const int* __restrict__ list, const int* __restrict__ off,
                 const int* __restrict__ seed_ptr, uint32_t thresh, float keep_scale, uint32_t bag0,
                 const T* __restrict__ dout, const float* __restrict__ l,
                 const float* __restrict__ m, const float* __restrict__ di,
                 const float* __restrict__ dssq, const float* __restrict__ dsumw,
                 T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_part,
                 int B, int N, int M, float scale) {
  using S_ = PkBwdSmem<D, T>;
  constexpr int NSLOT = S_::NSLOT;
  constexpr int CPT = D > THREADS ? D / THREADS : 1;  // columns a thread
  constexpr int DC = D / CPT;                         // threads a key row
  constexpr int QG = THREADS / DC, RPT = PK_KEYS / QG;
  static_assert(QG == 1 || QG == 2, "one or two column groups");
  extern __shared__ float4 smem4[];
  S_& S = *reinterpret_cast<S_*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = tid % DC, grp = tid / DC;
  const int n0 = 0, NS = N;  // every query, N <= NMAX
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const uint32_t seed = (uint32_t)seed_ptr[0];

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    pk_issue<D, T>(S.ring[s], k, v, list, n_tiles, M, i1, cur);
    cp_async_commit();
  }

  float qa[CPT][NMAX];           // sum_r da k_r of each column, this thread's keys
  float qu[CPT][PG ? NMAX : 1];  // sum_r du tanh(k_r)
  int b = -1;
  // bag b's dq partial at index block + b: the column groups added in order
  // through S.tk (free between a sub-step's barrier and its score pass)
  auto flush = [&]() {
    const size_t pb = (size_t)blockIdx.x + b;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int cc = col + DC * c;
      float r[NMAX];
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        r[n] = scale * qa[c][n];
        if constexpr (PG) {
          const float t = S.tq[n][cc];
          r[n] = fmaf(1.f - t * t, qu[c][n], r[n]);
        }
      }
      if constexpr (QG == 1) {
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          if (n < NS) dq_part[(pb * N + n0 + n) * D + cc] = r[n];
      } else {
        float* merge = &S.tk[0][0];  // [NMAX][D]
        if (grp == 0) {
#pragma unroll
          for (int n = 0; n < NMAX; ++n) merge[n * D + cc] = r[n];
        }
        __syncthreads();
        if (grp == 1) {
#pragma unroll
          for (int n = 0; n < NMAX; ++n)
            if (n < NS) dq_part[(pb * N + n0 + n) * D + cc] = merge[n * D + cc] + r[n];
        }
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
      if (ub != b) {  // a new bag: flush the last one's dq, load this one's rows
        if (b >= 0) flush();
        __syncthreads();  // the flush has read S.tq and S.tk
        b = ub;
        pk_bwd_load_slab<D, PG, T>(S, q, dout, l, m, di, dssq, dsumw, b, N, n0, NS);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
#pragma unroll
          for (int n = 0; n < NMAX; ++n) {
            qa[c][n] = 0.f;
            if constexpr (PG) qu[c][n] = 0.f;
          }
        }
        __syncthreads();
      }
      const T* slot = S.ring[s % NSLOT];
      const int r0 = t * FK_BM + j * PK_KEYS;  // the sub-step's first key

      // ---- a, u, dp of the warp's two keys; pd, da, du per (key, query) ----
      pk_bwd_scores<D, PG, T>(S, slot, PG ? &S.tk[0][0] : nullptr, mask, b, M, r0, n0, NS, seed,
                              thresh, keep_scale, bag0, scale, warp, lane);
      __syncthreads();

      // ---- dk, dv of the keys r = grp + QG x at this thread's columns; dq's sums ----
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int cc = col + DC * c;
        float qc[NMAX], tqc[NMAX], oc[NMAX];
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          qc[n] = S.q[n][cc];
          tqc[n] = PG ? S.tq[n][cc] : 0.f;
          oc[n] = S.dout[n][cc];
        }
#pragma unroll 4
        for (int x = 0; x < RPT; ++x) {
          const int r = grp + QG * x, key = r0 + r;
          if (key >= M) break;
          float da[NMAX], du[NMAX], pd[NMAX];
          load8(&S.da[r][0], da);
          load8(&S.pd[r][0], pd);
          if constexpr (PG) load8(&S.du[r][0], du);
          const float kr = to_f32(slot[r * D + cc]), tkr = PG ? S.tk[r][cc] : 0.f;
          float ka = 0.f, ku = 0.f, vv = 0.f;
#pragma unroll
          for (int n = 0; n < NMAX; ++n) {
            if (n < NS) {
              ka = fmaf(da[n], qc[n], ka);
              vv = fmaf(pd[n], oc[n], vv);
              qa[c][n] = fmaf(da[n], kr, qa[c][n]);
              if constexpr (PG) {
                ku = fmaf(du[n], tqc[n], ku);
                qu[c][n] = fmaf(du[n], tkr, qu[c][n]);
              }
            }
          }
          float dkr = scale * ka;
          if constexpr (PG) dkr = fmaf(1.f - tkr * tkr, ku, dkr);
          const size_t o = ((size_t)b * M + key) * D + cc;
          store1(dk + o, dkr);
          store1(dv + o, vv);
        }
      }
      // S.tk, S.da, S.du, S.pd and this slot are rewritten after the next barrier
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last sub-step's dk loop has read S.tk before the flush merges there
  if (b >= 0) flush();
}

}  // namespace mpo
