// Backward of the few-query co-attention for Hopper (sm_90a), float32: the
// pre-gated fuse-K form and the plain-K form.
//
// Replaces the Pallas TPU kernel of multimodal_path_omic_tpu/ops/coattn.py:
//   * mpo_coattn_bwd_fused_k <- _coattn_bwd_impl with _make_bwd_kernel(
//       fuse_k=True, pre_gate=True, emit_ssq, emit_sumw, dropout): the lean-V
//       training backward (VJP glue _coattn_fk_bwd), K3 in PERF.md.
//   * mpo_coattn_plain_bwd <- _coattn_bwd_impl with the plain K operand
//       (VJP glue _coattn_bwd): dq, dk, dv of the attention off the lean
//       routes, with or without the pre-gate; described above plain_bwd_kernel.
//
// The fuse-K form:
// Per key tile, with the forward's (l, m) and dropout bits (N queries, key r):
//   k = kv wk + bk,  a = q.k / sqrt(E),  u = tanh(q).tanh(k),  g = (u + 1) / 2,
//   s = a g (NEG where masked),  p = exp(s - m) / l,  pd = keep p / (1 - rate),
//   dp = dO.kv_r,  ds = pd dp - p di + 2 dssq pd^2 + dsumw pd (0 where masked),
//   da = ds g,  du = ds a / 2,
//   dq += da k / sqrt(E) + (1 - tanh(q)^2) (du tanh(k)),
//   dk  = da q / sqrt(E) + (1 - tanh(k)^2) (du tanh(q)),
//   dkv = pd^T dO + dk wk^T,  dwk += kv^T dk,  dbk += colsum(dk).
// di = rowsum(o dO) + 2 dssq ssq + dsumw sumw comes from the caller
// (ops/coattn.py, as JAX's _coattn_fk_bwd computes it outside the kernel).
//
// What bounds it on an H100: three [64 x F] x [F x E]-sized float32 products
// per 64-key tile (k, dk wk^T, kv^T dk): 3 * 2 B M F E = 103 GFLOP at B=32,
// M=8192, E=F=256, 1.5 ms at the 67 TFLOP/s of the CUDA cores, against
// 0.16 ms for the 0.54 GB it must move: bound by operations. Tensor cores
// (TF32) are left out for the same reason as in the forward (float32 parity).
//
// Design. The TPU runs the grid in order and accumulates dq, dwk and dbk in
// resident blocks. Here one block = (bag, split of the key tiles), as in the
// forward, so that B=32 bags fill the 132 SMs. A tile's kv rows and its
// tanh(k) (then dk) live in dynamic shared memory (180 KB at E=F=256); the
// three products are register-tiled SIMT loops (8 keys x 8 columns a thread,
// 128-bit shared reads). Each block writes its own float32 partials: dwk
// [F, E] in device memory (written by its first tile, then read-modified-
// written once per tile), dbk and dq once at its end. bwd_reduce_kernel sums
// the partials in a fixed order: no atomics, so two runs give identical
// gradients. dq's k term is taken off the key axis,
//   sum_r da_r k_r = (sum_r da_r kv_r) wk + (sum_r da_r) bk,
// so the block never needs k and tanh(k) at once.
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing; runs on the caller's stream.

#include "coattn_common.cuh"

namespace {

using namespace mpo;

__device__ __forceinline__ float f4get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Column j (< width / 32) of lane `lane` in the register-tiled layouts:
// float4 groups, so a warp's 128-bit shared-memory accesses never conflict.
__device__ __forceinline__ int lane_col(int j, int lane) {
  return (j >> 2) * 128 + 4 * lane + (j & 3);
}

template <int E, int F>
struct BwdSmem {
  alignas(16) float kv[FK_BM][F];               // kv tile (zero rows past M)
  alignas(16) float tk[FK_BM][E];               // tanh(k), then dk
  alignas(16) float w[FK_BF][E > F ? E : F];    // wk chunk [16][E], or wk^T chunk [16][F]
  alignas(16) float q[NMAX][E];
  alignas(16) float tq[NMAX][E];
  alignas(16) float dout[NMAX][F];
  float a[NMAX][FK_BM], g[NMAX][FK_BM], dp[NMAX][FK_BM];
  float pd[NMAX][FK_BM], da[NMAX][FK_BM], du[NMAX][FK_BM];
  float stat[5][NMAX];  // m, 1/l, di, dssq, dsumw per query
};

template <int E, int F>
__global__ void __launch_bounds__(THREADS)
fused_k_bwd_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                   const float* __restrict__ wk, const float* __restrict__ bk,
                   const uint8_t* __restrict__ mask, const int* __restrict__ seed_ptr,
                   uint32_t thresh, float keep_scale, const float* __restrict__ dout,
                   const float* __restrict__ l, const float* __restrict__ m,
                   const float* __restrict__ di, const float* __restrict__ dssq,
                   const float* __restrict__ dsumw, float* __restrict__ dkv,
                   float* __restrict__ dq_part, float* __restrict__ dwk_part,
                   float* __restrict__ dbk_part, int N, int M, int tiles_per_split,
                   float scale) {
  constexpr int EPT = E / 32;  // E columns per lane
  constexpr int FPT = F / 32;  // F columns per lane
  extern __shared__ float4 smem4[];
  BwdSmem<E, F>& S = *reinterpret_cast<BwdSmem<E, F>*>(smem4);

  const int b = blockIdx.x, split = blockIdx.y, P = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < N * E; i += THREADS) {
    const float v = q[(size_t)b * N * E + i];
    S.q[i / E][i % E] = v;
    S.tq[i / E][i % E] = tanhf(v);
  }
  for (int i = tid; i < N * F; i += THREADS) S.dout[i / F][i % F] = dout[(size_t)b * N * F + i];
  if (tid < N) {
    const size_t bn = (size_t)b * N + tid;
    const float lv = l[bn];
    S.stat[0][tid] = m[bn];
    S.stat[1][tid] = lv == 0.f ? 1.f : 1.f / lv;
    S.stat[2][tid] = di[bn];
    S.stat[3][tid] = dssq != nullptr ? dssq[bn] : 0.f;
    S.stat[4][tid] = dsumw != nullptr ? dsumw[bn] : 0.f;
  }
  float bias[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) bias[j] = bk[lane_col(j, lane)];
  // column-owner accumulators: thread tid owns E column tid (dq's tanh term,
  // dbk) and F column tid (z = sum_r da_r kv_r); thread n < N owns sum_r da
  float dqu[NMAX], z[NMAX], sda = 0.f, dbk_acc = 0.f;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) dqu[n] = z[n] = 0.f;

  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  const float* kv_b = kv + (size_t)b * M * F;
  float* dwk_blk = dwk_part + ((size_t)b * P + split) * F * E;
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int m0 = t * FK_BM;
    // ---- kv tile -> shared ----
    for (int i = tid; i < FK_BM * F / 4; i += THREADS) {
      const int r = i / (F / 4), c4 = i % (F / 4);
      const float4 v = m0 + r < M
          ? reinterpret_cast<const float4*>(kv_b + (size_t)(m0 + r) * F)[c4] : zero4;
      reinterpret_cast<float4*>(&S.kv[r][0])[c4] = v;
    }
    __syncthreads();

    // ---- k tile = kv @ wk + bk (warp: 8 key rows, lane: EPT columns) ----
    float acc[FK_RPW][EPT];
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
      for (int j = 0; j < EPT; ++j) acc[i][j] = 0.f;
    for (int f0 = 0; f0 < F; f0 += FK_BF) {
      for (int i = tid; i < FK_BF * E / 4; i += THREADS) {
        const int r = i / (E / 4), c = i % (E / 4);
        reinterpret_cast<float4*>(&S.w[r][0])[c] =
            reinterpret_cast<const float4*>(wk + (size_t)(f0 + r) * E)[c];
      }
      __syncthreads();
#pragma unroll
      for (int k4 = 0; k4 < FK_BF; k4 += 4) {
        float4 a4[FK_RPW];
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i)
          a4[i] = *reinterpret_cast<const float4*>(&S.kv[warp * FK_RPW + i][f0 + k4]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float w[EPT];
#pragma unroll
          for (int j4 = 0; j4 < EPT / 4; ++j4) {
            const float4 wv = *reinterpret_cast<const float4*>(&S.w[k4 + kk][j4 * 128 + 4 * lane]);
            w[4 * j4 + 0] = wv.x; w[4 * j4 + 1] = wv.y; w[4 * j4 + 2] = wv.z; w[4 * j4 + 3] = wv.w;
          }
#pragma unroll
          for (int i = 0; i < FK_RPW; ++i) {
            const float av = f4get(a4[i], kk);
#pragma unroll
            for (int j = 0; j < EPT; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // ---- a = q.k * scale; tanh(k) -> shared; gate; dp = dO.kv ----
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
      for (int j = 0; j < EPT; ++j) acc[i][j] += bias[j];
    for (int n = 0; n < N; ++n) {
      float qv[EPT];
#pragma unroll
      for (int j = 0; j < EPT; ++j) qv[j] = S.q[n][lane_col(j, lane)];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < EPT; ++j) p = fmaf(acc[i][j], qv[j], p);
        p = warp_sum(p);
        if (lane == i) S.a[n][warp * FK_RPW + i] = p * scale;
      }
    }
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i) {
#pragma unroll
      for (int j = 0; j < EPT; ++j) acc[i][j] = tanhf(acc[i][j]);
#pragma unroll
      for (int j4 = 0; j4 < EPT / 4; ++j4)
        *reinterpret_cast<float4*>(&S.tk[warp * FK_RPW + i][j4 * 128 + 4 * lane]) =
            make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1], acc[i][4 * j4 + 2], acc[i][4 * j4 + 3]);
    }
    for (int n = 0; n < N; ++n) {
      float tv[EPT];
#pragma unroll
      for (int j = 0; j < EPT; ++j) tv[j] = S.tq[n][lane_col(j, lane)];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        float u = 0.f;
#pragma unroll
        for (int j = 0; j < EPT; ++j) u = fmaf(acc[i][j], tv[j], u);
        u = warp_sum(u);
        if (lane == i) S.g[n][warp * FK_RPW + i] = (u + 1.f) * 0.5f;
      }
    }
    for (int n = 0; n < N; ++n) {
      float dv[FPT];
#pragma unroll
      for (int j = 0; j < FPT; ++j) dv[j] = S.dout[n][lane_col(j, lane)];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        float p = 0.f;
#pragma unroll
        for (int j4 = 0; j4 < FPT / 4; ++j4) {
          const float4 x = *reinterpret_cast<const float4*>(&S.kv[warp * FK_RPW + i][j4 * 128 + 4 * lane]);
          p = fmaf(x.x, dv[4 * j4], fmaf(x.y, dv[4 * j4 + 1], fmaf(x.z, dv[4 * j4 + 2], fmaf(x.w, dv[4 * j4 + 3], p))));
        }
        p = warp_sum(p);
        if (lane == i) S.dp[n][warp * FK_RPW + i] = p;
      }
    }
    __syncthreads();

    // ---- softmax / dropout / ssq / sumw backward, elementwise ----
    for (int idx = tid; idx < N * FK_BM; idx += THREADS) {
      const int n = idx / FK_BM, r = idx % FK_BM, key = m0 + r;
      float pd = 0.f, da = 0.f, du = 0.f;
      if (key < M) {  // keys past M do not exist: p = 0
        const bool valid = mask == nullptr || mask[(size_t)b * M + key];
        const float a = S.a[n][r], g = S.g[n][r];
        const float s = valid ? a * g : NEG;
        const float p = expf(s - S.stat[0][n]) * S.stat[1][n];
        pd = p;
        if (thresh != 0u)
          pd = dropout_bits(seed, (uint32_t)b, (uint32_t)n, (uint32_t)key) >= thresh
              ? p * keep_scale : 0.f;
        if (valid) {
          const float ds = pd * S.dp[n][r] - p * S.stat[2][n]
              + 2.f * S.stat[3][n] * pd * pd + S.stat[4][n] * pd;
          da = ds * g;
          du = ds * a * 0.5f;
        }
      }
      S.pd[n][r] = pd;
      S.da[n][r] = da;
      S.du[n][r] = du;
    }
    __syncthreads();

    // ---- column-owner sums over the tile's keys ----
    if (tid < E) {
      for (int r = 0; r < FK_BM; ++r) {
        const float tkv = S.tk[r][tid];
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          if (n < N) dqu[n] = fmaf(S.du[n][r], tkv, dqu[n]);
      }
    }
    if (tid < F) {
      for (int r = 0; r < FK_BM; ++r) {
        const float x = S.kv[r][tid];
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          if (n < N) z[n] = fmaf(S.da[n][r], x, z[n]);
      }
    }
    if (tid < N)
      for (int r = 0; r < FK_BM; ++r) sda += S.da[tid][r];
    __syncthreads();

    // ---- dk, in place over tanh(k) ----
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i) {
      const int row = warp * FK_RPW + i;
#pragma unroll
      for (int j4 = 0; j4 < EPT / 4; ++j4) {
        const int c = j4 * 128 + 4 * lane;
        const float4 t4 = *reinterpret_cast<const float4*>(&S.tk[row][c]);
        float4 sa = zero4, su = zero4;
        for (int n = 0; n < N; ++n) {
          const float dav = S.da[n][row], duv = S.du[n][row];
          const float4 q4 = *reinterpret_cast<const float4*>(&S.q[n][c]);
          const float4 u4 = *reinterpret_cast<const float4*>(&S.tq[n][c]);
          sa.x = fmaf(dav, q4.x, sa.x); sa.y = fmaf(dav, q4.y, sa.y);
          sa.z = fmaf(dav, q4.z, sa.z); sa.w = fmaf(dav, q4.w, sa.w);
          su.x = fmaf(duv, u4.x, su.x); su.y = fmaf(duv, u4.y, su.y);
          su.z = fmaf(duv, u4.z, su.z); su.w = fmaf(duv, u4.w, su.w);
        }
        *reinterpret_cast<float4*>(&S.tk[row][c]) = make_float4(
            scale * sa.x + (1.f - t4.x * t4.x) * su.x, scale * sa.y + (1.f - t4.y * t4.y) * su.y,
            scale * sa.z + (1.f - t4.z * t4.z) * su.z, scale * sa.w + (1.f - t4.w * t4.w) * su.w);
      }
    }
    __syncthreads();
    if (tid < E)
      for (int r = 0; r < FK_BM; ++r) dbk_acc += S.tk[r][tid];

    // ---- dkv = pd^T dO + dk wk^T (warp: 8 key rows, lane: FPT columns) ----
    float acc2[FK_RPW][FPT];
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
      for (int j = 0; j < FPT; ++j) acc2[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float dv[FPT];
#pragma unroll
      for (int j = 0; j < FPT; ++j) dv[j] = S.dout[n][lane_col(j, lane)];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        const float pdv = S.pd[n][warp * FK_RPW + i];
#pragma unroll
        for (int j = 0; j < FPT; ++j) acc2[i][j] = fmaf(pdv, dv[j], acc2[i][j]);
      }
    }
    for (int e0 = 0; e0 < E; e0 += FK_BF) {
      for (int f = tid; f < F; f += THREADS) {  // S.w[ee][f] = wk[f][e0 + ee]
        const float4* src = reinterpret_cast<const float4*>(wk + (size_t)f * E + e0);
#pragma unroll
        for (int c = 0; c < FK_BF / 4; ++c) {
          const float4 v = src[c];
          S.w[4 * c + 0][f] = v.x; S.w[4 * c + 1][f] = v.y;
          S.w[4 * c + 2][f] = v.z; S.w[4 * c + 3][f] = v.w;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k4 = 0; k4 < FK_BF; k4 += 4) {
        float4 a4[FK_RPW];
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i)
          a4[i] = *reinterpret_cast<const float4*>(&S.tk[warp * FK_RPW + i][e0 + k4]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float w[FPT];
#pragma unroll
          for (int j4 = 0; j4 < FPT / 4; ++j4) {
            const float4 wv = *reinterpret_cast<const float4*>(&S.w[k4 + kk][j4 * 128 + 4 * lane]);
            w[4 * j4 + 0] = wv.x; w[4 * j4 + 1] = wv.y; w[4 * j4 + 2] = wv.z; w[4 * j4 + 3] = wv.w;
          }
#pragma unroll
          for (int i = 0; i < FK_RPW; ++i) {
            const float av = f4get(a4[i], kk);
#pragma unroll
            for (int j = 0; j < FPT; ++j) acc2[i][j] = fmaf(av, w[j], acc2[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i) {
      const int key = m0 + warp * FK_RPW + i;
      if (key < M) {
        float* dst = dkv + ((size_t)b * M + key) * F;
#pragma unroll
        for (int j4 = 0; j4 < FPT / 4; ++j4)
          *reinterpret_cast<float4*>(dst + j4 * 128 + 4 * lane) = make_float4(
              acc2[i][4 * j4], acc2[i][4 * j4 + 1], acc2[i][4 * j4 + 2], acc2[i][4 * j4 + 3]);
      }
    }

    // ---- dwk partial += kv^T dk (warp: 8 F rows of a 64-row pass, lane: EPT columns) ----
    const bool first = t == t0;
    for (int fc0 = 0; fc0 < F; fc0 += FK_BM) {
      float acc3[FK_RPW][EPT];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
        for (int j = 0; j < EPT; ++j) acc3[i][j] = 0.f;
      for (int r = 0; r < FK_BM; ++r) {
        const float4 x0 = *reinterpret_cast<const float4*>(&S.kv[r][fc0 + warp * FK_RPW]);
        const float4 x1 = *reinterpret_cast<const float4*>(&S.kv[r][fc0 + warp * FK_RPW + 4]);
        const float xf[FK_RPW] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        float dk[EPT];
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4) {
          const float4 v = *reinterpret_cast<const float4*>(&S.tk[r][j4 * 128 + 4 * lane]);
          dk[4 * j4 + 0] = v.x; dk[4 * j4 + 1] = v.y; dk[4 * j4 + 2] = v.z; dk[4 * j4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
          for (int j = 0; j < EPT; ++j) acc3[i][j] = fmaf(xf[i], dk[j], acc3[i][j]);
      }
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        float* dst = dwk_blk + (size_t)(fc0 + warp * FK_RPW + i) * E;
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4) {
          float4* p4 = reinterpret_cast<float4*>(dst + j4 * 128 + 4 * lane);
          float4 v = first ? zero4 : *p4;
          v.x += acc3[i][4 * j4]; v.y += acc3[i][4 * j4 + 1];
          v.z += acc3[i][4 * j4 + 2]; v.w += acc3[i][4 * j4 + 3];
          *p4 = v;
        }
      }
    }
    __syncthreads();  // kv / tk / per-key arrays are rewritten by the next tile
  }

  // ---- this block's dq and dbk partials ----
  if (tid < F) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) S.kv[n][tid] = z[n];
  }
  if (tid < N) S.stat[0][tid] = sda;
  __syncthreads();
  if (tid < E) {
    float v[NMAX];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) v[n] = 0.f;
    for (int f = 0; f < F; ++f) {
      const float w = wk[(size_t)f * E + tid];
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
        if (n < N) v[n] = fmaf(S.kv[n][f], w, v[n]);
    }
    const float bkv = bk[tid];
    const size_t pb = (size_t)b * P + split;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float tq = S.tq[n][tid];
        dq_part[(pb * N + n) * E + tid] =
            scale * (v[n] + S.stat[0][n] * bkv) + (1.f - tq * tq) * dqu[n];
      }
    }
    dbk_part[pb * E + tid] = dbk_acc;
  }
}

// dq [B, N, E] = sum_p dq_part[b, p]; dwk [F, E], dbk [E] = sum over every
// block's partial (dwk == NULL: dq only, the plain-K form). Each output
// element is summed by one thread in a fixed order (no atomics:
// deterministic).
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const float* __restrict__ dq_part, const float* __restrict__ dwk_part,
              const float* __restrict__ dbk_part, float* __restrict__ dq,
              float* __restrict__ dwk, float* __restrict__ dbk, int B, int P, int N, int E,
              int F) {
  const size_t nq = (size_t)B * N * E, nw = (size_t)F * E;
  const size_t total = dwk != nullptr ? nq + nw + E : nq;
  const size_t ne = (size_t)N * E;
  const int blocks = B * P;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < nq) {
      const size_t b = i / ne, j = i % ne;
      for (int p = 0; p < P; ++p) acc += dq_part[(b * P + p) * ne + j];
      dq[i] = acc;
    } else if (i < nq + nw) {
      const size_t j = i - nq;
      for (int k = 0; k < blocks; ++k) acc += dwk_part[(size_t)k * nw + j];
      dwk[j] = acc;
    } else {
      const size_t j = i - nq - nw;
      for (int k = 0; k < blocks; ++k) acc += dbk_part[(size_t)k * E + j];
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
// (1.07 GB at B=32, M=8192, D=256: 0.32 ms at 3.35 TB/s) for 6 GFLOP of
// products (0.09 ms): bound by bytes. Design: as the forward (csrc/coattn.cu
// plain_kernel), one block = (bag, split of the keys) and one warp = a
// contiguous run of keys, a key's rows in registers (4 columns per lane and
// 128-column group). dk_r and dv_r belong to the key, so the warp that owns
// it writes them once, coalesced. Only dq sums over keys: each lane carries
// its columns of the N x D sums (two sets with the pre-gate), the block adds
// its 8 warps in shared memory in warp order, writes one partial per
// (bag, split), and bwd_reduce_kernel sums the splits in a fixed order: no
// atomics, two runs give the same bits.
// ---------------------------------------------------------------------------
template <int DV>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int lane,
                                         float4 (&x)[DV]) {
#pragma unroll
  for (int c = 0; c < DV; ++c) x[c] = *reinterpret_cast<const float4*>(row + c * 128 + 4 * lane);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ void axpy4(float a, const float4& x, float4& y) {
  y.x = fmaf(a, x.x, y.x); y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z); y.w = fmaf(a, x.w, y.w);
}

template <int DV, bool PG>
__global__ void __launch_bounds__(THREADS)
plain_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 const int* __restrict__ seed_ptr, uint32_t thresh, float keep_scale,
                 const float* __restrict__ dout, const float* __restrict__ l,
                 const float* __restrict__ m, const float* __restrict__ di,
                 const float* __restrict__ dssq, const float* __restrict__ dsumw,
                 float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq_part,
                 int N, int M, float scale) {
  constexpr int D = DV * 128;
  __shared__ __align__(16) float q_s[NMAX][D];
  __shared__ __align__(16) float tq_s[NMAX][D];
  __shared__ __align__(16) float do_s[NMAX][D];
  __shared__ __align__(16) float dq_s[NMAX][D];
  __shared__ float stat[5][NMAX];  // m, 1/l, di, dssq, dsumw per query
  const int b = blockIdx.x, split = blockIdx.y, P = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gw = split * WARPS + warp, W = P * WARPS;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < N * D; i += THREADS) {
    const float x = q[(size_t)b * N * D + i];
    q_s[i / D][i % D] = x;
    tq_s[i / D][i % D] = PG ? tanhf(x) : 0.f;
    do_s[i / D][i % D] = dout[(size_t)b * N * D + i];
  }
  if (tid < N) {
    const size_t bn = (size_t)b * N + tid;
    const float lv = l[bn];
    stat[0][tid] = m[bn];
    stat[1][tid] = lv == 0.f ? 1.f : 1.f / lv;
    stat[2][tid] = di[bn];
    stat[3][tid] = dssq != nullptr ? dssq[bn] : 0.f;
    stat[4][tid] = dsumw != nullptr ? dsumw[bn] : 0.f;
  }
  __syncthreads();

  float4 qa[NMAX][DV];              // sum_r da k_r
  float4 qu[PG ? NMAX : 1][DV];     // sum_r du tanh(k_r)
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      qa[n][c] = zero4;
      if constexpr (PG) qu[n][c] = zero4;
    }

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
    if (key + 1 < k1) {  // the next key's rows land while this one is worked on
      load_row<DV>(k_b + (size_t)(key + 1) * D, lane, kn);
      load_row<DV>(v_b + (size_t)(key + 1) * D, lane, vn);
    }
    if (PG) {
#pragma unroll
      for (int c = 0; c < DV; ++c)
        tk[c] = make_float4(tanhf(kx[c].x), tanhf(kx[c].y), tanhf(kx[c].z), tanhf(kx[c].w));
    }
    const bool valid = mask == nullptr || mask[(size_t)b * M + key];
    uint32_t keep = 0xffffffffu;
    if (thresh != 0u)  // lane n draws query n's bits
      keep = __ballot_sync(0xffffffffu, dropout_bits(seed, (uint32_t)b,
                                                     (uint32_t)(lane < N ? lane : 0),
                                                     (uint32_t)key) >= thresh);
    float4 ka[DV], ku[DV], va[DV];  // dk's two terms and dv of this key
#pragma unroll
    for (int c = 0; c < DV; ++c) ka[c] = ku[c] = va[c] = zero4;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        float a = 0.f, u = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < DV; ++c) {
          const int col = c * 128 + 4 * lane;
          a = dot4(*reinterpret_cast<const float4*>(&q_s[n][col]), kx[c], a);
          if (PG) u = dot4(*reinterpret_cast<const float4*>(&tq_s[n][col]), tk[c], u);
          dp = dot4(*reinterpret_cast<const float4*>(&do_s[n][col]), vx[c], dp);
        }
        a = warp_sum(a) * scale;
        const float g = PG ? (warp_sum(u) + 1.f) * 0.5f : 1.f;
        dp = warp_sum(dp);
        const float p = expf((valid ? a * g : NEG) - stat[0][n]) * stat[1][n];
        float pd = p;
        if (thresh != 0u) pd = (keep >> n) & 1u ? p * keep_scale : 0.f;
        const float ds = valid
            ? pd * dp - p * stat[2][n] + 2.f * stat[3][n] * pd * pd + stat[4][n] * pd : 0.f;
        const float da = ds * g, du = ds * a * 0.5f;
#pragma unroll
        for (int c = 0; c < DV; ++c) {
          const int col = c * 128 + 4 * lane;
          axpy4(da, kx[c], qa[n][c]);
          axpy4(da, *reinterpret_cast<const float4*>(&q_s[n][col]), ka[c]);
          axpy4(pd, *reinterpret_cast<const float4*>(&do_s[n][col]), va[c]);
          if constexpr (PG) {
            axpy4(du, tk[c], qu[n][c]);
            axpy4(du, *reinterpret_cast<const float4*>(&tq_s[n][col]), ku[c]);
          }
        }
      }
    }
    float* dk_r = dk + ((size_t)b * M + key) * D;
    float* dv_r = dv + ((size_t)b * M + key) * D;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      float4 r = make_float4(scale * ka[c].x, scale * ka[c].y, scale * ka[c].z, scale * ka[c].w);
      if (PG) {
        r.x = fmaf(1.f - tk[c].x * tk[c].x, ku[c].x, r.x);
        r.y = fmaf(1.f - tk[c].y * tk[c].y, ku[c].y, r.y);
        r.z = fmaf(1.f - tk[c].z * tk[c].z, ku[c].z, r.z);
        r.w = fmaf(1.f - tk[c].w * tk[c].w, ku[c].w, r.w);
      }
      *reinterpret_cast<float4*>(dk_r + c * 128 + 4 * lane) = r;
      *reinterpret_cast<float4*>(dv_r + c * 128 + 4 * lane) = va[c];
    }
  }

  // ---- this block's dq partial: its warps added in warp order ----
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
#pragma unroll
          for (int c = 0; c < DV; ++c) {
            const int col = c * 128 + 4 * lane;
            float4 r = make_float4(scale * qa[n][c].x, scale * qa[n][c].y, scale * qa[n][c].z,
                                   scale * qa[n][c].w);
            if constexpr (PG) {
              const float4 t = *reinterpret_cast<const float4*>(&tq_s[n][col]);
              r.x = fmaf(1.f - t.x * t.x, qu[n][c].x, r.x);
              r.y = fmaf(1.f - t.y * t.y, qu[n][c].y, r.y);
              r.z = fmaf(1.f - t.z * t.z, qu[n][c].z, r.z);
              r.w = fmaf(1.f - t.w * t.w, qu[n][c].w, r.w);
            }
            float4* dst = reinterpret_cast<float4*>(&dq_s[n][col]);
            if (w != 0) {
              const float4 acc = *dst;
              r.x += acc.x; r.y += acc.y; r.z += acc.z; r.w += acc.w;
            }
            *dst = r;
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t pb = (size_t)b * P + split;
  for (int i = tid; i < N * D; i += THREADS) dq_part[pb * N * D + i] = dq_s[i / D][i % D];
}

template <int E, int F>
int launch_bwd(const float* q, const float* kv, const float* wk, const float* bk,
               const uint8_t* mask, const int* seed, uint32_t thresh, float keep_scale,
               const float* dout, const float* l, const float* m, const float* di,
               const float* dssq, const float* dsumw, float* dkv, float* dq_part,
               float* dwk_part, float* dbk_part, int B, int N, int M, int splits, int per,
               float scale, cudaStream_t st) {
  const int smem = (int)sizeof(BwdSmem<E, F>);
  int err = (int)cudaFuncSetAttribute(fused_k_bwd_kernel<E, F>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  fused_k_bwd_kernel<E, F><<<dim3(B, splits), THREADS, smem, st>>>(
      q, kv, wk, bk, mask, seed, thresh, keep_scale, dout, l, m, di, dssq, dsumw, dkv,
      dq_part, dwk_part, dbk_part, N, M, per, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Inputs as the training forward (q [B, N, E], kv [B, M, F], wk [F, E],
// bk [E], mask [B, M] bool or NULL, seed: one int32 on the device, thresh /
// keep_scale as there) plus dout [B, N, F] and l, m, di [B, N]; dssq, dsumw
// [B, N] or NULL (zero cotangents). Out: dq [B, N, E], dkv [B, M, F],
// dwk [F, E], dbk [E]. Scratch: dq_part [B, splits, N, E], dwk_part
// [B * splits, F, E], dbk_part [B * splits, E]. Every split must own at least
// one of the ceil(M / 64) key tiles. E, F in {128, 256}; N <= 8.
int mpo_coattn_bwd_fused_k(const float* q, const float* kv, const float* wk, const float* bk,
                           const uint8_t* mask, const int* seed, const float* dout,
                           const float* l, const float* m, const float* di,
                           const float* dssq, const float* dsumw, float* dq, float* dkv,
                           float* dwk, float* dbk, float* dq_part, float* dwk_part,
                           float* dbk_part, int B, int N, int M, int F, int E, int splits,
                           float scale, uint32_t thresh, float keep_scale, void* stream) {
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  if (N < 1 || N > NMAX || M < 1 || B < 1 || splits < 1 || splits > n_tiles)
    return (int)cudaErrorInvalidValue;
  const int per = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * per >= n_tiles) return (int)cudaErrorInvalidValue;  // an empty split
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
#define MPO_BWD(E_, F_)                                                                  \
  if (E == E_ && F == F_)                                                                \
    err = launch_bwd<E_, F_>(q, kv, wk, bk, mask, seed, thresh, keep_scale, dout, l, m, di, \
                             dssq, dsumw, dkv, dq_part, dwk_part, dbk_part, B, N, M,        \
                             splits, per, scale, st);
  MPO_BWD(256, 256) else MPO_BWD(128, 128) else MPO_BWD(256, 128) else MPO_BWD(128, 256)
  else return (int)cudaErrorInvalidValue;
#undef MPO_BWD
  if (err) return err;
  const size_t total = (size_t)B * N * E + (size_t)F * E + E;
  const int grid = (int)((total + THREADS - 1) / THREADS);
  bwd_reduce_kernel<<<grid, THREADS, 0, st>>>(dq_part, dwk_part, dbk_part, dq, dwk, dbk, B,
                                          splits, N, E, F);
  return (int)cudaGetLastError();
}

// The plain-K form: q [B, N, D], k, v [B, M, D], mask [B, M] bool or NULL,
// seed / thresh / keep_scale as the forward, dout [B, N, D], l, m, di [B, N];
// dssq, dsumw [B, N] or NULL (zero cotangents). Out: dq [B, N, D], dk, dv
// [B, M, D]. Scratch: dq_part [B, splits, N, D]. D in {128, 256}; N <= 8.
int mpo_coattn_plain_bwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                         const int* seed, const float* dout, const float* l, const float* m,
                         const float* di, const float* dssq, const float* dsumw, float* dq,
                         float* dk, float* dv, float* dq_part, int B, int N, int M, int D,
                         int pre_gate, int splits, float scale, uint32_t thresh,
                         float keep_scale, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, splits);
#define MPO_PLAIN_BWD(DV_, PG_)                                                          \
  plain_bwd_kernel<DV_, PG_><<<grid, THREADS, 0, st>>>(q, k, v, mask, seed, thresh,        \
                                                       keep_scale, dout, l, m, di, dssq,   \
                                                       dsumw, dk, dv, dq_part, N, M, scale)
  if (D == 128 && pre_gate) MPO_PLAIN_BWD(1, true);
  else if (D == 128) MPO_PLAIN_BWD(1, false);
  else if (D == 256 && pre_gate) MPO_PLAIN_BWD(2, true);
  else if (D == 256) MPO_PLAIN_BWD(2, false);
  else return (int)cudaErrorInvalidValue;
#undef MPO_PLAIN_BWD
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)B * N * D;
  bwd_reduce_kernel<<<(int)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      dq_part, nullptr, nullptr, dq, nullptr, nullptr, B, splits, N, D, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
