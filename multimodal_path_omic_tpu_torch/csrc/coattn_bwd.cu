// Backward of the pre-gated fuse-K few-query co-attention for Hopper
// (sm_90a), float32.
//
// Replaces the Pallas TPU kernel of multimodal_path_omic_tpu/ops/coattn.py:
//   * mpo_coattn_bwd_fused_k <- _coattn_bwd_impl with _make_bwd_kernel(
//       fuse_k=True, pre_gate=True, emit_ssq, emit_sumw, dropout): the lean-V
//       training backward (VJP glue _coattn_fk_bwd), K3 in PERF.md.
//
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
// block's partial. Each output element is summed by one thread in a fixed
// order (no atomics: deterministic).
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const float* __restrict__ dq_part, const float* __restrict__ dwk_part,
              const float* __restrict__ dbk_part, float* __restrict__ dq,
              float* __restrict__ dwk, float* __restrict__ dbk, int B, int P, int N, int E,
              int F) {
  const size_t nq = (size_t)B * N * E, nw = (size_t)F * E, total = nq + nw + E;
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

}  // extern "C"
