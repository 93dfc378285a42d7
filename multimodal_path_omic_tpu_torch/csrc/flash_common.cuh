// Shared by csrc/flash.cu (forward) and csrc/flash_bwd.cu (backward): the
// mask value, the chunk copies between global and shared memory, and the two
// register-tiled SIMT products every phase of both kernels is made of. A
// block has 8 warps; a warp owns RPW "rows" (held transposed in shared memory
// for the block's lifetime), a lane owns columns lane, lane+32, ... of the
// tile that streams through shared memory in chunks.
#pragma once

#include "coattn_common.cuh"

namespace mpo {

constexpr float MASK_NEG = -1e9f;  // ops/layers.py NEG_INF

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// A depth chunk: rows k0 .. k0+BK-1, depths d0 .. d0+KC-1 (zero rows past L).
template <int BK, int KC, int N>
__device__ __forceinline__ void load_k(float4 (&reg)[N], const float* __restrict__ k_b,
                                       long long k_sl, int k0, int d0, int L) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int idx = threadIdx.x + u * THREADS, row = idx / (KC / 4), c = idx % (KC / 4);
    reg[u] = k0 + row < L
                 ? *reinterpret_cast<const float4*>(k_b + (long long)(k0 + row) * k_sl + d0 + 4 * c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int KC, int KS, int N>
__device__ __forceinline__ void store_k(const float4 (&reg)[N], float* __restrict__ kv_s) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int idx = threadIdx.x + u * THREADS, row = idx / (KC / 4), c = idx % (KC / 4);
    *reinterpret_cast<float4*>(&kv_s[row * KS + 4 * c]) = reg[u];
  }
}

// A row chunk: rows r0 .. r0+VC-1, all DH columns (zero rows past L).
template <int DH, int N>
__device__ __forceinline__ void load_v(float4 (&reg)[N], const float* __restrict__ v_b,
                                       long long v_sl, int r0, int L) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int idx = threadIdx.x + u * THREADS, row = idx / (DH / 4), c = idx % (DH / 4);
    reg[u] = r0 + row < L
                 ? *reinterpret_cast<const float4*>(v_b + (long long)(r0 + row) * v_sl + 4 * c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int DH, int N>
__device__ __forceinline__ void store_v(const float4 (&reg)[N], float* __restrict__ kv_s) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int idx = threadIdx.x + u * THREADS, row = idx / (DH / 4), c = idx % (DH / 4);
    *reinterpret_cast<float4*>(&kv_s[row * DH + 4 * c]) = reg[u];
  }
}

// s[i][t] += sum over one depth chunk of x[row i][d] * y[column t][d]: the
// warp's rows from xt_s ([depth][RS], already at the chunk's first depth;
// broadcast float4 reads), the lane's columns from the chunk kv_s ([col][KS]).
template <int RPW, int KPL, int KC, int KS, int RS>
__device__ __forceinline__ void dot_chunk(float (&s)[RPW][KPL], const float* __restrict__ xt_s,
                                          const float* __restrict__ kv_s, int warp, int lane) {
#pragma unroll
  for (int dd = 0; dd < KC; dd += 4) {
    float4 kf[KPL];
#pragma unroll
    for (int tt = 0; tt < KPL; ++tt)
      kf[tt] = *reinterpret_cast<const float4*>(&kv_s[(lane + 32 * tt) * KS + dd]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float a[RPW];
      const float* xrow = &xt_s[(dd + u) * RS + warp * RPW];
#pragma unroll
      for (int g = 0; g < RPW / 4; ++g) {
        const float4 a4 = *reinterpret_cast<const float4*>(xrow + 4 * g);
        a[4 * g + 0] = a4.x; a[4 * g + 1] = a4.y; a[4 * g + 2] = a4.z; a[4 * g + 3] = a4.w;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int tt = 0; tt < KPL; ++tt) s[i][tt] = fmaf(a[i], comp(kf[tt], u), s[i][tt]);
    }
  }
}

// o[i][j] += sum over one chunk of VC columns of p[row i][c] * y[c][j]: the
// warp's rows from pt_s ([column][RS], already at the chunk's first column),
// y's rows from the chunk kv_s ([VC][DH]). A lane owns output column `lane`
// (DH = 32) or columns j4*128 + 4*lane .. +3.
template <int RPW, int CPL, int VC, int DH, int RS>
__device__ __forceinline__ void acc_chunk(float (&o)[RPW][CPL], const float* __restrict__ pt_s,
                                          const float* __restrict__ kv_s, int warp, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < VC; ++kk) {
    float p[RPW], vv[CPL];
    const float* prow = &pt_s[kk * RS + warp * RPW];
#pragma unroll
    for (int g = 0; g < RPW / 4; ++g) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + 4 * g);
      p[4 * g + 0] = p4.x; p[4 * g + 1] = p4.y; p[4 * g + 2] = p4.z; p[4 * g + 3] = p4.w;
    }
    if constexpr (CPL == 1) {
      vv[0] = kv_s[kk * DH + lane];
    } else {
#pragma unroll
      for (int j4 = 0; j4 < CPL / 4; ++j4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&kv_s[kk * DH + j4 * 128 + 4 * lane]);
        vv[4 * j4 + 0] = v4.x; vv[4 * j4 + 1] = v4.y; vv[4 * j4 + 2] = v4.z; vv[4 * j4 + 3] = v4.w;
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
  }
}

// Write the warp's RPW values of each of the lane's KPL columns into a
// transposed tile pt_s ([column][RS]).
template <int RPW, int KPL, int RS>
__device__ __forceinline__ void store_transposed(const float (&s)[RPW][KPL],
                                                 float* __restrict__ pt_s, int warp, int lane) {
#pragma unroll
  for (int tt = 0; tt < KPL; ++tt)
#pragma unroll
    for (int g = 0; g < RPW / 4; ++g)
      *reinterpret_cast<float4*>(&pt_s[(lane + 32 * tt) * RS + warp * RPW + 4 * g]) =
          make_float4(s[4 * g + 0][tt], s[4 * g + 1][tt], s[4 * g + 2][tt], s[4 * g + 3][tt]);
}

// One accumulator row out: DH columns of o, scaled, to a row pointer.
template <int CPL>
__device__ __forceinline__ void store_row(const float (&o)[CPL], float scale,
                                          float* __restrict__ row, int lane) {
  if constexpr (CPL == 1) {
    row[lane] = o[0] * scale;
  } else {
#pragma unroll
    for (int j4 = 0; j4 < CPL / 4; ++j4)
      *reinterpret_cast<float4*>(row + j4 * 128 + 4 * lane) =
          make_float4(o[4 * j4 + 0] * scale, o[4 * j4 + 1] * scale, o[4 * j4 + 2] * scale,
                      o[4 * j4 + 3] * scale);
  }
}

// The attribute that allows more than 48 KB of dynamic shared memory belongs
// to (kernel instance, device): set once for each.
template <typename Kernel>
int allow_dynamic_smem(Kernel kernel, int bytes, bool (&allowed)[64]) {
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err) return err;
  if (device >= 64 || !allowed[device]) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    if (device < 64) allowed[device] = true;
  }
  return 0;
}

}  // namespace mpo
