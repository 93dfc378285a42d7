// Shared by csrc/coattn.cu (the plain-K forward with values and the export
// passes) and csrc/coattn_bwd.cu (the backward): the key stream the kernels
// with values walk and the per-key dot products all of them start from.
//
// The kernels with values walk the computed 64-key tiles of
// fused_k_common.cuh's list (a block an even share, across bags) in
// sub-steps of PK_KEYS keys. A sub-step's k rows and v rows come through a
// ring of shared-memory slots by cp.async, issued NSLOT - 1 sub-steps ahead
// in the block's own order (across tile and bag boundaries), so the next
// tiles' rows land while this one is worked on. Warp w scores keys 2w and
// 2w + 1 of a sub-step: each lane takes the dot products of its columns
// (float4 groups c * 128 + 4 * lane) against every query, and one
// transposing butterfly sums all of a warp's (query, key) products at once
// (31 shuffles for 32 values, where 32 warp_sums take 160).
#pragma once

#include "fused_k_common.cuh"

namespace mpo {

constexpr int PK_KEYS = 16;               // keys a sub-step
constexpr int PK_KPW = PK_KEYS / WARPS;   // keys a warp scores
static_assert(PK_KPW == 2, "the value layouts below hold two keys a warp");

// Sub-steps of tile t of a bag of M keys (the last tile may be short).
__device__ __forceinline__ int pk_subs(int t, int M) {
  return (min(FK_BM, M - t * FK_BM) + PK_KEYS - 1) / PK_KEYS;
}

// The next sub-step a block issues: list position i, sub-step j of its tile.
struct PkCursor {
  int i, j;
};

// Sub-step c of the block's sequence into `slot` ([PK_KEYS][D] k rows, then
// [PK_KEYS][D] v rows), asynchronously; zero rows past M. Advances c; past
// the block's share (i >= i1) issues nothing.
template <int D>
__device__ __forceinline__ void pk_issue(float* __restrict__ slot, const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const int* __restrict__ list, int n_tiles, int M,
                                         int i1, PkCursor& c) {
  if (c.i >= i1) return;
  const int u = list[c.i], b = u / n_tiles, t = u % n_tiles;
  const int r0 = t * FK_BM + c.j * PK_KEYS;
  load_tile_async<PK_KEYS, D, D>(slot, k + (size_t)b * M * D, D, r0, M);
  load_tile_async<PK_KEYS, D, D>(slot + PK_KEYS * D, v + (size_t)b * M * D, D, r0, M);
  if (++c.j == pk_subs(t, M)) {
    c.j = 0;
    ++c.i;
  }
}

// One level of sum_transpose: lanes that differ in bit OFF swap halves of
// v[0..2H-1] and add, so v[x] (x < H) then holds value x + H (lane & OFF ?
// 1 : 0) summed over both. Template recursion, so that every index is a
// constant (v stays in registers).
template <int H, int OFF, int NV>
__device__ __forceinline__ void sum_fold(float (&v)[NV], int lane) {
  if constexpr (H >= 1) {
    const bool hi = lane & OFF;
#pragma unroll
    for (int x = 0; x < H; ++x) {
      const float send = hi ? v[x] : v[x + H];
      v[x] = (hi ? v[x + H] : v[x]) + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    sum_fold<H / 2, OFF / 2, NV>(v, lane);
  }
}

// Sums each of v[0..NV-1] (NV = 2, 4, .., 32) over the warp's 32 lanes by a
// transposing butterfly (NV - 1 + log2(32 / NV) shuffles). Returns, in lane
// l, the total of value l / (32 / NV).
template <int NV>
__device__ __forceinline__ float sum_transpose(float (&v)[NV], int lane) {
  static_assert(NV >= 2 && NV <= 32 && (NV & (NV - 1)) == 0, "a power of two up to 32");
  sum_fold<NV / 2, 16, NV>(v, lane);
  float r = v[0];
#pragma unroll
  for (int off = 16 / NV; off >= 1; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

// The value layouts of pk_key_sums: value (n * 2 + r) * 2 + t of the
// 32-value sums, value n * 2 + r of the 16-value ones (query n, the warp's
// key r). After sum_transpose lane l holds query l / 4, key (l / 2) % 2; its
// first member (t = 0) in the even lane.
__device__ __forceinline__ int pk_query(int lane) { return lane >> 2; }
__device__ __forceinline__ int pk_key(int lane) { return (lane >> 1) & 1; }

// The sums of the warp's two keys (sub-step rows 2 warp and 2 warp + 1 of
// the slot) against all NMAX queries (queries past N hold zeros), summed
// over the warp: a = q.k, and the second value of the pair: u = tanh(q).
// tanh(k) with PG, else dp = dO.v with DP (else none: 16 values). With PG and
// DP, dp comes back in `dp` (16 values). tk_s != NULL: the keys' tanh(k)
// rows are stored there ([PK_KEYS][D]). Returns, in the even lanes, a, and
// sets `second` to the pair's second value (every lane calls it).
template <int D, bool PG, bool DP>
__device__ __forceinline__ float pk_key_sums(const float* __restrict__ slot,
                                             const float (*__restrict__ q)[D],
                                             const float (*__restrict__ tq)[D],
                                             const float (*__restrict__ dout)[D],
                                             float* __restrict__ tk_s, int N, int warp,
                                             int lane, float& second, float& dp) {
  constexpr int DV = D / 128;
  constexpr bool PAIR = PG || DP;
  constexpr int NA = PAIR ? 32 : 16;
  float4 kx[PK_KPW][DV], tk[PK_KPW][DV], vx[PK_KPW][DV];
#pragma unroll
  for (int r = 0; r < PK_KPW; ++r) {
    const int row = warp * PK_KPW + r;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      const int col = c * 128 + 4 * lane;
      kx[r][c] = *reinterpret_cast<const float4*>(slot + row * D + col);
      if constexpr (DP) vx[r][c] = *reinterpret_cast<const float4*>(slot + (PK_KEYS + row) * D + col);
      if constexpr (PG) {
        tk[r][c] = make_float4(tanhf(kx[r][c].x), tanhf(kx[r][c].y), tanhf(kx[r][c].z),
                               tanhf(kx[r][c].w));
        if (tk_s != nullptr) *reinterpret_cast<float4*>(tk_s + row * D + col) = tk[r][c];
      }
    }
  }
  float va[NA], vd[16];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    float a[PK_KPW] = {}, u[PK_KPW] = {}, d[PK_KPW] = {};
    if (n < N) {
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        const int col = c * 128 + 4 * lane;
        const float4 qv = *reinterpret_cast<const float4*>(&q[n][col]);
        float4 tv, ov;
        if constexpr (PG) tv = *reinterpret_cast<const float4*>(&tq[n][col]);
        if constexpr (DP) ov = *reinterpret_cast<const float4*>(&dout[n][col]);
#pragma unroll
        for (int r = 0; r < PK_KPW; ++r) {
          const float4 kk = kx[r][c];
          a[r] = fmaf(qv.x, kk.x, fmaf(qv.y, kk.y, fmaf(qv.z, kk.z, fmaf(qv.w, kk.w, a[r]))));
          if constexpr (PG) {
            const float4 t = tk[r][c];
            u[r] = fmaf(tv.x, t.x, fmaf(tv.y, t.y, fmaf(tv.z, t.z, fmaf(tv.w, t.w, u[r]))));
          }
          if constexpr (DP) {
            const float4 x = vx[r][c];
            d[r] = fmaf(ov.x, x.x, fmaf(ov.y, x.y, fmaf(ov.z, x.z, fmaf(ov.w, x.w, d[r]))));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < PK_KPW; ++r) {
      const int i = n * PK_KPW + r;
      if constexpr (PAIR) {
        va[2 * i] = a[r];
        va[2 * i + 1] = PG ? u[r] : d[r];
      } else {
        va[i] = a[r];
      }
      vd[i] = d[r];
    }
  }
  const float tot = sum_transpose<NA>(va, lane);
  second = PAIR ? __shfl_down_sync(0xffffffffu, tot, 1) : 0.f;
  dp = 0.f;
  if constexpr (PG && DP) dp = sum_transpose<16>(vd, lane);
  return tot;
}

// The score of a (query, key) pair from pk_key_sums' a = q.k and, with the
// pre-gate, its second value g = tanh(q).tanh(k), as the forwards compute
// it: one expression, so that the export's weights pass reproduces its stats
// pass's scores bit for bit (the largest weight is exp(0) of pass 1's m).
template <bool PG>
__device__ __forceinline__ float pk_score(float a, float g, float scale) {
  const float s = a * scale;
  return PG ? s * (g + 1.f) * 0.5f : s;
}

// The main pass's grid: the blocks of `kernel` (THREADS threads, `smem`
// bytes of dynamic shared memory) resident at once on this device, at most
// max_blocks; found once per (instance, device).
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem, int max_blocks, int (&cache)[64], int* blocks) {
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err) return err;
  int n = device < 64 ? cache[device] : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err) return err;
    n = sms * (per_sm > 0 ? per_sm : 1);
    if (device < 64) cache[device] = n;
  }
  *blocks = n < max_blocks ? n : max_blocks;
  return 0;
}

}  // namespace mpo
