// Shared by csrc/coattn.cu (the fuse-K and plain-K forwards and the export
// passes) and csrc/coattn_bwd.cu (the backwards): the key-tile flag and list
// kernels that let them skip the 64-key tiles without a valid key and share
// the rest evenly over the blocks of the main pass, and the per-key dot
// products of a warp's 8 keys. The kernels are static: each source builds
// its own library with its own copy.
#pragma once

#include "flash_common.cuh"

namespace mpo {

// Column j (< width / 32) of lane `lane` in the register-tiled layouts:
// float4 groups, so a warp's 128-bit shared-memory accesses never conflict.
__device__ __forceinline__ int lane_col(int j, int lane) {
  return (j >> 2) * 128 + 4 * lane + (j & 3);
}

// Sums each of v[0..7] over the warp's 32 lanes (a transposing butterfly:
// 9 shuffles where eight warp_sums take 40). Returns, in every lane, the
// total of value sum8_index(lane).
__device__ __forceinline__ float sum8(float (&v)[8], int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = lane & 16;
    const float send = hi ? v[k] : v[k + 4];
    v[k] = (hi ? v[k + 4] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = lane & 8;
    const float send = hi ? v[k] : v[k + 2];
    v[k] = (hi ? v[k + 2] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi = lane & 4;
  float r = (hi ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[1], 4);
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  return r + __shfl_xor_sync(0xffffffffu, r, 1);
}

__device__ __forceinline__ int sum8_index(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// Whether a bag's mask row holds a valid key, for fk_tiles_kernel: 16 bytes
// a thread over the row's 16-byte-aligned body (one barrier step per 16 x
// blockDim.x keys: two at M = 8192, where flash_common.cuh's
// bag_has_valid_key takes 32 for a bag without a valid key) and one byte a
// thread over the fewer than 16 bytes before and after it: row b of a
// [B, M] mask starts at b * M bytes, aligned only where M % 16 == 0. (The
// flash kernels keep the byte-wise scan: with this one inlined the 8 x 16
// forward measured 5% slower, PERF.md.)
__device__ __forceinline__ bool fk_bag_has_valid_key(const uint8_t* __restrict__ mask_b, int L) {
  const int tid = threadIdx.x;
  const int head = min(L, (int)((16u - ((unsigned)(uintptr_t)mask_b & 15u)) & 15u));
  const int n16 = (L - head) / 16, tail = head + 16 * n16;
  bool f = (tid < head && mask_b[tid] != 0) || (tid < L - tail && mask_b[tail + tid] != 0);
  const uint4* body = reinterpret_cast<const uint4*>(mask_b + head);
  for (int base = 0;; base += blockDim.x) {
    if (base + tid < n16) {
      const uint4 x = body[base + tid];
      f = f || (x.x | x.y | x.z | x.w) != 0u;
    }
    if (__syncthreads_or(f)) return true;
    if (base + (int)blockDim.x >= n16) return false;
    f = false;
  }
}

// Pass 1 (blocks of FK_FLAG_TILES tiles of one bag): which 64-key tiles are
// computed. With a valid key in the bag, a tile without one is skipped (flag
// 0): its weights exp(NEG - m) underflow to exactly 0, so it adds nothing to
// o, l, ssq or sumw, and its ds is 0 by the mask, so nothing to dq, dwk or
// dbk; a bag without a valid key computes every tile, or with `lone` (the
// export passes, whose l = M, m = NEG and weights exp(NEG - m) / l there do
// not depend on k) is one unit of flag FK_LONE (tile 0) that reads no k.
// dkv != NULL (the backwards, rows of F floats): the skipped tiles' dkv rows
// are set to 0, and with dkv2 != NULL (the plain-K backward's dv beside its
// dk) those of dkv2.
// A block's FK_FLAG_TILES tiles are read in one round trip, four keys a
// thread: warp w's lanes 0..15 hold tile 2w, lanes 16..31 tile 2w + 1, and
// one ballot flags both (no barrier a tile).
constexpr int FK_FLAG_TILES = 16;
constexpr uint8_t FK_LONE = 2;

static __global__ void __launch_bounds__(THREADS)
fk_tiles_kernel(const uint8_t* __restrict__ mask, float* __restrict__ dkv,
                float* __restrict__ dkv2, uint8_t* __restrict__ flags, int M, int F,
                bool lone) {
  static_assert(FK_FLAG_TILES * FK_BM == 4 * THREADS && FK_BM == 64, "4 keys a thread");
  __shared__ uint8_t computed_s[FK_FLAG_TILES];
  const int b = blockIdx.x, n_tiles = (M + FK_BM - 1) / FK_BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * M;
  const bool skip = mask_b != nullptr && fk_bag_has_valid_key(mask_b, M);
  const int t0 = blockIdx.y * FK_FLAG_TILES, t1 = min(n_tiles, t0 + FK_FLAG_TILES);
  bool any = false;  // a valid key among this thread's four
  if (skip) {
    const int key0 = t0 * FK_BM + 4 * tid;
#pragma unroll
    for (int x = 0; x < 4; ++x) any = any || (key0 + x < M && mask_b[key0 + x] != 0);
  }
  const unsigned bal = __ballot_sync(0xffffffffu, any);
  if (lane < 2) {
    const int t = t0 + 2 * warp + lane;
    uint8_t f = skip ? (uint8_t)((bal >> (16 * lane)) & 0xffffu ? 1 : 0) : 1;
    if (lone && mask_b != nullptr && !skip) f = t == 0 ? FK_LONE : 0;
    if (t < t1) flags[(size_t)b * n_tiles + t] = f;
    computed_s[2 * warp + lane] = f;
  }
  if (dkv == nullptr) return;
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    if (computed_s[t - t0]) continue;
    const int r1 = min((t + 1) * FK_BM, M);
    const size_t row0 = ((size_t)b * M + (size_t)t * FK_BM) * F;
    float4* dst = reinterpret_cast<float4*>(dkv + row0);
    float4* dst2 = dkv2 == nullptr ? nullptr : reinterpret_cast<float4*>(dkv2 + row0);
    for (int i = tid; i < (r1 - t * FK_BM) * F / 4; i += blockDim.x) {
      dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dst2 != nullptr) dst2[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Pass 2 (one block): the computed units u = bag * n_tiles + tile in order
// into list, off[b] = the position of bag b's first unit, off[B] = their
// count T. Every bag has at least one computed tile (or its lone unit).
// Thread t takes a run of consecutive units: it counts its computed ones,
// one block-wide scan gives each run its first position, and the run is
// written in order.
static __global__ void __launch_bounds__(THREADS)
fk_list_kernel(const uint8_t* __restrict__ flags, int* __restrict__ list,
               int* __restrict__ off, int B, int n_tiles) {
  __shared__ int warp_tot[WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = B * n_tiles, per = (n + THREADS - 1) / THREADS;
  const int u0 = min(n, tid * per), u1 = min(n, u0 + per);
  int cnt = 0;
#pragma unroll 4
  for (int u = u0; u < u1; ++u) cnt += flags[u] != 0;
  int incl = cnt;  // inclusive scan of cnt over the warp, then over the warps
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int pos = incl - cnt, tot = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) pos += warp_tot[w];
    tot += warp_tot[w];
  }
  for (int u = u0; u < u1; ++u) {
    if (u % n_tiles == 0) off[u / n_tiles] = pos;
    if (flags[u] != 0) list[pos++] = u;
  }
  if (tid == 0) off[B] = tot;
}

// Blocks that walk the list split the T computed units evenly: block g of G
// takes positions [g * per, min(T, (g + 1) * per)). Such a block visits
// bags in rising order and writes a bag's partial at index g + b: unique per
// visited (block, bag) pair, as both rise along the list, so G + B partials
// hold them all; bag b's come from blocks off[b] / per .. (off[b + 1] - 1) /
// per.
__device__ __forceinline__ int units_per_block(const int* __restrict__ off, int B, int G) {
  return (off[B] + G - 1) / G;
}

// The flag and list passes on `st` (flags [B * n_tiles], list [B * n_tiles],
// off [B + 1]; dkv, dkv2 and lone as fk_tiles_kernel).
static inline void launch_tile_list(const uint8_t* mask, float* dkv, float* dkv2,
                                    uint8_t* flags, int* list, int* off, int B, int M, int F,
                                    cudaStream_t st, bool lone = false) {
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  fk_tiles_kernel<<<dim3(B, (n_tiles + FK_FLAG_TILES - 1) / FK_FLAG_TILES), THREADS, 0, st>>>(
      mask, dkv, dkv2, flags, M, F, lone);
  fk_list_kernel<<<1, THREADS, 0, st>>>(flags, list, off, B, n_tiles);
}

}  // namespace mpo
