// Shared by csrc/coattn.cu (the fuse-K and plain-K forwards) and
// csrc/coattn_bwd.cu (their backwards): the key-tile flag and list kernels
// that let them skip the 64-key tiles without a valid key and share the rest
// evenly over the blocks of the main pass, and the per-key dot products of a
// warp's 8 keys. The kernels
// are static: each source builds its own library with its own copy.
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

// Pass 1 (blocks of FK_FLAG_TILES tiles of one bag): which 64-key tiles are
// computed. With a valid key in the bag, a tile without one is skipped (flag
// 0): its weights exp(NEG - m) underflow to exactly 0, so it adds nothing to
// o, l, ssq or sumw, and its ds is 0 by the mask, so nothing to dq, dwk or
// dbk; a bag without a valid key computes every tile. dkv != NULL (the
// backwards, rows of F floats): the skipped tiles' dkv rows are set to 0, and
// with dkv2 != NULL (the plain-K backward's dv beside its dk) those of dkv2.
constexpr int FK_FLAG_TILES = 16;

static __global__ void __launch_bounds__(THREADS)
fk_tiles_kernel(const uint8_t* __restrict__ mask, float* __restrict__ dkv,
                float* __restrict__ dkv2, uint8_t* __restrict__ flags, int M, int F) {
  const int b = blockIdx.x, n_tiles = (M + FK_BM - 1) / FK_BM;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * M;
  const bool skip = mask_b != nullptr && bag_has_valid_key(mask_b, M);
  const int t1 = min(n_tiles, ((int)blockIdx.y + 1) * FK_FLAG_TILES);
  for (int t = blockIdx.y * FK_FLAG_TILES; t < t1; ++t) {
    const bool computed = next_tile<FK_BM>(mask_b, t, t + 1, M, skip) == t;
    if (threadIdx.x == 0) flags[(size_t)b * n_tiles + t] = computed;
    if (computed || dkv == nullptr) continue;
    const int r1 = min((t + 1) * FK_BM, M);
    const size_t row0 = ((size_t)b * M + (size_t)t * FK_BM) * F;
    float4* dst = reinterpret_cast<float4*>(dkv + row0);
    float4* dst2 = dkv2 == nullptr ? nullptr : reinterpret_cast<float4*>(dkv2 + row0);
    for (int i = threadIdx.x; i < (r1 - t * FK_BM) * F / 4; i += blockDim.x) {
      dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dst2 != nullptr) dst2[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Pass 2 (one block): the computed units u = bag * n_tiles + tile in order
// into list, off[b] = the position of bag b's first unit, off[B] = their
// count T. Every bag has at least one computed tile.
static __global__ void __launch_bounds__(THREADS)
fk_list_kernel(const uint8_t* __restrict__ flags, int* __restrict__ list,
               int* __restrict__ off, int B, int n_tiles) {
  __shared__ int warp_tot[WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = B * n_tiles;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += THREADS) {
    const int u = c0 + tid;
    const bool f = u < n && flags[u] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int pos = base + __popc(bal & ((1u << lane) - 1u)), tot = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) pos += warp_tot[w];
      tot += warp_tot[w];
    }
    if (f) list[pos] = u;
    if (u < n && u % n_tiles == 0) off[u / n_tiles] = pos;
    __syncthreads();  // warp_tot is rewritten by the next chunk
    base += tot;
  }
  if (tid == 0) off[B] = base;
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
// off [B + 1]; dkv, dkv2 as fk_tiles_kernel).
static inline void launch_tile_list(const uint8_t* mask, float* dkv, float* dkv2,
                                    uint8_t* flags, int* list, int* off, int B, int M, int F,
                                    cudaStream_t st) {
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  fk_tiles_kernel<<<dim3(B, (n_tiles + FK_FLAG_TILES - 1) / FK_FLAG_TILES), THREADS, 0, st>>>(
      mask, dkv, dkv2, flags, M, F);
  fk_list_kernel<<<1, THREADS, 0, st>>>(flags, list, off, B, n_tiles);
}

}  // namespace mpo
