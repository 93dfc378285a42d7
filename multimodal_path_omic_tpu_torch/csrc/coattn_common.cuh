// Shared by csrc/coattn.cu (forward kernels) and csrc/coattn_bwd.cu
// (backward kernel): constants, warp reductions and the dropout bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mpo {

constexpr float NEG = -0.7f * 3.4e38f;  // finite mask value (coattn.py NEG)
constexpr int NMAX = 8;                  // queries a pass holds, one warp each (a slab)
constexpr int NQ_MAX = 256;              // queries the plain-K kernels take (plain_k_tiles.cuh)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FK_BM = 64;                // keys per fuse-K tile
constexpr int FK_BF = 16;                // depth per register-tiled GEMM step
constexpr int FK_RPW = FK_BM / WARPS;    // key rows owned by one warp
constexpr int MAX_PARTS = 1024;          // partials merged per bag

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Attention-dropout bits of element (bag b, query n, key index `key`; b and
// key are global indices: a mesh rank offsets its local ones):
// word 0 of Philox4x32-10 (Salmon et al., SC'11) at counter (key, n, b, 0)
// under key (seed, 0). Counter-based, so the bits depend only on the element,
// not on the tile or split that computes it: the backward regenerates the
// forward's mask exactly, and ops/coattn.py::dropout_bits computes the same
// words in torch integer ops. Keep iff bits >= threshold (uint32).
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t b, uint32_t n,
                                                 uint32_t key) {
  uint32_t c0 = key, c1 = n, c2 = b, c3 = 0u, k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

}  // namespace mpo
