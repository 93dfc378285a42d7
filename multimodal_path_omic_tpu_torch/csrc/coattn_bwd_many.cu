// Backward of the plain-K co-attention past eight queries for Hopper
// (sm_90a): dq, dk, dv at 9 <= N <= 256 queries (NQ_MAX), float32 and
// bfloat16 instances, D in {128, 256, 512}, with or without the pre-gate.
//
// Replaces the Pallas TPU kernel of multimodal_path_omic_tpu/ops/coattn.py:
//   * mpo_coattn_plain_bwd <- _coattn_bwd_impl with the plain K operand
//       (VJP glue _coattn_bwd) at the JAX kernels' full query range: the JAX
//       kernel keeps a grid step's whole query block in VMEM (kernel_eligible
//       takes up to 256 queries). At N <= 8 csrc/coattn_bwd.cu's kernel runs.
//
// The math is plain_k_bwd.cuh's (K3, plain-K form). What bounds it on an
// H100: it reads k and v and writes dk and dv once (1.07 GB at B = 32, M =
// 8192, D = 256: 0.27 ms over the valid keys) and does 5 N D multiply-adds
// a key (8 with the pre-gate: q.k, the gate, dO.v, dv, dq and dk with their
// gate terms), so past N ~ 16 it is bound by operations: at N = 256 the
// five products are 2 x 5 B M N D = 172 GFLOP over every key (275 with the
// gate; 2.6 ms of float32 FMA, 1.0 ms as 3xTF32). Every product runs on the
// tensor cores (plain_k_tiles.cuh: float32 3xTF32 mma.sync; bfloat16
// m16n8k16 on the raw bfloat16 tiles for q.k, the gate and dO.v, and the
// float32 da, du, pd against bfloat16 rows as two TF32 products, exact in
// the rows), and each product once: dq sums over keys and dk, dv over
// queries, and neither fits one block at N = 256 (dq of a bag at D = 512 is
// 512 KB), so two passes over the shared tile list, the first leaving the
// per-element terms the second needs:
//   * tile_dkv_kernel, key-tile major: the blocks resident at once, each an
//     even share of the listed tiles in row tiles of KR keys (64 at D = 128,
//     32 at 256, 16 at 512; k, v, tanh(k) held) against the bag's queries in
//     chunks of QC (16 or 32; q and dout through a two-slot cp.async ring,
//     tanh(q) and the bag's statistics staged once per row tile, not once
//     per 8-query slab at every 16-key sub-step): a = k q^T, g = tanh(k)
//     tanh(q)^T, dp = v dout^T into partial tiles; p, pd (the Philox bits
//     regenerated per element), ds, da, du per element; dv += pd dout, dk's
//     sums da q and du tanh(q) in registers, written once, in T; and da
//     (du) into a scratch [B, M, NP] float32, keys major, NP = S QT. The
//     next row tile's k and v and first chunk land during the last chunk's
//     sums.
//   * tile_dq_kernel, query-tile major, after it: block (g, y) takes query
//     tile y (QT = 64 at D <= 256, 32 at 512: its sums in registers) over
//     block g's share of the listed tiles, k and the scratch's da (du)
//     blocks in 32-key sub-steps through a cp.async ring, tanh(k) once per
//     key and tile: dq = sum da k / sqrt(D) + (1 - tanh(q)^2) sum du tanh(k),
//     two "acc" products and nothing scored again. A partial per (block,
//     bag), bwd_reduce_kernel sums them in block order.
// The scratch costs B M NP floats (twice with the pre-gate; 52 MB at N = 50
// and 268 MB at N = 256 for B = 32, M = 8192), written and read once.
// Float32 products split their operands with integer operations and keep
// fresh sums over 16 deep (plain_k_tiles.cuh); the kernels are bound by
// issue and latency at one block of eight warps an SM (their shared memory),
// not by bytes or the tensor cores. No atomics: two runs give the same bits.
// The flag pass writes dk = dv = 0 on the skipped tiles. Partials and
// scratch share dq_part: [max(1, max_blocks / S) + B, N, D], then the
// scratch; per_tile = max(1, resident / S), S = ceil(N / QT).

// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing; runs on the caller's stream.

#include "plain_k_tiles.cuh"

namespace {

using namespace mpo;

template <typename T>
int plain_bwd_many(const T* q, const T* k, const T* v, const uint8_t* mask, const int* seed,
                   const T* dout, const float* l, const float* m, const float* di,
                   const float* dssq, const float* dsumw, T* dq, T* dk, T* dv, float* dq_part,
                   uint8_t* flags, int* list, int* off, int B, int N, int M, int D, int pre_gate,
                   int max_blocks, float scale, uint32_t thresh, float keep_scale, uint32_t bag0,
                   void* stream) {
  if (N <= NMAX || N > NQ_MAX || M < 1 || B < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPO_PLAIN_BWD(D_, PG_)                                                                 \
  if (D == D_ && (pre_gate != 0) == PG_)                                                       \
    return launch_tile_bwd<D_, PG_, T>(q, k, v, mask, seed, dout, l, m, di, dssq, dsumw, dq,   \
                                       dk, dv, dq_part, flags, list, off, B, N, M, max_blocks, \
                                       scale, thresh, keep_scale, bag0, st);
  MPO_PLAIN_BWD(256, true) MPO_PLAIN_BWD(256, false) MPO_PLAIN_BWD(128, true)
  MPO_PLAIN_BWD(128, false) MPO_PLAIN_BWD(512, true) MPO_PLAIN_BWD(512, false)
#undef MPO_PLAIN_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// As mpo_coattn_plain_bwd (csrc/coattn_bwd.cu), at 9 <= N <= 256 queries.
// Scratch: dq_part [max(1, max_blocks / S) + B, N, D] float32, then [B, M,
// S QT] (twice with the pre-gate), S = ceil(N / QT), QT the dq pass's query
// tile (above).
int mpo_coattn_plain_bwd(const float* q, const float* k, const float* v,
                         const uint8_t* mask, const int* seed, const float* dout,
                         const float* l, const float* m, const float* di, const float* dssq,
                         const float* dsumw, float* dq, float* dk, float* dv, float* dq_part,
                         uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
                         int pre_gate, int max_blocks, float scale, uint32_t thresh,
                         float keep_scale, uint32_t bag0, void* stream) {
  return plain_bwd_many<float>(q, k, v, mask, seed, dout, l, m, di, dssq, dsumw, dq, dk, dv,
                               dq_part, flags, list, off, B, N, M, D, pre_gate, max_blocks, scale,
                               thresh, keep_scale, bag0, stream);
}

// The bfloat16 instances: q, k, v, dout, dq, dk and dv bfloat16, everything
// else as above.
int mpo_coattn_plain_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const uint8_t* mask, const int* seed,
                              const __nv_bfloat16* dout, const float* l, const float* m,
                              const float* di, const float* dssq, const float* dsumw,
                              __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                              float* dq_part, uint8_t* flags, int* list, int* off, int B,
                              int N, int M, int D, int pre_gate, int max_blocks, float scale,
                              uint32_t thresh, float keep_scale, uint32_t bag0,
                              void* stream) {
  return plain_bwd_many<__nv_bfloat16>(q, k, v, mask, seed, dout, l, m, di, dssq, dsumw, dq, dk,
                                       dv, dq_part, flags, list, off, B, N, M, D, pre_gate,
                                       max_blocks, scale, thresh, keep_scale, bag0, stream);
}

}  // extern "C"
