// The plain-K forward with values and the export passes past eight queries
// for Hopper (sm_90a): 9 <= N <= 256 queries (NQ_MAX), float32 and bfloat16
// instances, D in {128, 256, 512}, with or without the pre-gate; the
// forward in its eval and training forms.
//
// Replaces the Pallas TPU kernels of multimodal_path_omic_tpu/ops/coattn.py
// at the JAX kernels' full query range (kernel_eligible takes up to 256
// queries: a grid step keeps the whole query block in VMEM):
//   * mpo_coattn_plain_fwd <- _coattn_fwd_impl with the plain K operand and
//       values (coattention);
//   * mpo_coattn_stats     <- _coattn_fwd_impl, statistics (export pass 1);
//   * mpo_coattn_weights   <- coattention_weights (export pass 2).
// At N <= 8 csrc/coattn.cu's instances run. A source of its own, so that
// nvcc builds these instances beside csrc/coattn.cu's, in parallel.
//
// The forward with values (plain_k_tiles.cuh tile_fwd_kernel). What bounds
// it on an H100: per key it reads k and v once (bytes: 0.11 ms at B = 32,
// M = 8192, D = 256 over the valid keys) and does 2 N D (3 N D with the
// pre-gate) multiply-adds, so past N ~ 16 it is bound by operations: at N =
// 256 the products are 2 x 3 B M N D = 103 GFLOP with the gate, 1.5 ms of
// float32 FMA, 0.6 ms as 3xTF32 at the tensor cores' 495 TFLOP/s. So every
// product runs on the tensor cores, in query tiles: block (g, y) takes
// query tile y (QT = 64 queries at D <= 256, 32 at D = 512; S = ceil(N /
// QT) tiles, one at N = 50, four at N = 256) over block g's share of the
// key-tile list (fused_k_common.cuh: tiles without a valid key skipped),
// grid (per_tile, S), per_tile = max(1, resident / S). Per sub-step of KS
// keys (8..32, what shared memory leaves beside the tile's q and tanh(q);
// k and v through a two-slot cp.async ring issued a sub-step ahead across
// tiles and bags): tanh(k) once per key and tile into a tile of its own; a
// = q k^T and g = tanh(q) tanh(k)^T as "row" products into partial tiles
// (warps over 16-query row groups, key columns, depth slices); the scores,
// the mask (NEG; keys >= M absent), an online softmax over R = 32 / KS rows
// a warp at once, a lane a key (the training form's Philox dropout at the
// element's counter, ssq and sumw), p over the scores; o = o alpha + p v as
// an "acc" product, o in registers (16 rows x D / WCA columns a warp). Four
// barriers a sub-step (tanh(k), scores, softmax, the next slot). Products:
// float32 3xTF32 mma.sync (1xTF32 misses the float32 l bar), each operand
// split in integer operations (the conversion instruction, twice an
// element, runs on a slower pipe) with fresh sums over 16 deep, eight warps
// a block whose score tiles are as wide as the partial tiles' shared memory
// allows (two 8-key column tiles a warp at D = 128; the split of an operand
// is paid once per warp that loads it); bfloat16 m16n8k16 on the raw
// bfloat16 tiles for the scores (fresh sums a 16-deep step), sixteen warps a
// block, and p v with p split in two TF32 parts against v widened, which
// TF32 holds exactly: float32 accuracy in p, never p rounded to bfloat16
// (the JAX kernel's float32 pd . v). Rows past N in the last tile are
// computed on zeros and never stored. Measured, the float32 instances are
// bound by issue and latency at one block of eight warps an SM (their
// shared memory), at 0.12-0.17 of the 3xTF32 bound.
// Partials [per_tile + B, N, *] at index block + bag, merged by
// combine_kernel in block order: no atomics, two runs give the same bits.
//
// The export passes are plain_k_fwd.cuh's kernels with SLABS: the queries in
// slabs of eight, one slab a block, on the same tile list (csrc/coattn.cu's
// "Past eight queries").
//
// Interface: plain C, called through ctypes. Every function returns
// cudaGetLastError() after its launches (0 = success); nothing allocates,
// everything runs on the caller's stream. The entry points are those of
// csrc/coattn.cu (names and arguments; the caller picks the library by N);
// the partial buffers are [max(1, max_blocks / S) + B, N, *]: S = ceil(N /
// QT) query tiles for the forward with values, ceil(N / 8) query slabs for
// the export passes.

#include "plain_k_tiles.cuh"

using namespace mpo;

namespace {

template <typename T>
int plain_tile_fwd(const T* q, const T* k, const T* v, const uint8_t* mask, const int* seed, T* o,
                   float* l, float* m, float* ssq, float* sumw, float* o_part, float* ml_part,
                   float* sq_part, uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
                   int pre_gate, int max_blocks, int train, float scale, uint32_t thresh,
                   float keep_scale, uint32_t bag0, void* stream) {
  if (!queries_taken<true>(N) || M < 1 || B < 1 || max_blocks < 1 || max_blocks > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPO_TILE(D_, PG_, TRAIN_)                                                              \
  if (D == D_ && (pre_gate != 0) == PG_ && (train != 0) == TRAIN_)                             \
    return launch_tile_fwd<D_, PG_, TRAIN_, T>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part, \
                                               ml_part, sq_part, flags, list, off, B, N, M,     \
                                               max_blocks, scale, thresh, keep_scale, bag0, st);
#define MPO_TILE_D(D_)                                                                         \
  MPO_TILE(D_, false, false) MPO_TILE(D_, true, false) MPO_TILE(D_, false, true)               \
  MPO_TILE(D_, true, true)
  MPO_TILE_D(256) MPO_TILE_D(128) MPO_TILE_D(512)
#undef MPO_TILE_D
#undef MPO_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int mpo_coattn_plain_fwd(const float* q, const float* k, const float* v,
                         const uint8_t* mask, const int* seed, float* o, float* l, float* m,
                         float* ssq, float* sumw, float* o_part, float* ml_part,
                         float* sq_part, uint8_t* flags, int* list, int* off, int B, int N,
                         int M, int D, int pre_gate, int max_blocks, int train, float scale,
                         uint32_t thresh, float keep_scale, uint32_t bag0, void* stream) {
  return plain_tile_fwd<float>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part, ml_part,
                                sq_part, flags, list, off, B, N, M, D, pre_gate, max_blocks,
                                train, scale, thresh, keep_scale, bag0, stream);
}

int mpo_coattn_plain_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const uint8_t* mask, const int* seed,
                              __nv_bfloat16* o, float* l, float* m, float* ssq, float* sumw,
                              float* o_part, float* ml_part, float* sq_part, uint8_t* flags,
                              int* list, int* off, int B, int N, int M, int D, int pre_gate,
                              int max_blocks, int train, float scale, uint32_t thresh,
                              float keep_scale, uint32_t bag0, void* stream) {
  return plain_tile_fwd<__nv_bfloat16>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part,
                                        ml_part, sq_part, flags, list, off, B, N, M, D,
                                        pre_gate, max_blocks, train, scale, thresh, keep_scale,
                                        bag0, stream);
}

int mpo_coattn_stats(const float* q, const float* k, const uint8_t* mask, float* l,
                     float* m, float* ml_part, uint8_t* flags, int* list, int* off, int B,
                     int N, int M, int D, int pre_gate, int max_blocks, float scale,
                     void* stream) {
  return export_stats<float, true>(q, k, mask, l, m, ml_part, flags, list, off, B, N, M, D,
                                   pre_gate, max_blocks, scale, stream);
}

int mpo_coattn_weights(const float* q, const float* k, const uint8_t* mask,
                       const float* l, const float* m, float* w, uint8_t* flags, int* list,
                       int* off, int B, int N, int M, int D, int pre_gate, int max_blocks,
                       int list_ready, float scale, void* stream) {
  return export_weights<float, true>(q, k, mask, l, m, w, flags, list, off, B, N, M, D,
                                     pre_gate, max_blocks, list_ready, scale, stream);
}

int mpo_coattn_stats_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const uint8_t* mask, float* l, float* m, float* ml_part,
                          uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
                          int pre_gate, int max_blocks, float scale, void* stream) {
  return export_stats<__nv_bfloat16, true>(q, k, mask, l, m, ml_part, flags, list, off, B, N, M,
                                           D, pre_gate, max_blocks, scale, stream);
}

int mpo_coattn_weights_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const uint8_t* mask, const float* l, const float* m, float* w,
                            uint8_t* flags, int* list, int* off, int B, int N, int M, int D,
                            int pre_gate, int max_blocks, int list_ready, float scale,
                            void* stream) {
  return export_weights<__nv_bfloat16, true>(q, k, mask, l, m, w, flags, list, off, B, N, M, D,
                                             pre_gate, max_blocks, list_ready, scale, stream);
}

}  // extern "C"
