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
// At N <= 8 csrc/coattn.cu's instances run. The kernels are plain_k_fwd.cuh's
// with SLABS: the queries in slabs of eight, one slab a block, on the same
// tile list; the design, its costs and what bounds it are csrc/coattn.cu's
// "Past eight queries" notes. A source of its own, so that nvcc builds
// these instances beside csrc/coattn.cu's, in parallel.
//
// Interface: plain C, called through ctypes. Every function returns
// cudaGetLastError() after its launches (0 = success); nothing allocates,
// everything runs on the caller's stream. The entry points are those of
// csrc/coattn.cu (names and arguments; the caller picks the library by N);
// the partial buffers are [max(1, max_blocks / S) + B, N, *], S = ceil(N / 8)
// query slabs.

#include "plain_k_fwd.cuh"

using namespace mpo;

extern "C" {

int mpo_coattn_plain_fwd(const float* q, const float* k, const float* v,
                         const uint8_t* mask, const int* seed, float* o, float* l, float* m,
                         float* ssq, float* sumw, float* o_part, float* ml_part,
                         float* sq_part, uint8_t* flags, int* list, int* off, int B, int N,
                         int M, int D, int pre_gate, int max_blocks, int train, float scale,
                         uint32_t thresh, float keep_scale, uint32_t bag0, void* stream) {
  return plain_fwd<float, true>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part, ml_part,
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
  return plain_fwd<__nv_bfloat16, true>(q, k, v, mask, seed, o, l, m, ssq, sumw, o_part,
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
