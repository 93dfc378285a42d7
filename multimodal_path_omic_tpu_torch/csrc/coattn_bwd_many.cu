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
// The math is plain_k_bwd.cuh's (K3, plain-K form). What changes past eight
// queries: the score layout of pk_key_sums holds NMAX = 8 queries a warp, and
// dq's sums over keys are NMAX values a thread in registers, so the queries
// go in slabs of eight. dq and dk / dv then want opposite loop orders: dq is
// a sum over keys for each query (query-major), dk and dv sums over queries
// for each key (key-major), and neither sum fits one block at N = 256 (dq of
// a bag at D = 512 is 512 KB). So two main passes over the shared tile list:
//   * the dq pass, plain_bwd_kernel<.., KV = false>: block (g, y) takes
//     query slab y over block g's share of the listed tiles (per_slab =
//     max(1, resident / S) blocks a slab, S = ceil(N / 8) slabs; the slabs
//     of one share run at once, so the k and v tiles each slab re-reads come
//     from L2), carries the slab's dq sums in registers and writes a partial
//     per (block, bag); bwd_reduce_kernel sums them in block order;
//   * the dk / dv pass, plain_bwd_kv_kernel: key-tile major, the blocks
//     resident at once over the listed tiles; per 16-key sub-step every slab
//     in turn (its q, tanh(q), dout and statistics from L2 into shared
//     memory), the slab terms added in registers, dk and dv written once.
// Costs: each pass scores every (query, key) pair (the scores twice, 3 N D
// FMAs a key a pass); the dq pass reads k and v S times (from L2 where the
// slabs keep pace); the dk / dv pass reads q and dout S times a 16-key
// sub-step (3 N D floats, from L2); tanh(k) is taken S times in the dq pass
// and tanh(q) once a slab and sub-step in the dk / dv pass. Past N ~ 16 the
// function is bound by operations, not bytes: at B = 32, M = 8192, D = 256
// and N = 256 the products are 3 x 2 B M N D = 103 GFLOP against 1.07 GB.
// Partials: dq_part [per_slab + B, N, D] float32 (at N = 256, D = 512 and
// per_slab 4: 36 x 256 x 512 x 4 bytes = 18.9 MB).
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing; runs on the caller's stream.

#include <type_traits>

#include "plain_k_bwd.cuh"

namespace {

using namespace mpo;

template <int D, bool PG, typename T>
int launch_plain_bwd_many(const T* q, const T* k, const T* v, const uint8_t* mask,
                          const int* seed, const T* dout, const float* l, const float* m,
                          const float* di, const float* dssq, const float* dsumw, T* dq, T* dk,
                          T* dv, float* dq_part, uint8_t* flags, int* list, int* off, int B,
                          int N, int M, int max_blocks, float scale, uint32_t thresh,
                          float keep_scale, uint32_t bag0, cudaStream_t st) {
  static bool allowed_dq[64] = {}, allowed_kv[64] = {};
  static int resident_dq[64] = {}, resident_kv[64] = {};
  constexpr int smem = (int)sizeof(PkBwdSmem<D, T>);
  static_assert(smem <= 232448, "shared memory of one block");
  int err = allow_dynamic_smem(plain_bwd_kernel<D, PG, T, false>, smem, allowed_dq);
  if (err) return err;
  err = allow_dynamic_smem(plain_bwd_kv_kernel<D, PG, T>, smem, allowed_kv);
  if (err) return err;
  int dq_blocks = 0, kv_blocks = 0;
  err = resident_blocks(plain_bwd_kernel<D, PG, T, false>, smem, max_blocks, resident_dq,
                        &dq_blocks);
  if (err) return err;
  err = resident_blocks(plain_bwd_kv_kernel<D, PG, T>, smem, max_blocks, resident_kv, &kv_blocks);
  if (err) return err;
  const int slabs = (N + NMAX - 1) / NMAX, per_slab = max(1, dq_blocks / slabs);
  launch_tile_list(mask, dk, dv, flags, list, off, B, M, D, st, false, (int)sizeof(T));
  plain_bwd_kernel<D, PG, T, false><<<dim3(per_slab, slabs), THREADS, smem, st>>>(
      q, k, v, mask, list, off, seed, thresh, keep_scale, bag0, dout, l, m, di, dssq, dsumw,
      nullptr, nullptr, dq_part, B, N, M, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  plain_bwd_kv_kernel<D, PG, T><<<kv_blocks, THREADS, smem, st>>>(
      q, k, v, mask, list, off, seed, thresh, keep_scale, bag0, dout, l, m, di, dssq, dsumw, dk,
      dv, B, N, M, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)B * N * D;
  bwd_reduce_kernel<T><<<(int)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      dq_part, nullptr, nullptr, off, dq, nullptr, nullptr, B, per_slab, 0, N, D, 0);
  return (int)cudaGetLastError();
}

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
    return launch_plain_bwd_many<D_, PG_, T>(q, k, v, mask, seed, dout, l, m, di, dssq, dsumw, \
                                             dq, dk, dv, dq_part, flags, list, off, B, N, M,   \
                                             max_blocks, scale, thresh, keep_scale, bag0, st);
  MPO_PLAIN_BWD(256, true) MPO_PLAIN_BWD(256, false) MPO_PLAIN_BWD(128, true)
  MPO_PLAIN_BWD(128, false) MPO_PLAIN_BWD(512, true) MPO_PLAIN_BWD(512, false)
#undef MPO_PLAIN_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// As mpo_coattn_plain_bwd (csrc/coattn_bwd.cu), at 9 <= N <= 256 queries.
// Scratch: dq_part [max(1, max_blocks / S) + B, N, D], S = ceil(N / 8).
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
