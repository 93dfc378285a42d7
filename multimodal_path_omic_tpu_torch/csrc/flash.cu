// Masked flash self-attention forward for Hopper (sm_90a), float32.
//
// Replaces multimodal_path_omic_tpu/ops/flash.py::flash_attention (the JAX
// package hands GE-NaCAGaT's M x M self-attention to JAX's library Pallas TPU
// kernel): for every (bag b, head h) over L positions
//   s[i, j] = (q[i] . k[j]) * scale,  s[i, j] = -1e9 where key j is masked
//   out[i]  = softmax_j(s[i, :]) v
// with the L x L scores never in device memory. Key-mask semantics, as the
// port's masked_softmax (ops/layers.py): the fill value is the finite -1e9,
// every query row is computed (pad rows too: they attend to the valid keys),
// and a bag with no valid key gives the uniform mean of v over its L keys.
// Keys at index >= L do not exist (weight exactly 0).
//
// What bounds it on an H100, and what the design does about it: 4*B*H*L^2*dh
// float32 operations (2.2 TFLOP at B=8, L=16384, H*dh=256: 32.8 ms at
// 67 TFLOP/s) against 0.5 GB of q, k, v, out, so it is bound by operations,
// and both products must stay float32 FMAs (no TF32: the port is held to
// float32 parity). One block = (bag, head, tile of BQ queries), 8 warps; warp
// w owns RPW = BQ/8 query rows across all keys of a key tile, so the online
// softmax (m, l per row) is warp-local: shuffles, no block barrier. Per key
// tile of BK keys:
//   * S = Q K^T as a register-tiled SIMT GEMM: a thread holds RPW rows x
//     BK/32 keys (keys lane, lane+32, ...); Q (pre-scaled) sits transposed in
//     shared memory for the whole block, so a warp's rows at one depth are
//     broadcast float4 reads; K streams through shared memory in depth chunks.
//   * mask, online softmax, P written transposed to shared memory.
//   * O += P V with O in registers (RPW rows x dh/32 columns a thread), V
//     streaming through the same shared buffer in key chunks.
// K and V chunks are straight float4 copies (no transposition), prefetched
// into registers one chunk ahead across the phase boundaries, so global
// latency hides behind the math. Two instances for the two GE shapes: dh=256
// (one head; 64 queries x 128 keys, O = 64 registers a thread) and dh=32
// (eight heads; 128 x 128). q, k, v are taken with their strides, so the
// packed [B, L, 3E] in-projection is read in place; out is written as
// [B, L, H, dh], so merging the heads is free.
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launch (0 = success); allocates nothing, runs on the caller's stream.

#include "flash_common.cuh"

namespace {

using namespace mpo;

template <int DH, int BQ, int BK, int KC, int VC>
struct FlashCfg {
  static constexpr int RPW = BQ / WARPS;               // query rows per warp
  static constexpr int KPL = BK / 32;                  // keys per lane
  static constexpr int CPL = DH / 32;                  // output columns per lane
  static constexpr int QS = BQ + 4;                    // row stride of qt_s and pt_s
  static constexpr int KS = KC + 4;                    // row stride of a K chunk
  static constexpr int K_V4 = BK * KC / 4 / THREADS;   // K float4s per thread per chunk
  static constexpr int V_V4 = VC * DH / 4 / THREADS;   // V float4s per thread per chunk
  static constexpr int KV_FLOATS = BK * KS > VC * DH ? BK * KS : VC * DH;
  static constexpr int SMEM_BYTES = 4 * (DH * QS + BK * QS + KV_FLOATS);
  static_assert(RPW % 4 == 0 && KPL >= 1 && (CPL == 1 || CPL % 4 == 0), "tile shape");
  static_assert(KC % 4 == 0 && DH % KC == 0 && BK % VC == 0, "chunk shape");
  static_assert(K_V4 * THREADS * 4 == BK * KC && V_V4 * THREADS * 4 == VC * DH, "chunk copy");
};

// q, k, v: element (b, h, i, d) at base + b*sb + h*sh + i*sl + d (strides in
// floats, multiples of 4; bases 16-byte aligned). mask [B, L] bool or NULL.
// out [B, L, H, DH] contiguous. m_out, l_out [B, H, L] (each row's running
// maximum and the sum of exp(s - m) over its keys, what the backward
// recomputes p from) or both NULL.
template <int DH, int BQ, int BK, int KC, int VC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int L, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                 long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                 float scale) {
  using C = FlashCfg<DH, BQ, BK, KC, VC>;
  constexpr int RPW = C::RPW, KPL = C::KPL, CPL = C::CPL, QS = C::QS, KS = C::KS;
  constexpr int NKC = DH / KC, NVC = BK / VC;
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;              // [DH][QS]: q * scale, transposed
  float* pt_s = qt_s + DH * QS;    // [BK][QS]: p of the key tile, transposed
  float* kv_s = pt_s + BK * QS;    // a K chunk [BK][KS] or a V chunk [VC][DH]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const float* q_b = q + (long long)b * q_sb + (long long)h * q_sh;
  const float* k_b = k + (long long)b * k_sb + (long long)h * k_sh;
  const float* v_b = v + (long long)b * v_sb + (long long)h * v_sh;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;

  float4 kreg[C::K_V4], vreg[C::V_V4];
  load_k<BK, KC>(kreg, k_b, k_sl, 0, 0, L);

  // the block's queries, scaled, transposed (zero rows past L)
  for (int idx = tid; idx < BQ * DH / 4; idx += THREADS) {
    const int row = idx / (DH / 4), c = idx % (DH / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < L)
      x = *reinterpret_cast<const float4*>(q_b + (long long)(q0 + row) * q_sl + 4 * c);
    qt_s[(4 * c + 0) * QS + row] = x.x * scale;
    qt_s[(4 * c + 1) * QS + row] = x.y * scale;
    qt_s[(4 * c + 2) * QS + row] = x.z * scale;
    qt_s[(4 * c + 3) * QS + row] = x.w * scale;
  }

  float m_run[RPW], l_run[RPW], o[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -3.0e38f;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) o[i][j] = 0.f;
  }

  const int n_tiles = (L + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;

    // ---- S = (q * scale) K^T over the depth chunks ----
    float s[RPW][KPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int tt = 0; tt < KPL; ++tt) s[i][tt] = 0.f;
#pragma unroll 1
    for (int c = 0; c < NKC; ++c) {
      store_k<KC, KS>(kreg, kv_s);
      __syncthreads();  // also orders qt_s (first pass) before its reads
      if (c + 1 < NKC) load_k<BK, KC>(kreg, k_b, k_sl, k0, (c + 1) * KC, L);
      else load_v<DH>(vreg, v_b, v_sl, k0, L);
      dot_chunk<RPW, KPL, KC, KS, QS>(s, qt_s + c * KC * QS, kv_s, warp, lane);
      __syncthreads();  // kv_s is rewritten by the next chunk
    }

    // ---- key mask, online softmax (warp-local), P -> pt_s ----
    bool exists[KPL], valid[KPL];
#pragma unroll
    for (int tt = 0; tt < KPL; ++tt) {
      const int key = k0 + lane + 32 * tt;
      exists[tt] = key < L;
      valid[tt] = exists[tt] && (mask_b == nullptr || mask_b[key] != 0);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int tt = 0; tt < KPL; ++tt) {
        // a key past L does not exist: weight exactly 0
        const float x = exists[tt] ? (valid[tt] ? s[i][tt] : MASK_NEG) : -INFINITY;
        s[i][tt] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], warp_max(mx));  // finite: key k0 exists
      const float alpha = expf(m_run[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int tt = 0; tt < KPL; ++tt) {
        const float p = expf(s[i][tt] - m_new);
        s[i][tt] = p;
        ps += p;
      }
      l_run[i] = l_run[i] * alpha + warp_sum(ps);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPL; ++j) o[i][j] *= alpha;
    }
    store_transposed<RPW, KPL, QS>(s, pt_s, warp, lane);
    // a warp reads back only the rows it wrote: the barrier below orders it

    // ---- O += P V over the key chunks ----
#pragma unroll 1
    for (int c = 0; c < NVC; ++c) {
      store_v<DH>(vreg, kv_s);
      __syncthreads();
      if (c + 1 < NVC) load_v<DH>(vreg, v_b, v_sl, k0 + (c + 1) * VC, L);
      else if (t + 1 < n_tiles) load_k<BK, KC>(kreg, k_b, k_sl, k0 + BK, 0, L);
      acc_chunk<RPW, CPL, VC, DH, QS>(o, pt_s + c * VC * QS, kv_s, warp, lane);
      __syncthreads();  // kv_s (and, after the last chunk, pt_s) is rewritten next
    }
  }

  // ---- out[b, row, h, :] = o / l; m and l [B, H, L] where asked for ----
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp * RPW + i;
    if (row < L) {
      const float inv = l_run[i] == 0.f ? 1.f : 1.f / l_run[i];
      store_row<CPL>(o[i], inv, out + (((size_t)b * L + row) * H + h) * DH, lane);
      if (m_out != nullptr && lane == 0) {  // the backward's softmax statistics
        m_out[((size_t)b * H + h) * L + row] = m_run[i];
        l_out[((size_t)b * H + h) * L + row] = l_run[i];
      }
    }
  }
}

template <int DH, int BQ, int BK, int KC, int VC>
int launch_flash(const float* q, const float* k, const float* v, const uint8_t* mask,
                 float* out, float* m_out, float* l_out, int B, int H, int L,
                 const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem = FlashCfg<DH, BQ, BK, KC, VC>::SMEM_BYTES;
  static bool smem_allowed[64] = {};
  const int err = allow_dynamic_smem(flash_fwd_kernel<DH, BQ, BK, KC, VC>, smem, smem_allowed);
  if (err) return err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<DH, BQ, BK, KC, VC><<<grid, THREADS, smem, stream>>>(
      q, k, v, mask, out, m_out, l_out, H, L, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: [B, H, L, DH] views with unit stride on DH; strides (batch, head,
// position) in floats, each a multiple of 4, bases 16-byte aligned. mask
// [B, L] bool or NULL. Out: [B, L, H, DH] contiguous; m_out and l_out [B, H, L]
// contiguous, or both NULL. DH in {256, 32}; B * H <= 65535.
int mpo_flash_fwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                  float* out, float* m_out, float* l_out, int B, int H, int L, int DH,
                  long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                  long long k_sl, long long v_sb, long long v_sh, long long v_sl, float scale,
                  void* stream) {
  if (B < 1 || H < 1 || L < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl};
  for (int i = 0; i < 9; ++i)
    if (st[i] % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (DH == 256)
    return launch_flash<256, 64, 128, 16, 16>(q, k, v, mask, out, m_out, l_out, B, H, L, st, scale,
                                              stream_);
  if (DH == 32)
    return launch_flash<32, 128, 128, 32, 128>(q, k, v, mask, out, m_out, l_out, B, H, L, st,
                                               scale, stream_);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
