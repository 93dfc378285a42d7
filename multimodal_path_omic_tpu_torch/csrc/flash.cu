// Masked flash self-attention forward for Hopper (sm_90a), float32 and
// bfloat16 instances.
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
// operations (2.2 TFLOP at B=8, L=16384, H*dh=256) against 0.5 GB of q, k,
// v, out, so it is bound by operations. Both products run on the tensor cores
// as 3xTF32 mma.sync (flash_common.cuh: float32 accuracy, three TF32
// products each, 495/3 = 165 TFLOP/s at best instead of float32 FMAs' 67).
// mma.sync, not wgmma: its fragments sit in registers, so P V needs no
// K-major transposed copy of P or V in shared memory (wgmma's rule for TF32
// operands). One block = (bag, head, tile of BR queries), 8 warps; per key
// tile of BC keys:
//   * S = (q * scale) K^T: warp w takes 16 query rows and a column group (and,
//     at width 512, a depth half), writes its scores to shared memory;
//   * the online softmax, one warp a row (m, l and the rescale factor of each
//     row in shared memory), P written over the scores;
//   * O = O * alpha + P V with O in registers: 16 rows x dh / (8 / (BR / 16))
//     columns a warp.
// Key tiles without a valid key are skipped when the bag has one (their
// weights are exactly 0). K and V tiles come in by cp.async, read in place
// with their strides from the packed [B, L, 3E] in-projection: V of a tile
// lands while its scores are computed, the next valid K tile while P V runs.
// out is written as [B, L, H, dh], so merging the heads is free. Instances:
// dh 16, 32, 64 (128 queries x 64 keys), 128, 256 (64 x 64) and 512 (32 x 32,
// scores split over two depth halves).
//
// The bfloat16 instances (GE under a bfloat16 compute dtype; the JAX package
// hands the library kernel bfloat16 q, k, v) keep the same tiles and
// phases. q, k, v stay bfloat16 in shared memory (cp.async copies their
// bytes), both products are bfloat16 mma.sync.m16n8k16 with float32 sums
// (a product of two bfloat16 values is exact in float32), and the kernel
// rounds where the TPU kernel does: the scale multiplies the float32 sum
// q k^T, p is rounded to bfloat16 before P V (m and l come from the
// unrounded p and stay float32), and out is written in bfloat16. Bound by
// operations at the bfloat16 rate (989 TFLOP/s), 6x the 3xTF32 form's.
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launch (0 = success); allocates nothing, runs on the caller's stream.

#include "flash_common.cuh"

namespace {

using namespace mpo;

template <typename T, int DH, int BR, int BC, int WK, int NW>
struct FwdCfg {
  using Tl = Tiles<DH, BR, BC, WK, NW>;
  static constexpr bool BF = IS_BF16<T>;
  static constexpr int XS = BF ? DH + 8 : Tl::XS;  // row stride of an operand tile (values)
  static constexpr int PS = BF ? BC + 8 : Tl::SS;  // row stride of the p tile
  // q, K, V tiles (T); WK partial score tiles (float32; in float32 slice 0
  // then holds p); the bfloat16 p tile; m, l, alpha
  static constexpr int SMEM_BYTES = (int)sizeof(T) * (BR + 2 * BC) * XS +
                                    4 * (WK * BR * Tl::SS + 3 * BR) + (BF ? 2 * BR * PS : 0);
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(!BF || (Tl::KD % 16 == 0 && BC % 16 == 0), "bfloat16 MMA depth 16");
};

// q, k, v: element (b, h, i, d) at base + b*sb + h*sh + i*sl + d (strides in
// values, multiples of 16 bytes; bases 16-byte aligned). mask [B, L] bool or
// NULL. out [B, L, H, DH] contiguous. m_out, l_out [B, H, L] float32 (each
// row's running maximum and the sum of exp(s - m) over its keys, what the
// backward recomputes p from) or both NULL.
// T = float: the scores are (q * scale) k^T, q scaled as it lands in shared
// memory; p stays float32. T = __nv_bfloat16 (the TPU kernel's roundings,
// jax/experimental/pallas/ops/tpu/flash_attention.py): s = (q k^T) * scale,
// the scale applied to the float32 sum; m and l from the unrounded p; p
// rounded to bfloat16 for P V; out = o / l written in bfloat16.
template <typename T, int DH, int BR, int BC, int WK, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int H, int L,
                 long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                 long long k_sl, long long v_sb, long long v_sh, long long v_sl, float scale) {
  using Tl = Tiles<DH, BR, BC, WK, NW>;
  using Cfg = FwdCfg<T, DH, BR, BC, WK, NW>;
  constexpr bool BF = Cfg::BF;
  constexpr int XS = Cfg::XS, PS = Cfg::PS, SS = Tl::SS, NT = Tl::NT, NA = Tl::NA;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [BR][XS]: q (float32: q * scale)
  T* k_s = q_s + BR * XS;               // [BC][XS]: the key tile
  T* v_s = k_s + BC * XS;               // [BC][XS]: the value tile
  float* s_s = reinterpret_cast<float*>(v_s + BC * XS);  // [WK][BR][SS]: partial scores
  // [BR][PS]: p (float32: over slice 0 of the scores)
  T* p_s = BF ? reinterpret_cast<T*>(s_s + WK * BR * SS) : reinterpret_cast<T*>(s_s);
  float* m_s = BF ? reinterpret_cast<float*>(p_s + BR * PS) : s_s + WK * BR * SS;  // [BR]
  float* l_s = m_s + BR;  // [BR]: running sum
  float* a_s = l_s + BR;  // [BR]: this tile's rescale factor

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tl tl(warp);
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BR;
  const T* q_b = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* k_b = k + (long long)b * k_sb + (long long)h * k_sh;
  const T* v_b = v + (long long)b * v_sb + (long long)h * v_sh;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;

  const int n_tiles = (L + BC - 1) / BC;
  const bool skip = mask_b != nullptr && bag_has_valid_key(mask_b, L);
  int t = next_tile<BC>(mask_b, 0, n_tiles, L, skip);  // < n_tiles: L >= 1
  load_tile_async<BC, DH, XS>(k_s, k_b, k_sl, t * BC, L);
  cp_async_commit();
  if constexpr (BF) {  // waited for with the first key tile
    load_tile_async<BR, DH, XS>(q_s, q_b, q_sl, q0, L);
    cp_async_commit();
  } else {
    load_tile<BR, DH, XS>(q_s, q_b, q_sl, q0, L, scale);
  }
  for (int i = tid; i < BR; i += 32 * NW) {
    m_s[i] = -3.0e38f;
    l_s[i] = 0.f;
  }

  const int r0 = 16 * tl.wr;                  // the warp's rows
  const int n0s = 8 * NT * tl.wn, k0s = Tl::KD * tl.wk;  // its scores' columns, depths
  const int n0a = 8 * NA * tl.wc;             // its output columns
  float o[NA][4];
  zero_c<NA>(o);

  while (t < n_tiles) {
    const int c0 = t * BC;
    load_tile_async<BC, DH, XS>(v_s, v_b, v_sl, c0, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the key tile (and q_s, m_s, l_s the first time) ready

    // ---- S = (q * scale) K^T (bfloat16: q K^T) ----
    {
      float s[NT][4];
      zero_c<NT>(s);
      row_product<NT, Tl::KD, Tl::GR>(s, q_s, XS, k_s, XS, r0, n0s, k0s, lane);
      store_c<NT>(s, s_s + tl.wk * BR * SS, SS, r0, n0s, lane);
    }
    __syncthreads();  // scores complete, k_s free
    const int tn = next_tile<BC>(mask_b, t + 1, n_tiles, L, skip);
    if (tn < n_tiles) load_tile_async<BC, DH, XS>(k_s, k_b, k_sl, tn * BC, L);
    cp_async_commit();

    // ---- key mask, online softmax (one warp a row), P ----
    constexpr int CPL = (BC + 31) / 32;
    for (int i = warp; i < BR; i += NW) {
      float x[CPL];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u, key = c0 + c;
        x[u] = -INFINITY;  // a key past L does not exist: weight exactly 0
        if (c < BC && key < L) {
          float sum = s_s[i * SS + c];
#pragma unroll
          for (int w = 1; w < WK; ++w) sum += s_s[(w * BR + i) * SS + c];
          if constexpr (BF) sum *= scale;
          x[u] = (mask_b == nullptr || mask_b[key] != 0) ? sum : MASK_NEG;
        }
        mx = fmaxf(mx, x[u]);
      }
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, warp_max(mx));  // finite: key c0 exists
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        const float p = expf(x[u] - m_new);
        ps += p;
        if (c < BC) store1(p_s + i * PS + c, p);  // bfloat16: rounded
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + ps;
        m_s[i] = m_new;
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // the value tile ready; p and alpha complete

    // ---- O = O * alpha + P V ----
    {
      const int g = lane >> 2;
      const float a0 = a_s[r0 + g], a1 = a_s[r0 + g + 8];
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
    }
    acc_product<NA, BC, Tl::GA>(o, p_s, PS, v_s, XS, r0, n0a, lane);
    __syncthreads();  // v_s and the p / score tiles are rewritten by the next tile
    t = tn;
  }
  cp_async_wait<0>();

  // ---- out[b, row, h, :] = o / l; m and l [B, H, L] where asked for ----
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + g + 8 * half, row = q0 + i;
    if (row < L) {
      const float l = l_s[i], inv = l == 0.f ? 1.f : 1.f / l;
      T* orow = out + (((size_t)b * L + row) * H + h) * DH + n0a + 2 * tq;
#pragma unroll
      for (int j = 0; j < NA; ++j)
        store2(orow + 8 * j, o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    }
  }
  if (m_out != nullptr)  // the backward's softmax statistics
    for (int i = tid; i < BR && q0 + i < L; i += 32 * NW) {
      m_out[((size_t)b * H + h) * L + q0 + i] = m_s[i];
      l_out[((size_t)b * H + h) * L + q0 + i] = l_s[i];
    }
}

template <typename T, int DH, int BR, int BC, int WK, int NW, int MINB>
int launch_flash(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, float* m_out,
                 float* l_out, int B, int H, int L, const long long* st, float scale,
                 cudaStream_t stream) {
  constexpr int smem = FwdCfg<T, DH, BR, BC, WK, NW>::SMEM_BYTES;
  static bool smem_allowed[64] = {};
  const int err = allow_dynamic_smem(flash_fwd_kernel<T, DH, BR, BC, WK, NW, MINB>, smem,
                                     smem_allowed);
  if (err) return err;
  const dim3 grid((L + BR - 1) / BR, B * H);
  flash_fwd_kernel<T, DH, BR, BC, WK, NW, MINB><<<grid, 32 * NW, smem, stream>>>(
      q, k, v, mask, out, m_out, l_out, H, L, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int flash_fwd(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, float* m_out,
              float* l_out, int B, int H, int L, int DH, const long long* st, float scale,
              void* stream) {
  if (B < 1 || H < 1 || L < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st[i] % (16 / (int)sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (width, queries a block, keys a tile, depth slices of the scores, warps
  // a block, blocks an SM: two where the shared memory allows, which caps
  // registers at 128)
#define MPO_FWD(D, BR, BC, WK, NW, MINB) \
  launch_flash<T, D, BR, BC, WK, NW, MINB>(q, k, v, mask, out, m_out, l_out, B, H, L, st, scale, s)
  switch (DH) {
    case 16: return MPO_FWD(16, 128, 64, 1, 8, 2);
    case 32: return MPO_FWD(32, 128, 64, 1, 8, 2);
    case 64: return MPO_FWD(64, 128, 64, 1, 8, 2);
    case 128: return MPO_FWD(128, 64, 64, 1, 8, 1);
    case 256: return MPO_FWD(256, 64, 64, 1, 8, 1);
    case 512: return MPO_FWD(512, 32, 32, 2, 8, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MPO_FWD
}

}  // namespace

extern "C" {

// q, k, v: [B, H, L, DH] views with unit stride on DH; strides (batch, head,
// position) in values, each a multiple of 16 bytes, bases 16-byte aligned.
// mask [B, L] bool or NULL. Out: [B, L, H, DH] contiguous; m_out and l_out
// [B, H, L] float32 contiguous, or both NULL. DH in {16, 32, 64, 128, 256,
// 512}; B * H <= 65535.
int mpo_flash_fwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                  float* out, float* m_out, float* l_out, int B, int H, int L, int DH,
                  long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                  long long k_sl, long long v_sb, long long v_sh, long long v_sl, float scale,
                  void* stream) {
  const long long st[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl};
  return flash_fwd<float>(q, k, v, mask, out, m_out, l_out, B, H, L, DH, st, scale, stream);
}

// The same in bfloat16: q, k, v and out bfloat16, m_out and l_out float32.
int mpo_flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const uint8_t* mask, __nv_bfloat16* out, float* m_out, float* l_out, int B,
                       int H, int L, int DH, long long q_sb, long long q_sh, long long q_sl,
                       long long k_sb, long long k_sh, long long k_sl, long long v_sb,
                       long long v_sh, long long v_sl, float scale, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl};
  return flash_fwd<__nv_bfloat16>(q, k, v, mask, out, m_out, l_out, B, H, L, DH, st, scale,
                                  stream);
}

}  // extern "C"
