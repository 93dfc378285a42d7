// Masked flash self-attention backward for Hopper (sm_90a), float32.
//
// Replaces the backward of multimodal_path_omic_tpu/ops/flash.py::
// flash_attention (the custom VJP of JAX's library Pallas TPU kernel, with
// its dq and dkv passes): for every (bag b, head h) over L positions, with
// s = scale * q k^T filled with the finite -1e9 at masked keys exactly as the
// forward (csrc/flash.cu) and the forward's row statistics m, l,
//   p     = exp(s - m) / l                 (recomputed, never in device memory)
//   dv    = p^T dout
//   dp    = dout v^T
//   delta = rowsum(dout * out)
//   ds    = p * (dp - delta), and 0 at every masked key (the mask is a where)
//   dq    = scale * ds k        dk = scale * ds^T q
// A masked key still has p = 1/L in a bag without a valid key (m = -1e9), so
// it feeds dv there, but never dq or dk. Pad query rows are computed like any
// other row.
//
// What bounds it on an H100, and what the design does about it: float32
// FMAs, as the forward. dq sums over key tiles and dk, dv over query tiles;
// to stay bitwise repeatable without atomics and without L/tile partial
// copies of dq there are two passes of one kernel template, each block
// holding its sums in registers for its whole life:
//   * dq pass  (DKV = false): a block owns a tile of queries (rows) and walks
//     the key tiles (columns): S and dP, then dq += ds K. 3 products.
//   * dkv pass (DKV = true): a block owns a tile of keys (rows) and walks the
//     query tiles (columns), everything transposed: S^T = (k * scale) q^T and
//     dP^T = v dout^T, then dv += p^T dout and dk += ds^T q. 4 products.
// That is 7 products where 5 are necessary (14*B*H*L^2*dh operations: 7.7
// TFLOP at B=8, L=16384, H*dh=256, 115 ms at 67 TFLOP/s). A small first
// kernel writes delta. Per column tile a pass runs the forward's two
// register-tiled SIMT products (flash_common.cuh): the row side (q * scale
// and dout, or k * scale and v) sits transposed in shared memory for the
// block's life, the column side streams through shared memory in chunks
// prefetched into registers one chunk ahead, p and ds go through shared
// memory transposed. With two accumulators of dh = 256 columns a thread, the
// dkv pass owns 32 keys a block (4 rows a warp: 64 accumulator registers)
// where the dq pass owns 64 queries. All operands are taken with their
// strides: q, k, v are read in place from the packed [B, L, 3E]
// in-projection, and dq, dk, dv are written into one packed buffer, so the
// in-projection's backward is one product.
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing, runs on the caller's stream.

#include "flash_common.cuh"

namespace {

using namespace mpo;

template <int DH, int R, int C, int KC, int VC, bool DKV>
struct BwdCfg {
  static constexpr int RPW = R / WARPS;                // rows per warp
  static constexpr int KPL = C / 32;                   // columns per lane
  static constexpr int CPL = DH / 32;                  // output columns per lane
  static constexpr int RS = R + 4;                     // row stride of the transposed tiles
  static constexpr int KS = KC + 4;                    // row stride of a depth chunk
  static constexpr int K_V4 = C * KC / 4 / THREADS;    // float4s per thread per depth chunk
  static constexpr int V_V4 = VC * DH / 4 / THREADS;   // float4s per thread per row chunk
  static constexpr int KV_FLOATS = C * KS > VC * DH ? C * KS : VC * DH;
  static constexpr int NP = DKV ? 2 : 1;               // ds, and p beside it for dv
  static constexpr int ST = DKV ? C : R;               // queries whose statistics are held
  static constexpr int SMEM_BYTES = 4 * (2 * DH * RS + NP * C * RS + KV_FLOATS + 3 * ST);
  static_assert(RPW % 4 == 0 && KPL >= 1 && (CPL == 1 || CPL % 4 == 0), "tile shape");
  static_assert(KC % 4 == 0 && DH % KC == 0 && C % VC == 0, "chunk shape");
  static_assert(K_V4 * THREADS * 4 == C * KC && V_V4 * THREADS * 4 == VC * DH, "chunk copy");
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
};

// An operand [B, H, L, DH] with unit stride on DH: element (b, h, i, d) at
// p + b*sb + h*sh + i*sl + d (strides in floats, multiples of 4).
struct Operand {
  const float* p;
  long long sb, sh, sl;
};

struct BwdArgs {
  // x1, x2: the row side of the scores (scaled in shared memory) and of dp;
  // y1, y2: their column sides. dq pass: q, dout | k, v. dkv pass: k, v | q, dout.
  Operand x1, x2, y1, y2;
  const uint8_t* mask;   // [B, L] bool or NULL
  const float* m;        // [B, H, L] the forward's row maximum
  const float* l;        // [B, H, L] the forward's row sum
  const float* delta;    // [B, H, L] rowsum(dout * out)
  Operand out1, out2;    // scale * ds-sum (dq or dk), and the p-sum (dv; dkv pass only)
  int H, L;
  float scale;
};

// m, 1/l and delta of n queries from first on, into st_s [3][ST] (identity
// values past L).
template <int ST>
__device__ __forceinline__ void load_stats(float* __restrict__ st_s, const BwdArgs& a,
                                           size_t stat_b, int first, int n) {
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const bool ok = first + idx < a.L;
    st_s[idx] = ok ? a.m[stat_b + first + idx] : 0.f;
    st_s[ST + idx] = ok ? 1.f / a.l[stat_b + first + idx] : 1.f;
    st_s[2 * ST + idx] = ok ? a.delta[stat_b + first + idx] : 0.f;
  }
}

template <int DH, int R, int C, int KC, int VC, bool DKV>
__global__ void __launch_bounds__(THREADS) flash_bwd_kernel(const BwdArgs a) {
  using Cf = BwdCfg<DH, R, C, KC, VC, DKV>;
  constexpr int RPW = Cf::RPW, KPL = Cf::KPL, CPL = Cf::CPL, RS = Cf::RS, KS = Cf::KS;
  constexpr int ST = Cf::ST, NKC = DH / KC, NVC = C / VC;
  extern __shared__ __align__(16) float smem[];
  float* x1t_s = smem;                       // [DH][RS]: x1 * scale, transposed
  float* x2t_s = x1t_s + DH * RS;            // [DH][RS]: x2, transposed
  float* ds_s = x2t_s + DH * RS;             // [C][RS]: ds of the column tile, transposed
  float* p_s = DKV ? ds_s + C * RS : ds_s;   // [C][RS]: p (dq pass: overwritten by ds)
  float* kv_s = ds_s + Cf::NP * C * RS;      // a depth chunk [C][KS] or a row chunk [VC][DH]
  float* st_s = kv_s + Cf::KV_FLOATS;        // [3][ST]: m, 1/l, delta of the queries

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int r0 = blockIdx.x * R, L = a.L;
  const float* x1_b = a.x1.p + (long long)b * a.x1.sb + (long long)h * a.x1.sh;
  const float* x2_b = a.x2.p + (long long)b * a.x2.sb + (long long)h * a.x2.sh;
  const float* y1_b = a.y1.p + (long long)b * a.y1.sb + (long long)h * a.y1.sh;
  const float* y2_b = a.y2.p + (long long)b * a.y2.sb + (long long)h * a.y2.sh;
  const long long y1_sl = a.y1.sl, y2_sl = a.y2.sl;
  const uint8_t* mask_b = a.mask == nullptr ? nullptr : a.mask + (size_t)b * L;
  const size_t stat_b = ((size_t)b * a.H + h) * L;

  float4 kreg[Cf::K_V4], vreg[Cf::V_V4];
  load_k<C, KC>(kreg, y1_b, y1_sl, 0, 0, L);

  // the block's rows, transposed (zero rows past L)
  for (int idx = tid; idx < R * DH / 4; idx += THREADS) {
    const int row = idx / (DH / 4), c = idx % (DH / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r0 + row < L) {
      x = *reinterpret_cast<const float4*>(x1_b + (long long)(r0 + row) * a.x1.sl + 4 * c);
      y = *reinterpret_cast<const float4*>(x2_b + (long long)(r0 + row) * a.x2.sl + 4 * c);
    }
    x1t_s[(4 * c + 0) * RS + row] = x.x * a.scale;
    x1t_s[(4 * c + 1) * RS + row] = x.y * a.scale;
    x1t_s[(4 * c + 2) * RS + row] = x.z * a.scale;
    x1t_s[(4 * c + 3) * RS + row] = x.w * a.scale;
    x2t_s[(4 * c + 0) * RS + row] = y.x;
    x2t_s[(4 * c + 1) * RS + row] = y.y;
    x2t_s[(4 * c + 2) * RS + row] = y.z;
    x2t_s[(4 * c + 3) * RS + row] = y.w;
  }
  if constexpr (!DKV) load_stats<ST>(st_s, a, stat_b, r0, R);  // the rows are the queries

  // dkv pass: the rows are the keys, valid or masked (a row past L: masked)
  bool rvalid[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int key = r0 + warp * RPW + i;
    rvalid[i] = DKV && key < L && (mask_b == nullptr || mask_b[key] != 0);
  }

  float acc1[RPW][CPL], acc2[DKV ? RPW : 1][CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc1[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < (DKV ? RPW : 1); ++i) acc2[i][j] = 0.f;
  }

  const int n_tiles = (L + C - 1) / C;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * C;
    // the columns are the queries: this tile's statistics (the barriers of
    // the first product order the writes before their reads)
    if constexpr (DKV) load_stats<ST>(st_s, a, stat_b, c0, C);

    // ---- S = (x1 * scale) y1^T over the depth chunks ----
    float s[RPW][KPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int tt = 0; tt < KPL; ++tt) s[i][tt] = 0.f;
#pragma unroll 1
    for (int c = 0; c < NKC; ++c) {
      store_k<KC, KS>(kreg, kv_s);
      __syncthreads();  // also orders x1t_s, x2t_s, st_s before their reads
      if (c + 1 < NKC) load_k<C, KC>(kreg, y1_b, y1_sl, c0, (c + 1) * KC, L);
      else load_k<C, KC>(kreg, y2_b, y2_sl, c0, 0, L);
      dot_chunk<RPW, KPL, KC, KS, RS>(s, x1t_s + c * KC * RS, kv_s, warp, lane);
      __syncthreads();  // kv_s is rewritten by the next chunk
    }

    // ---- p = exp(s - m) / l with the forward's fill at masked keys ----
    bool cexists[KPL], kvalid[KPL];  // kvalid: dq pass, the columns are the keys
#pragma unroll
    for (int tt = 0; tt < KPL; ++tt) {
      const int col = c0 + lane + 32 * tt;
      cexists[tt] = col < L;
      kvalid[tt] = !DKV && cexists[tt] && (mask_b == nullptr || mask_b[col] != 0);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int tt = 0; tt < KPL; ++tt) {
        const int qi = DKV ? lane + 32 * tt : warp * RPW + i;  // the query's slot in st_s
        const bool valid = DKV ? rvalid[i] : kvalid[tt];
        const float x = valid ? s[i][tt] : MASK_NEG;
        // a column past L does not exist: weight exactly 0
        s[i][tt] = cexists[tt] ? expf(x - st_s[qi]) * st_s[ST + qi] : 0.f;
      }
    store_transposed<RPW, KPL, RS>(s, p_s, warp, lane);

    // ---- dP = x2 y2^T over the depth chunks ----
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int tt = 0; tt < KPL; ++tt) s[i][tt] = 0.f;
#pragma unroll 1
    for (int c = 0; c < NKC; ++c) {
      store_k<KC, KS>(kreg, kv_s);
      __syncthreads();
      if (c + 1 < NKC) load_k<C, KC>(kreg, y2_b, y2_sl, c0, (c + 1) * KC, L);
      else if constexpr (DKV) load_v<DH>(vreg, y2_b, y2_sl, c0, L);
      else load_v<DH>(vreg, y1_b, y1_sl, c0, L);
      dot_chunk<RPW, KPL, KC, KS, RS>(s, x2t_s + c * KC * RS, kv_s, warp, lane);
      __syncthreads();
    }

    // ---- ds = p * (dP - delta), 0 at masked keys; a thread reads back the p
    // it wrote itself ----
#pragma unroll
    for (int tt = 0; tt < KPL; ++tt)
#pragma unroll
      for (int g = 0; g < RPW / 4; ++g) {
        const int at = (lane + 32 * tt) * RS + warp * RPW + 4 * g;
        const float4 p4 = *reinterpret_cast<const float4*>(&p_s[at]);
        float d[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = 4 * g + u;
          const int qi = DKV ? lane + 32 * tt : warp * RPW + i;
          const bool valid = DKV ? rvalid[i] : kvalid[tt];
          d[u] = valid ? comp(p4, u) * (s[i][tt] - st_s[2 * ST + qi]) : 0.f;
        }
        *reinterpret_cast<float4*>(&ds_s[at]) = make_float4(d[0], d[1], d[2], d[3]);
      }
    // a warp reads back only the rows it wrote: the barrier below orders it

    // ---- dkv pass: dv += p^T dout over the row chunks of dout ----
    if constexpr (DKV) {
#pragma unroll 1
      for (int c = 0; c < NVC; ++c) {
        store_v<DH>(vreg, kv_s);
        __syncthreads();
        if (c + 1 < NVC) load_v<DH>(vreg, y2_b, y2_sl, c0 + (c + 1) * VC, L);
        else load_v<DH>(vreg, y1_b, y1_sl, c0, L);
        acc_chunk<RPW, CPL, VC, DH, RS>(acc2, p_s + c * VC * RS, kv_s, warp, lane);
        __syncthreads();
      }
    }

    // ---- dq += ds k, or dk += ds^T q, over the row chunks of y1 ----
#pragma unroll 1
    for (int c = 0; c < NVC; ++c) {
      store_v<DH>(vreg, kv_s);
      __syncthreads();
      if (c + 1 < NVC) load_v<DH>(vreg, y1_b, y1_sl, c0 + (c + 1) * VC, L);
      else if (t + 1 < n_tiles) load_k<C, KC>(kreg, y1_b, y1_sl, c0 + C, 0, L);
      acc_chunk<RPW, CPL, VC, DH, RS>(acc1, ds_s + c * VC * RS, kv_s, warp, lane);
      __syncthreads();  // kv_s, p_s, ds_s and st_s are rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    if (row < L) {
      store_row<CPL>(acc1[i], a.scale, const_cast<float*>(a.out1.p) + (long long)b * a.out1.sb +
                                           (long long)h * a.out1.sh + (long long)row * a.out1.sl,
                     lane);
      if constexpr (DKV)
        store_row<CPL>(acc2[i], 1.f, const_cast<float*>(a.out2.p) + (long long)b * a.out2.sb +
                                         (long long)h * a.out2.sh + (long long)row * a.out2.sl,
                       lane);
    }
  }
}

// delta[b, h, i] = sum_d dout[b, h, i, d] * out[b, i, h, d]: one warp a row.
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const Operand dout, const float* __restrict__ out,
                       float* __restrict__ delta, int H, int L, long long n_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;  // (b * H + h) * L + i
  if (row >= n_rows) return;
  const long long i = row % L, bh = row / L, h = bh % H, b = bh / H;
  const float* d = dout.p + b * dout.sb + h * dout.sh + i * dout.sl;
  const float* o = out + ((b * L + i) * H + h) * DH;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < DH; c += 32) sum = fmaf(d[c], o[c], sum);
  sum = warp_sum(sum);
  if (lane == 0) delta[row] = sum;
}

template <int DH, int R, int C, int KC, int VC, bool DKV>
int launch_pass(const BwdArgs& args, int B, cudaStream_t stream) {
  constexpr int smem = BwdCfg<DH, R, C, KC, VC, DKV>::SMEM_BYTES;
  static bool smem_allowed[64] = {};
  const int err = allow_dynamic_smem(flash_bwd_kernel<DH, R, C, KC, VC, DKV>, smem, smem_allowed);
  if (err) return err;
  const dim3 grid((args.L + R - 1) / R, B * args.H);
  flash_bwd_kernel<DH, R, C, KC, VC, DKV><<<grid, THREADS, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// The three launches of one backward: delta, the dq pass, the dkv pass.
// RQ: queries a block of the dq pass owns; RK: keys a block of the dkv pass owns.
template <int DH, int RQ, int RK, int C, int KC, int VC>
int launch_bwd(const Operand& q, const Operand& k, const Operand& v, const Operand& dout,
               const uint8_t* mask, const float* out, const float* m, const float* l,
               float* delta, const Operand& dq, const Operand& dk, const Operand& dv, int B,
               int H, int L, float scale, cudaStream_t stream) {
  const long long n_rows = (long long)B * H * L;
  flash_bwd_delta_kernel<DH><<<(unsigned)((n_rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      dout, out, delta, H, L, n_rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const BwdArgs dq_pass = {q, dout, k, v, mask, m, l, delta, dq, dq, H, L, scale};
  err = launch_pass<DH, RQ, C, KC, VC, false>(dq_pass, B, stream);
  if (err) return err;
  const BwdArgs dkv_pass = {k, v, q, dout, mask, m, l, delta, dk, dv, H, L, scale};
  return launch_pass<DH, RK, C, KC, VC, true>(dkv_pass, B, stream);
}

}  // namespace

extern "C" {

// q, k, v, dout (in) and dq, dk, dv (out): [B, H, L, DH] views with unit
// stride on DH; st holds their (batch, head, position) strides in floats, in
// that order (21 values), each a multiple of 4; bases 16-byte aligned. mask
// [B, L] bool or NULL. out [B, L, H, DH] and m, l, delta [B, H, L] contiguous;
// delta is scratch the call fills. DH in {256, 32}; B * H <= 65535;
// B * H * L / 8 < 2^31.
int mpo_flash_bwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                  const float* out, const float* m, const float* l, const float* dout,
                  float* delta, float* dq, float* dk, float* dv, int B, int H, int L, int DH,
                  const long long* st, float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * L / WARPS >= 2147483647LL) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 21; ++i)
    if (st[i] % 4 != 0) return (int)cudaErrorInvalidValue;
  const Operand q_ = {q, st[0], st[1], st[2]}, k_ = {k, st[3], st[4], st[5]};
  const Operand v_ = {v, st[6], st[7], st[8]}, dout_ = {dout, st[9], st[10], st[11]};
  const Operand dq_ = {dq, st[12], st[13], st[14]}, dk_ = {dk, st[15], st[16], st[17]};
  const Operand dv_ = {dv, st[18], st[19], st[20]};
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (DH == 256)
    return launch_bwd<256, 64, 32, 128, 16, 16>(q_, k_, v_, dout_, mask, out, m, l, delta, dq_,
                                                 dk_, dv_, B, H, L, scale, stream_);
  if (DH == 32)
    return launch_bwd<32, 128, 128, 128, 32, 128>(q_, k_, v_, dout_, mask, out, m, l, delta, dq_,
                                                  dk_, dv_, B, H, L, scale, stream_);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
