// Masked flash self-attention backward for Hopper (sm_90a), float32 and
// bfloat16 instances.
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
// What bounds it on an H100, and what the design does about it: operations.
// Every product runs on the tensor cores as 3xTF32 mma.sync at float32
// accuracy (flash_common.cuh). dq sums over key tiles and dk, dv over query
// tiles; to stay bitwise repeatable without atomics and without L / tile
// partial copies of dq there are two passes of one kernel template, each
// block holding its sums in registers for its whole life:
//   * dq pass  (DKV = false): a block owns a tile of queries (rows) and walks
//     the key tiles (columns): dP = dout V^T, S = (q * scale) K^T, then
//     dq += ds K. 3 products. Key tiles without a valid key are skipped when
//     the bag has one (ds is 0 there).
//   * dkv pass (DKV = true): a block owns a tile of keys (rows) and walks the
//     query tiles (columns), everything transposed: dP^T = v dout^T,
//     S^T = (k * scale) q^T, then dv += p^T dout and dk += ds^T q. 4
//     products. A block whose keys are all masked, in a bag with a valid key,
//     writes dk = dv = 0 and returns (its p underflows to exactly 0).
// 7 products where 5 are necessary: fusing the passes would need dq partials
// per key tile, or atomics. A small first kernel writes delta. The row side
// (q * scale and dout, or k * scale and v) sits in shared memory for the
// block's life; the column side comes in tile by tile by cp.async, each tile
// landing while a product that does not read it runs; scores and dP go
// through shared memory as partial tiles (summed in a fixed order at width
// 512, whose score products split the depth over four warps), p and ds with
// them. Instances: dh 16, 32 (128 rows x 32 columns), 64 (64 x 64), 128
// (64 x 64), 256 (64 x 32: the dkv pass owns 64 keys, its two sums 128
// registers a thread) and 512 (32 x 16, the scores over four depth slices).
// All operands are taken with their strides: q, k, v are read in place from
// the packed [B, L, 3E] in-projection, and dq, dk, dv are written into one
// packed buffer, so the in-projection's backward is one product.
//
// The bfloat16 instances keep the tiles and passes; the operands stay
// bfloat16 in shared memory, every product is a bfloat16 mma.sync with
// float32 sums, and the kernel rounds where the TPU kernel's dq and dkv
// passes do (flash_attention.py): s = (q k^T) * scale and p = exp(s - m) / l
// in float32, dv += round(p)^T dout, dp = dout v^T in float32, ds = p (dp -
// delta) * scale rounded to bfloat16 before dq += ds k and dk += ds^T q, and
// dq, dk, dv written in bfloat16 (delta = rowsum(out * dout) in float32 from
// the bfloat16 values).
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing, runs on the caller's stream.

#include "flash_common.cuh"

namespace {

using namespace mpo;

template <typename T, int DH, int BR, int BC, int WK, int NW>
struct BwdCfg {
  using Tl = Tiles<DH, BR, BC, WK, NW>;
  static constexpr bool BF = IS_BF16<T>;
  static constexpr int XS = BF ? DH + 8 : Tl::XS;  // row stride of an operand tile (values)
  static constexpr int PS = BF ? BC + 8 : Tl::SS;  // row stride of the p and ds tiles
  // x1, x2 (rows), y1, y2 (columns) in T; WK partial tiles each of s and dp
  // (float32; in float32 slice 0 then holds p, ds); the bfloat16 p and ds
  // tiles; m, 1/l, delta of the queries (rows or columns)
  static constexpr int SMEM_BYTES = (int)sizeof(T) * 2 * (BR + BC) * XS +
                                    4 * (2 * WK * BR * Tl::SS + 3 * (BR > BC ? BR : BC)) +
                                    (BF ? 2 * 2 * BR * PS : 0);
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(!BF || (Tl::KD % 16 == 0 && BC % 16 == 0), "bfloat16 MMA depth 16");
};

// An operand [B, H, L, DH] with unit stride on DH: element (b, h, i, d) at
// p + b*sb + h*sh + i*sl + d (strides in values, multiples of 16 bytes).
template <typename T>
struct Operand {
  const T* p;
  long long sb, sh, sl;
};

template <typename T>
struct BwdArgs {
  // x1, x2: the row side of the scores (float32: scaled in shared memory)
  // and of dp; y1, y2: their column sides. dq pass: q, dout | k, v. dkv
  // pass: k, v | q, dout.
  Operand<T> x1, x2, y1, y2;
  const uint8_t* mask;   // [B, L] bool or NULL
  const float* m;        // [B, H, L] the forward's row maximum
  const float* l;        // [B, H, L] the forward's row sum
  const float* delta;    // [B, H, L] rowsum(dout * out)
  Operand<T> out1, out2; // the ds-sum (dq or dk), and the p-sum (dv; dkv pass only)
  int H, L;
  float scale;
};

// m, 1/l and delta of n queries from first on, into st_s [3][ST] (identity
// values past L).
template <int ST, typename T>
__device__ __forceinline__ void load_stats(float* __restrict__ st_s, const BwdArgs<T>& a,
                                           size_t stat_b, int first, int n) {
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const bool ok = first + idx < a.L;
    st_s[idx] = ok ? a.m[stat_b + first + idx] : 0.f;
    st_s[ST + idx] = ok ? 1.f / a.l[stat_b + first + idx] : 1.f;
    st_s[2 * ST + idx] = ok ? a.delta[stat_b + first + idx] : 0.f;
  }
}

// The warp's sums (rows r0 .. r0+15 of the block, columns n0 ..) times
// `scale`, to rows < L of an output operand.
template <int NA, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[NA][4], float scale,
                                           const Operand<T>& out, int b, int h, int row0, int n0,
                                           int L, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= L) continue;
    T* p = const_cast<T*>(out.p) + (long long)b * out.sb + (long long)h * out.sh +
           (long long)row * out.sl + n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NA; ++j)
      store2(p + 8 * j, acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

// T = float: the products at float32 accuracy (3xTF32), x1 scaled as it
// lands, dq and dk scaled as they are written. T = __nv_bfloat16 (the TPU
// kernel's roundings): s = (x1 y1^T) * scale in float32, p in float32 from
// the forward's m and l, dv += round(p)^T dout, ds = p (dp - delta) * scale
// rounded to bfloat16 for dq += ds k and dk += ds^T q; dq, dk, dv written in
// bfloat16.
template <typename T, int DH, int BR, int BC, int WK, int NW, int MINB, bool DKV>
__global__ void __launch_bounds__(32 * NW, MINB) flash_bwd_kernel(const BwdArgs<T> a) {
  using Tl = Tiles<DH, BR, BC, WK, NW>;
  using Cfg = BwdCfg<T, DH, BR, BC, WK, NW>;
  constexpr bool BF = Cfg::BF;
  constexpr int XS = Cfg::XS, PS = Cfg::PS, SS = Tl::SS, NT = Tl::NT, NA = Tl::NA;
  constexpr int ST = BR > BC ? BR : BC;
  // the dkv pass holds two sums: at 16 column tiles each, two in flight (registers)
  constexpr int GA = DKV && NA >= 16 ? 2 : Tl::GA;
  extern __shared__ __align__(16) unsigned char smem[];
  T* x1_s = reinterpret_cast<T*>(smem);  // [BR][XS]: x1 (float32: x1 * scale)
  T* x2_s = x1_s + BR * XS;              // [BR][XS]: x2
  T* y1_s = x2_s + BR * XS;              // [BC][XS]: the column tile of y1
  T* y2_s = y1_s + BC * XS;              // [BC][XS]: the column tile of y2
  float* s_s = reinterpret_cast<float*>(y2_s + BC * XS);  // [WK][BR][SS]: partial s
  float* d_s = s_s + WK * BR * SS;                        // [WK][BR][SS]: partial dp
  // [BR][PS]: p and ds (float32: over slice 0 of s and dp)
  T* p_s = BF ? reinterpret_cast<T*>(d_s + WK * BR * SS) : reinterpret_cast<T*>(s_s);
  T* ds_s = BF ? p_s + BR * PS : reinterpret_cast<T*>(d_s);
  float* st_s = BF ? reinterpret_cast<float*>(ds_s + BR * PS) : d_s + WK * BR * SS;  // [3][ST]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tl tl(warp);
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int rb = blockIdx.x * BR, L = a.L;
  const T* x1_b = a.x1.p + (long long)b * a.x1.sb + (long long)h * a.x1.sh;
  const T* x2_b = a.x2.p + (long long)b * a.x2.sb + (long long)h * a.x2.sh;
  const T* y1_b = a.y1.p + (long long)b * a.y1.sb + (long long)h * a.y1.sh;
  const T* y2_b = a.y2.p + (long long)b * a.y2.sb + (long long)h * a.y2.sh;
  const uint8_t* mask_b = a.mask == nullptr ? nullptr : a.mask + (size_t)b * L;
  const size_t stat_b = ((size_t)b * a.H + h) * L;

  const int r0 = 16 * tl.wr;                             // the warp's rows
  const int n0s = 8 * NT * tl.wn, k0s = Tl::KD * tl.wk;  // its scores' columns, depths
  const int n0a = 8 * NA * tl.wc;                        // its sums' columns
  float acc1[NA][4], acc2[DKV ? NA : 1][4];
  zero_c<NA>(acc1);
  zero_c<DKV ? NA : 1>(acc2);

  const int n_tiles = (L + BC - 1) / BC;
  const bool skip = mask_b != nullptr && bag_has_valid_key(mask_b, L);
  if constexpr (DKV) {
    // keys all masked in a bag with a valid key: dk = dv = 0
    if (skip && !__syncthreads_or(tid < BR && rb + tid < L && mask_b[rb + tid] != 0)) {
      store_rows<NA>(acc1, 1.f, a.out1, b, h, rb + r0, n0a, L, lane);
      store_rows<NA>(acc1, 1.f, a.out2, b, h, rb + r0, n0a, L, lane);
      return;
    }
  }
  // the dq pass skips key tiles without a valid key; the dkv pass walks every
  // query tile
  int t = next_tile<BC>(mask_b, 0, n_tiles, L, !DKV && skip);
  if constexpr (BF) {  // the rows: waited for with the first y2 tile
    load_tile_async<BR, DH, XS>(x1_s, x1_b, a.x1.sl, rb, L);
    load_tile_async<BR, DH, XS>(x2_s, x2_b, a.x2.sl, rb, L);
    cp_async_commit();
  }
  load_tile_async<BC, DH, XS>(y2_s, y2_b, a.y2.sl, t * BC, L);
  cp_async_commit();
  load_tile_async<BC, DH, XS>(y1_s, y1_b, a.y1.sl, t * BC, L);
  cp_async_commit();
  if constexpr (!BF) {
    load_tile<BR, DH, XS>(x1_s, x1_b, a.x1.sl, rb, L, a.scale);
    load_tile<BR, DH, XS>(x2_s, x2_b, a.x2.sl, rb, L, 1.f);
  }
  if constexpr (!DKV) load_stats<ST>(st_s, a, stat_b, rb, BR);  // the rows are the queries

  while (t < n_tiles) {
    const int c0 = t * BC;
    // the columns are the queries: this tile's statistics (the previous
    // tile's reads of st_s ended before its last barriers)
    if constexpr (DKV) load_stats<ST>(st_s, a, stat_b, c0, BC);
    cp_async_wait<1>();
    __syncthreads();  // the y2 tile ready (and the rows, statistics)

    // ---- dP = x2 y2^T ----
    {
      float s[NT][4];
      zero_c<NT>(s);
      row_product<NT, Tl::KD, Tl::GR>(s, x2_s, XS, y2_s, XS, r0, n0s, k0s, lane);
      store_c<NT>(s, d_s + tl.wk * BR * SS, SS, r0, n0s, lane);
    }
    int tn = t + 1;
    if constexpr (!DKV) {
      __syncthreads();  // y2_s free: the next valid tile's values come in
      tn = next_tile<BC>(mask_b, t + 1, n_tiles, L, skip);
      if (tn < n_tiles) load_tile_async<BC, DH, XS>(y2_s, y2_b, a.y2.sl, tn * BC, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the y1 tile ready

    // ---- S = (x1 * scale) y1^T (bfloat16: x1 y1^T) ----
    {
      float s[NT][4];
      zero_c<NT>(s);
      row_product<NT, Tl::KD, Tl::GR>(s, x1_s, XS, y1_s, XS, r0, n0s, k0s, lane);
      store_c<NT>(s, s_s + tl.wk * BR * SS, SS, r0, n0s, lane);
    }
    __syncthreads();  // s and dp complete

    // ---- p = exp(s - m) / l with the forward's fill; ds = p (dp - delta),
    // 0 at masked keys (bfloat16: times the scale, both rounded) ----
    for (int idx = tid; idx < BR * BC; idx += 32 * NW) {
      const int i = idx / BC, c = idx % BC, col = c0 + c;
      float s = s_s[i * SS + c], dp = d_s[i * SS + c];
#pragma unroll
      for (int w = 1; w < WK; ++w) {
        s += s_s[(w * BR + i) * SS + c];
        dp += d_s[(w * BR + i) * SS + c];
      }
      if constexpr (BF) s *= a.scale;
      const int key = DKV ? rb + i : col, qi = DKV ? c : i;  // qi: the query's slot in st_s
      const bool valid = key < L && (mask_b == nullptr || mask_b[key] != 0);
      float p = 0.f, ds = 0.f;
      if (col < L) {  // a column past L does not exist: weight exactly 0
        p = expf((valid ? s : MASK_NEG) - st_s[qi]) * st_s[ST + qi];
        ds = valid ? p * (dp - st_s[2 * ST + qi]) : 0.f;
      }
      store1(p_s + i * PS + c, p);
      store1(ds_s + i * PS + c, BF ? ds * a.scale : ds);
    }
    __syncthreads();  // p and ds complete

    // ---- dkv pass: dv += p^T dout ----
    if constexpr (DKV) {
      acc_product<NA, BC, GA>(acc2, p_s, PS, y2_s, XS, r0, n0a, lane);
      __syncthreads();  // y2_s free: the next query tile's dout comes in
      if (tn < n_tiles) load_tile_async<BC, DH, XS>(y2_s, y2_b, a.y2.sl, tn * BC, L);
      cp_async_commit();
    }

    // ---- dq += ds k, or dk += ds^T q ----
    acc_product<NA, BC, GA>(acc1, ds_s, PS, y1_s, XS, r0, n0a, lane);
    __syncthreads();  // y1_s, the p / ds tiles and st_s are rewritten by the next tile
    if (tn < n_tiles) load_tile_async<BC, DH, XS>(y1_s, y1_b, a.y1.sl, tn * BC, L);
    cp_async_commit();
    t = tn;
  }
  cp_async_wait<0>();

  store_rows<NA>(acc1, BF ? 1.f : a.scale, a.out1, b, h, rb + r0, n0a, L, lane);
  if constexpr (DKV) store_rows<NA>(acc2, 1.f, a.out2, b, h, rb + r0, n0a, L, lane);
}

// delta[b, h, i] = sum_d dout[b, h, i, d] * out[b, i, h, d] in float32: one
// warp a row.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const Operand<T> dout, const T* __restrict__ out,
                       float* __restrict__ delta, int H, int L, long long n_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;  // (b * H + h) * L + i
  if (row >= n_rows) return;
  const long long i = row % L, bh = row / L, h = bh % H, b = bh / H;
  const T* d = dout.p + b * dout.sb + h * dout.sh + i * dout.sl;
  const T* o = out + ((b * L + i) * H + h) * DH;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < DH; c += 32) sum = fmaf(to_f32(d[c]), to_f32(o[c]), sum);
  sum = warp_sum(sum);
  if (lane == 0) delta[row] = sum;
}

template <typename T, int DH, int BR, int BC, int WK, int NW, int MINB, bool DKV>
int launch_pass(const BwdArgs<T>& args, int B, cudaStream_t stream) {
  constexpr int smem = BwdCfg<T, DH, BR, BC, WK, NW>::SMEM_BYTES;
  static bool smem_allowed[64] = {};
  const int err = allow_dynamic_smem(flash_bwd_kernel<T, DH, BR, BC, WK, NW, MINB, DKV>, smem,
                                     smem_allowed);
  if (err) return err;
  const dim3 grid((args.L + BR - 1) / BR, B * args.H);
  flash_bwd_kernel<T, DH, BR, BC, WK, NW, MINB, DKV><<<grid, 32 * NW, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// The three launches of one backward: delta, the dq pass, the dkv pass (both
// passes with the same tile shape: BR rows a block, BC columns a step, WK
// depth slices of the score products, NW warps a block, MINB blocks an SM).
template <typename T, int DH, int BR, int BC, int WK, int NW, int MINB>
int launch_bwd(const Operand<T>& q, const Operand<T>& k, const Operand<T>& v,
               const Operand<T>& dout, const uint8_t* mask, const T* out, const float* m,
               const float* l, float* delta, const Operand<T>& dq, const Operand<T>& dk,
               const Operand<T>& dv, int B, int H, int L, float scale, cudaStream_t stream) {
  const long long n_rows = (long long)B * H * L;
  flash_bwd_delta_kernel<T, DH>
      <<<(unsigned)((n_rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(dout, out, delta, H, L,
                                                                         n_rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const BwdArgs<T> dq_pass = {q, dout, k, v, mask, m, l, delta, dq, dq, H, L, scale};
  err = launch_pass<T, DH, BR, BC, WK, NW, MINB, false>(dq_pass, B, stream);
  if (err) return err;
  const BwdArgs<T> dkv_pass = {k, v, q, dout, mask, m, l, delta, dk, dv, H, L, scale};
  return launch_pass<T, DH, BR, BC, WK, NW, MINB, true>(dkv_pass, B, stream);
}

template <typename T>
int flash_bwd(const T* q, const T* k, const T* v, const uint8_t* mask, const T* out,
              const float* m, const float* l, const T* dout, float* delta, T* dq, T* dk, T* dv,
              int B, int H, int L, int DH, const long long* st, float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * L / WARPS >= 2147483647LL) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 21; ++i)
    if (st[i] % (16 / (int)sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
  const Operand<T> q_ = {q, st[0], st[1], st[2]}, k_ = {k, st[3], st[4], st[5]};
  const Operand<T> v_ = {v, st[6], st[7], st[8]}, dout_ = {dout, st[9], st[10], st[11]};
  const Operand<T> dq_ = {dq, st[12], st[13], st[14]}, dk_ = {dk, st[15], st[16], st[17]};
  const Operand<T> dv_ = {dv, st[18], st[19], st[20]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (width, rows a block, columns a step, depth slices of the scores, warps a
  // block, blocks an SM: two where the shared memory allows, which caps
  // registers at 128). Chosen on the card among 8 and 16 warps, one and two
  // blocks an SM, and 16 to 128 rows by 16 to 64 columns (float32).
#define MPO_BWD(D, BR, BC, WK, NW, MINB)                                                       \
  launch_bwd<T, D, BR, BC, WK, NW, MINB>(q_, k_, v_, dout_, mask, out, m, l, delta, dq_, dk_, \
                                         dv_, B, H, L, scale, s)
  switch (DH) {
    case 16: return MPO_BWD(16, 128, 32, 1, 8, 2);
    case 32: return MPO_BWD(32, 128, 32, 1, 8, 2);
    case 64: return MPO_BWD(64, 64, 64, 1, 8, 2);
    case 128: return MPO_BWD(128, 64, 64, 1, 8, 1);
    case 256: return MPO_BWD(256, 64, 32, 1, 8, 1);
    case 512: return MPO_BWD(512, 32, 16, 4, 8, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MPO_BWD
}

}  // namespace

extern "C" {

// q, k, v, dout (in) and dq, dk, dv (out): [B, H, L, DH] views with unit
// stride on DH; st holds their (batch, head, position) strides in values, in
// that order (21 values), each a multiple of 16 bytes; bases 16-byte aligned.
// mask [B, L] bool or NULL. out [B, L, H, DH] and m, l, delta [B, H, L]
// (float32) contiguous; delta is scratch the call fills. DH in {16, 32, 64,
// 128, 256, 512}; B * H <= 65535; B * H * L / 8 < 2^31.
int mpo_flash_bwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                  const float* out, const float* m, const float* l, const float* dout,
                  float* delta, float* dq, float* dk, float* dv, int B, int H, int L, int DH,
                  const long long* st, float scale, void* stream) {
  return flash_bwd<float>(q, k, v, mask, out, m, l, dout, delta, dq, dk, dv, B, H, L, DH, st,
                          scale, stream);
}

// The same in bfloat16: q, k, v, out, dout, dq, dk, dv bfloat16; m, l and
// delta float32.
int mpo_flash_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const uint8_t* mask, const __nv_bfloat16* out, const float* m,
                       const float* l, const __nv_bfloat16* dout, float* delta,
                       __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H,
                       int L, int DH, const long long* st, float scale, void* stream) {
  return flash_bwd<__nv_bfloat16>(q, k, v, mask, out, m, l, dout, delta, dq, dk, dv, B, H, L,
                                  DH, st, scale, stream);
}

}  // extern "C"
