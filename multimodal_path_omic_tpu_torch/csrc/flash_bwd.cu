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
// The float32 instances stay on 3xTF32 mma.sync: wgmma takes TF32 operands
// K-major only, and dv += p^T dout, dk += ds^T q, dq += ds k read their B
// operands (dout, q, k as they lie, [rows][dh]) MN-major.
//
// bfloat16: the kernel rounds where the TPU kernel's dq and dkv passes do
// (flash_attention.py): s = (q k^T) * scale and p = exp(s - m) / l in
// float32, dv += round(p)^T dout, dp = dout v^T in float32, ds = p (dp -
// delta) * scale rounded to bfloat16 before dq += ds k and dk += ds^T q, and
// dq, dk, dv written in bfloat16 (delta = rowsum(out * dout) in float32 from
// the bfloat16 values). Widths 16 to 256 run the same two passes on Hopper's
// warpgroup MMA (flash_dq_wg_kernel, flash_dkv_wg_kernel; flash_sm90.cuh): a
// warpgroup of 64 rows runs its two score products (S and dP, or S^T and
// dP^T) as two wgmma groups into registers, forms p while the second runs
// and ds once it is done (the key mask read once a tile), and feeds them
// back as the register A operand of its sums (dq; dv and dk), whose B tiles
// (k; dout and q) are read MN-major from the same swizzled shared tiles the
// score products read K-major. p = 2^((s - m) log2 e - log2 l) on the exp
// unit (ex2.approx, lg2.approx: the division by l folded into the exponent).
// The column side comes in by cp.async into a ring of two or three stages.
// What bounds it: the instructions each score takes (an exponential in each
// pass, the mask, ds), then the products; at width 64 the dkv pass spills 64
// bytes under the 128 registers its four warpgroups allow. Tiles (rows a
// block x columns a step): dq pass
// 128 x 64 (width 64: 256 x 32 in four warpgroups; 256: 128 x 32), dkv pass
// 128 x 32 (64: 256 x 32); the dkv pass at width 256 holds 64 keys in two
// warpgroups, dk and dv of 64 x 256 being 256 registers a thread: warpgroup 0
// forms S^T, warpgroup 1 dP^T, they trade them through shared memory, and
// each sums one half of dk's and dv's columns. At width 512 the dq pass holds
// 64 rows in two warpgroups (dq of 64 x 512 would be 256 registers a thread):
// each forms S and dP over one depth half, the halves summed in a fixed order
// through shared memory, and sums one half of dq's columns, on 16-key tiles
// (209 KB of shared memory). The width-512 dkv pass keeps the mma.sync pass
// (bfloat16 operands, the tiles above): dk and dv of 64 keys are 2 x 64 x 512
// float32 = 256 KB, every register of an SM (65,536 of 4 bytes), and wgmma's
// row tile is 64, so no single-pass warpgroup split holds them. Two passes
// would fit (a dv pass and a dk pass, each 128 KB of sums split over two
// warpgroups) at the cost of forming S^T and p twice; not done.
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing, runs on the caller's stream.

#include "flash_sm90.cuh"

namespace {

using namespace mpo;
using sm90::bf16;

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

// ---------------------------------------------------------------------------
// bfloat16 at widths 16 .. 256: warpgroup MMA (flash_sm90.cuh)
// ---------------------------------------------------------------------------

// The dq pass: SPLIT = 1, NWG warpgroups of 64 query rows; SPLIT = 2 (two
// warpgroups, width 512), both on the same 64 rows, warpgroup w forming S and
// dP over depth half w (the halves summed in a fixed order through shared
// memory) and holding dq's columns half w. q and dout in shared memory for
// the block's life, key tiles of BC keys (K and V) in a ring of NS stages.
template <int DH, int BC, int NWG, int SPLIT, int NS>
struct DqWg {
  static constexpr int NTH = 128 * NWG, BR = 64 * NWG / SPLIT, DW = DH / SPLIT;
  static constexpr int ROWS = BR * DH * 2;  // q or dout
  static constexpr int TILE = BC * DH * 2;  // a K or V tile
  static constexpr int X_BYTES = SPLIT == 2 ? 2 * 2 * 64 * BC * 4 : 0;  // halves of S, dP
  static constexpr int SMEM_BYTES = 1024 + 2 * ROWS + NS * 2 * TILE + X_BYTES;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(SPLIT == 1 || NWG == 2, "two warpgroups split a row group");
  static_assert(BC % 16 == 0 && DW <= 256 && NS >= 2, "tiles");
};

// The dkv pass: SPLIT = 1, NWG warpgroups of 64 key rows; SPLIT = 2 (two
// warpgroups), both on the same 64 keys, warpgroup 0 forming S^T and 1 dP^T,
// exchanged through shared memory, each holding one half of dk's and dv's
// columns. k and v in shared memory for the block's life; query tiles of BC
// (q, dout, and the queries' m, l, delta) in a ring of NS stages.
template <int DH, int BC, int NWG, int SPLIT, int NS>
struct DkvWg {
  static constexpr int NTH = 128 * NWG, BR = 64 * NWG / SPLIT, DW = DH / SPLIT;
  static constexpr int ROWS = BR * DH * 2;  // k or v
  static constexpr int TILE = BC * DH * 2;  // a q or dout tile
  static constexpr int STATS = 3 * BC * 4;  // m, l, delta of a tile's queries
  static constexpr int X_BYTES = SPLIT == 2 ? 2 * 64 * BC * 4 : 0;  // S^T and dP^T
  static constexpr int SMEM_BYTES = 1024 + 2 * ROWS + NS * (2 * TILE + STATS) + X_BYTES;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(SPLIT == 1 || NWG == 2, "two warpgroups split a row group");
  static_assert(BC % 32 == 0 && DW <= 256 && NS >= 2, "tiles");
};

// The warpgroup's sums (rows row0 + 16 warp + g (+ 8), columns c0 + 8j + 2t)
// to rows < L of an output operand, in bfloat16.
template <int N>
__device__ __forceinline__ void store_acc(const float (&acc)[N], const Operand<bf16>& out, int b,
                                          int h, int row0, int c0, int L) {
  const int lane = threadIdx.x & 31;
  const int row = row0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row + 8 * hf >= L) continue;
    bf16* p = const_cast<bf16*>(out.p) + (long long)b * out.sb + (long long)h * out.sh +
              (long long)(row + 8 * hf) * out.sl + c0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) store2(p + 8 * j, acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  }
}

// dq += ds k over the valid key tiles: S = q K^T and dP = dout V^T as wgmma
// into registers, p = exp(s * scale - m) / l, ds = p (dp - delta) * scale (0
// at masked keys) rounded to bfloat16 as the A registers of dq += ds K (K
// MN-major). args as flash_bwd_kernel's dq pass.
template <int DH, int BC, int NWG, int SPLIT, int NS, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB) flash_dq_wg_kernel(const BwdArgs<bf16> a) {
  using C = DqWg<DH, BC, NWG, SPLIT, NS>;
  constexpr int NTH = C::NTH, BR = C::BR, DW = C::DW, TILE = C::TILE, NSC = BC / 2;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const uint32_t q_s = sm90::aligned_base(smem_wg);  // [BR][DH] each, swizzled
  const uint32_t do_s = q_s + C::ROWS;
  const uint32_t ring = do_s + C::ROWS;  // stage st: K at ring + 2 st TILE, V after
  // [2][2][NSC][128]: each warpgroup's half of S, then of dP, thread-major
  // (SPLIT = 2)
  float* x_s =
      reinterpret_cast<float*>(smem_wg + (ring + NS * 2 * TILE - sm90::smem_addr(smem_wg)));

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, tq = lane & 3;
  const int rg = SPLIT == 1 ? wg : 0, half = SPLIT == 1 ? 0 : wg;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int rb = blockIdx.x * BR, L = a.L;
  const bf16* q_b = a.x1.p + (long long)b * a.x1.sb + (long long)h * a.x1.sh;
  const bf16* do_b = a.x2.p + (long long)b * a.x2.sb + (long long)h * a.x2.sh;
  const bf16* k_b = a.y1.p + (long long)b * a.y1.sb + (long long)h * a.y1.sh;
  const bf16* v_b = a.y2.p + (long long)b * a.y2.sb + (long long)h * a.y2.sh;
  const uint8_t* mask_b = a.mask == nullptr ? nullptr : a.mask + (size_t)b * L;
  const size_t stat_b = ((size_t)b * a.H + h) * L;

  const int n_tiles = (L + BC - 1) / BC;
  const bool skip = mask_b != nullptr && bag_has_valid_key(mask_b, L);
  auto load_kv = [&](int tile, int stage) {
    const uint32_t kt = ring + stage * 2 * TILE;
    sm90::load_sw<BC, DH, NTH>(kt, k_b, a.y1.sl, tile * BC, L);
    sm90::load_sw<BC, DH, NTH>(kt + TILE, v_b, a.y2.sl, tile * BC, L);
  };
  sm90::load_sw<BR, DH, NTH>(q_s, q_b, a.x1.sl, rb, L);
  sm90::load_sw<BR, DH, NTH>(do_s, do_b, a.x2.sl, rb, L);
  cp_async_commit();
  int tiles[NS];  // as the forward's ring
  {
    int t = sm90::next_tile_warp<BC>(mask_b, 0, n_tiles, L, skip, lane);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tiles[s] = t;
      if (s == NS - 1) break;
      if (t < n_tiles) {
        load_kv(t, s);
        t = sm90::next_tile_warp<BC>(mask_b, t + 1, n_tiles, L, skip, lane);
      }
      cp_async_commit();
    }
  }
  // the statistics of the thread's rows g and g + 8 (identity past L)
  const int r = rb + 64 * rg + 16 * (wt >> 5) + (lane >> 2);
  float m_r[2], lg2l_r[2], d_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool ok = r + 8 * hf < L;
    m_r[hf] = ok ? a.m[stat_b + r + 8 * hf] : 0.f;
    lg2l_r[hf] = ok ? sm90::lg2_fast(a.l[stat_b + r + 8 * hf]) : 0.f;
    d_r[hf] = ok ? a.delta[stat_b + r + 8 * hf] : 0.f;
  }

  float dq[DW / 2];
  sm90::zero_acc(dq);
  for (int it = 0; tiles[0] < n_tiles; ++it) {
    const int c0 = tiles[0] * BC, st = it % NS;
    cp_async_wait<NS - 2>();
    sm90::fence_async_smem();
    __syncthreads();  // this tile's stage landed; the last step's stage is free
    {
      const int tn = tiles[NS - 1];
      if (tn < n_tiles) load_kv(tn, (it + NS - 1) % NS);
      cp_async_commit();
#pragma unroll
      for (int s = 0; s < NS - 1; ++s) tiles[s] = tiles[s + 1];
      tiles[NS - 1] =
          tn < n_tiles ? sm90::next_tile_warp<BC>(mask_b, tn + 1, n_tiles, L, skip, lane) : tn;
    }
    const uint32_t kt = ring + st * 2 * TILE, vt = kt + TILE;

    // ---- S = q K^T, dP = dout V^T (the warpgroup's depth): two groups, p
    // formed while dP runs (SPLIT = 2: both, then the halves summed) ----
    float s[NSC], dp[NSC];
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < DW / 16; ++ks) {
      const int kd = half * (DW / 16) + ks;
      sm90::wgmma_ss(s, sm90::desc_k<BR, DH>(q_s, 64 * rg, kd), sm90::desc_k<BC, DH>(kt, 0, kd),
                     ks);
    }
    sm90::wg_commit();
#pragma unroll
    for (int ks = 0; ks < DW / 16; ++ks) {
      const int kd = half * (DW / 16) + ks;
      sm90::wgmma_ss(dp, sm90::desc_k<BR, DH>(do_s, 64 * rg, kd),
                     sm90::desc_k<BC, DH>(vt, 0, kd), ks);
    }
    sm90::wg_commit();
    uint32_t w[(BC + 31) / 32];
    sm90::tile_bits<BC>(w, mask_b, c0, L, lane);
    if constexpr (SPLIT == 1) {
      sm90::wg_wait<1>();
      sm90::fence_acc(s);
    } else {
      sm90::wg_wait<0>();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);
#pragma unroll
      for (int i = 0; i < NSC; ++i) {
        x_s[(wg * NSC + i) * 128 + wt] = s[i];
        x_s[((2 + wg) * NSC + i) * 128 + wt] = dp[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NSC; ++i) {
        s[i] = x_s[i * 128 + wt] + x_s[(NSC + i) * 128 + wt];
        dp[i] = x_s[(2 * NSC + i) * 128 + wt] + x_s[(3 * NSC + i) * 128 + wt];
      }
    }

    // ---- p = exp(s * scale - m) / l at valid keys (s holds it) ----
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      const uint32_t bits = sm90::col_bits(w, j, tq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = (bits >> e) & 1u;  // a valid key (so one that exists)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& x = s[4 * j + 2 * hf + e];
          x = live ? sm90::exp_over(x * a.scale - m_r[hf], lg2l_r[hf]) : 0.f;
        }
      }
    }

    // ---- ds = p (dp - delta) * scale, 0 at masked keys and past L ----
    if constexpr (SPLIT == 1) {
      sm90::wg_wait<0>();
      sm90::fence_acc(dp);
    }
#pragma unroll
    for (int i = 0; i < NSC; ++i) s[i] = s[i] * (dp[i] - d_r[(i >> 1) & 1]) * a.scale;
    uint32_t da[BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) sm90::a_frag(da[kk], s, kk);

    // ---- dq += ds K (the warpgroup's columns) ----
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      sm90::wgmma_rs(dq, da[kk], sm90::desc_mn<BC, DH>(kt, kk, half * DW), 1);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_acc(dq);
  }
  cp_async_wait<0>();
  store_acc(dq, a.out1, b, h, rb + 64 * rg, half * DW, L);
}

// dk += ds^T q and dv += round(p)^T dout over every query tile: S^T = k Q^T
// and dP^T = v dOut^T as wgmma into registers, p^T and ds^T formed there
// (the queries' m, 1/l, delta from the stage) and fed back as the A registers
// of the two sums (Q and dOut MN-major). args as flash_bwd_kernel's dkv pass.
template <int DH, int BC, int NWG, int SPLIT, int NS, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB) flash_dkv_wg_kernel(const BwdArgs<bf16> a) {
  using C = DkvWg<DH, BC, NWG, SPLIT, NS>;
  constexpr int NTH = C::NTH, BR = C::BR, DW = C::DW, TILE = C::TILE, NSC = BC / 2;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const uint32_t k_s = sm90::aligned_base(smem_wg);  // [BR][DH] each, swizzled
  const uint32_t v_s = k_s + C::ROWS;
  const uint32_t ring = v_s + C::ROWS;  // stage st: q at ring + 2 st TILE, dout after
  const uint32_t st_a = ring + NS * 2 * TILE;                      // [NS][3][BC]
  float* st_s = reinterpret_cast<float*>(smem_wg + (st_a - sm90::smem_addr(smem_wg)));
  float* x_s = st_s + NS * 3 * BC;  // [2][NSC][128]: S^T, dP^T thread-major (SPLIT = 2)

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31, tq = lane & 3;
  const int rg = SPLIT == 1 ? wg : 0, half = SPLIT == 1 ? 0 : wg;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int rb = blockIdx.x * BR, L = a.L;
  const bf16* k_b = a.x1.p + (long long)b * a.x1.sb + (long long)h * a.x1.sh;
  const bf16* v_b = a.x2.p + (long long)b * a.x2.sb + (long long)h * a.x2.sh;
  const bf16* q_b = a.y1.p + (long long)b * a.y1.sb + (long long)h * a.y1.sh;
  const bf16* do_b = a.y2.p + (long long)b * a.y2.sb + (long long)h * a.y2.sh;
  const uint8_t* mask_b = a.mask == nullptr ? nullptr : a.mask + (size_t)b * L;
  const size_t stat_b = ((size_t)b * a.H + h) * L;

  // keys all masked in a bag with a valid key: dk = dv = 0
  if (mask_b != nullptr && bag_has_valid_key(mask_b, L) &&
      !__syncthreads_or(tid < BR && rb + tid < L && mask_b[rb + tid] != 0)) {
    for (int idx = tid; idx < BR * (DH / 8); idx += NTH) {
      const int row = rb + idx / (DH / 8), c = 8 * (idx % (DH / 8));
      if (row >= L) continue;
      for (int u = 0; u < 2; ++u) {
        const Operand<bf16>& o = u == 0 ? a.out1 : a.out2;
        *reinterpret_cast<uint4*>(const_cast<bf16*>(o.p) + (long long)b * o.sb +
                                  (long long)h * o.sh + (long long)row * o.sl + c) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const int n_tiles = (L + BC - 1) / BC;
  auto load_tile = [&](int tile, int stage) {  // q, dout, and m, l, delta of the queries
    const uint32_t qt = ring + stage * 2 * TILE, sa = st_a + stage * C::STATS;
    const int c0 = tile * BC;
    sm90::load_sw<BC, DH, NTH>(qt, q_b, a.y1.sl, c0, L);
    sm90::load_sw<BC, DH, NTH>(qt + TILE, do_b, a.y2.sl, c0, L);
    for (int idx = tid; idx < 3 * BC; idx += NTH) {
      const int which = idx / BC, c = idx % BC;
      const float* src = which == 0 ? a.m : which == 1 ? a.l : a.delta;
      const bool ok = c0 + c < L;
      sm90::cp4(sa + 4 * idx, ok ? src + stat_b + c0 + c : src, ok);
    }
  };
  sm90::load_sw<BR, DH, NTH>(k_s, k_b, a.x1.sl, rb, L);
  sm90::load_sw<BR, DH, NTH>(v_s, v_b, a.x2.sl, rb, L);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }
  // the thread's keys (rows g and g + 8): valid or masked
  const int r = rb + 64 * rg + 16 * (wt >> 5) + (lane >> 2);
  bool valid_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    valid_r[hf] = r + 8 * hf < L && (mask_b == nullptr || mask_b[r + 8 * hf] != 0);

  float dk[DW / 2], dv[DW / 2];
  sm90::zero_acc(dk);
  sm90::zero_acc(dv);
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BC, st = t % NS;
    cp_async_wait<NS - 2>();
    sm90::fence_async_smem();
    __syncthreads();  // this tile's stage landed; the last step's stage is free
    if (t + NS - 1 < n_tiles) load_tile(t + NS - 1, (t + NS - 1) % NS);
    cp_async_commit();
    const uint32_t qt = ring + st * 2 * TILE, dot = qt + TILE;
    const float* sts = st_s + st * 3 * BC;

    // ---- S^T = k Q^T, dP^T = v dOut^T: two groups, p formed while dP^T
    // runs (SPLIT = 2: one each, exchanged) ----
    float s[NSC], dp[NSC];
    sm90::wg_fence();
    if (SPLIT == 1 || wg == 0) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        sm90::wgmma_ss(s, sm90::desc_k<BR, DH>(k_s, 64 * rg, ks),
                       sm90::desc_k<BC, DH>(qt, 0, ks), ks);
    }
    sm90::wg_commit();
    if (SPLIT == 1 || wg == 1) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        sm90::wgmma_ss(dp, sm90::desc_k<BR, DH>(v_s, 64 * rg, ks),
                       sm90::desc_k<BC, DH>(dot, 0, ks), ks);
    }
    sm90::wg_commit();
    if constexpr (SPLIT == 1) {
      sm90::wg_wait<1>();
      sm90::fence_acc(s);
    } else {
      sm90::wg_wait<0>();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < NSC; ++i) x_s[i * 128 + wt] = s[i];
      } else {
#pragma unroll
        for (int i = 0; i < NSC; ++i) x_s[(NSC + i) * 128 + wt] = dp[i];
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < NSC; ++i) dp[i] = x_s[(NSC + i) * 128 + wt];
      } else {
#pragma unroll
        for (int i = 0; i < NSC; ++i) s[i] = x_s[i * 128 + wt];
      }
    }

    // ---- p^T = exp(s * scale - m) / l (s holds it), 0 past L ----
    const int lim = L - c0;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tq + e;
        const bool exists = col < lim;
        const float mc = sts[col], lg2l = exists ? sm90::lg2_fast(sts[BC + col]) : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& x = s[4 * j + 2 * hf + e];
          x = exists ? sm90::exp_over((valid_r[hf] ? x * a.scale : MASK_NEG) - mc, lg2l) : 0.f;
        }
      }
    }

    // ---- ds^T = p (dp - delta) * scale, 0 at masked keys ----
    if constexpr (SPLIT == 1) {
      sm90::wg_wait<0>();
      sm90::fence_acc(dp);
    }
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dc = sts[2 * BC + 8 * j + 2 * tq + e];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf + e;
          dp[i] = valid_r[hf] ? s[i] * (dp[i] - dc) * a.scale : 0.f;
        }
      }
    }
    uint32_t pa[BC / 16][4], da[BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      sm90::a_frag(pa[kk], s, kk);
      sm90::a_frag(da[kk], dp, kk);
    }

    // ---- dv += p^T dOut, dk += ds^T Q (the warpgroup's columns) ----
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      sm90::wgmma_rs(dv, pa[kk], sm90::desc_mn<BC, DH>(dot, kk, half * DW), 1);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      sm90::wgmma_rs(dk, da[kk], sm90::desc_mn<BC, DH>(qt, kk, half * DW), 1);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_acc(dk);
    sm90::fence_acc(dv);
  }
  cp_async_wait<0>();
  store_acc(dk, a.out1, b, h, rb + 64 * rg, half * DW, L);
  store_acc(dv, a.out2, b, h, rb + 64 * rg, half * DW, L);
}

template <typename Kernel>
int launch_wg(Kernel kernel, int smem, bool (&allowed)[64], int rows, int threads,
              const BwdArgs<bf16>& args, int B, cudaStream_t stream) {
  const int err = allow_dynamic_smem(kernel, smem, allowed);
  if (err) return err;
  kernel<<<dim3((args.L + rows - 1) / rows, B * args.H), threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// The three launches of a bfloat16 backward: delta, the dq pass on warpgroup
// MMA (BCQ keys a tile, NWGQ warpgroups, SPQ sharing a row group, NSQ stages,
// MBQ blocks an SM), the dkv pass (WG_DKV: on warpgroup MMA, the same for BCK
// queries a tile; else the mma.sync pass at width 512's tiles, 32 rows x 16
// columns, four depth slices, eight warps).
template <int DH, int BCQ, int NWGQ, int SPQ, int NSQ, int MBQ, int BCK, int NWGK, int SPK,
          int NSK, int MBK, bool WG_DKV = true>
int launch_bwd_wg(const Operand<bf16>& q, const Operand<bf16>& k, const Operand<bf16>& v,
                  const Operand<bf16>& dout, const uint8_t* mask, const bf16* out,
                  const float* m, const float* l, float* delta, const Operand<bf16>& dq,
                  const Operand<bf16>& dk, const Operand<bf16>& dv, int B, int H, int L,
                  float scale, cudaStream_t stream) {
  using Q = DqWg<DH, BCQ, NWGQ, SPQ, NSQ>;
  const long long n_rows = (long long)B * H * L;
  flash_bwd_delta_kernel<bf16, DH>
      <<<(unsigned)((n_rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(dout, out, delta, H, L,
                                                                         n_rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  static bool dq_allowed[64] = {};
  const BwdArgs<bf16> dq_pass = {q, dout, k, v, mask, m, l, delta, dq, dq, H, L, scale};
  err = launch_wg(flash_dq_wg_kernel<DH, BCQ, NWGQ, SPQ, NSQ, MBQ>, Q::SMEM_BYTES, dq_allowed, Q::BR,
                  Q::NTH, dq_pass, B, stream);
  if (err) return err;
  const BwdArgs<bf16> dkv_pass = {k, v, q, dout, mask, m, l, delta, dk, dv, H, L, scale};
  if constexpr (WG_DKV) {
    using K = DkvWg<DH, BCK, NWGK, SPK, NSK>;
    static bool dkv_allowed[64] = {};
    return launch_wg(flash_dkv_wg_kernel<DH, BCK, NWGK, SPK, NSK, MBK>, K::SMEM_BYTES,
                     dkv_allowed, K::BR, K::NTH, dkv_pass, B, stream);
  } else {
    return launch_pass<bf16, DH, 32, 16, 4, 8, 1, true>(dkv_pass, B, stream);
  }
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
  // bfloat16 (width; dq pass: keys a tile, warpgroups, warpgroups sharing a
  // row group, stages, blocks an SM; dkv pass: queries a tile and the same)
#define MPO_BWD_WG(D, BCQ, NWGQ, SPQ, NSQ, MBQ, BCK, NWGK, SPK, NSK, MBK)                     \
  launch_bwd_wg<D, BCQ, NWGQ, SPQ, NSQ, MBQ, BCK, NWGK, SPK, NSK, MBK>(                        \
      q_, k_, v_, dout_, mask, out, m, l, delta, dq_, dk_, dv_, B, H, L, scale, s)
  if constexpr (IS_BF16<T>) {
    switch (DH) {
      case 16: return MPO_BWD_WG(16, 64, 2, 1, 3, 2, 32, 2, 1, 3, 2);
      case 32: return MPO_BWD_WG(32, 64, 2, 1, 3, 2, 32, 2, 1, 3, 2);
      case 64: return MPO_BWD_WG(64, 32, 4, 1, 3, 1, 32, 4, 1, 3, 1);
      case 128: return MPO_BWD_WG(128, 64, 2, 1, 2, 1, 32, 2, 1, 3, 1);
      case 256: return MPO_BWD_WG(256, 32, 2, 1, 2, 1, 32, 2, 2, 3, 1);
      // width 512: the dq pass on warpgroup MMA (two warpgroups on 64 rows,
      // 16-key tiles); dk and dv of 64 keys are 2 x 64 x 512 float32 = 256
      // KB, every register of an SM (65,536 of 4 bytes), and wgmma's row tile
      // is 64, so no single-pass warpgroup split holds them (a dv pass and a
      // dk pass would, forming S^T and p twice): the dkv pass stays on the
      // mma.sync pass above
      case 512:
        return launch_bwd_wg<512, 16, 2, 2, 2, 1, 0, 0, 0, 0, 0, false>(
            q_, k_, v_, dout_, mask, out, m, l, delta, dq_, dk_, dv_, B, H, L, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (DH) {
      case 16: return MPO_BWD(16, 128, 32, 1, 8, 2);
      case 32: return MPO_BWD(32, 128, 32, 1, 8, 2);
      case 64: return MPO_BWD(64, 64, 64, 1, 8, 2);
      case 128: return MPO_BWD(128, 64, 64, 1, 8, 1);
      case 256: return MPO_BWD(256, 64, 32, 1, 8, 1);
      case 512: return MPO_BWD(512, 32, 16, 4, 8, 1);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MPO_BWD
#undef MPO_BWD_WG
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
