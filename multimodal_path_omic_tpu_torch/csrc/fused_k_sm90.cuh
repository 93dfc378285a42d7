// The bfloat16 fuse-K co-attention pair on Hopper's warpgroup MMA (wgmma,
// sm_90a): the forward in both forms (fk_fwd_wg_kernel, launched by
// csrc/coattn.cu) and the backward (fk_bwd_wg_kernel and dwk_wg_kernel,
// launched by csrc/coattn_bwd.cu) at (E, F) in {128, 256}^2 and (512, 512)
// (ops/coattn.py BF16_EF). They replace, in bfloat16, the Pallas kernels the
// float32 instances of csrc/coattn.cu and csrc/coattn_bwd.cu replace
// (multimodal_path_omic_tpu/ops/coattn.py _make_fwd_kernel and
// _make_bwd_kernel with fuse_k=True, pre_gate=True), and compute what they
// compute from bfloat16 q, kv, wk, bk (ops/coattn.py:136-158, 190, 461-503):
// k = kv wk + bk summed in float32 and rounded to bfloat16; q.k and
// tanh(q).tanh(k) float32 sums of exact bfloat16 products (tanh rounded to
// bfloat16); p float32 and o += p kv in float32; in the backward dk float32
// and its products with wk and kv accurate to float32.
//
// What bounds them on an H100: the projection k = kv wk is 2 B M F E
// operations over the computed key tiles (34 GFLOP at B = 32, M = 8192,
// E = F = 256, 0.035 ms at 989 TFLOP/s in bfloat16; 137 GFLOP at 512), the
// backward's function adds dk wk^T and kv^T dk (three such products), against
// 134 MB of kv read in bfloat16 (0.04 ms): near balance. This design adds
// to the backward two products (dk in two bfloat16 parts) and the dk
// scratch's round trip (537 MB at E = 256). The float32-tile design they
// replace ran at a tenth of the bound (TF32 mma.sync on widened copies, wk
// re-streamed every tile).
//
// Design: one block an SM of two warpgroups (256 threads) walks an even
// share of the computed 64-key tiles (fused_k_common.cuh: the tile flags and
// list, skipped tiles, a bag without a valid key computes every tile), one
// unit at a time; the Philox dropout counters, the per-(block, bag) partials
// and their fixed-order merges (combine_kernel, bwd_reduce_kernel) are the
// float32 instances'. Warpgroup w owns k columns [w E / 2, (w + 1) E / 2).
//  * Operands in shared memory are bfloat16 in flash_sm90.cuh's swizzled
//    tiles, filled by cp.async and read by wgmma descriptors; one layout
//    serves a tile read K-major and MN-major, so no tile is transposed.
//  * E, F <= 256: wk [F][E] is loaded once a block and stays resident (at
//    most 128 KB): B of the projection read MN-major, B of dk wk^T read
//    K-major. The kv tile [64][F] is A of the projection (K-major), of dp =
//    kv dO^T and, read MN-major, of z^T = kv^T da^T. The forward keeps two kv
//    tiles (the next one lands during this one); the backward one, whose
//    next tile is fetched during the dkv product.
//  * E = F = 512: wk (512 KB) streams in steps of 32 depths: a kv slice
//    [64][32] and a wk slice [32][512] a step through a three-slot ring,
//    issued two steps ahead across units (the float32 design's ring, on
//    bfloat16 bytes); the backward's dkv product takes wk's rows in [256][64]
//    steps through the same ring. Each warpgroup's k is 64 x 256 float32 (128
//    registers a thread): the columns are split over the two warpgroups
//    rather than chunked, so that k is formed once and its score partials
//    are summed once. The o += p kv rows (forward) and z's kv rows (backward)
//    are read from L2, where the ring has just passed them.
//  * Projection: wgmma m64nNk16 (N = E / 2), A = the kv tile, B = wk,
//    float32 sums in registers, 16 depths a step in depth order; then + bk
//    and rounded to bfloat16 (finish_k). The backward recomputes k with the
//    same device functions in the same order, so its scores are the
//    forward's bit for bit and p meets the forward's (l, m).
//  * Scores from registers (tile_scores): k's accumulator fragments are the
//    A operand of wgmma m64n8k16 against q [8][E] (K-major, zero rows past
//    N): q.k; then tanh of the same fragments, rounded to bfloat16, against
//    tanh(q): u. Each warpgroup's partial sums (its E half) meet in shared
//    memory and are added in warpgroup order by both kernels. k never
//    reaches shared memory in the forward.
//  * Forward: one warp a query runs the mask, the online softmax and the
//    training form's dropout, ssq and sumw; o += p kv on the CUDA cores (2 N
//    F operations a key, p float32: no product rounds p).
//  * Backward: dp = kv dO^T rides the projection (warpgroup 0). ds, da and
//    du per (query, key) on the CUDA cores (a bag's sum of da by warp
//    reductions), then as two bfloat16 parts (hi = bf16(x), lo = bf16(x -
//    hi)) the B operands of dqu^T += tanh(k)^T du^T (tanh(k) stored [64][E]
//    for it) and, E <= 256, z^T += kv^T da^T (E = 512: z on the CUDA cores
//    from L2); dq = scale (z wk + sum(da) bk) + (1 - tanh(q)^2) dqu when a
//    block leaves a bag (dq's k term taken off the key axis, as the float32
//    instance does). dkv = dk wk^T + pd^T dO: warpgroup w owns dkv's F
//    columns [w F / 2, ...) over all of E (E = 512: two passes of 128
//    columns, wk's rows streamed through the ring in [256][64] steps); dk is
//    formed 64 E columns a block by both warpgroups, every key: x = du^T
//    tanh(q) (wgmma, A = du's parts [keys x 16 queries], B = tanh(q) read
//    MN-major), x *= 1 - tanh(k)^2, x += (scale da)^T q (wgmma), all float32;
//    x is split into hi + lo bfloat16 parts, the A registers of the block's
//    four dkv steps: |dk - hi - lo| <= 2^-16 |dk|, where the float32
//    instance's two TF32 parts keep 2^-22; dkv and dwk are rounded to
//    bfloat16 afterwards, whose own rounding is 2^-9. pd^T dO joins the same
//    sums (A = pd's parts, B = dO read MN-major). No dk tile is stored and no
//    partial sums are exchanged; warpgroup 0 writes dk's parts to the
//    scratch [B, M, E] (hi, then lo, in the float32 scratch's bytes).
//  * dwk_wg_kernel: dwk = kv^T dk split-K over the listed units, one block a
//    (256 x 128 tile of dwk, 128 x 128 at F = 128; share of the list), kv
//    [64][256] and the dk parts [64][128] staged by cp.async in two stages,
//    A = kv read MN-major, B = the dk parts MN-major (wgmma with both
//    transpose bits); the blocks of the first F rows also sum dbk =
//    colsum(hi + lo). Each block writes one partial; bwd_reduce_kernel sums
//    them in a fixed order.
//  * A product with k = 16 queries (the backward's dk and pd^T dO) reads the
//    [8][W] q and tanh(q) tiles with a zero 8-row stride (desc_mn8): k
//    8..15 meet A's zero columns; dO has a [16][F] tile with zero rows.
//
// Accumulator layout (flash_sm90.cuh): warp q of a warpgroup, g = lane / 4,
// t = lane % 4: d[4j + 2h + e] = (row 16 q + g + 8 h, column 8 j + 2 t + e).

#pragma once

#include "flash_sm90.cuh"
#include "fused_k_common.cuh"

namespace mpo {
namespace fk90 {

using sm90::bf16;

constexpr int NTH = THREADS;   // two warpgroups
constexpr int PS = FK_BM + 4;  // row stride of the per-(query, key) float arrays

// ---------------------------------------------------------------------------
// Shared-memory geometry and access
// ---------------------------------------------------------------------------

template <int E, int F>
struct Geo {
  static constexpr bool WIDE = E > 256;                 // E = F = 512: wk streams
  static constexpr int EW = E / 2;                      // k (and dk) columns a warpgroup
  static constexpr int CD = 32;                         // WIDE: depths a projection step
  static constexpr int KV_TILE = FK_BM * F * 2;         // a whole kv tile
  static constexpr int WK_BYTES = WIDE ? 0 : F * E * 2;  // resident wk
  static constexpr int KV_SLICE = FK_BM * CD * 2;       // WIDE: a step's kv slice
  static constexpr int SLOT = KV_SLICE + CD * E * 2;    // + its wk slice
  static constexpr int RING = WIDE ? 3 * SLOT : 0;
  static constexpr int Q_TILE = NMAX * E * 2;           // q or tanh(q) [8][E]
  static constexpr int OC = F / NTH > 0 ? F / NTH : 1;  // o (z) columns a thread
  static_assert(E % 128 == 0 && F % 128 == 0 && (!WIDE || E == F), "instances");
};

// The o (forward) or z (backward, E = 512) columns of thread tid: F = 512 a
// bfloat16 pair, 2 tid and 2 tid + 1; else tid (none at F = 128 past 127).
template <int F>
__device__ __forceinline__ int own_col(int tid, int c) {
  return F == 512 ? 2 * tid + c : tid + NTH * c;
}

__device__ __forceinline__ unsigned char* sptr(unsigned char* smem, uint32_t addr) {
  return smem + (addr - sm90::smem_addr(smem));
}

// Byte offset of value (r, c) in a swizzled [ROWS][W] bfloat16 tile.
template <int ROWS, int W>
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  using S = sm90::Sw<W>;
  return S::swz((c / S::CW) * (ROWS * S::RB) + r * S::RB + (c % S::CW) * 2);
}

template <int ROWS, int W>
__device__ __forceinline__ float2 get_pair(unsigned char* smem, uint32_t tile, int r, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(sptr(smem, tile + sw_off<ROWS, W>(r, c))));
}

template <int ROWS, int W>
__device__ __forceinline__ float get_one(unsigned char* smem, uint32_t tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(sptr(smem, tile + sw_off<ROWS, W>(r, c))));
}

template <int ROWS, int W>
__device__ __forceinline__ void put_one(unsigned char* smem, uint32_t tile, int r, int c, float v) {
  *reinterpret_cast<bf16*>(sptr(smem, tile + sw_off<ROWS, W>(r, c))) = __float2bfloat16(v);
}

// The N rows of a [N][W] bfloat16 operand into the swizzled tile [ROWS][W]
// at `tile`, rows past N zero; TANH: tanh of each value, rounded to bfloat16
// (tanh(q)).
template <int ROWS, int W, bool TANH>
__device__ __forceinline__ void put_rows(unsigned char* smem, uint32_t tile,
                                         const bf16* __restrict__ src, int N) {
  using S = sm90::Sw<W>;
  constexpr int CPR = W / 8, CPB = S::CW / 8;  // 16-byte chunks a row, a block row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NTH) {
    const int n = idx / CPR, c = idx % CPR;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)n * W + 8 * c);
      if constexpr (TANH) {
        bf16* x = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __float2bfloat16(tanhf(__bfloat162float(x[i])));
      }
    }
    const uint32_t off = S::swz((c / CPB) * (ROWS * S::RB) + n * S::RB + (c % CPB) * 16);
    *reinterpret_cast<uint4*>(sptr(smem, tile + off)) = v;
  }
}

// MN-major B of a k = 16 product whose k rows 0..7 are the rows of the
// swizzled [8][W] tile at `tile` (N columns from c0, a multiple of 64): SBO
// 0 reads rows 0..7 again as k 8..15, which meet A's zero columns 8..15
// (finite values times 0).
template <int W>
__device__ __forceinline__ uint64_t desc_mn8(uint32_t tile, int c0) {
  using S = sm90::Sw<W>;
  return sm90::make_desc(tile + (c0 / S::CW) * (NMAX * S::RB), NMAX * S::RB, 0, S::MODE);
}

// The A registers of a [64 keys x 16 queries] operand from floats x[n][key]
// (queries 8.. zero), split into bfloat16 hi and lo parts, times `mul`.
__device__ __forceinline__ void nk_frags(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const float (*x)[PS], int wq, int g, int t, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wq + g + 8 * h;
    const float v0 = mul * x[2 * t][r], v1 = mul * x[2 * t + 1][r];
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h2);
    hi[h] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[h] = sm90::pack_bf16(v0 - hf.x, v1 - hf.y);
    hi[2 + h] = lo[2 + h] = 0u;
  }
}

// Keeps A registers of asynchronous products live (unmoved) until this point.
template <int K>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[i][j]));
}

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

// The pre-gated score from the scaled q.k and u = tanh(q).tanh(k), as both
// kernels form it: s = a (u + 1) / 2.
__device__ __forceinline__ float gated(float a, float u) { return a * ((u + 1.f) * 0.5f); }

// ---------------------------------------------------------------------------
// k and the scores of a 64-key tile: the device functions both kernels run
// ---------------------------------------------------------------------------

// E, F <= 256: k columns [wg E / 2, ...) = kv wk over depths 0 .. F - 1 (the
// kv tile at kvt K-major [64][F], wk resident [F][E] read MN-major). DP (the
// backward, warpgroup 0): also dp = kv dO^T [64 x 8] (dO K-major, rows 0..7
// of the [16][F] tile at dot) from the same A.
template <int E, int F, bool DP>
__device__ __forceinline__ void project_tile(float (&k)[E / 4], float (&dp)[4], uint32_t kvt,
                                             uint32_t wks, uint32_t dot, int wg) {
  sm90::wg_fence();
#pragma unroll
  for (int ks = 0; ks < F / 16; ++ks) {
    const uint64_t a = sm90::desc_k<FK_BM, F>(kvt, 0, ks);
    sm90::wgmma_ss<0, 1>(k, a, sm90::desc_mn<F, E>(wks, ks, wg * (E / 2)), ks > 0);
    if (DP && wg == 0) sm90::wgmma_ss<0, 0>(dp, a, sm90::desc_k<2 * NMAX, F>(dot, 0, ks), ks > 0);
  }
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_acc(k);
  if (DP) sm90::fence_acc(dp);
}

// E = F = 512: projection step `step` (depths 32 step ..) from a ring slot
// (kv slice K-major [64][32], then the wk slice [32][E] read MN-major); DP
// as project_tile.
template <int E, bool DP>
__device__ __forceinline__ void project_step(float (&k)[E / 4], float (&dp)[4], uint32_t slot,
                                             uint32_t dot, int step, int wg) {
  using G = Geo<E, E>;
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < G::CD / 16; ++kk) {
    const uint64_t a = sm90::desc_k<FK_BM, G::CD>(slot, 0, kk);
    const int acc = step > 0 || kk > 0;
    sm90::wgmma_ss<0, 1>(k, a, sm90::desc_mn<G::CD, E>(slot + G::KV_SLICE, kk, wg * (E / 2)), acc);
    if (DP && wg == 0)
      sm90::wgmma_ss<0, 0>(dp, a, sm90::desc_k<2 * NMAX, E>(dot, 0, step * (G::CD / 16) + kk), acc);
  }
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_acc(k);
  if (DP) sm90::fence_acc(dp);
}

// k = the product + bk, rounded to bfloat16 (columns c0 + 8 j + 2 t + e).
template <int E>
__device__ __forceinline__ void finish_k(float (&k)[E / 4], const bf16* __restrict__ bk, int c0,
                                         int t) {
#pragma unroll
  for (int j = 0; j < E / 16; ++j) {
    const float2 b2 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bk + c0 + 8 * j + 2 * t));
    k[4 * j] = rbf(k[4 * j] + b2.x);
    k[4 * j + 1] = rbf(k[4 * j + 1] + b2.y);
    k[4 * j + 2] = rbf(k[4 * j + 2] + b2.x);
    k[4 * j + 3] = rbf(k[4 * j + 3] + b2.y);
  }
}

// The warpgroup's partial scores of the tile: sa = k q^T and su = tanh(k)
// tanh(q)^T over its E half ([64 keys x 8 queries] each, m64n8 layout), k's
// fragments as the A operand; k is left holding tanh(k), rounded to
// bfloat16.
template <int E>
__device__ __forceinline__ void tile_scores(float (&k)[E / 4], uint32_t q_s, uint32_t tq_s,
                                            int wg, float (&sa)[4], float (&su)[4]) {
  constexpr int NK = E / 32, KG = NK < 8 ? NK : 8;  // steps, steps in flight
  const int kd0 = wg * NK;
#pragma unroll
  for (int g0 = 0; g0 < NK; g0 += KG) {
    uint32_t fr[KG][4];
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) sm90::a_frag(fr[kk], k, g0 + kk);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KG; ++kk)
      sm90::wgmma_rs<0>(sa, fr[kk], sm90::desc_k<NMAX, E>(q_s, 0, kd0 + g0 + kk), g0 + kk > 0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    keep_regs(fr);
    sm90::fence_acc(sa);
  }
#pragma unroll
  for (int i = 0; i < E / 4; ++i) k[i] = rbf(tanhf(k[i]));
#pragma unroll
  for (int g0 = 0; g0 < NK; g0 += KG) {
    uint32_t fr[KG][4];
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) sm90::a_frag(fr[kk], k, g0 + kk);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KG; ++kk)
      sm90::wgmma_rs<0>(su, fr[kk], sm90::desc_k<NMAX, E>(tq_s, 0, kd0 + g0 + kk), g0 + kk > 0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    keep_regs(fr);
    sm90::fence_acc(su);
  }
}

// A [64 x 8] m64n8 accumulator into rows [8][PS] of (query, key) floats.
__device__ __forceinline__ void put_nk(float (*dst)[PS], const float (&d)[4], int wq, int g,
                                       int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) dst[2 * t + e][16 * wq + g + 8 * h] = d[2 * h + e];
}

// ---------------------------------------------------------------------------
// Forward (both forms)
// ---------------------------------------------------------------------------

// Byte offsets from the 1024-aligned base.
template <int E, int F>
struct FwdSmem {
  using G = Geo<E, F>;
  static constexpr int WK = 0;                        // E, F <= 256: wk
  static constexpr int KV = G::WK_BYTES;              // E, F <= 256: two kv tiles
  static constexpr int RING = 0;                      // E = 512: the step ring
  static constexpr int Q = G::WIDE ? G::RING : KV + 2 * G::KV_TILE;
  static constexpr int TQ = Q + G::Q_TILE;
  static constexpr int PART = TQ + G::Q_TILE;         // float [2 wg][2: a, u][8][PS]
  static constexpr int P = PART + 2 * 2 * NMAX * PS * 4;  // float [8][PS]: the weights p
  static constexpr int ALPHA = P + NMAX * PS * 4;     // float [8]
  static constexpr int BYTES = 1024 + ALPHA + NMAX * 4;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// One block walks an even share of the computed (bag, tile) units in list
// order and, for each bag it visits, writes one unnormalized partial at index
// block + bag (o_part [G + B, N, F], ml_part [G + B, N, 2]; TRAIN: sq_part,
// ssq and sumw of the dropped weights), as the float32 fused_k_kernel does.
template <int E, int F, bool TRAIN>
__global__ void __launch_bounds__(NTH, 1)
fk_fwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                 const bf16* __restrict__ wk, const bf16* __restrict__ bk,
                 const uint8_t* __restrict__ mask, const int* __restrict__ list,
                 const int* __restrict__ off, float* __restrict__ o_part,
                 float* __restrict__ ml_part, float* __restrict__ sq_part,
                 const int* __restrict__ seed_ptr, uint32_t thresh, float keep_scale,
                 uint32_t bag0, int B, int N, int M, float scale) {
  using G = Geo<E, F>;
  using L = FwdSmem<E, F>;
  constexpr int OC = G::OC, NST = F / G::CD;  // o columns a thread; ring steps a unit (E = 512)
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = sm90::aligned_base(smem);
  unsigned char* sb = sptr(smem, base);
  auto part = reinterpret_cast<float (*)[2][NMAX][PS]>(sb + L::PART);
  auto ps = reinterpret_cast<float (*)[PS]>(sb + L::P);
  float* alpha_s = reinterpret_cast<float*>(sb + L::ALPHA);

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const uint32_t seed = TRAIN ? (uint32_t)seed_ptr[0] : 0u;
  auto kv_of = [&](int u) { return kv + (size_t)(u / n_tiles) * M * F; };

  // E = 512: step s of the block's sequence (NST a unit) into ring slot s % 3
  auto issue_step = [&](int s) {
    const int i = i0 + s / NST;
    if (i >= i1) return;
    const int u = list[i], c = s % NST;
    const uint32_t slot = base + L::RING + (s % 3) * G::SLOT;
    sm90::load_sw<FK_BM, G::CD, NTH>(slot, kv_of(u) + c * G::CD, F, (u % n_tiles) * FK_BM, M);
    sm90::load_sw<G::CD, E, NTH>(slot + G::KV_SLICE, wk, E, c * G::CD, F);
  };
  auto load_kv = [&](int i) {  // E, F <= 256: unit i's kv tile into tile (i - i0) % 2
    const int u = list[i];
    sm90::load_sw<FK_BM, F, NTH>(base + L::KV + ((i - i0) & 1) * G::KV_TILE, kv_of(u), F,
                                 (u % n_tiles) * FK_BM, M);
  };
  if constexpr (G::WIDE) {
    issue_step(0);
    cp_async_commit();
    issue_step(1);
    cp_async_commit();
  } else {
    sm90::load_sw<F, E, NTH>(base + L::WK, wk, E, 0, F);
    if (i0 < i1) load_kv(i0);
    cp_async_commit();
  }

  float oacc[NMAX][OC];                 // set when the first bag begins
  float m_run = NEG, l_run = 0.f;       // the softmax state of query `warp`
  float ssq_run = 0.f, sumw_run = 0.f;  // TRAIN: sums of pd^2 and pd
  int b = -1;
  auto flush = [&]() {  // the partial of bag b at index block + b
    const size_t pb = (size_t)blockIdx.x + b;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const int f = own_col<F>(tid, c);
          if (f < F) o_part[(pb * N + n) * F + f] = oacc[n][c];
        }
      }
    }
    if (warp < N && lane == 0) {
      ml_part[(pb * N + warp) * 2 + 0] = m_run;
      ml_part[(pb * N + warp) * 2 + 1] = l_run;
      if constexpr (TRAIN) {
        sq_part[(pb * N + warp) * 2 + 0] = ssq_run;
        sq_part[(pb * N + warp) * 2 + 1] = sumw_run;
      }
    }
  };

  int s = 0;  // E = 512: the block's ring step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, m0 = (u % n_tiles) * FK_BM;
    if (ub != b) {  // a new bag: flush the last one's partial, load this one's queries
      if (b >= 0) flush();
      b = ub;
      // the last unit's score products are done with the q tiles (waited; a barrier since)
      put_rows<NMAX, E, false>(smem, base + L::Q, q + (size_t)b * N * E, N);
      put_rows<NMAX, E, true>(smem, base + L::TQ, q + (size_t)b * N * E, N);
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
#pragma unroll
        for (int c = 0; c < OC; ++c) oacc[n][c] = 0.f;
      m_run = NEG;
      l_run = ssq_run = sumw_run = 0.f;
    }

    // ---- k = kv wk + bk (this warpgroup's columns), then its partial scores ----
    float k[E / 4], unused[4];
    if constexpr (G::WIDE) {
#pragma unroll 1
      for (int c = 0; c < NST; ++c, ++s) {
        cp_async_wait<1>();
        sm90::fence_async_smem();
        __syncthreads();  // step s landed (and the q tiles are written); slot (s + 2) % 3 is free
        issue_step(s + 2);
        cp_async_commit();
        project_step<E, false>(k, unused, base + L::RING + (s % 3) * G::SLOT, 0, c, wg);
      }
    } else {
      cp_async_wait<0>();
      sm90::fence_async_smem();
      __syncthreads();  // this unit's kv tile (and wk) landed, the q tiles written; the other tile is free
      if (i + 1 < i1) load_kv(i + 1);
      cp_async_commit();
      project_tile<E, F, false>(k, unused, base + L::KV + ((i - i0) & 1) * G::KV_TILE,
                                base + L::WK, 0, wg);
    }
    finish_k<E>(k, bk, wg * G::EW, t);
    float sa[4], su[4];
    tile_scores<E>(k, base + L::Q, base + L::TQ, wg, sa, su);
    put_nk(part[wg][0], sa, wq, g, t);
    put_nk(part[wg][1], su, wq, g, t);
    __syncthreads();

    // ---- the two halves' sums, pre-gate, mask, online softmax: one warp a query ----
    if (warp < N) {
      float sv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, key = m0 + r;
        const float a = (part[0][0][warp][r] + part[1][0][warp][r]) * scale;
        const float x = gated(a, part[0][1][warp][r] + part[1][1][warp][r]);
        const bool exists = key < M;  // keys past M do not exist: weight exactly 0
        const bool valid = exists && (mask == nullptr || mask[(size_t)b * M + key]);
        sv[h] = !exists ? -INFINITY : (valid ? x : NEG);
      }
      const float m_new = fmaxf(m_run, warp_max(fmaxf(sv[0], sv[1])));
      const float alpha = expf(m_run - m_new);
      float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      l_run = l_run * alpha + warp_sum(p0 + p1);
      m_run = m_new;
      if constexpr (TRAIN) {
        if (thresh != 0u) {
          const uint32_t key = (uint32_t)(m0 + lane);
          p0 = dropout_bits(seed, bag0 + b, warp, key) >= thresh ? p0 * keep_scale : 0.f;
          p1 = dropout_bits(seed, bag0 + b, warp, key + 32u) >= thresh ? p1 * keep_scale : 0.f;
        }
        ssq_run = ssq_run * (alpha * alpha) + warp_sum(p0 * p0 + p1 * p1);
        sumw_run = sumw_run * alpha + warp_sum(p0 + p1);
      }
      ps[warp][lane] = p0;
      ps[warp][lane + 32] = p1;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    // ---- o[n, f] = alpha o + sum_r p[n, r] kv[r, f] (float32; kv exact) ----
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float a = alpha_s[n];
#pragma unroll
        for (int c = 0; c < OC; ++c) oacc[n][c] *= a;
      }
    }
    if constexpr (G::WIDE) {  // the kv rows from L2 (the ring has just read them)
      const bf16* kv_t = kv + ((size_t)b * M + m0) * F + 2 * tid;
      const int rows = min(FK_BM, M - m0);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kv_t + (size_t)r * F));
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            const float p = ps[n][r];
            oacc[n][0] = fmaf(p, x.x, oacc[n][0]);
            oacc[n][1] = fmaf(p, x.y, oacc[n][1]);
          }
        }
      }
    } else if (tid < F) {  // the tile in shared memory (rows past M are 0, and so is their p)
      const uint32_t kvt = base + L::KV + ((i - i0) & 1) * G::KV_TILE;
#pragma unroll 2
      for (int r0 = 0; r0 < FK_BM; r0 += 4) {
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = get_one<FK_BM, F>(smem, kvt, r0 + j, tid);
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            const float4 p4 = *reinterpret_cast<const float4*>(&ps[n][r0]);
            oacc[n][0] = fmaf(p4.x, x[0], oacc[n][0]);
            oacc[n][0] = fmaf(p4.y, x[1], oacc[n][0]);
            oacc[n][0] = fmaf(p4.z, x[2], oacc[n][0]);
            oacc[n][0] = fmaf(p4.w, x[3], oacc[n][0]);
          }
        }
      }
    }
    // ps, alpha_s and part are rewritten after the next unit's first barrier
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
}

template <int E, int F, bool TRAIN>
int launch_fwd(const bf16* q, const bf16* kv, const bf16* wk, const bf16* bk,
               const uint8_t* mask, const int* list, const int* off, float* o_part,
               float* ml_part, float* sq_part, const int* seed, uint32_t thresh, float keep_scale,
               uint32_t bag0, int B, int N, int M, int blocks, float scale, cudaStream_t st) {
  static bool allowed[64] = {};
  constexpr int smem = FwdSmem<E, F>::BYTES;
  const int err = allow_dynamic_smem(fk_fwd_wg_kernel<E, F, TRAIN>, smem, allowed);
  if (err) return err;
  fk_fwd_wg_kernel<E, F, TRAIN><<<blocks, NTH, smem, st>>>(q, kv, wk, bk, mask, list, off,
                                                            o_part, ml_part, sq_part, seed,
                                                            thresh, keep_scale, bag0, B, N, M,
                                                            scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Byte offsets from the 1024-aligned base.
template <int E, int F>
struct BwdSmem {
  using G = Geo<E, F>;
  static constexpr int WK = 0;            // E, F <= 256: wk
  static constexpr int KV = G::WK_BYTES;  // E, F <= 256: the kv tile
  static constexpr int RING = 0;          // E = 512: the step ring
  // tanh(k) [64][E] bfloat16; at a flush z [8][F], dqu [8][E] and the
  // warps' sums of da [8][2], float
  static constexpr int ZB = (NMAX * (E + F) + 2 * NMAX) * 4;
  static constexpr int TK_BYTES = (FK_BM * E * 2 > ZB ? FK_BM * E * 2 : ZB + 1023) / 1024 * 1024;
  static constexpr int TK = G::WIDE ? G::RING : KV + G::KV_TILE;
  static constexpr int Q = TK + TK_BYTES;
  static constexpr int TQ = Q + G::Q_TILE;
  // dO [16][F], rows past N zero: B of dp (rows 0..7, K-major) and of pd^T dO
  // (MN-major, k = 16 queries)
  static constexpr int DO = TQ + G::Q_TILE;
  static constexpr int DAH = DO + 2 * NMAX * F * 2;  // da, du as bfloat16 parts, each [8][64]
  static constexpr int DAL = DAH + 1024, DUH = DAL + 1024, DUL = DUH + 1024;
  // float [2 wg][2: a, u][8][PS]: the partial scores, then in place pd
  // ([0][0]), da ([1][0]) and du ([0][1])
  static constexpr int PART = DUL + 1024;
  static constexpr int DP = PART + 2 * 2 * NMAX * PS * 4;  // float [8][PS]
  static constexpr int STAT = DP + NMAX * PS * 4;          // float [5][8]: m, 1/l, di, dssq, dsumw
  static constexpr int BYTES = 1024 + STAT + 5 * NMAX * 4;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// Per key tile, with the forward's (l, m) and dropout bits (N queries, key r):
//   a = q.k / sqrt(E), u = tanh(q).tanh(k), g = (u + 1) / 2, s = a g (NEG
//   where masked), p = exp(s - m) / l, pd = keep p / (1 - rate), dp = dO.kv_r,
//   ds = pd dp - p di + 2 dssq pd^2 + dsumw pd (0 where masked), da = ds g,
//   du = ds a / 2; dq += da k / sqrt(E) + (1 - tanh(q)^2) (du tanh(k));
//   dk = da q / sqrt(E) + (1 - tanh(k)^2) (du tanh(q)); dkv = pd^T dO +
//   dk wk^T; dwk += kv^T dk, dbk += colsum(dk) (dwk_wg_kernel, from the dk
//   parts this kernel writes to dk_hi, dk_lo [B, M, E]). dq_part: a bag's dq
//   partial at index block + bag, as the float32 fused_k_bwd_kernel writes it.
// The dkv product: warpgroup w owns dkv's F columns [w F / 2, ...) over all
// of E (E = 512: in two passes of 128 columns). dk is formed 64 E columns a
// block, for every key of the tile, by both warpgroups: x = du^T tanh(q) by
// wgmma (A = du [keys x queries] in hi and lo parts, B = tanh(q) read
// MN-major), x *= 1 - tanh(k)^2 (tanh(k) from the TK tile), x += (scale
// da)^T q by wgmma; x is split into the hi and lo A registers of the block's
// four dkv steps (warpgroup 0 also writes them to the scratch): no dk tile is
// stored and no partial sums are exchanged.
template <int E, int F>
__global__ void __launch_bounds__(NTH, 1)
fk_bwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                 const bf16* __restrict__ wk, const bf16* __restrict__ bk,
                 const uint8_t* __restrict__ mask, const int* __restrict__ seed_ptr,
                 uint32_t thresh, float keep_scale, uint32_t bag0, const bf16* __restrict__ dout,
                 const float* __restrict__ l, const float* __restrict__ m,
                 const float* __restrict__ di, const float* __restrict__ dssq,
                 const float* __restrict__ dsumw, bf16* __restrict__ dkv,
                 bf16* __restrict__ dk_hi, bf16* __restrict__ dk_lo,
                 const int* __restrict__ list, const int* __restrict__ off,
                 float* __restrict__ dq_part, int B, int N, int M, float scale) {
  using G = Geo<E, F>;
  using L = BwdSmem<E, F>;
  constexpr int EW = G::EW, OC = G::OC;
  constexpr int NP = G::WIDE ? 2 : 1;           // dkv passes
  constexpr int NC = F / 2 / NP;                // dkv columns a warpgroup a pass
  constexpr int NB = E / 64;                    // dk blocks of 64 E columns
  constexpr int CD = G::CD;                     // E = 512: depths a projection step
  constexpr int NPS = F / CD;                   // E = 512: projection steps a unit
  constexpr int NST = NPS + NP * NB;            // E = 512: ring steps a unit (then dkv)
  constexpr int ZM = G::WIDE ? 1 : F / 128;     // E, F <= 256: z^T m-blocks a warpgroup
  constexpr int QM = E / 128;                   // dqu^T m-blocks a warpgroup
  constexpr int CE = (E + NTH - 1) / NTH;       // E columns a thread at a flush
  static_assert(!G::WIDE || 2 * NC * 64 * 2 <= G::SLOT, "a dkv step's wk rows fit a ring slot");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = sm90::aligned_base(smem);
  unsigned char* sb = sptr(smem, base);
  auto part = reinterpret_cast<float (*)[2][NMAX][PS]>(sb + L::PART);
  auto dps = reinterpret_cast<float (*)[PS]>(sb + L::DP);
  auto stat = reinterpret_cast<float (*)[NMAX]>(sb + L::STAT);
  float* xs = reinterpret_cast<float*>(sb + L::TK);  // the TK region as floats (a flush)

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  auto kv_of = [&](int u) { return kv + (size_t)(u / n_tiles) * M * F; };

  // E = 512: ring step s of the block's sequence into slot s % 3; NST a unit:
  // NPS projection steps (kv slice [64][CD] and wk slice [CD][E]), then for
  // each dkv pass p and dk block cb the wk rows of both warpgroups' columns
  // (rows [w F / 2 + p NC, + NC), w = 0, 1) at E columns 64 cb .. ([2 NC][64],
  // read K-major)
  auto issue_step = [&](int s) {
    const int i = i0 + s / NST;
    if (i >= i1) return;
    const int u = list[i], c = s % NST;
    const uint32_t slot = base + L::RING + (s % 3) * G::SLOT;
    if (c < NPS) {
      sm90::load_sw<FK_BM, CD, NTH>(slot, kv_of(u) + c * CD, F, (u % n_tiles) * FK_BM, M);
      sm90::load_sw<CD, E, NTH>(slot + G::KV_SLICE, wk, E, c * CD, F);
    } else {
      const int p = (c - NPS) / NB, cb = (c - NPS) % NB;
#pragma unroll
      for (int w = 0; w < 2; ++w)
        sm90::load_sw<NC, 64, NTH>(slot + w * NC * 128, wk + 64 * cb, E, w * (F / 2) + p * NC, F);
    }
  };
  auto load_kv = [&](int i) {  // E, F <= 256: unit i's kv tile
    const int u = list[i];
    sm90::load_sw<FK_BM, F, NTH>(base + L::KV, kv_of(u), F, (u % n_tiles) * FK_BM, M);
  };
  if constexpr (G::WIDE) {
    issue_step(0);
    cp_async_commit();
    issue_step(1);
    cp_async_commit();
  } else {
    sm90::load_sw<F, E, NTH>(base + L::WK, wk, E, 0, F);
    if (i0 < i1) load_kv(i0);
    cp_async_commit();
  }

  // the current bag's column sums: z^T = kv^T da^T (E, F <= 256: m64n8
  // accumulators of m-blocks wg + 2x; E = 512: column owners), dqu^T =
  // tanh(k)^T du^T (m-blocks wg + 2x), and the warp's sums of da (lane 0:
  // queries warp / 2 and warp / 2 + 4)
  float zacc[ZM][4], zc[OC][NMAX], dqa[QM][4], sdw[2];
  auto zero_bag = [&]() {
#pragma unroll
    for (int x = 0; x < ZM; ++x) sm90::zero_acc(zacc[x]);
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int n = 0; n < NMAX; ++n) zc[c][n] = 0.f;
#pragma unroll
    for (int x = 0; x < QM; ++x) sm90::zero_acc(dqa[x]);
    sdw[0] = sdw[1] = 0.f;
  };
  int b = -1;
  // dq of bag b: scale (z wk + sum(da) bk) + (1 - tanh(q)^2) dqu, into
  // partial block + b; z, dqu and the sums of da meet in the TK region
  auto flush = [&]() {
    __syncthreads();  // the last unit is done with the TK region
    float* zs = xs;                 // [8][F]
    float* dqs = zs + NMAX * F;     // [8][E]
    float* sws = dqs + NMAX * E;    // [8 warps][2]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * t + e, r = 16 * wq + g + 8 * h;
        if constexpr (!G::WIDE) {
#pragma unroll
          for (int x = 0; x < ZM; ++x) zs[n * F + 64 * (wg + 2 * x) + r] = zacc[x][2 * h + e];
        }
#pragma unroll
        for (int x = 0; x < QM; ++x) dqs[n * E + 64 * (wg + 2 * x) + r] = dqa[x][2 * h + e];
      }
    if constexpr (G::WIDE) {
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int n = 0; n < NMAX; ++n) zs[n * F + own_col<F>(tid, c)] = zc[c][n];
    }
    if (lane == 0) {
      sws[2 * warp] = sdw[0];
      sws[2 * warp + 1] = sdw[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < CE; ++h) {
      const int col = tid + NTH * h;
      if (col < E) {
        float v[NMAX];
#pragma unroll
        for (int n = 0; n < NMAX; ++n) v[n] = 0.f;
#pragma unroll 8
        for (int f = 0; f < F; ++f) {  // wk from shared memory where it is resident
          const float w = G::WIDE ? __bfloat162float(wk[(size_t)f * E + col])
                                  : get_one<F, E>(smem, base + L::WK, f, col);
#pragma unroll
          for (int n = 0; n < NMAX; ++n)
            if (n < N) v[n] = fmaf(zs[n * F + f], w, v[n]);
        }
        const float bkv = __bfloat162float(bk[col]);
        float* dst = dq_part + ((size_t)blockIdx.x + b) * N * E;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            // sum(da) of query n: warps 2 (n % 4) and 2 (n % 4) + 1, pass n / 4
            const int w0 = 2 * (n % 4), it = n / 4;
            const float sda = sws[2 * w0 + it] + sws[2 * (w0 + 1) + it];
            const float tq = get_one<NMAX, E>(smem, base + L::TQ, n, col);
            dst[n * E + col] = scale * (v[n] + sda * bkv) + (1.f - tq * tq) * dqs[n * E + col];
          }
        }
      }
    }
    __syncthreads();  // the TK region and the q tiles are read before they are rewritten
  };

  int s = 0;  // E = 512: the block's ring step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, m0 = (u % n_tiles) * FK_BM;
    if (ub != b) {  // a new bag: flush the last one's dq partial, load this one's rows
      if (b >= 0) flush();
      b = ub;
      put_rows<NMAX, E, false>(smem, base + L::Q, q + (size_t)b * N * E, N);
      put_rows<NMAX, E, true>(smem, base + L::TQ, q + (size_t)b * N * E, N);
      put_rows<2 * NMAX, F, false>(smem, base + L::DO, dout + (size_t)b * N * F, N);
      if (tid < N) {
        const size_t bn = (size_t)b * N + tid;
        const float lv = l[bn];
        stat[0][tid] = m[bn];
        stat[1][tid] = lv == 0.f ? 1.f : 1.f / lv;
        stat[2][tid] = di[bn];
        stat[3][tid] = dssq != nullptr ? dssq[bn] : 0.f;
        stat[4][tid] = dsumw != nullptr ? dsumw[bn] : 0.f;
      }
      zero_bag();
    }
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * M;

    // ---- k = kv wk + bk as the forward computes it; dp = kv dO^T (warpgroup 0) ----
    float k[E / 4], dp[4];
    if constexpr (G::WIDE) {
#pragma unroll 1
      for (int c = 0; c < NPS; ++c, ++s) {
        cp_async_wait<1>();
        sm90::fence_async_smem();
        __syncthreads();  // step s landed (and the bag's tiles are written); slot (s + 2) % 3 is free
        issue_step(s + 2);
        cp_async_commit();
        project_step<E, true>(k, dp, base + L::RING + (s % 3) * G::SLOT, base + L::DO, c, wg);
      }
    } else {
      cp_async_wait<0>();
      sm90::fence_async_smem();
      __syncthreads();  // this unit's kv tile (and wk) landed, the bag's tiles written
      project_tile<E, F, true>(k, dp, base + L::KV, base + L::WK, base + L::DO, wg);
    }
    finish_k<E>(k, bk, wg * EW, t);
    float sa[4], su[4];
    tile_scores<E>(k, base + L::Q, base + L::TQ, wg, sa, su);  // k now holds tanh(k)
    put_nk(part[wg][0], sa, wq, g, t);
    put_nk(part[wg][1], su, wq, g, t);
    if (wg == 0) put_nk(dps, dp, wq, g, t);
    // tanh(k) into the TK tile [64][E]: A of the dqu^T product, and dk's
#pragma unroll
    for (int j = 0; j < EW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t o = sw_off<FK_BM, E>(16 * wq + g + 8 * h, wg * EW + 8 * j + 2 * t);
        *reinterpret_cast<__nv_bfloat162*>(sptr(smem, base + L::TK + o)) =
            __floats2bfloat162_rn(k[4 * j + 2 * h], k[4 * j + 2 * h + 1]);
      }
    sm90::fence_async_smem();
    __syncthreads();

    // ---- softmax / dropout / ssq / sumw backward per (query, key): warp w
    // takes query w / 2 + 4 p, keys 32 (w % 2) .. + 31, in pass p ----
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + NTH * p, n = idx / FK_BM, r = idx % FK_BM, key = m0 + r;
      float pd = 0.f, da = 0.f, du = 0.f;
      if (n < N && key < M) {  // keys past M do not exist: p = 0
        const bool valid = mask_b == nullptr || mask_b[key];
        const float a = (part[0][0][n][r] + part[1][0][n][r]) * scale;
        const float uu = part[0][1][n][r] + part[1][1][n][r];
        const float gg = (uu + 1.f) * 0.5f;
        const float sc = valid ? gated(a, uu) : NEG;
        const float pr = expf(sc - stat[0][n]) * stat[1][n];
        pd = pr;
        if (thresh != 0u)
          pd = dropout_bits(seed, bag0 + (uint32_t)b, (uint32_t)n, (uint32_t)key) >= thresh
              ? pr * keep_scale : 0.f;
        if (valid) {
          const float ds = pd * dps[n][r] - pr * stat[2][n] + 2.f * stat[3][n] * pd * pd +
                           stat[4][n] * pd;
          da = ds * gg;
          du = ds * a * 0.5f;
        }
      }
      part[0][0][n][r] = pd;
      part[1][0][n][r] = da;
      part[0][1][n][r] = du;
      const float dah = rbf(da), duh = rbf(du);
      put_one<NMAX, FK_BM>(smem, base + L::DAH, n, r, dah);
      put_one<NMAX, FK_BM>(smem, base + L::DAL, n, r, da - dah);
      put_one<NMAX, FK_BM>(smem, base + L::DUH, n, r, duh);
      put_one<NMAX, FK_BM>(smem, base + L::DUL, n, r, du - duh);
      const float ws = warp_sum(da);
      if (lane == 0) sdw[p] += ws;
    }
    sm90::fence_async_smem();
    __syncthreads();

    // ---- the bag's column sums: dqu^T += tanh(k)^T du^T, z^T += kv^T da^T ----
    sm90::wg_fence();
#pragma unroll
    for (int x = 0; x < QM; ++x)
#pragma unroll
      for (int ks = 0; ks < FK_BM / 16; ++ks) {
        const uint64_t a = sm90::desc_mn<FK_BM, E>(base + L::TK, ks, 64 * (wg + 2 * x));
        sm90::wgmma_ss<1, 0>(dqa[x], a, sm90::desc_k<NMAX, FK_BM>(base + L::DUH, 0, ks), 1);
        sm90::wgmma_ss<1, 0>(dqa[x], a, sm90::desc_k<NMAX, FK_BM>(base + L::DUL, 0, ks), 1);
      }
    if constexpr (!G::WIDE) {
#pragma unroll
      for (int x = 0; x < ZM; ++x)
#pragma unroll
        for (int ks = 0; ks < FK_BM / 16; ++ks) {
          const uint64_t a = sm90::desc_mn<FK_BM, F>(base + L::KV, ks, 64 * (wg + 2 * x));
          sm90::wgmma_ss<1, 0>(zacc[x], a, sm90::desc_k<NMAX, FK_BM>(base + L::DAH, 0, ks), 1);
          sm90::wgmma_ss<1, 0>(zacc[x], a, sm90::desc_k<NMAX, FK_BM>(base + L::DAL, 0, ks), 1);
        }
    }
    sm90::wg_commit();
    if constexpr (G::WIDE) {  // z from the kv rows in L2 (the ring has just read them)
      const bf16* kv_t = kv + ((size_t)b * M + m0) * F + 2 * tid;
      const int rows = min(FK_BM, M - m0);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kv_t + (size_t)r * F));
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            const float d = part[1][0][n][r];
            zc[0][n] = fmaf(d, x.x, zc[0][n]);
            zc[1][n] = fmaf(d, x.y, zc[1][n]);
          }
        }
      }
    }
    sm90::wg_wait<0>();
#pragma unroll
    for (int x = 0; x < QM; ++x) sm90::fence_acc(dqa[x]);
#pragma unroll
    for (int x = 0; x < ZM; ++x) sm90::fence_acc(zacc[x]);
    if constexpr (!G::WIDE) {
      __syncthreads();  // the z products are done with the kv tile
      if (i + 1 < i1) load_kv(i + 1);  // lands during the dkv product
      cp_async_commit();
    }

    // ---- dkv = dk wk^T + pd^T dO, this warpgroup's F columns ----
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      const int col0 = wg * (F / 2) + p * NC;  // this pass's first dkv column
      float d[NC / 2];
#pragma unroll 1
      for (int cb = 0; cb < NB; ++cb) {
        // dk of E columns 64 cb .. for the thread's keys, as its A registers:
        // x = du^T tanh(q), x *= 1 - tanh(k)^2, x += (scale da)^T q
        float x[32];
        uint32_t ah[4], al[4];
        nk_frags(ah, al, part[0][1], wq, g, t, 1.f);  // du^T
        sm90::wg_fence();
        sm90::wgmma_rs<1>(x, ah, desc_mn8<E>(base + L::TQ, 64 * cb), 0);
        sm90::wgmma_rs<1>(x, al, desc_mn8<E>(base + L::TQ, 64 * cb), 1);
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_acc(x);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 tk = get_pair<FK_BM, E>(smem, base + L::TK, 16 * wq + g + 8 * h,
                                                 64 * cb + 8 * j + 2 * t);
            x[4 * j + 2 * h] *= 1.f - tk.x * tk.x;
            x[4 * j + 2 * h + 1] *= 1.f - tk.y * tk.y;
          }
        {
          uint32_t a2[2][4] = {{ah[0], ah[1], ah[2], ah[3]}, {al[0], al[1], al[2], al[3]}};
          keep_regs(a2);
        }
        nk_frags(ah, al, part[1][0], wq, g, t, scale);  // (scale da)^T
        sm90::wg_fence();
        sm90::wgmma_rs<1>(x, ah, desc_mn8<E>(base + L::Q, 64 * cb), 1);
        sm90::wgmma_rs<1>(x, al, desc_mn8<E>(base + L::Q, 64 * cb), 1);
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_acc(x);
        {
          uint32_t a2[2][4] = {{ah[0], ah[1], ah[2], ah[3]}, {al[0], al[1], al[2], al[3]}};
          keep_regs(a2);
        }
        uint32_t fh[4][4], fl[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wq + g + 8 * h, c = 64 * cb + 8 * j + 2 * t;
            const float v0 = x[4 * j + 2 * h], v1 = x[4 * j + 2 * h + 1];
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
            const float2 hf = __bfloat1622float2(h2);
            const int kk = j / 2, xr = 2 * (j % 2) + h;  // a_frag's register of (j, h)
            fh[kk][xr] = *reinterpret_cast<const uint32_t*>(&h2);
            fl[kk][xr] = sm90::pack_bf16(v0 - hf.x, v1 - hf.y);
            if (wg == 0 && p == 0 && m0 + r < M) {  // the parts to the scratch, for dwk_wg_kernel
              const size_t o = ((size_t)b * M + m0 + r) * E + c;
              *reinterpret_cast<uint32_t*>(dk_hi + o) = fh[kk][xr];
              *reinterpret_cast<uint32_t*>(dk_lo + o) = fl[kk][xr];
            }
          }
        uint32_t wkb = 0;  // E = 512: wk rows of the pass's columns, E columns 64 cb ..
        if constexpr (G::WIDE) {
          cp_async_wait<1>();
          sm90::fence_async_smem();
          __syncthreads();  // step s landed; slot (s + 2) % 3 is free
          issue_step(s + 2);
          cp_async_commit();
          wkb = base + L::RING + (s % 3) * G::SLOT;
          ++s;
        }
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bd = G::WIDE ? sm90::desc_k<2 * NC, 64>(wkb, wg * NC, kk)
                                      : sm90::desc_k<F, E>(base + L::WK, col0, 4 * cb + kk);
          sm90::wgmma_rs<0>(d, fh[kk], bd, cb > 0 || kk > 0);
          sm90::wgmma_rs<0>(d, fl[kk], bd, 1);
        }
        sm90::wg_commit();
        sm90::wg_wait<0>();
        keep_regs(fh);
        keep_regs(fl);
      }
      // + pd^T dO (B = dO [16 queries][F] read MN-major)
      uint32_t ph[4], pl[4];
      nk_frags(ph, pl, part[0][0], wq, g, t, 1.f);
      sm90::wg_fence();
      sm90::wgmma_rs<1>(d, ph, sm90::desc_mn<2 * NMAX, F>(base + L::DO, 0, col0), 1);
      sm90::wgmma_rs<1>(d, pl, sm90::desc_mn<2 * NMAX, F>(base + L::DO, 0, col0), 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_acc(d);
      {
        uint32_t a2[2][4] = {{ph[0], ph[1], ph[2], ph[3]}, {pl[0], pl[1], pl[2], pl[3]}};
        keep_regs(a2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = m0 + 16 * wq + g + 8 * h;
        if (key < M) {
          bf16* dst = dkv + ((size_t)b * M + key) * F + col0 + 2 * t;
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) store2(dst + 8 * j, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
}

// dwk = kv^T dk, split-K over the listed units: block (x, y) takes the TF x
// 128 tile x of dwk (F rows f0 .., E columns e0 ..; TF = 256 where F allows,
// so that dk is read F / 256 times) over list positions [y per, (y + 1)
// per); warpgroup w its rows f0 + w TF / 2 .., in m-blocks of 64. Per unit,
// staged in shared memory: kv [64][TF] (F columns f0 ..), dk's hi and lo
// parts [64][128] (E columns e0 ..), two stages. Blocks with f0 = 0 also sum
// dbk over the same units. One partial each: dwk_part [W, F, E], dbk_part
// [W, E].
template <int F>
struct DwkCfg {
  static constexpr int TF = F >= 256 ? 256 : 128;  // F rows a block
  static constexpr int MB = TF / 128;              // m-blocks of 64 a warpgroup
  static constexpr int KV_T = FK_BM * TF * 2, DK_T = FK_BM * 128 * 2;
  static constexpr int STAGE = KV_T + 2 * DK_T;
  static constexpr int SMEM = 1024 + 2 * STAGE;
};

template <int E, int F>
__global__ void __launch_bounds__(NTH, 1)
dwk_wg_kernel(const bf16* __restrict__ kv, const bf16* __restrict__ dk_hi,
              const bf16* __restrict__ dk_lo, const int* __restrict__ list,
              const int* __restrict__ off, float* __restrict__ dwk_part,
              float* __restrict__ dbk_part, int B, int M) {
  using C = DwkCfg<F>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = sm90::aligned_base(smem);
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int f0 = (blockIdx.x / (E / 128)) * C::TF, e0 = (blockIdx.x % (E / 128)) * 128;
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.y);
  const int i0 = min(off[B], (int)blockIdx.y * per), i1 = min(off[B], i0 + per);
  const bool with_dbk = f0 == 0 && tid < 128;
  auto stage_in = [&](int i, int st) {
    const int u = list[i], bb = u / n_tiles, r0 = (u % n_tiles) * FK_BM;
    const uint32_t sp = base + st * C::STAGE;
    sm90::load_sw<FK_BM, C::TF, NTH>(sp, kv + (size_t)bb * M * F + f0, F, r0, M);
    sm90::load_sw<FK_BM, 128, NTH>(sp + C::KV_T, dk_hi + (size_t)bb * M * E + e0, E, r0, M);
    sm90::load_sw<FK_BM, 128, NTH>(sp + C::KV_T + C::DK_T, dk_lo + (size_t)bb * M * E + e0, E,
                                   r0, M);
  };
  float acc[C::MB][64], dbk = 0.f;
#pragma unroll
  for (int x = 0; x < C::MB; ++x) sm90::zero_acc(acc[x]);
  if (i0 < i1) stage_in(i0, 0);
  cp_async_commit();
  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) & 1;
    cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();  // stage st landed; stage st ^ 1 is free
    if (i + 1 < i1) stage_in(i + 1, st ^ 1);
    cp_async_commit();
    const uint32_t sp = base + st * C::STAGE, hi = sp + C::KV_T, lo = hi + C::DK_T;
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < FK_BM / 16; ++ks)
#pragma unroll
      for (int x = 0; x < C::MB; ++x) {
        const uint64_t a = sm90::desc_mn<FK_BM, C::TF>(sp, ks, 64 * (wg * C::MB + x));
        sm90::wgmma_ss<1, 1>(acc[x], a, sm90::desc_mn<FK_BM, 128>(hi, ks, 0), 1);
        sm90::wgmma_ss<1, 1>(acc[x], a, sm90::desc_mn<FK_BM, 128>(lo, ks, 0), 1);
      }
    sm90::wg_commit();
    if (with_dbk)  // rows past M are zero
      for (int r = 0; r < FK_BM; ++r)
        dbk += get_one<FK_BM, 128>(smem, hi, r, tid) + get_one<FK_BM, 128>(smem, lo, r, tid);
    sm90::wg_wait<0>();
#pragma unroll
    for (int x = 0; x < C::MB; ++x) sm90::fence_acc(acc[x]);
  }
  cp_async_wait<0>();
  float* dst = dwk_part + (size_t)blockIdx.y * F * E;
#pragma unroll
  for (int x = 0; x < C::MB; ++x)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + 64 * (wg * C::MB + x) + 16 * wq + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store2(dst + (size_t)f * E + e0 + 8 * j + 2 * t, acc[x][4 * j + 2 * h],
               acc[x][4 * j + 2 * h + 1]);
    }
  if (with_dbk) dbk_part[(size_t)blockIdx.y * E + e0 + tid] = dbk;
}

// The backward's main and dwk launches (the tile flag and list passes, and
// the reduction, are the caller's). dk_scratch: [B, M, E] float32 bytes,
// holding dk's hi parts [B, M, E] and then its lo parts.
template <int E, int F>
int launch_bwd(const bf16* q, const bf16* kv, const bf16* wk, const bf16* bk,
               const uint8_t* mask, const int* seed, uint32_t thresh, float keep_scale,
               uint32_t bag0, const bf16* dout, const float* l, const float* m,
               const float* di, const float* dssq, const float* dsumw, bf16* dkv,
               float* dk_scratch, const int* list, const int* off, float* dq_part,
               float* dwk_part, float* dbk_part, int B, int N, int M, int blocks, int wsplits,
               float scale, cudaStream_t st) {
  static bool allowed_main[64] = {}, allowed_dwk[64] = {};
  constexpr int smem = BwdSmem<E, F>::BYTES;
  int err = allow_dynamic_smem(fk_bwd_wg_kernel<E, F>, smem, allowed_main);
  if (err) return err;
  err = allow_dynamic_smem(dwk_wg_kernel<E, F>, DwkCfg<F>::SMEM, allowed_dwk);
  if (err) return err;
  bf16* dk_hi = reinterpret_cast<bf16*>(dk_scratch);
  bf16* dk_lo = dk_hi + (size_t)B * M * E;
  fk_bwd_wg_kernel<E, F><<<blocks, NTH, smem, st>>>(
      q, kv, wk, bk, mask, seed, thresh, keep_scale, bag0, dout, l, m, di, dssq, dsumw, dkv,
      dk_hi, dk_lo, list, off, dq_part, B, N, M, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dwk_wg_kernel<E, F><<<dim3((F / DwkCfg<F>::TF) * (E / 128), wsplits), NTH, DwkCfg<F>::SMEM,
                        st>>>(
      kv, dk_hi, dk_lo, list, off, dwk_part, dbk_part, B, M);
  return (int)cudaGetLastError();
}

}  // namespace fk90
}  // namespace mpo
