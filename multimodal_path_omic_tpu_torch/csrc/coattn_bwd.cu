// Backward of the few-query co-attention for Hopper (sm_90a), float32: the
// pre-gated fuse-K form and the plain-K form; and bfloat16 instances of both
// (mpo_coattn_bwd_fused_k_bf16 below the design notes, and
// mpo_coattn_plain_bwd_bf16, described above plain_bwd_kernel).
//
// Replaces the Pallas TPU kernel of multimodal_path_omic_tpu/ops/coattn.py:
//   * mpo_coattn_bwd_fused_k <- _coattn_bwd_impl with _make_bwd_kernel(
//       fuse_k=True, pre_gate=True, emit_ssq, emit_sumw, dropout): the lean-V
//       training backward (VJP glue _coattn_fk_bwd), K3 in PERF.md.
//   * mpo_coattn_plain_bwd <- _coattn_bwd_impl with the plain K operand
//       (VJP glue _coattn_bwd): dq, dk, dv of the attention off the lean
//       routes, with or without the pre-gate, at N <= 8 queries; described
//       above plain_bwd_kernel (plain_k_bwd.cuh; past eight queries:
//       csrc/coattn_bwd_many.cu).
//
// The fuse-K form:
// Per key tile, with the forward's (l, m) and dropout bits (N queries, key r):
//   k = kv wk + bk,  a = q.k / sqrt(E),  u = tanh(q).tanh(k),  g = (u + 1) / 2,
//   s = a g (NEG where masked),  p = exp(s - m) / l,  pd = keep p / (1 - rate),
//   dp = dO.kv_r,  ds = pd dp - p di + 2 dssq pd^2 + dsumw pd (0 where masked),
//   da = ds g,  du = ds a / 2,
//   dq += da k / sqrt(E) + (1 - tanh(q)^2) (du tanh(k)),
//   dk  = da q / sqrt(E) + (1 - tanh(k)^2) (du tanh(q)),
//   dkv = pd^T dO + dk wk^T,  dwk += kv^T dk,  dbk += colsum(dk).
// di = rowsum(o dO) + 2 dssq ssq + dsumw sumw comes from the caller
// (ops/coattn.py, as JAX's _coattn_fk_bwd computes it outside the kernel).
//
// What bounds it on an H100: three [M x F] x [F x E]-sized products (k,
// dk wk^T, kv^T dk), 6 B M F E = 103 GFLOP at B=32, M=8192, E=F=256 over
// every key (412 GFLOP at E=F=512). They run on the tensor cores as 3xTF32
// mma.sync at float32 accuracy (flash_common.cuh: three TF32 products each,
// 3 x 103 GFLOP / 495 TFLOP/s = 0.62 ms), against 0.16 ms for the 0.54 GB
// the function must move: bound by operations. Key tiles without a valid key need none.
//
// Design: five launches, no atomics.
//  * fk_tiles_kernel flags the 64-key tiles to compute: with a valid key in
//    the bag, a tile without one is skipped (fused_k_common.cuh): p is
//    exactly 0 there and ds is 0 by the mask, so it adds nothing to dq, dwk
//    or dbk, and the pass writes its dkv = 0; a bag without a valid key
//    computes every tile.
//    fk_list_kernel lists the computed (bag, tile) units in order. Both are
//    in fused_k_common.cuh, shared with the forward (csrc/coattn.cu).
//  * fused_k_bwd_kernel: one block an SM; block g takes an even share of
//    the list (so a full bag and a short one cost the same per tile), 8
//    warps, each product's [64 x width] output over a 2 x 4 warp grid (32
//    rows x width / 4 columns a warp, two row groups sharing each split B
//    fragment). Per tile: k = kv wk ("acc" product: the kv tile as A, wk in
//    16-row chunks [16][E]); a, g, dp and ds of the N <= 8 queries on the
//    CUDA cores through shared memory (8 keys a warp, the dot products
//    summed by a transposing butterfly); dk over k's place; dkv = pd^T dO +
//    dk wk^T ("row" product: wk in 16-column chunks [F][16], read as they
//    lie: no transposing store). The wk chunks pass through a three-slot
//    cp.async ring, each issued two chunk steps ahead, one barrier a step;
//    the next unit's kv tile comes in slices during the dkv product (its
//    slot is free once dp and the key sums are taken). dk goes to a scratch
//    [B, M, E]. dq and dbk are column sums over a bag's tiles; a block
//    writes a bag's dq partial when it leaves the bag (dq's k term taken off
//    the key axis, sum_r da_r k_r = (sum_r da_r kv_r) wk + (sum_r da_r) bk,
//    so the block never needs k and tanh(k) at once) and dbk once.
//  * E = F = 512 (NaCAGaT big; FkWideSmem, the `WIDE` branches): the kv
//    tile [64][520] and k [64][516] together (265,216 bytes) exceed one
//    block's 232,448, so kv is not resident. It streams through the ring with
//    the wk rows, as in the forward (csrc/coattn.cu): each 8-deep step
//    brings a kv slice [64][8] and a wk slice [8][256], and the k product
//    runs in two E chunks of 256 into the whole k [64][516], which stays
//    (k, then tanh(k), then dk). dp = dO.kv_r and z = sum_r da_r kv_r read
//    the kv rows in place from L2 (the ring has just passed them). The dkv
//    product runs in two F halves of 256, its wk column chunks [256][8]
//    through the same ring. Ring 36,864 + k 132,096 + q, tq 32,768 + dout
//    16,384 + per-key rows 6,144 + stats 160 = 224,416 bytes. A thread owns
//    two E columns and two F columns of the column sums, and the products'
//    accumulators are the 256 instance's ([2][8][4] a thread): ptxas gives
//    255 registers and no spill (64 bytes of stack hold z, which the flush
//    indexes by query, as 32 bytes do at 256).
//  * dwk_kernel: dwk = kv^T dk over the listed units (split-K: no block
//    reads and writes a dwk partial per tile), one block = (a 128 x 128
//    tile of dwk, an even share of the list): kv and dk slices staged
//    [keys][128] by cp.async, two stages;
//    A = kv read column-major from its slice (acc_product_rows with TA: no
//    transposed copy), B = dk. The output tile stays in registers over the
//    share and is written once, as that block's partial.
//  * bwd_reduce_kernel sums the partials in a fixed order (dq over the
//    blocks that held the bag, dbk over blocks, dwk over shares): two runs
//    give identical gradients.

// The bfloat16 instances ((E, F) in {128, 256}^2 and (512, 512);
// mpo_coattn_bwd_fused_k_bf16) are a design of their own on Hopper's
// warpgroup MMA, fk_bwd_wg_kernel and dwk_wg_kernel in fused_k_sm90.cuh (its
// notes there): k recomputed by the forward's device functions, dk formed
// 64 columns at a time and split into two bfloat16 parts, the A registers
// against wk for dkv and, through the scratch, the B tiles against kv for
// dwk; the tile list, dropout and fixed-order reductions of the float32
// instances. q, kv, wk, bk and dO are read as bfloat16; dq and dkv written
// in bfloat16; dwk and dbk summed in float32 (the wrapper casts them to
// wk's type, as _coattn_fk_bwd does).
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing; runs on the caller's stream.

#include <type_traits>

#include "fused_k_sm90.cuh"
#include "plain_k_bwd.cuh"

namespace {

using namespace mpo;

template <int E, int F>
struct FkSmem {
  static constexpr bool WIDE = false;
  static constexpr int WC = 16;       // wk rows (k product) or columns (dkv) a chunk
  static constexpr int KVS = F + 8;   // kv tile: acc-product A, 8 mod 32
  static constexpr int KS = E + 4;    // k / tanh(k) / dk: row-product A, 4 mod 32
  static constexpr int RS = E + 4;    // wk row chunk [WC][E]: acc-product B, 4 mod 32
  static constexpr int CS = WC + 4;   // wk column chunk [F][WC]: row-product B (20: no conflict)
  static constexpr int SLOT = WC * RS > F * CS ? WC * RS : F * CS;
  static constexpr int NCF = F / WC, NCE = E / WC;  // chunks of the k and dkv products
  static constexpr int NTE = E / 32, NTF = F / 32;  // column tiles a warp (4 column quarters)
  static constexpr int GK = NTE < 4 ? NTE : 4, GD = NTF < 4 ? NTF : 4;  // tiles in flight
  static constexpr int NK = NCF, FH = F, NFH = 1;   // the k product's chunks; dkv in one pass
  static constexpr int KV_ROWS = FK_BM / NCE;       // next unit's kv rows a dkv chunk brings
  alignas(16) float kv[FK_BM][KVS];   // kv tile (zero rows past M)
  alignas(16) float k[FK_BM][KS];     // k, then tanh(k), then dk
  alignas(16) float ring[3][SLOT];    // wk chunks: a three-slot ring
  alignas(16) float q[NMAX][E];
  alignas(16) float tq[NMAX][E];
  alignas(16) float dout[NMAX][F];
  // per (query, key): a, g, dp, overwritten in place by pd, da, du
  alignas(16) float a_pd[NMAX][FK_BM];
  alignas(16) float g_da[NMAX][FK_BM];
  alignas(16) float dp_du[NMAX][FK_BM];
  float stat[5][NMAX];  // m, 1/l, di, dssq, dsumw per query
};

// E = F = 512: kv streams through the ring (see the design notes), float32
// slices 8 deep.
template <int E, int F>
struct FkWideSmem {
  static constexpr bool WIDE = true;
  static constexpr int WC = 8;                  // depth of a chunk step, both products
  static constexpr int EC = 256, NEC = E / EC;  // k product: E columns a chunk
  static constexpr int FH = 256, NFH = F / FH;  // dkv product: F columns a pass
  static constexpr int KVS = WC;                // kv slice [64][WC]: acc-product A, 8 mod 32
  static constexpr int RS = EC + 4;             // wk row slice [WC][EC]: acc-product B
  static constexpr int KS = E + 4;              // k / tanh(k) / dk: row-product A, 4 mod 32
  static constexpr int CS = WC + 4;             // wk column chunk [FH][WC]: row-product B (12: no conflict)
  static constexpr int SLOT = FK_BM * KVS + WC * RS > FH * CS ? FK_BM * KVS + WC * RS : FH * CS;
  static constexpr int NCF = F / WC, NCE = E / WC;  // chunk steps an E chunk, an F half
  static constexpr int NK = NEC * NCF;              // chunk steps of the k product
  static constexpr int NTE = EC / 32, NTF = FH / 32;
  static constexpr int GK = 4, GD = 4;
  static constexpr int KV_ROWS = 0;  // kv is not resident
  alignas(16) float ring[3][SLOT];
  alignas(16) float k[FK_BM][KS];  // k, then tanh(k), then dk
  alignas(16) float q[NMAX][E];
  alignas(16) float tq[NMAX][E];
  alignas(16) float dout[NMAX][F];
  alignas(16) float a_pd[NMAX][FK_BM];
  alignas(16) float g_da[NMAX][FK_BM];
  alignas(16) float dp_du[NMAX][FK_BM];
  float stat[5][NMAX];
};

template <int E, int F>
using FkBwdSmem = std::conditional_t<(E > 256 || F > 256), FkWideSmem<E, F>, FkSmem<E, F>>;

template <int E, int F>
__global__ void __launch_bounds__(THREADS)
fused_k_bwd_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                   const float* __restrict__ wk, const float* __restrict__ bk,
                   const uint8_t* __restrict__ mask, const int* __restrict__ seed_ptr,
                   uint32_t thresh, float keep_scale, uint32_t bag0, const float* __restrict__ dout,
                   const float* __restrict__ l, const float* __restrict__ m,
                   const float* __restrict__ di, const float* __restrict__ dssq,
                   const float* __restrict__ dsumw, float* __restrict__ dkv,
                   float* __restrict__ dk_out, const int* __restrict__ list,
                   const int* __restrict__ off, float* __restrict__ dq_part,
                   float* __restrict__ dbk_part, int B, int N, int M, float scale) {
  using S_ = FkBwdSmem<E, F>;
  constexpr bool WIDE = S_::WIDE;
  constexpr int EPT = E / 32;  // E columns per lane
  constexpr int FPT = F / 32;  // F columns per lane
  constexpr int CE = (E + THREADS - 1) / THREADS;  // E columns a column owner holds
  constexpr int CF = (F + THREADS - 1) / THREADS;  // F columns a column owner holds
  constexpr int WC = S_::WC, KS = S_::KS, RS = S_::RS, CS = S_::CS;
  constexpr int NTE = S_::NTE, NTF = S_::NTF, NCF = S_::NCF, NCE = S_::NCE;
  constexpr int NC = S_::NK + S_::NFH * NCE;  // chunk steps a unit
  extern __shared__ float4 smem4[];
  S_& S = *reinterpret_cast<S_*>(smem4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 1, wc = warp >> 1;  // the products' warp grid: rows 32 wr, quarter wc
  const int g4 = lane >> 2, t4 = lane & 3;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);

  // Chunk step s of the block's sequence into ring slot s % 3, NC a unit.
  // Narrow: NCF wk row chunks [WC][E] for k, then NCE column chunks [F][WC]
  // for dkv. WIDE: for each E chunk, NCF steps of a kv slice [64][WC] and a
  // wk row slice [WC][EC] (zero kv rows past M); then for each F half, NCE
  // wk column chunks [FH][WC].
  auto issue_chunk = [&](int s) {
    const int i = i0 + s / NC;
    if (i >= i1) return;
    const int c = s % NC;
    if constexpr (WIDE) {
      auto* slot = S.ring[s % 3];
      if (c < S_::NK) {
        const int u = list[i], f0 = (c % NCF) * WC;
        load_tile_async<FK_BM, WC, S_::KVS>(slot, kv + (size_t)(u / n_tiles) * M * F + f0, F,
                                            (u % n_tiles) * FK_BM, M);
        load_tile_async<WC, S_::EC, RS>(slot + FK_BM * S_::KVS, wk + (c / NCF) * S_::EC, E, f0, F);
      } else {
        const int c2 = c - S_::NK;
        load_tile_async<S_::FH, WC, CS>(slot, wk + (size_t)(c2 / NCE) * S_::FH * E +
                                                  (c2 % NCE) * WC, E, 0, S_::FH);
      }
    } else {
      if (c < NCF) load_tile_async<WC, E, RS>(S.ring[s % 3], wk, E, c * WC, F);
      else load_tile_async<F, WC, CS>(S.ring[s % 3], wk + (c - NCF) * WC, E, 0, F);
    }
  };
  if constexpr (!WIDE) {
    if (i0 < i1) {
      const int u = list[i0];
      load_tile_async<FK_BM, F, S_::KVS>(&S.kv[0][0], kv + (size_t)(u / n_tiles) * M * F, F,
                                         (u % n_tiles) * FK_BM, M);
    }
  }
  issue_chunk(0);
  cp_async_commit();
  issue_chunk(1);
  cp_async_commit();
  // column-owner accumulators of the current bag: thread tid owns E columns
  // tid + 256 h, h < CE (dq's tanh term) and F columns tid + 256 h, h < CF
  // (z = sum_r da_r kv_r); thread n < N owns sum_r da; dbk sums over every
  // bag of the block
  float dqu[CE][NMAX], z[CF][NMAX], sda = 0.f, dbk_acc[CE];
#pragma unroll
  for (int h = 0; h < CE; ++h) dbk_acc[h] = 0.f;
  int b = -1;
  // The bag's dq partial (partial g + b: unique per visited (block, bag)
  // pair, as both rise along the unit list); z and sda pass through S.k.
  auto flush = [&]() {
    __syncthreads();  // the last tile's dkv product is done with S.k
    float* zs = &S.k[0][0];  // [NMAX][F], then sda [NMAX]
#pragma unroll
    for (int h = 0; h < CF; ++h) {
      const int col = tid + THREADS * h;
      if (col < F)
        for (int n = 0; n < N; ++n) zs[n * F + col] = z[h][n];
    }
    if (tid < N) zs[NMAX * F + tid] = sda;
    __syncthreads();
#pragma unroll
    for (int h = 0; h < CE; ++h) {
      const int col = tid + THREADS * h;
      if (col < E) {
        float v[NMAX];
#pragma unroll
        for (int n = 0; n < NMAX; ++n) v[n] = 0.f;
        for (int f = 0; f < F; ++f) {
          const float w = wk[(size_t)f * E + col];
#pragma unroll
          for (int n = 0; n < NMAX; ++n)
            if (n < N) v[n] = fmaf(zs[n * F + f], w, v[n]);
        }
        const float bkv = bk[col];
        float* dst = dq_part + ((size_t)blockIdx.x + b) * N * E;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            const float tq = S.tq[n][col];
            dst[n * E + col] = scale * (v[n] + zs[NMAX * F + n] * bkv) + (1.f - tq * tq) * dqu[h][n];
          }
        }
      }
    }
    __syncthreads();  // zs and S.tq read before they are rewritten
  };

  int s = 0;  // the block's chunk step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, m0 = (u % n_tiles) * FK_BM;
    if (ub != b) {  // a new bag: flush the last one's dq partial, load this one's rows
      if (b >= 0) flush();
      b = ub;
      for (int j = tid; j < N * E; j += THREADS) {
        const float v = q[(size_t)b * N * E + j];
        S.q[j / E][j % E] = v;
        S.tq[j / E][j % E] = tanhf(v);
      }
      for (int j = tid; j < N * F; j += THREADS) S.dout[j / F][j % F] = dout[(size_t)b * N * F + j];
      if (tid < N) {
        const size_t bn = (size_t)b * N + tid;
        const float lv = l[bn];
        S.stat[0][tid] = m[bn];
        S.stat[1][tid] = lv == 0.f ? 1.f : 1.f / lv;
        S.stat[2][tid] = di[bn];
        S.stat[3][tid] = dssq != nullptr ? dssq[bn] : 0.f;
        S.stat[4][tid] = dsumw != nullptr ? dsumw[bn] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
#pragma unroll
        for (int h = 0; h < CE; ++h) dqu[h][n] = 0.f;
#pragma unroll
        for (int h = 0; h < CF; ++h) z[h][n] = 0.f;
      }
      sda = 0.f;
    }
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * M;
    const float* kv_t = kv + ((size_t)b * M + m0) * F;  // WIDE: the tile's kv rows, read in place
    const int rows = min(FK_BM, M - m0);
    const float* kv_next = nullptr;  // narrow: the next unit's kv tile, loaded during dkv
    int m0_next = 0;
    if (!WIDE && i + 1 < i1) {
      const int un = list[i + 1];
      kv_next = kv + (size_t)(un / n_tiles) * M * F;
      m0_next = (un % n_tiles) * FK_BM;
    }

    // ---- k tile = kv wk + bk -> S.k ----
    if constexpr (WIDE) {
#pragma unroll 1
      for (int ec = 0; ec < S_::NEC; ++ec) {
        float c[2][NTE][4];
        zero_c<NTE>(c[0]);
        zero_c<NTE>(c[1]);
#pragma unroll 1
        for (int ch = 0; ch < NCF; ++ch, ++s) {
          cp_async_wait<1>();
          __syncthreads();  // chunk s landed; slot (s + 2) % 3 is free
          issue_chunk(s + 2);
          cp_async_commit();
          const float* slot = S.ring[s % 3];
          acc_product_rows<2, NTE, WC, S_::GK>(c, slot, S_::KVS, slot + FK_BM * S_::KVS, RS,
                                               32 * wr, 8 * NTE * wc, lane);
        }
#pragma unroll
        for (int j = 0; j < NTE; ++j) {
          const int col = ec * S_::EC + 8 * NTE * wc + 8 * j + 2 * t4;
          const float b0 = bk[col], b1 = bk[col + 1];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            c[r][j][0] += b0; c[r][j][1] += b1;
            c[r][j][2] += b0; c[r][j][3] += b1;
          }
        }
        // S.k is free: the last unit's dkv product ended before this unit's
        // first step barrier
        store_c<NTE>(c[0], &S.k[0][ec * S_::EC], KS, 32 * wr, 8 * NTE * wc, lane);
        store_c<NTE>(c[1], &S.k[0][ec * S_::EC], KS, 32 * wr + 16, 8 * NTE * wc, lane);
      }
    } else {
      float c[2][NTE][4];
      zero_c<NTE>(c[0]);
      zero_c<NTE>(c[1]);
#pragma unroll 1
      for (int ch = 0; ch < NCF; ++ch, ++s) {
        if (ch == 0) cp_async_wait<0>();  // this tile's kv too
        else cp_async_wait<1>();
        __syncthreads();  // chunk s landed; slot (s + 2) % 3 is free
        issue_chunk(s + 2);
        cp_async_commit();
        acc_product_rows<2, NTE, WC, S_::GK>(c, &S.kv[0][ch * WC], S_::KVS, S.ring[s % 3], RS,
                                             32 * wr, 8 * NTE * wc, lane);
      }
#pragma unroll
      for (int j = 0; j < NTE; ++j) {
        const int col = 8 * NTE * wc + 8 * j + 2 * t4;
        const float b0 = bk[col], b1 = bk[col + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          c[r][j][0] += b0; c[r][j][1] += b1;
          c[r][j][2] += b0; c[r][j][3] += b1;
        }
      }
      store_c<NTE>(c[0], &S.k[0][0], KS, 32 * wr, 8 * NTE * wc, lane);
      store_c<NTE>(c[1], &S.k[0][0], KS, 32 * wr + 16, 8 * NTE * wc, lane);
    }
    __syncthreads();
    // ---- a = q.k * scale; tanh(k) over k; gate; dp = dO.kv (warp: 8 keys) ----
    static_assert(FK_RPW == 8, "sum8: 8 keys a warp");
    const int ri = warp * FK_RPW + sum8_index(lane);  // the key this lane's sums belong to
    const bool writer = (lane & 3) == 0;
    if constexpr (WIDE) {
      // per E chunk of 256 columns, the chunks' sums added in registers
      constexpr int EH = S_::EC, EPH = EH / 32;
      float a_acc[NMAX], u_acc[NMAX];
#pragma unroll
      for (int n = 0; n < NMAX; ++n) a_acc[n] = u_acc[n] = 0.f;
#pragma unroll 1
      for (int h = 0; h < S_::NEC; ++h) {
        float kr[FK_RPW][EPH];
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
          for (int j4 = 0; j4 < EPH / 4; ++j4) {
            const float4 v = *reinterpret_cast<const float4*>(&S.k[warp * FK_RPW + i][h * EH + j4 * 128 + 4 * lane]);
            kr[i][4 * j4] = v.x; kr[i][4 * j4 + 1] = v.y; kr[i][4 * j4 + 2] = v.z; kr[i][4 * j4 + 3] = v.w;
          }
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n >= N) break;
          float qv[EPH], p[FK_RPW];
#pragma unroll
          for (int j = 0; j < EPH; ++j) qv[j] = S.q[n][h * EH + lane_col(j, lane)];
#pragma unroll
          for (int i = 0; i < FK_RPW; ++i) {
            p[i] = 0.f;
#pragma unroll
            for (int j = 0; j < EPH; ++j) p[i] = fmaf(kr[i][j], qv[j], p[i]);
          }
          a_acc[n] += sum8(p, lane);
        }
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i) {
#pragma unroll
          for (int j = 0; j < EPH; ++j) kr[i][j] = tanhf(kr[i][j]);
#pragma unroll
          for (int j4 = 0; j4 < EPH / 4; ++j4)
            *reinterpret_cast<float4*>(&S.k[warp * FK_RPW + i][h * EH + j4 * 128 + 4 * lane]) =
                make_float4(kr[i][4 * j4], kr[i][4 * j4 + 1], kr[i][4 * j4 + 2], kr[i][4 * j4 + 3]);
        }
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n >= N) break;
          float tv[EPH], p[FK_RPW];
#pragma unroll
          for (int j = 0; j < EPH; ++j) tv[j] = S.tq[n][h * EH + lane_col(j, lane)];
#pragma unroll
          for (int i = 0; i < FK_RPW; ++i) {
            p[i] = 0.f;
#pragma unroll
            for (int j = 0; j < EPH; ++j) p[i] = fmaf(kr[i][j], tv[j], p[i]);
          }
          u_acc[n] += sum8(p, lane);
        }
      }
      if (writer) {
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n >= N) break;
          S.a_pd[n][ri] = a_acc[n] * scale;
          S.g_da[n][ri] = (u_acc[n] + 1.f) * 0.5f;
        }
      }
      // dp: the warp's 8 kv rows from L2, 128 columns at a time, for every query
      float dpa[NMAX][FK_RPW];
#pragma unroll
      for (int n = 0; n < NMAX; ++n)
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i) dpa[n][i] = 0.f;
#pragma unroll 1
      for (int j4 = 0; j4 < FPT / 4; ++j4) {
        float4 x[FK_RPW];
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i) {
          const int r = warp * FK_RPW + i;
          x[i] = r < rows ? load4(kv_t + (size_t)r * F + j4 * 128 + 4 * lane)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n >= N) break;
          const float4 d = *reinterpret_cast<const float4*>(&S.dout[n][j4 * 128 + 4 * lane]);
#pragma unroll
          for (int i = 0; i < FK_RPW; ++i)
            dpa[n][i] = fmaf(x[i].x, d.x, fmaf(x[i].y, d.y, fmaf(x[i].z, d.z, fmaf(x[i].w, d.w, dpa[n][i]))));
        }
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        const float dp = sum8(dpa[n], lane);
        if (writer) S.dp_du[n][ri] = dp;
      }
    } else {
      float kr[FK_RPW][EPT];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4) {
          const float4 v = *reinterpret_cast<const float4*>(&S.k[warp * FK_RPW + i][j4 * 128 + 4 * lane]);
          kr[i][4 * j4] = v.x; kr[i][4 * j4 + 1] = v.y; kr[i][4 * j4 + 2] = v.z; kr[i][4 * j4 + 3] = v.w;
        }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        float qv[EPT], p[FK_RPW];
#pragma unroll
        for (int j = 0; j < EPT; ++j) qv[j] = S.q[n][lane_col(j, lane)];
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i) {
          p[i] = 0.f;
#pragma unroll
          for (int j = 0; j < EPT; ++j) p[i] = fmaf(kr[i][j], qv[j], p[i]);
        }
        const float a = sum8(p, lane);
        if (writer) S.a_pd[n][ri] = a * scale;
      }
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
#pragma unroll
        for (int j = 0; j < EPT; ++j) kr[i][j] = tanhf(kr[i][j]);
#pragma unroll
        for (int j4 = 0; j4 < EPT / 4; ++j4)
          *reinterpret_cast<float4*>(&S.k[warp * FK_RPW + i][j4 * 128 + 4 * lane]) =
              make_float4(kr[i][4 * j4], kr[i][4 * j4 + 1], kr[i][4 * j4 + 2], kr[i][4 * j4 + 3]);
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        float tv[EPT], u[FK_RPW];
#pragma unroll
        for (int j = 0; j < EPT; ++j) tv[j] = S.tq[n][lane_col(j, lane)];
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i) {
          u[i] = 0.f;
#pragma unroll
          for (int j = 0; j < EPT; ++j) u[i] = fmaf(kr[i][j], tv[j], u[i]);
        }
        const float us = sum8(u, lane);
        if (writer) S.g_da[n][ri] = (us + 1.f) * 0.5f;
      }
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        float dv[FPT], p[FK_RPW];
#pragma unroll
        for (int j = 0; j < FPT; ++j) dv[j] = S.dout[n][lane_col(j, lane)];
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i) {
          p[i] = 0.f;
#pragma unroll
          for (int j4 = 0; j4 < FPT / 4; ++j4) {
            const float4 x = *reinterpret_cast<const float4*>(&S.kv[warp * FK_RPW + i][j4 * 128 + 4 * lane]);
            p[i] = fmaf(x.x, dv[4 * j4], fmaf(x.y, dv[4 * j4 + 1], fmaf(x.z, dv[4 * j4 + 2], fmaf(x.w, dv[4 * j4 + 3], p[i]))));
          }
        }
        const float dp = sum8(p, lane);
        if (writer) S.dp_du[n][ri] = dp;
      }
    }
    __syncthreads();

    // ---- softmax / dropout / ssq / sumw backward, elementwise ----
    for (int idx = tid; idx < N * FK_BM; idx += THREADS) {
      const int n = idx / FK_BM, r = idx % FK_BM, key = m0 + r;
      float pd = 0.f, da = 0.f, du = 0.f;
      if (key < M) {  // keys past M do not exist: p = 0
        const bool valid = mask_b == nullptr || mask_b[key];
        const float a = S.a_pd[n][r], g = S.g_da[n][r];
        const float s = valid ? a * g : NEG;
        const float p = expf(s - S.stat[0][n]) * S.stat[1][n];
        pd = p;
        if (thresh != 0u)
          pd = dropout_bits(seed, bag0 + (uint32_t)b, (uint32_t)n, (uint32_t)key) >= thresh
              ? p * keep_scale : 0.f;
        if (valid) {
          const float ds = pd * S.dp_du[n][r] - p * S.stat[2][n]
              + 2.f * S.stat[3][n] * pd * pd + S.stat[4][n] * pd;
          da = ds * g;
          du = ds * a * 0.5f;
        }
      }
      S.a_pd[n][r] = pd;
      S.g_da[n][r] = da;
      S.dp_du[n][r] = du;
    }
    __syncthreads();

    // ---- column-owner sums over the tile's keys ----
#pragma unroll
    for (int h = 0; h < CE; ++h) {
      const int col = tid + THREADS * h;
      if (col < E) {
        for (int r = 0; r < FK_BM; ++r) {
          const float tkv = S.k[r][col];
#pragma unroll
          for (int n = 0; n < NMAX; ++n)
            if (n < N) dqu[h][n] = fmaf(S.dp_du[n][r], tkv, dqu[h][n]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < CF; ++h) {
      const int col = tid + THREADS * h;
      if (col < F) {
        // WIDE: the kv rows from L2 (rows past M do not exist; their da is 0)
        for (int r = 0; r < (WIDE ? rows : FK_BM); ++r) {
          float x;
          if constexpr (WIDE) x = kv_t[(size_t)r * F + col];
          else x = S.kv[r][col];
#pragma unroll
          for (int n = 0; n < NMAX; ++n)
            if (n < N) z[h][n] = fmaf(S.g_da[n][r], x, z[h][n]);
        }
      }
    }
    if (tid < N)
      for (int r = 0; r < FK_BM; ++r) sda += S.g_da[tid][r];
    __syncthreads();

    // ---- dk, over tanh(k) (warp: 8 keys, lane: 4 columns of each 128) ----
#pragma unroll
    for (int j4 = 0; j4 < EPT / 4; ++j4) {
      const int c = j4 * 128 + 4 * lane;
      float4 sa[FK_RPW], su[FK_RPW];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) sa[i] = su[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n >= N) break;
        const float4 q4 = *reinterpret_cast<const float4*>(&S.q[n][c]);
        const float4 u4 = *reinterpret_cast<const float4*>(&S.tq[n][c]);
        float dav[FK_RPW], duv[FK_RPW];
#pragma unroll
        for (int h = 0; h < FK_RPW / 4; ++h) {
          const float4 a4 = *reinterpret_cast<const float4*>(&S.g_da[n][warp * FK_RPW + 4 * h]);
          const float4 b4 = *reinterpret_cast<const float4*>(&S.dp_du[n][warp * FK_RPW + 4 * h]);
          dav[4 * h] = a4.x; dav[4 * h + 1] = a4.y; dav[4 * h + 2] = a4.z; dav[4 * h + 3] = a4.w;
          duv[4 * h] = b4.x; duv[4 * h + 1] = b4.y; duv[4 * h + 2] = b4.z; duv[4 * h + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < FK_RPW; ++i) {
          sa[i].x = fmaf(dav[i], q4.x, sa[i].x); sa[i].y = fmaf(dav[i], q4.y, sa[i].y);
          sa[i].z = fmaf(dav[i], q4.z, sa[i].z); sa[i].w = fmaf(dav[i], q4.w, sa[i].w);
          su[i].x = fmaf(duv[i], u4.x, su[i].x); su[i].y = fmaf(duv[i], u4.y, su[i].y);
          su[i].z = fmaf(duv[i], u4.z, su[i].z); su[i].w = fmaf(duv[i], u4.w, su[i].w);
        }
      }
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i) {
        float4* kp = reinterpret_cast<float4*>(&S.k[warp * FK_RPW + i][c]);
        const float4 t4v = *kp;
        *kp = make_float4(scale * sa[i].x + (1.f - t4v.x * t4v.x) * su[i].x,
                          scale * sa[i].y + (1.f - t4v.y * t4v.y) * su[i].y,
                          scale * sa[i].z + (1.f - t4v.z * t4v.z) * su[i].z,
                          scale * sa[i].w + (1.f - t4v.w * t4v.w) * su[i].w);
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < CE; ++h) {
      const int col = tid + THREADS * h;
      if (col < E)
        for (int r = 0; r < FK_BM; ++r) dbk_acc[h] += S.k[r][col];
    }
    for (int idx = tid; idx < FK_BM * E / 4; idx += THREADS) {  // dk -> scratch, for dwk_kernel
      const int r = idx / (E / 4), c4 = idx % (E / 4);
      if (m0 + r < M)
        reinterpret_cast<float4*>(dk_out + ((size_t)b * M + m0 + r) * E)[c4] =
            reinterpret_cast<const float4*>(&S.k[r][0])[c4];
    }

    // ---- dkv = pd^T dO + dk wk^T (WIDE: in F halves) ----
#pragma unroll 1
    for (int fh = 0; fh < S_::NFH; ++fh) {
      const int f0 = fh * S_::FH;  // the pass's first F column
      float d[2][NTF][4];
      zero_c<NTF>(d[0]);
      zero_c<NTF>(d[1]);
      for (int n = 0; n < N; ++n) {
        float pr[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) pr[r][h] = S.a_pd[n][32 * wr + 16 * r + g4 + 8 * h];
#pragma unroll
        for (int j = 0; j < NTF; ++j) {
          const float2 dv = *reinterpret_cast<const float2*>(&S.dout[n][f0 + 8 * NTF * wc + 8 * j + 2 * t4]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              d[r][j][2 * h] = fmaf(pr[r][h], dv.x, d[r][j][2 * h]);
              d[r][j][2 * h + 1] = fmaf(pr[r][h], dv.y, d[r][j][2 * h + 1]);
            }
        }
      }
#pragma unroll 1
      for (int ch = 0; ch < NCE; ++ch, ++s) {
        cp_async_wait<1>();
        __syncthreads();  // chunk s landed; slot (s + 2) % 3 is free
        issue_chunk(s + 2);
        if constexpr (!WIDE) {
          if (kv_next != nullptr)  // a slice of the next unit's kv tile (S.kv is free now)
            load_tile_async<S_::KV_ROWS, F, S_::KVS>(&S.kv[ch * S_::KV_ROWS][0], kv_next, F,
                                                     m0_next + ch * S_::KV_ROWS, M);
        }
        cp_async_commit();
        row_product_rows<2, NTF, WC, S_::GD>(d, &S.k[0][ch * WC], KS, S.ring[s % 3], CS, 32 * wr,
                                             8 * NTF * wc, 0, lane);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = m0 + 32 * wr + 16 * r + g4 + 8 * h;
          if (key >= M) continue;
          float* dst = dkv + ((size_t)b * M + key) * F + f0 + 8 * NTF * wc + 2 * t4;
#pragma unroll
          for (int j = 0; j < NTF; ++j) store2(dst + 8 * j, d[r][j][2 * h], d[r][j][2 * h + 1]);
        }
    }
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
#pragma unroll
  for (int h = 0; h < CE; ++h) {
    const int col = tid + THREADS * h;
    if (col < E) dbk_part[(size_t)blockIdx.x * E + col] = dbk_acc[h];
  }
}

// dwk partial of one block: rows f0 .. f0+127 and columns e0 .. e0+127 of
// kv^T dk over its share of the computed units (block y of W takes list
// positions [y * per, (y + 1) * per)). 8 warps: 64 rows (four row groups) x
// 32 columns each.
constexpr int DW_T = 128;                     // dwk tile side a block
constexpr int DW_S = DW_T + 4;                // staged slice stride: 4 mod 32
constexpr int DW_STAGE = 2 * FK_BM * DW_S;    // kv slice + dk slice (floats)
constexpr int DW_SMEM = 2 * DW_STAGE * 4;     // two stages, bytes

template <int E, int F>
__global__ void __launch_bounds__(THREADS)
dwk_kernel(const float* __restrict__ kv, const float* __restrict__ dk,
           const int* __restrict__ list, const int* __restrict__ off,
           float* __restrict__ dwk_part, int B, int M) {
  extern __shared__ __align__(16) float dw_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 1, wc = warp >> 1;
  const int f0 = (blockIdx.x / (E / DW_T)) * DW_T, e0 = (blockIdx.x % (E / DW_T)) * DW_T;
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.y);
  const int i0 = min(off[B], (int)blockIdx.y * per), i1 = min(off[B], i0 + per);
  float c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) zero_c<4>(c[i]);
  auto stage_in = [&](int i, float* dst) {
    const int u = list[i], bb = u / n_tiles, r0 = (u % n_tiles) * FK_BM;
    load_tile_async<FK_BM, DW_T, DW_S>(dst, kv + (size_t)bb * M * F + f0, F, r0, M);
    load_tile_async<FK_BM, DW_T, DW_S>(dst + FK_BM * DW_S, dk + (size_t)bb * M * E + e0, E, r0, M);
  };
  if (i0 < i1) stage_in(i0, dw_smem);
  cp_async_commit();
  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage st landed; stage st ^ 1 is free
    if (i + 1 < i1) stage_in(i + 1, dw_smem + (st ^ 1) * DW_STAGE);
    cp_async_commit();
    const float* sp = dw_smem + st * DW_STAGE;
    acc_product_rows<4, 4, FK_BM, 4, true>(c, sp, DW_S, sp + FK_BM * DW_S, DW_S, 64 * wr, 32 * wc,
                                           lane);
  }
  cp_async_wait<0>();
  float* part = dwk_part + (size_t)blockIdx.y * F * E;
#pragma unroll
  for (int i = 0; i < 4; ++i) store_c<4>(c[i], part, E, f0 + 64 * wr + 16 * i, e0 + 32 * wc, lane);
}


template <int D, bool PG, typename T>
int launch_plain_bwd(const T* q, const T* k, const T* v, const uint8_t* mask,
                     const int* seed, const T* dout, const float* l, const float* m,
                     const float* di, const float* dssq, const float* dsumw, T* dq,
                     T* dk, T* dv, float* dq_part, uint8_t* flags, int* list, int* off,
                     int B, int N, int M, int max_blocks, float scale, uint32_t thresh,
                     float keep_scale, uint32_t bag0, cudaStream_t st) {
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = (int)sizeof(PkBwdSmem<D, T>);
  static_assert(smem <= 232448, "shared memory of one block");
  int err = allow_dynamic_smem(plain_bwd_kernel<D, PG, T>, smem, allowed);
  if (err) return err;
  int blocks = 0;
  err = resident_blocks(plain_bwd_kernel<D, PG, T>, smem, max_blocks, resident, &blocks);
  if (err) return err;
  launch_tile_list(mask, dk, dv, flags, list, off, B, M, D, st, false, (int)sizeof(T));
  plain_bwd_kernel<D, PG, T><<<blocks, THREADS, smem, st>>>(
      q, k, v, mask, list, off, seed, thresh, keep_scale, bag0, dout, l, m, di, dssq, dsumw, dk, dv,
      dq_part, B, N, M, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)B * N * D;
  bwd_reduce_kernel<T><<<(int)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      dq_part, nullptr, nullptr, off, dq, nullptr, nullptr, B, blocks, 0, 0, N, D, 0);
  return (int)cudaGetLastError();
}

// Both entry points of the plain-K backward: D in {128, 256, 512}, with or
// without the pre-gate.
template <typename T>
int plain_bwd(const T* q, const T* k, const T* v, const uint8_t* mask, const int* seed,
              const T* dout, const float* l, const float* m, const float* di,
              const float* dssq, const float* dsumw, T* dq, T* dk, T* dv, float* dq_part,
              uint8_t* flags, int* list, int* off, int B, int N, int M, int D, int pre_gate,
              int max_blocks, float scale, uint32_t thresh, float keep_scale, uint32_t bag0,
              void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MPO_PLAIN_BWD(D_, PG_)                                                                \
  if (D == D_ && (pre_gate != 0) == PG_)                                                      \
    return launch_plain_bwd<D_, PG_, T>(q, k, v, mask, seed, dout, l, m, di, dssq, dsumw, dq,  \
                                        dk, dv, dq_part, flags, list, off, B, N, M,           \
                                        max_blocks, scale, thresh, keep_scale, bag0, st);
  MPO_PLAIN_BWD(256, true) MPO_PLAIN_BWD(256, false) MPO_PLAIN_BWD(128, true)
  MPO_PLAIN_BWD(128, false) MPO_PLAIN_BWD(512, true) MPO_PLAIN_BWD(512, false)
#undef MPO_PLAIN_BWD
  return (int)cudaErrorInvalidValue;
}

template <int E, int F>
int launch_bwd(const float* q, const float* kv, const float* wk, const float* bk,
               const uint8_t* mask, const int* seed, uint32_t thresh, float keep_scale,
               uint32_t bag0,
               const float* dout, const float* l, const float* m, const float* di,
               const float* dssq, const float* dsumw, float* dkv, float* dk_scratch,
               uint8_t* flags, int* list, int* off, float* dq_part, float* dwk_part,
               float* dbk_part, int B, int N, int M, int blocks, int wsplits, float scale,
               cudaStream_t st) {
  static bool allowed_main[64] = {}, allowed_dwk[64] = {};
  constexpr int smem = (int)sizeof(FkBwdSmem<E, F>);
  static_assert(smem <= 232448, "shared memory of one block");
  int err = allow_dynamic_smem(fused_k_bwd_kernel<E, F>, smem, allowed_main);
  if (err) return err;
  err = allow_dynamic_smem(dwk_kernel<E, F>, DW_SMEM, allowed_dwk);
  if (err) return err;
  launch_tile_list(mask, dkv, nullptr, flags, list, off, B, M, F, st);
  fused_k_bwd_kernel<E, F><<<blocks, THREADS, smem, st>>>(
      q, kv, wk, bk, mask, seed, thresh, keep_scale, bag0, dout, l, m, di, dssq, dsumw, dkv,
      dk_scratch, list, off, dq_part, dbk_part, B, N, M, scale);
  dwk_kernel<E, F><<<dim3((F / DW_T) * (E / DW_T), wsplits), THREADS, DW_SMEM, st>>>(
      kv, dk_scratch, list, off, dwk_part, B, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Inputs as the training forward (q [B, N, E], kv [B, M, F], wk [F, E],
// bk [E], mask [B, M] bool or NULL, seed: one int32 on the device, thresh /
// keep_scale / bag0 as there) plus dout [B, N, F] and l, m, di [B, N]; dssq, dsumw
// [B, N] or NULL (zero cotangents). Out: dq [B, N, E], dkv [B, M, F],
// dwk [F, E], dbk [E]. Scratch: dk_scratch [B, M, E], flags [B * T] uint8,
// list [B * T] and off [B + 1] int32 (T = ceil(M / 64) key tiles a bag),
// dq_part [blocks + B, N, E], dbk_part [blocks, E], dwk_part [wsplits, F, E].
// E, F in {128, 256}, or E = F = 512; N <= 8.
int mpo_coattn_bwd_fused_k(const float* q, const float* kv, const float* wk, const float* bk,
                           const uint8_t* mask, const int* seed, const float* dout,
                           const float* l, const float* m, const float* di,
                           const float* dssq, const float* dsumw, float* dq, float* dkv,
                           float* dwk, float* dbk, float* dq_part, float* dwk_part,
                           float* dbk_part, float* dk_scratch, uint8_t* flags, int* list,
                           int* off, int B, int N, int M, int F, int E, int blocks, int wsplits,
                           float scale, uint32_t thresh, float keep_scale, uint32_t bag0,
                           void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || blocks < 1 || wsplits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
#define MPO_BWD(E_, F_)                                                                    \
  if (E == E_ && F == F_)                                                                  \
    err = launch_bwd<E_, F_>(q, kv, wk, bk, mask, seed, thresh, keep_scale, bag0, dout, l,        \
                                    m, di, dssq, dsumw, dkv, dk_scratch, flags, list, off,  \
                                    dq_part, dwk_part, dbk_part, B, N, M, blocks, wsplits,  \
                                    scale, st);
  MPO_BWD(256, 256) else MPO_BWD(128, 128) else MPO_BWD(256, 128) else MPO_BWD(128, 256)
  else MPO_BWD(512, 512) else return (int)cudaErrorInvalidValue;
#undef MPO_BWD
  if (err) return err;
  const size_t total = (size_t)B * N * E + (size_t)F * E + E;
  const int grid = (int)((total + THREADS - 1) / THREADS);
  bwd_reduce_kernel<float><<<grid, THREADS, 0, st>>>(dq_part, dwk_part, dbk_part, off, dq, dwk,
                                                     dbk, B, blocks, wsplits, blocks, N, E, F);
  return (int)cudaGetLastError();
}

// The bfloat16 instances (fused_k_sm90.cuh): q, kv, wk, bk, dout, dq and
// dkv bfloat16, everything else (dwk and dbk included) as above; E, F in
// {128, 256}, or E = F = 512. dk_scratch's bytes hold dk's two bfloat16
// parts; dbk_part [wsplits, E] the dwk pass's dbk partials.
int mpo_coattn_bwd_fused_k_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kv,
                                const __nv_bfloat16* wk, const __nv_bfloat16* bk,
                                const uint8_t* mask, const int* seed,
                                const __nv_bfloat16* dout, const float* l, const float* m,
                                const float* di, const float* dssq, const float* dsumw,
                                __nv_bfloat16* dq, __nv_bfloat16* dkv, float* dwk, float* dbk,
                                float* dq_part, float* dwk_part, float* dbk_part,
                                float* dk_scratch, uint8_t* flags, int* list, int* off, int B,
                                int N, int M, int F, int E, int blocks, int wsplits, float scale,
                                uint32_t thresh, float keep_scale, uint32_t bag0, void* stream) {
  if (N < 1 || N > NMAX || M < 1 || B < 1 || blocks < 1 || wsplits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  // the tile flags and list (dkv = 0 on the skipped tiles), then the wgmma
  // kernels (fused_k_sm90.cuh); dbk's partials come from the dwk pass
  launch_tile_list(mask, dkv, nullptr, flags, list, off, B, M, F, st, false, 2);
#define MPO_BWD16(E_, F_)                                                                  \
  if (E == E_ && F == F_)                                                                  \
    err = fk90::launch_bwd<E_, F_>(q, kv, wk, bk, mask, seed, thresh, keep_scale, bag0, dout, \
                                   l, m, di, dssq, dsumw, dkv, dk_scratch, list, off, dq_part, \
                                   dwk_part, dbk_part, B, N, M, blocks, wsplits, scale, st);
  MPO_BWD16(256, 256) else MPO_BWD16(128, 128) else MPO_BWD16(256, 128)
  else MPO_BWD16(128, 256) else MPO_BWD16(512, 512) else return (int)cudaErrorInvalidValue;
#undef MPO_BWD16
  if (err) return err;
  const size_t total = (size_t)B * N * E + (size_t)F * E + E;
  const int grid = (int)((total + THREADS - 1) / THREADS);
  bwd_reduce_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
      dq_part, dwk_part, dbk_part, off, dq, dwk, dbk, B, blocks, wsplits, wsplits, N, E, F);
  return (int)cudaGetLastError();
}

// The plain-K form: q [B, N, D], k, v [B, M, D], mask [B, M] bool or NULL,
// seed / thresh / keep_scale as the forward, dout [B, N, D], l, m, di [B, N];
// dssq, dsumw [B, N] or NULL (zero cotangents). Out: dq [B, N, D], dk, dv
// [B, M, D]. max_blocks: the most main-pass blocks (it runs the blocks
// resident at once, up to that). Scratch: dq_part [max_blocks + B, N, D],
// flags [B * T] uint8, list [B * T] and off [B + 1] int32 (T = ceil(M / 64)
// key tiles a bag). D in {128, 256, 512}; N <= 8.
int mpo_coattn_plain_bwd(const float* q, const float* k, const float* v, const uint8_t* mask,
                         const int* seed, const float* dout, const float* l, const float* m,
                         const float* di, const float* dssq, const float* dsumw, float* dq,
                         float* dk, float* dv, float* dq_part, uint8_t* flags, int* list,
                         int* off, int B, int N, int M, int D, int pre_gate, int max_blocks,
                         float scale, uint32_t thresh, float keep_scale, uint32_t bag0,
                         void* stream) {
  return plain_bwd<float>(q, k, v, mask, seed, dout, l, m, di, dssq, dsumw, dq, dk, dv, dq_part,
                          flags, list, off, B, N, M, D, pre_gate, max_blocks, scale, thresh,
                          keep_scale, bag0, stream);
}

// The bfloat16 instances: q, k, v, dout, dq, dk and dv bfloat16, everything
// else as above.
int mpo_coattn_plain_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const uint8_t* mask, const int* seed,
                              const __nv_bfloat16* dout, const float* l, const float* m,
                              const float* di, const float* dssq, const float* dsumw,
                              __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                              float* dq_part, uint8_t* flags, int* list, int* off, int B, int N,
                              int M, int D, int pre_gate, int max_blocks, float scale,
                              uint32_t thresh, float keep_scale, uint32_t bag0, void* stream) {
  return plain_bwd<__nv_bfloat16>(q, k, v, mask, seed, dout, l, m, di, dssq, dsumw, dq, dk, dv,
                                  dq_part, flags, list, off, B, N, M, D, pre_gate, max_blocks,
                                  scale, thresh, keep_scale, bag0, stream);
}

}  // extern "C"
