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
// Keys at index >= L do not exist (weight exactly 0). Key tiles without a
// valid key are skipped when the bag has one (their weights are exactly 0).
// q, k, v are read in place with their strides from the packed [B, L, 3E]
// in-projection; out is written as [B, L, H, dh], so merging the heads is
// free. Instances: dh 16, 32, 64, 128, 256, 512 in both types.
//
// What bounds it on an H100: 4*B*H*L^2*dh operations (2.2 TFLOP at B=8,
// L=16384, H*dh=256) against 0.5 GB of q, k, v, out, so operations; at dh 16
// and 32 in bfloat16 the exponentials (one a score, 16 a clock an SM) weigh
// as much as the products.
//
// float32 (flash_fwd_kernel): both products run on the tensor cores as 3xTF32
// mma.sync (flash_common.cuh: float32 accuracy, three TF32 products each,
// 495/3 = 165 TFLOP/s at best instead of float32 FMAs' 67). mma.sync, not
// wgmma: wgmma takes TF32 operands K-major only, so P V would need a
// transposed copy of P or V in shared memory, where mma.sync's fragments sit
// in registers. One block = (bag, head, tile of BR queries), 8 warps; per key
// tile of BC keys:
//   * S = (q * scale) K^T: warp w takes 16 query rows and a column group (and,
//     at width 512, a depth half), writes its scores to shared memory;
//   * the online softmax, one warp a row (m, l and the rescale factor of each
//     row in shared memory), P written over the scores;
//   * O = O * alpha + P V with O in registers: 16 rows x dh / (8 / (BR / 16))
//     columns a warp.
// K and V tiles come in by cp.async: V of a tile lands while its scores are
// computed, the next valid K tile while P V runs. Tiles: dh 16, 32, 64 (128
// queries x 64 keys), 128, 256 (64 x 64) and 512 (32 x 32, scores split over
// two depth halves).
//
// bfloat16 (flash_fwd_wg_kernel; GE under a bfloat16 compute dtype, where the
// JAX package hands the library kernel bfloat16 q, k, v): Hopper's
// warpgroup MMA (flash_sm90.cuh), bfloat16 operands and float32 sums, the
// TPU kernel's roundings: the scale multiplies the float32 sum q k^T, p is
// rounded to bfloat16 for P V while m and l come from the unrounded p, out is
// written in bfloat16. A block holds two or three warpgroups of 64 query
// rows; per key tile of BC keys a warpgroup
//   * runs S = q K^T as wgmma (q and the K tile in shared memory) into
//     registers, 64 x BC float32;
//   * applies the scale and the tile's key mask (one byte read a key a warp,
//     ballot words; no select where the warp's tile is all valid), and the
//     online softmax in registers: a row lives in the four threads of a
//     quad, its max and sum by two shuffles, its exponentials on the exp unit
//     (ex2.approx of (s - m) log2 e: a masked score against its own fill
//     gives exactly 1);
//   * rounds p to bfloat16 pairs that are, as they stand, the A registers of
//     O = O * alpha + P V, a wgmma with V MN-major in shared memory.
// No score leaves the registers. K and V come in by cp.async into a ring of
// two or three stages, the next valid tiles landing while this one computes.
// What bounds it: at widths 16 and 32 the instructions a score takes (the
// exponential, the mask, the max and sum), about as many as the exp unit's
// floor; above, the products and the serial chain of a warpgroup's tile
// (wgmma, wait, softmax, wgmma, wait), which the other warpgroups of the SM
// overlap. Tiles (queries a block x keys a tile, stages, blocks an SM): dh 16
// and 32 128 x 64, 3, 2; 64 192 x 128, 2, 1; 128 128 x 128, 2, 1; 256
// 128 x 64, 2, 1 (O 128 registers a thread); 512 64 x 32, 2, 1, where O of
// 64 rows would take 256 registers a thread: two warpgroups share the rows,
// each sums S over one depth half and holds one half of O's columns; the
// halves of S meet in shared memory, summed in a fixed order, and both
// warpgroups run the same softmax on the same sums. Splitting a tile into
// sub-tiles whose softmax overlaps the last sub-tile's P V, and one
// warpgroup a block at more blocks an SM, both measured slower on the card.
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launch (0 = success); allocates nothing, runs on the caller's stream.

#include "flash_sm90.cuh"

namespace {

using namespace mpo;
using sm90::bf16;

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

template <int DH, int BR, int BC, int WK, int NW>
struct FwdCfg {
  using Tl = Tiles<DH, BR, BC, WK, NW>;
  // q, K, V tiles; WK partial score tiles (slice 0 then holds p); m, l, alpha
  static constexpr int SMEM_BYTES = 4 * ((BR + 2 * BC) * Tl::XS + WK * BR * Tl::SS + 3 * BR);
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
};

// q, k, v: element (b, h, i, d) at base + b*sb + h*sh + i*sl + d (strides in
// values, multiples of 16 bytes; bases 16-byte aligned). mask [B, L] bool or
// NULL. out [B, L, H, DH] contiguous. m_out, l_out [B, H, L] float32 (each
// row's running maximum and the sum of exp(s - m) over its keys, what the
// backward recomputes p from) or both NULL. The scores are (q * scale) k^T,
// q scaled as it lands in shared memory.
template <int DH, int BR, int BC, int WK, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int L, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                 long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                 float scale) {
  using Tl = Tiles<DH, BR, BC, WK, NW>;
  constexpr int XS = Tl::XS, SS = Tl::SS, NT = Tl::NT, NA = Tl::NA;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [BR][XS]: q * scale
  float* k_s = q_s + BR * XS;                   // [BC][XS]: the key tile
  float* v_s = k_s + BC * XS;                   // [BC][XS]: the value tile
  float* s_s = v_s + BC * XS;                   // [WK][BR][SS]: partial scores; slice 0: p
  float* m_s = s_s + WK * BR * SS;              // [BR]
  float* l_s = m_s + BR;                        // [BR]: running sum
  float* a_s = l_s + BR;                        // [BR]: this tile's rescale factor

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tl tl(warp);
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BR;
  const float* q_b = q + (long long)b * q_sb + (long long)h * q_sh;
  const float* k_b = k + (long long)b * k_sb + (long long)h * k_sh;
  const float* v_b = v + (long long)b * v_sb + (long long)h * v_sh;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;

  const int n_tiles = (L + BC - 1) / BC;
  const bool skip = mask_b != nullptr && bag_has_valid_key(mask_b, L);
  int t = next_tile<BC>(mask_b, 0, n_tiles, L, skip);  // < n_tiles: L >= 1
  load_tile_async<BC, DH, XS>(k_s, k_b, k_sl, t * BC, L);
  cp_async_commit();
  load_tile<BR, DH, XS>(q_s, q_b, q_sl, q0, L, scale);
  for (int i = tid; i < BR; i += 32 * NW) {
    m_s[i] = -3.0e38f;
    l_s[i] = 0.f;
  }

  const int r0 = 16 * tl.wr;                             // the warp's rows
  const int n0s = 8 * NT * tl.wn, k0s = Tl::KD * tl.wk;  // its scores' columns, depths
  const int n0a = 8 * NA * tl.wc;                        // its output columns
  float o[NA][4];
  zero_c<NA>(o);

  while (t < n_tiles) {
    const int c0 = t * BC;
    load_tile_async<BC, DH, XS>(v_s, v_b, v_sl, c0, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the key tile (and q_s, m_s, l_s the first time) ready

    // ---- S = (q * scale) K^T ----
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
        if (c < BC) s_s[i * SS + c] = p;
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
    acc_product<NA, BC, Tl::GA>(o, s_s, SS, v_s, XS, r0, n0a, lane);
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
      float* orow = out + (((size_t)b * L + row) * H + h) * DH + n0a + 2 * tq;
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

template <int DH, int BR, int BC, int WK, int NW, int MINB>
int launch_flash(const float* q, const float* k, const float* v, const uint8_t* mask, float* out,
                 float* m_out, float* l_out, int B, int H, int L, const long long* st,
                 float scale, cudaStream_t stream) {
  constexpr int smem = FwdCfg<DH, BR, BC, WK, NW>::SMEM_BYTES;
  static bool smem_allowed[64] = {};
  const int err =
      allow_dynamic_smem(flash_fwd_kernel<DH, BR, BC, WK, NW, MINB>, smem, smem_allowed);
  if (err) return err;
  const dim3 grid((L + BR - 1) / BR, B * H);
  flash_fwd_kernel<DH, BR, BC, WK, NW, MINB><<<grid, 32 * NW, smem, stream>>>(
      q, k, v, mask, out, m_out, l_out, H, L, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: warpgroup MMA
// ---------------------------------------------------------------------------

// NWG warpgroups a block. SPLIT = 1: each owns 64 query rows (BR = 64 NWG).
// SPLIT = 2 (two warpgroups): both own the same 64 rows; warpgroup w sums the
// scores over depth half w and holds output columns half w. NS stages of
// (K tile, V tile) in the ring.
template <int DH, int BC, int NWG, int SPLIT, int NS>
struct FwdWg {
  static constexpr int NTH = 128 * NWG;
  static constexpr int BR = 64 * NWG / SPLIT;
  static constexpr int DW = DH / SPLIT;  // a warpgroup's depth of S and columns of O
  static constexpr int Q_BYTES = BR * DH * 2;
  static constexpr int TILE = BC * DH * 2;                       // a K or V tile
  static constexpr int X_BYTES = SPLIT == 2 ? 2 * 64 * BC * 4 : 0;  // the halves of S
  // 1024 bytes to align the tiles for the swizzle
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + NS * 2 * TILE + X_BYTES;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(SPLIT == 1 || NWG == 2, "two warpgroups split a row group");
  static_assert(BC % 32 == 0 && DW % 16 == 0 && DW <= 256 && NS >= 2, "tiles");
};

// The arguments of flash_fwd_kernel in bfloat16 (m_out, l_out float32).
template <int DH, int BC, int NWG, int SPLIT, int NS, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB)
flash_fwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    bf16* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                    int H, int L, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                    long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                    long long v_sl, float scale) {
  using C = FwdWg<DH, BC, NWG, SPLIT, NS>;
  constexpr int NTH = C::NTH, BR = C::BR, DW = C::DW, TILE = C::TILE;
  constexpr int NSC = BC / 2, NO = DW / 2;  // score and output sums a thread
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const uint32_t q_s = sm90::aligned_base(smem_wg);  // [BR][DH], swizzled
  const uint32_t ring = q_s + C::Q_BYTES;            // stage st: K at ring + 2 st TILE, V after
  // [2][NSC][128]: each warpgroup's half of S, thread-major (SPLIT = 2)
  float* x_s =
      reinterpret_cast<float*>(smem_wg + (ring + NS * 2 * TILE - sm90::smem_addr(smem_wg)));

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31;
  const int tq = lane & 3;
  const int rg = SPLIT == 1 ? wg : 0, half = SPLIT == 1 ? 0 : wg;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BR;
  const bf16* q_b = q + (long long)b * q_sb + (long long)h * q_sh;
  const bf16* k_b = k + (long long)b * k_sb + (long long)h * k_sh;
  const bf16* v_b = v + (long long)b * v_sb + (long long)h * v_sh;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * L;

  const int n_tiles = (L + BC - 1) / BC;
  const bool skip = mask_b != nullptr && bag_has_valid_key(mask_b, L);
  auto load_kv = [&](int tile, int stage) {
    const uint32_t kt = ring + stage * 2 * TILE;
    sm90::load_sw<BC, DH, NTH>(kt, k_b, k_sl, tile * BC, L);
    sm90::load_sw<BC, DH, NTH>(kt + TILE, v_b, v_sl, tile * BC, L);
  };
  sm90::load_sw<BR, DH, NTH>(q_s, q_b, q_sl, q0, L);
  cp_async_commit();
  // tiles[0]: the tile the next step computes; tiles[s]: the one s stages on
  int tiles[NS];
  {
    int t = sm90::next_tile_warp<BC>(mask_b, 0, n_tiles, L, skip, lane);  // < n_tiles
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

  float o[NO];
  sm90::zero_acc(o);
  float m_r[2] = {-3.0e38f, -3.0e38f}, l_r[2] = {0.f, 0.f};  // rows g and g + 8

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

    // ---- S = q K^T (the warpgroup's depth), float32 in registers ----
    float s[NSC];
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < DW / 16; ++ks) {
      const int kd = half * (DW / 16) + ks;
      sm90::wgmma_ss(s, sm90::desc_k<BR, DH>(q_s, 64 * rg, kd), sm90::desc_k<BC, DH>(kt, 0, kd),
                     ks);
    }
    sm90::wg_commit();
    uint32_t w[(BC + 31) / 32];
    sm90::tile_bits<BC>(w, mask_b, c0, L, lane);
    sm90::wg_wait<0>();
    sm90::fence_acc(s);
    if constexpr (SPLIT == 2) {  // S = half 0 + half 1, the same sums in both warpgroups
#pragma unroll
      for (int i = 0; i < NSC; ++i) x_s[(wg * NSC + i) * 128 + wt] = s[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NSC; ++i) s[i] = x_s[i * 128 + wt] + x_s[(NSC + i) * 128 + wt];
    }

    // ---- scale, key mask, online softmax; p rounded as the A registers ----
    float mx[2] = {-INFINITY, -INFINITY};
    if (sm90::all_valid(w)) {  // the warp's common case: no select
#pragma unroll
      for (int i = 0; i < NSC; ++i) {
        s[i] *= scale;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      const int lim = L - c0;  // keys of the tile that exist
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        const uint32_t bits = sm90::col_bits(w, j, tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float fill = 8 * j + 2 * tq + e < lim ? MASK_NEG : -INFINITY;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float& x = s[4 * j + 2 * hf + e];
            x = (bits >> e) & 1u ? x * scale : fill;
            mx[hf] = fmaxf(mx[hf], x);
          }
        }
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m_r[hf], sm90::quad_max(mx[hf]));  // finite: key c0 exists
      alpha[hf] = sm90::exp_fast(m_r[hf] - m_new);
      m_r[hf] = m_new;
    }
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      const int hf = (i >> 1) & 1;
      s[i] = sm90::exp_fast(s[i] - m_r[hf]);
      ps[hf] += s[i];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_r[hf] = l_r[hf] * alpha[hf] + sm90::quad_sum(ps[hf]);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) sm90::a_frag(pa[kk], s, kk);

    // ---- O += P V (the warpgroup's columns) ----
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      sm90::wgmma_rs(o, pa[kk], sm90::desc_mn<BC, DH>(vt, kk, half * DW), 1);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_acc(o);
  }
  cp_async_wait<0>();

  // ---- out[b, row, h, :] = o / l; m and l [B, H, L] where asked for ----
  const int r = q0 + 64 * rg + 16 * (wt >> 5) + (lane >> 2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r + 8 * hf;
    if (row >= L) continue;
    const float inv = l_r[hf] == 0.f ? 1.f : 1.f / l_r[hf];
    bf16* orow = out + (((size_t)b * L + row) * H + h) * DH + half * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      store2(orow + 8 * j, o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    if (m_out != nullptr && tq == 0 && half == 0) {
      m_out[((size_t)b * H + h) * L + row] = m_r[hf];
      l_out[((size_t)b * H + h) * L + row] = l_r[hf];
    }
  }
}

template <int DH, int BC, int NWG, int SPLIT, int NS, int MINB>
int launch_flash_wg(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask, bf16* out,
                    float* m_out, float* l_out, int B, int H, int L, const long long* st,
                    float scale, cudaStream_t stream) {
  using C = FwdWg<DH, BC, NWG, SPLIT, NS>;
  static bool smem_allowed[64] = {};
  const int err = allow_dynamic_smem(flash_fwd_wg_kernel<DH, BC, NWG, SPLIT, NS, MINB>,
                                     C::SMEM_BYTES, smem_allowed);
  if (err) return err;
  const dim3 grid((L + C::BR - 1) / C::BR, B * H);
  flash_fwd_wg_kernel<DH, BC, NWG, SPLIT, NS, MINB><<<grid, C::NTH, C::SMEM_BYTES, stream>>>(
      q, k, v, mask, out, m_out, l_out, H, L, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int check_args(int B, int H, int L, const float* m_out, const float* l_out, const long long* st) {
  if (B < 1 || H < 1 || L < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st[i] % (16 / (int)sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
  return 0;
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
  if (const int err = check_args<float>(B, H, L, m_out, l_out, st)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (width, queries a block, keys a tile, depth slices of the scores, warps
  // a block, blocks an SM: two where the shared memory allows, which caps
  // registers at 128)
#define MPO_FWD(D, BR, BC, WK, NW, MINB) \
  launch_flash<D, BR, BC, WK, NW, MINB>(q, k, v, mask, out, m_out, l_out, B, H, L, st, scale, s)
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

// The same in bfloat16: q, k, v and out bfloat16, m_out and l_out float32.
int mpo_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask,
                       bf16* out, float* m_out, float* l_out, int B, int H, int L, int DH,
                       long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                       long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                       long long v_sl, float scale, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl};
  if (const int err = check_args<bf16>(B, H, L, m_out, l_out, st)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (width, keys a tile, warpgroups a block, warpgroups sharing a row group,
  // ring stages, blocks an SM); ops/flash.py KEY_TILE holds the keys a tile
#define MPO_FWD_WG(D, BC, NWG, SPLIT, NS, MINB)                                                \
  launch_flash_wg<D, BC, NWG, SPLIT, NS, MINB>(q, k, v, mask, out, m_out, l_out, B, H, L, st, \
                                                scale, s)
  switch (DH) {
    case 16: return MPO_FWD_WG(16, 64, 2, 1, 3, 2);
    case 32: return MPO_FWD_WG(32, 64, 2, 1, 3, 2);
    case 64: return MPO_FWD_WG(64, 128, 3, 1, 2, 1);
    case 128: return MPO_FWD_WG(128, 128, 2, 1, 2, 1);
    case 256: return MPO_FWD_WG(256, 64, 2, 1, 2, 1);
    case 512: return MPO_FWD_WG(512, 32, 2, 2, 2, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MPO_FWD_WG
}

}  // extern "C"
