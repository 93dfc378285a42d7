// The plain-K forward with values and its backward past eight queries on
// the tensor cores (csrc/coattn_many.cu, csrc/coattn_bwd_many.cu; the design
// notes are theirs): query tiles of 16..64 queries a block, every product an
// mma.sync (float32: 3xTF32, flash_common.cuh; bfloat16: bf16 operands with
// float32 sums, and the float32 weights against bfloat16 rows as two TF32
// products, exact in the rows). The tile list, the Philox bits and the
// fixed-order merges are those of the kernels at up to eight queries
// (fused_k_common.cuh, coattn_common.cuh, combine_kernel, bwd_reduce_kernel).
//
// The forward and the backward's dk / dv pass share one shape: a block
// holds a "row side" in shared memory for a while (the query tile, or a tile
// of keys) and streams the "column side" (sub-steps of keys, or chunks of
// queries) through a two-slot cp.async ring. Per column step: tanh of the
// streamed operand into a tile of its own (once per element and row tile:
// the pre-gate), the score products X Y^T into partial tiles (Tiles<>:
// warps over row groups, column groups and depth slices), one elementwise
// pass over the partials (summed in slice order), and the "acc" products
// into float32 sums held in registers (rows 16 a warp, D / WCA columns).
// The dq pass runs last and scores nothing: it streams k with the dk / dv
// pass's da and du (a scratch) into two "acc" products.
#pragma once

#include "plain_k_bwd.cuh"
#include "plain_k_fwd.cuh"

namespace mpo {

// ---------------------------------------------------------------------------
// Products by element type
// ---------------------------------------------------------------------------

// flash_common.cuh's split_tf32 (big = tf32(x) rounded to nearest, ties
// away; small = tf32(x - big), x - big exact) in integer operations: adding
// half a unit of the 13 dropped bits to the magnitude's bits and masking
// them rounds exactly as cvt.rna.tf32.f32 does, for every finite value, on
// the full-rate integer pipes, where the conversion instruction would take
// the slower conversion pipe twice an element.
__device__ __forceinline__ void split_tf32i(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// The A fragment of rows r0.. (16) and columns k0.. (8) of a row-major tile
// (flash_common.cuh load_a with split_tf32i).
__device__ __forceinline__ void load_ai(uint32_t (&big)[4], uint32_t (&small)[4],
                                        const float* __restrict__ tile, int stride, int r0, int k0,
                                        int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * stride + k0 + (lane & 3);
  split_tf32i(p[0], big[0], small[0]);
  split_tf32i(p[8 * stride], big[1], small[1]);
  split_tf32i(p[4], big[2], small[2]);
  split_tf32i(p[8 * stride + 4], big[3], small[3]);
}

// SU 8-deep steps of a 3xTF32 "row" product into c (one 16 x 8 tile): the
// A fragments ab / as [a0 + u], the B fragments bb / bs [u]. Each pair of
// steps sums in fresh registers (a_big b_small, a_small b_big, a_big b_big,
// the first step then the second), added into c with a rounded float32 add
// in depth order: flash_common.cuh's mma_group over 16 deep rather than 8,
// half its adds, the tensor cores' unrounded adds over 16 products' depth.
template <int SU, int KA>
__device__ __forceinline__ void fresh_sums(float (&c)[4], const uint32_t (&ab)[KA][4],
                                           const uint32_t (&as)[KA][4],
                                           const uint32_t (&bb)[SU][2],
                                           const uint32_t (&bs)[SU][2], int a0) {
  static_assert(SU % 2 == 0, "steps in pairs");
  float f[SU / 2][4];
#pragma unroll
  for (int h = 0; h < SU / 2; ++h) f[h][0] = f[h][1] = f[h][2] = f[h][3] = 0.f;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int h = 0; h < SU / 2; ++h) mma_tf32(f[h], ab[a0 + 2 * h + v], bs[2 * h + v]);
#pragma unroll
    for (int h = 0; h < SU / 2; ++h) mma_tf32(f[h], as[a0 + 2 * h + v], bb[2 * h + v]);
#pragma unroll
    for (int h = 0; h < SU / 2; ++h) mma_tf32(f[h], ab[a0 + 2 * h + v], bb[2 * h + v]);
  }
#pragma unroll
  for (int h = 0; h < SU / 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += f[h][e];
}

// "row" product c[j] += X[r0.. +16][k] Y[n0 + 8j .. +8][k]^T over depths
// k0 .. k0 + KD - 1. float32: 3xTF32 with flash_common.cuh's split (in
// integer operations) and fresh sums (fresh_sums), SU steps in flight at
// once: a warp's tile here is one or two 8-column tiles, so the MMAs of one
// fresh sum, which depend on each other, would otherwise wait on one
// another (the tensor cores' latency).
template <int NT, int KD, int G, int SU>
__device__ __forceinline__ void score_product(float (&c)[NT][4], const float* __restrict__ x,
                                              int xs, const float* __restrict__ y, int ys, int r0,
                                              int n0, int k0, int lane) {
  static_assert(KD % (8 * SU) == 0, "depth in groups of SU steps");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = k0; kk < k0 + KD; kk += 8 * SU) {
    uint32_t ab[SU][4], as[SU][4];
#pragma unroll
    for (int u = 0; u < SU; ++u) load_ai(ab[u], as[u], x, xs, r0, kk + 8 * u, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[SU][2], bs[SU][2];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const float* p = y + (n0 + 8 * j + g) * ys + kk + 8 * u + t;
        split_tf32i(p[0], bb[u][0], bs[u][0]);
        split_tf32i(p[4], bb[u][1], bs[u][1]);
      }
      fresh_sums<SU>(c[j], ab, as, bb, bs, 0);
    }
  }
}

// bfloat16: m16n8k16 products (exact in float32) summed a 16-deep step in
// fresh registers, then added into c with a rounded float32 add, as the
// 3xTF32 form does: the tensor cores' own adds do not round to nearest.
template <int NT, int KD, int G, int SU>
__device__ __forceinline__ void score_product(float (&c)[NT][4],
                                              const __nv_bfloat16* __restrict__ x, int xs,
                                              const __nv_bfloat16* __restrict__ y, int ys, int r0,
                                              int n0, int k0, int lane) {
  static_assert(KD % 64 == 0, "bfloat16 MMA depth, four steps in flight");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = k0; kk < k0 + KD; kk += 16) {
    uint32_t a[4];
    load_a_bf16(a, x, xs, r0, kk, lane);
    float s[NT][4];
    zero_c<NT>(s);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* p = y + (n0 + 8 * j + g) * ys + kk + 2 * t;
      const uint32_t b[2] = {lds_pair(p), lds_pair(p + 8)};
      mma_bf16(s[j], a, b);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += s[j][e];
  }
}

// "acc" product c[j] += P[r0.. +16][k] Y[k][n0 + 8j .. +8], P float32,
// with flash_common.cuh acc_product_rows' k order (lane t holds k = 2t,
// 2t + 1: one 8-byte load of a P pair). float32 Y: 3xTF32 (split_tf32i);
// bfloat16 Y: P split into TF32 big + small against Y widened, which TF32
// holds exactly, two MMAs a step (Y's small part is 0): P at float32
// accuracy, never rounded to bfloat16 (the JAX kernel's float32 pd . v).
// Fresh sums over two 8-deep steps where KC allows (fresh_sums' rule).
template <int NT, int KC, int G, typename TY>
__device__ __forceinline__ void value_product(float (&c)[NT][4], const float* __restrict__ p,
                                              int ps, const TY* __restrict__ y, int ys, int r0,
                                              int n0, int lane) {
  constexpr bool EXACT_Y = IS_BF16<TY>;
  constexpr int KP = KC % 16 == 0 ? 2 : 1;  // 8-deep steps a fresh sum
  static_assert(NT % G == 0 && KC % 8 == 0, "column tile groups, depth 8");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kk = 0; kk < KC; kk += 8 * KP) {
    uint32_t ab[KP][4], as[KP][4];
#pragma unroll
    for (int v = 0; v < KP; ++v) {
      const float2 lo = *reinterpret_cast<const float2*>(p + (r0 + g) * ps + kk + 8 * v + 2 * t);
      const float2 hi =
          *reinterpret_cast<const float2*>(p + (r0 + g + 8) * ps + kk + 8 * v + 2 * t);
      split_tf32i(lo.x, ab[v][0], as[v][0]);
      split_tf32i(hi.x, ab[v][1], as[v][1]);
      split_tf32i(lo.y, ab[v][2], as[v][2]);
      split_tf32i(hi.y, ab[v][3], as[v][3]);
    }
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      uint32_t bb[KP][G][2], bs[KP][G][2];
#pragma unroll
      for (int v = 0; v < KP; ++v) {
        const TY* yk = y + (kk + 8 * v + 2 * t) * ys + n0 + g;
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if constexpr (EXACT_Y) {
            bb[v][u][0] = bf16_tf32(yk[8 * (j0 + u)]);
            bb[v][u][1] = bf16_tf32(yk[8 * (j0 + u) + ys]);
          } else {
            split_tf32i(yk[8 * (j0 + u)], bb[v][u][0], bs[v][u][0]);
            split_tf32i(yk[8 * (j0 + u) + ys], bb[v][u][1], bs[v][u][1]);
          }
        }
      }
      float f[G][4];
#pragma unroll
      for (int u = 0; u < G; ++u) f[u][0] = f[u][1] = f[u][2] = f[u][3] = 0.f;
#pragma unroll
      for (int v = 0; v < KP; ++v) {
        if constexpr (!EXACT_Y) {
#pragma unroll
          for (int u = 0; u < G; ++u) mma_tf32(f[u], ab[v], bs[v][u]);
        }
#pragma unroll
        for (int u = 0; u < G; ++u) mma_tf32(f[u], as[v], bb[v][u]);
#pragma unroll
        for (int u = 0; u < G; ++u) mma_tf32(f[u], ab[v], bb[v][u]);
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j0 + u][e] += f[u][e];
    }
  }
}

// Four consecutive values into a tile of T (bfloat16: rounded to nearest).
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ float4 tanh4(float4 v) {
  return make_float4(tanhf(v.x), tanhf(v.y), tanhf(v.z), tanhf(v.w));
}

// dst [ROWS][XS] = tanh(src [ROWS][XS]) in T (bfloat16: rounded, as the
// kernels at up to eight queries round it), the whole block.
template <int ROWS, int D, int XS, int NTH, typename T>
__device__ __forceinline__ void tanh_tile(const T* __restrict__ src, T* __restrict__ dst) {
  constexpr int V4 = D / 4;
  for (int x = threadIdx.x; x < ROWS * V4; x += NTH) {
    const int o = (x / V4) * XS + 4 * (x % V4);
    store4(dst + o, tanh4(load4(src + o)));
  }
}

// Rows 0 .. ROWS-1 of a [*, D] operand (src: its row 0) into dst [ROWS][XS]
// in T, zeros from row `rows` on; with tdst, tanh of them too. Synchronous:
// the rows a block holds for a while.
template <int ROWS, int D, int XS, int NTH, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int rows, T* __restrict__ dst,
                                          T* __restrict__ tdst) {
  constexpr int V4 = D / 4;
  for (int x = threadIdx.x; x < ROWS * V4; x += NTH) {
    const int r = x / V4, c = 4 * (x % V4);
    const float4 v = r < rows ? load4(src + (size_t)r * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * XS + c, v);
    if (tdst != nullptr) store4(tdst + r * XS + c, tanh4(v));
  }
}

// Sum and max over segments of W lanes (W = 8, 16, 32), fixed order.
template <int W>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int W>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sub-steps of KS keys of tile t of a bag of M keys (the last tile may be short).
template <int KS>
__device__ __forceinline__ int tile_subs(int t, int M) {
  return (min(FK_BM, M - t * FK_BM) + KS - 1) / KS;
}

// Sub-step c of the block's sequence into `slot` ([KS][XS] k rows, then
// [KS][XS] v rows, in T), asynchronously; zero rows past M. Advances c; past
// the block's share (i >= i1) issues nothing.
template <int D, int KS, int XS, typename T>
__device__ __forceinline__ void tile_issue(T* __restrict__ slot, const T* __restrict__ k,
                                           const T* __restrict__ v, const int* __restrict__ list,
                                           int n_tiles, int M, int i1, PkCursor& c) {
  if (c.i >= i1) return;
  const int u = list[c.i], b = u / n_tiles, t = u % n_tiles;
  const int r0 = t * FK_BM + c.j * KS;
  load_tile_async<KS, D, XS>(slot, k + (size_t)b * M * D, D, r0, M);
  load_tile_async<KS, D, XS>(slot + KS * XS, v + (size_t)b * M * D, D, r0, M);
  if (++c.j == tile_subs<KS>(t, M)) {
    c.j = 0;
    ++c.i;
  }
}

// Score-tile row stride (floats): 8 past the width, so that the acc
// products' float2 loads of a P tile hit distinct banks at 16 and 32
// columns (two ways at 8, whose instances have no shared memory to spare).
constexpr int tile_ss(int cols) { return cols + 8; }

// Queries a block of the forward and of the backward's dq pass past eight
// queries, rows {D, float32, bfloat16}: what the forward's shared memory
// holds beside the key ring, and the dq pass's sums in registers. The
// wrapper sizes the partial buffers and the dq scratch from the same rows
// (ops/coattn.py QUERY_TILE; a CPU test reads these).
constexpr int QUERY_TILE[3][3] = {{128, 64, 64}, {256, 64, 64}, {512, 32, 32}};

constexpr int query_tile(const int (&rows)[3][3], int D, bool bf) {
  return rows[D == 128 ? 0 : D == 256 ? 1 : 2][bf ? 2 : 1];
}

// ---------------------------------------------------------------------------
// Forward with values: block (g, y) takes query tile y (queries QT y ..) over
// block g's share of the listed tiles, keys in sub-steps of KS.
// ---------------------------------------------------------------------------

template <int D, typename T, bool PG>
struct TileFwd {
  static constexpr bool BF = IS_BF16<T>;
  static constexpr int QT = query_tile(QUERY_TILE, D, BF);  // queries a block
  static constexpr int KS = BF ? (D < 512 ? 32 : 16) : (D == 128 ? 32 : D == 256 ? 16 : 8);
  // warps a block, and depth slices of the scores: in float32 eight warps,
  // each score tile as wide as the partial tiles' shared memory allows (the
  // split of an operand is paid per warp that loads it); in bfloat16, whose
  // raw tiles need no split, sixteen
  static constexpr int NW = BF ? 16 : 8;
  static constexpr int WK = D < 512 ? 1 : 4;
  static constexpr int SU = NW == 16 ? 2 : 4;  // float32 score steps in flight
  using Tl = Tiles<D, QT, KS, WK, NW>;
  static constexpr int XS = BF ? D + 8 : D + 4;  // operand row stride (values of T)
  static constexpr int SS = tile_ss(KS);
  static constexpr int NSLOT = 2;
  static constexpr int SLOT = 2 * KS * XS;  // k rows, then v rows
  // the ring, q, tanh(q), tanh(k) (T); a and g partials (p over a's slice
  // 0); m, l, alpha, ssq, sumw of the queries
  static constexpr int BYTES = (int)sizeof(T) * (NSLOT * SLOT + (PG ? 2 : 1) * QT * XS +
                                                 (PG ? KS * XS : 0)) +
                               4 * ((PG ? 2 : 1) * WK * QT * SS + 5 * QT);
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(QT % (NW * (32 / KS)) == 0 && KS <= 32, "softmax rows a warp pass");
};

template <int D, bool PG, bool TRAIN, typename T>
__global__ void __launch_bounds__(32 * TileFwd<D, T, PG>::NW, 1)
tile_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const uint8_t* __restrict__ mask, const int* __restrict__ list,
                const int* __restrict__ off, float* __restrict__ o_part,
                float* __restrict__ ml_part, float* __restrict__ sq_part,
                const int* __restrict__ seed_ptr, uint32_t thresh, float keep_scale,
                uint32_t bag0, int B, int N, int M, float scale) {
  using C = TileFwd<D, T, PG>;
  using Tl = typename C::Tl;
  constexpr int QT = C::QT, KS = C::KS, XS = C::XS, SS = C::SS, NSLOT = C::NSLOT;
  constexpr int NT = Tl::NT, NA = Tl::NA, R = 32 / KS, NW = C::NW, NTH = 32 * NW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* q_s = ring + NSLOT * C::SLOT;
  T* tq_s = q_s + QT * XS;
  T* tk_s = tq_s + (PG ? QT * XS : 0);
  float* a_s = reinterpret_cast<float*>(tk_s + (PG ? KS * XS : 0));  // [WK][QT][SS]
  float* g_s = a_s + C::WK * QT * SS;
  float* st = g_s + (PG ? C::WK * QT * SS : 0);
  float *m_s = st, *l_s = st + QT, *al_s = st + 2 * QT, *sq_s = st + 3 * QT, *sw_s = st + 4 * QT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tl tl(warp);
  const int n0 = blockIdx.y * QT, NS = min(QT, N - n0);
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const uint32_t seed = TRAIN ? (uint32_t)seed_ptr[0] : 0u;
  const int r0w = 16 * tl.wr, n0a = 8 * NA * tl.wc;                // the warp's sums
  const int n0s = 8 * NT * tl.wn, k0s = Tl::KD * tl.wk;            // its scores
  const int gq = lane >> 2, tq = lane & 3;

  PkCursor cur{i0, 0};
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    tile_issue<D, KS, XS>(ring + s * C::SLOT, k, v, list, n_tiles, M, i1, cur);
    cp_async_commit();
  }

  float o[NA][4];
  int b = -1;
  auto flush = [&]() {  // bag b's partial at index block + b; row state by thread = row
    const size_t pb = (size_t)blockIdx.x + b;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0w + gq + 8 * h;
      if (row < NS) {
        float* dst = o_part + (pb * N + n0 + row) * D + n0a + 2 * tq;
#pragma unroll
        for (int j = 0; j < NA; ++j) store2(dst + 8 * j, o[j][2 * h], o[j][2 * h + 1]);
      }
    }
    if (tid < NS) {
      const size_t i = (pb * N + n0 + tid) * 2;
      ml_part[i] = m_s[tid];
      ml_part[i + 1] = l_s[tid];
      if constexpr (TRAIN) {
        sq_part[i] = sq_s[tid];
        sq_part[i + 1] = sw_s[tid];
      }
    }
  };

  int s = 0;  // the block's sub-step
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles, subs = tile_subs<KS>(t, M);
    for (int j = 0; j < subs; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncthreads();  // sub-step s landed; the last sub-step's products are done
      tile_issue<D, KS, XS>(ring + ((s + NSLOT - 1) % NSLOT) * C::SLOT, k, v, list, n_tiles, M,
                            i1, cur);
      cp_async_commit();
      if (ub != b) {  // a new bag: flush the last one's partial, load this one's queries
        if (b >= 0) flush();
        b = ub;
        load_rows<QT, D, XS, NTH>(q + ((size_t)b * N + n0) * D, NS, q_s, PG ? tq_s : nullptr);
        if (tid < QT) {
          m_s[tid] = NEG;
          l_s[tid] = sq_s[tid] = sw_s[tid] = 0.f;
          al_s[tid] = 1.f;
        }
#pragma unroll
        for (int x = 0; x < NA; ++x) o[x][0] = o[x][1] = o[x][2] = o[x][3] = 0.f;
      }
      const T* ks = ring + (s % NSLOT) * C::SLOT;
      const T* vs = ks + KS * XS;
      const int r0 = t * FK_BM + j * KS;  // the sub-step's first key
      if constexpr (PG) tanh_tile<KS, D, XS, NTH>(ks, tk_s);  // once per key and query tile
      __syncthreads();  // q (a new bag), tanh(k) ready

      // ---- a = q k^T, g = tanh(q) tanh(k)^T: the warp's partial tiles ----
      {
        float c[NT][4];
        zero_c<NT>(c);
        score_product<NT, Tl::KD, Tl::GR, C::SU>(c, q_s, XS, ks, XS, r0w, n0s, k0s, lane);
        store_c<NT>(c, a_s + tl.wk * QT * SS, SS, r0w, n0s, lane);
        if constexpr (PG) {
          zero_c<NT>(c);
          score_product<NT, Tl::KD, Tl::GR, C::SU>(c, tq_s, XS, tk_s, XS, r0w, n0s, k0s, lane);
          store_c<NT>(c, g_s + tl.wk * QT * SS, SS, r0w, n0s, lane);
        }
      }
      __syncthreads();

      // ---- online softmax: R rows a warp at once, a lane a key ----
      {
        const int sub = lane / KS, cc = lane % KS, key = r0 + cc;
        const bool exists = key < M;  // keys past M do not exist: weight exactly 0
        const bool valid = exists && (mask == nullptr || mask[(size_t)b * M + key]);
        for (int row = warp * R + sub; row < QT; row += NW * R) {
          const bool live = row < NS;
          float x = -INFINITY;
          if (live && exists) {
            float a = 0.f, g = 0.f;
#pragma unroll
            for (int w = 0; w < C::WK; ++w) {
              a += a_s[(w * QT + row) * SS + cc];
              if constexpr (PG) g += g_s[(w * QT + row) * SS + cc];
            }
            x = valid ? pk_score<PG>(a, g, scale) : NEG;
          }
          const float m_old = m_s[row];
          const float m_new = fmaxf(m_old, seg_max<KS>(x));
          const float alpha = expf(m_old - m_new);
          float p = expf(x - m_new);
          const float psum = seg_sum<KS>(p);
          float p2 = 0.f, p1 = 0.f;
          if constexpr (TRAIN) {
            if (thresh != 0u && live && exists)
              p = dropout_bits(seed, bag0 + (uint32_t)b, (uint32_t)(n0 + row), (uint32_t)key) >=
                          thresh ? p * keep_scale : 0.f;
            p2 = seg_sum<KS>(p * p);
            p1 = seg_sum<KS>(p);
          }
          a_s[row * SS + cc] = p;  // over slice 0: this lane's own element
          if (cc == 0 && live) {
            m_s[row] = m_new;
            l_s[row] = l_s[row] * alpha + psum;
            al_s[row] = alpha;
            if constexpr (TRAIN) {
              sq_s[row] = sq_s[row] * (alpha * alpha) + p2;
              sw_s[row] = sw_s[row] * alpha + p1;
            }
          }
        }
      }
      __syncthreads();  // p and alpha complete

      // ---- o = o alpha + p v ----
      {
        const float a0 = al_s[r0w + gq], a1 = al_s[r0w + gq + 8];
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          o[x][0] *= a0;
          o[x][1] *= a0;
          o[x][2] *= a1;
          o[x][3] *= a1;
        }
      }
      value_product<NA, KS, Tl::GA>(o, a_s, SS, vs, XS, r0w, n0a, lane);
      // the tiles and this slot are rewritten after the next sub-step's barrier
    }
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
}

// ---------------------------------------------------------------------------
// Backward. Per (query n, key r), from the forward's (l, m), di and the
// regenerated dropout bits (plain_k_bwd.cuh, K3):
//   a = q.k / sqrt(D), g = (tanh q . tanh k + 1) / 2 (1 without the gate),
//   p = exp((valid ? a g : NEG) - m) / l, pd = keep p / (1 - rate),
//   ds = valid ? pd dp - p di + 2 dssq pd^2 + dsumw pd : 0, dp = dO.v,
//   da = ds g / sqrt(D) (the scale folded in), du = ds a / 2.
// ---------------------------------------------------------------------------

struct PkGrad {
  float da, du, pd;
};

template <bool PG>
__device__ __forceinline__ PkGrad pk_grad(float dot, float u, float dp, bool valid, float m,
                                          float linv, float di, float dssq, float dsumw,
                                          bool drop, bool keep, float keep_scale, float scale) {
  const float a = dot * scale;
  const float g = PG ? (u + 1.f) * 0.5f : 1.f;
  const float p = expf((valid ? a * g : NEG) - m) * linv;
  const float pd = drop ? (keep ? p * keep_scale : 0.f) : p;
  const float ds = valid ? pd * dp - p * di + 2.f * dssq * pd * pd + dsumw * pd : 0.f;
  return {ds * g * scale, ds * a * 0.5f, pd};
}

// The dq pass, after the dk / dv pass: block (g, y) takes query tile y over
// block g's share, keys in sub-steps of KS; the k rows streamed with the dk
// / dv pass's da (and du) of the tile's queries against them, which it left
// in a scratch [B, M, NP] (keys major, NP = S QT queries), so that dq is
// two "acc" products and nothing is scored twice.
template <int D, typename T, bool PG>
struct TileDq {
  static constexpr bool BF = IS_BF16<T>;
  static constexpr int QT = query_tile(QUERY_TILE, D, BF);
  static constexpr int KS = 32;
  static constexpr int NW = 8;
  static constexpr int WR = QT / 16, WCA = NW / WR, NA = D / 8 / WCA;  // the sums' warp grid
  static constexpr int GA = NA < 4 ? NA : 4;
  static constexpr int XS = BF ? D + 8 : D + 4;
  static constexpr int PS = QT + 4;  // da block row stride (floats; 4 mod 32)
  static constexpr int NSLOT = 2;
  static constexpr int SLOT = KS * XS;              // k rows (values of T)
  static constexpr int DSLOT = (PG ? 2 : 1) * KS * PS;  // da, then du rows (floats)
  // the k ring and tanh(k) (T); the da / du ring
  static constexpr int BYTES =
      (int)sizeof(T) * (NSLOT * SLOT + (PG ? KS * XS : 0)) + 4 * NSLOT * DSLOT;
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(WR * WCA == NW && NA * 8 * WCA == D, "sum tiles");
};

// The dk / dv pass, first: key-tile major, a block an even share of the
// listed tiles, each in row tiles of KR keys (k, v, tanh(k) held) against
// the bag's queries in chunks of QC (q, dout streamed, tanh(q) once a
// chunk; the next row tile's k, v and first chunk land during the last
// chunk's sums). It writes dk and dv once, and da (du) for the dq pass.
template <int D, typename T, bool PG>
struct TileDkv {
  static constexpr bool BF = IS_BF16<T>;
  static constexpr int KR = D == 128 ? 64 : D == 256 ? 32 : 16;
  // float32 at D = 256: chunks of 32 queries where no tanh tiles take the
  // room (without the gate), else 16
  static constexpr bool WIDE = !BF && !PG && D == 256;
  static constexpr int QC =
      BF || WIDE ? (D < 512 ? 32 : 16) : (D == 128 ? 32 : D == 256 ? 16 : 8);
  static constexpr int NW = BF ? 16 : 8;  // warps a block (as TileFwd)
  static constexpr int WK = BF ? (D == 128 ? 1 : D == 256 ? 2 : 8)
                               : (D == 128 ? 1 : D == 256 ? (WIDE ? 2 : 4) : 8);
  static constexpr int SU = NW == 16 ? 2 : 4;
  using Tl = Tiles<D, KR, QC, WK, NW>;
  static constexpr int XS = BF ? D + 8 : D + 4;
  static constexpr int SS = tile_ss(QC);
  static constexpr int NSLOT = 2;
  static constexpr int SLOT = 2 * QC * XS;  // q rows, then dout rows
  // k, v, tanh(k) rows, the ring, tanh(q) (T); a, g, dp partials (da, du,
  // pd over slice 0); the bag's m, 1/l, di, dssq, dsumw
  static constexpr int BYTES = (int)sizeof(T) * ((PG ? 3 : 2) * KR * XS + NSLOT * SLOT +
                                                 (PG ? QC * XS : 0)) +
                               4 * ((PG ? 3 : 2) * WK * KR * SS + 5 * NQ_MAX);
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(FK_BM % KR == 0, "row tiles of a 64-key tile");
};

// A da block of the scratch into `dst` [KS][PS] (QT queries from n0 of
// keys r0 ..), asynchronously; zero rows past M.
template <int KS, int QT, int PS>
__device__ __forceinline__ void load_da(float* __restrict__ dst, const float* __restrict__ scr,
                                        int NP, int r0, int M, int n0, int nth) {
  constexpr int V4 = QT / 4;
  for (int x = threadIdx.x; x < KS * V4; x += nth) {
    const int row = x / V4, c = 4 * (x % V4);
    const bool ok = r0 + row < M;
    cp_async16(dst + row * PS + c, ok ? scr + (size_t)(r0 + row) * NP + n0 + c : scr, ok);
  }
}

// "acc" product c[j] += P[r0.. +16][k] Y[k][n0 + 8j .. +8] with P stored
// transposed, element (row, k) at p[k * ps + row] (the scratch's keys-major
// da blocks), otherwise value_product's (its k order, types and fresh sums).
template <int NT, int KC, int G, typename TY>
__device__ __forceinline__ void value_product_t(float (&c)[NT][4], const float* __restrict__ p,
                                                int ps, const TY* __restrict__ y, int ys, int r0,
                                                int n0, int lane) {
  constexpr bool EXACT_Y = IS_BF16<TY>;
  static_assert(NT % G == 0 && KC % 16 == 0, "column tile groups, depth 16");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float* pk = p + (kk + 8 * v + 2 * t) * ps + r0 + g;
      split_tf32i(pk[0], ab[v][0], as[v][0]);        // (g, 2t)
      split_tf32i(pk[8], ab[v][1], as[v][1]);        // (g + 8, 2t)
      split_tf32i(pk[ps], ab[v][2], as[v][2]);       // (g, 2t + 1)
      split_tf32i(pk[ps + 8], ab[v][3], as[v][3]);   // (g + 8, 2t + 1)
    }
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      uint32_t bb[2][G][2], bs[2][G][2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int ok = (kk + 8 * v + 2 * t) * ys + n0 + g;
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if constexpr (EXACT_Y) {
            bb[v][u][0] = bf16_tf32(y[ok + 8 * (j0 + u)]);
            bb[v][u][1] = bf16_tf32(y[ok + 8 * (j0 + u) + ys]);
          } else {
            split_tf32i(y[ok + 8 * (j0 + u)], bb[v][u][0], bs[v][u][0]);
            split_tf32i(y[ok + 8 * (j0 + u) + ys], bb[v][u][1], bs[v][u][1]);
          }
        }
      }
      float f[G][4];
#pragma unroll
      for (int u = 0; u < G; ++u) f[u][0] = f[u][1] = f[u][2] = f[u][3] = 0.f;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if constexpr (!EXACT_Y) {
#pragma unroll
          for (int u = 0; u < G; ++u) mma_tf32(f[u], ab[v], bs[v][u]);
        }
#pragma unroll
        for (int u = 0; u < G; ++u) mma_tf32(f[u], as[v], bb[v][u]);
#pragma unroll
        for (int u = 0; u < G; ++u) mma_tf32(f[u], ab[v], bb[v][u]);
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j0 + u][e] += f[u][e];
    }
  }
}

// dq = sum over keys of (da / sqrt(D)) k + (1 - tanh(q)^2) sum du tanh(k),
// from the scratch (the dk / dv pass's da, du: scr [B, M, NP], du at
// offset B M NP); a partial per (block, bag) at index block + bag.
template <int D, bool PG, typename T>
__global__ void __launch_bounds__(32 * TileDq<D, T, PG>::NW, 1)
tile_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const int* __restrict__ list,
               const int* __restrict__ off, const float* __restrict__ scr,
               float* __restrict__ dq_part, int B, int N, int M, int NP) {
  using C = TileDq<D, T, PG>;
  constexpr int QT = C::QT, KS = C::KS, XS = C::XS, PS = C::PS, NSLOT = C::NSLOT;
  constexpr int NA = C::NA, NTH = 32 * C::NW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* tk_s = ring + NSLOT * C::SLOT;
  float* da_ring = reinterpret_cast<float*>(tk_s + (PG ? KS * XS : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * QT, NS = min(QT, N - n0);
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const int r0w = 16 * (warp % C::WR), n0a = 8 * NA * (warp / C::WR);
  const int gq = lane >> 2, tq = lane & 3;
  const size_t du_off = (size_t)B * M * NP;

  PkCursor cur{i0, 0};
  auto issue = [&](int slot) {  // the next sub-step's k rows and da (du) block
    if (cur.i >= i1) return;
    const int u = list[cur.i], b = u / n_tiles, t = u % n_tiles, r0 = t * FK_BM + cur.j * KS;
    load_tile_async<KS, D, XS>(ring + slot * C::SLOT, k + (size_t)b * M * D, D, r0, M);
    float* dst = da_ring + slot * C::DSLOT;
    const float* src = scr + (size_t)b * M * NP;
    load_da<KS, QT, PS>(dst, src, NP, r0, M, n0, NTH);
    if constexpr (PG) load_da<KS, QT, PS>(dst + KS * PS, src + du_off, NP, r0, M, n0, NTH);
    if (++cur.j == tile_subs<KS>(t, M)) {
      cur.j = 0;
      ++cur.i;
    }
  };
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) {
    issue(s);
    cp_async_commit();
  }

  float qa[NA][4];           // sum_r (da / sqrt(D)) k_r
  float qu[PG ? NA : 1][4];  // sum_r du tanh(k_r)
  int b = -1;
  auto flush = [&]() {  // bag b's dq partial at index block + b
    const size_t pb = (size_t)blockIdx.x + b;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0w + gq + 8 * h;
      if (row < NS) {
        const size_t o = ((size_t)b * N + n0 + row) * D + n0a + 2 * tq;
        float* dst = dq_part + (pb * N + n0 + row) * D + n0a + 2 * tq;
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          float x0 = qa[j][2 * h], x1 = qa[j][2 * h + 1];
          if constexpr (PG) {  // 1 - tanh(q)^2 of q's own value, in T's precision
            const float t0 = round_to<T>(tanhf(to_f32(q[o + 8 * j])));
            const float t1 = round_to<T>(tanhf(to_f32(q[o + 8 * j + 1])));
            x0 = fmaf(1.f - t0 * t0, qu[j][2 * h], x0);
            x1 = fmaf(1.f - t1 * t1, qu[j][2 * h + 1], x1);
          }
          store2(dst + 8 * j, x0, x1);
        }
      }
    }
  };

  int s = 0;
  for (int i = i0; i < i1; ++i) {
    const int u = list[i], ub = u / n_tiles, t = u % n_tiles, subs = tile_subs<KS>(t, M);
    for (int j = 0; j < subs; ++j, ++s) {
      cp_async_wait<NSLOT - 2>();
      __syncthreads();  // sub-step s landed; the last sub-step's products are done
      issue((s + NSLOT - 1) % NSLOT);
      cp_async_commit();
      if (ub != b) {  // a new bag: flush the last one's dq
        if (b >= 0) flush();
        b = ub;
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          qa[x][0] = qa[x][1] = qa[x][2] = qa[x][3] = 0.f;
          if constexpr (PG) qu[x][0] = qu[x][1] = qu[x][2] = qu[x][3] = 0.f;
        }
      }
      const T* ks = ring + (s % NSLOT) * C::SLOT;
      const float* das = da_ring + (s % NSLOT) * C::DSLOT;
      if constexpr (PG) {
        tanh_tile<KS, D, XS, NTH>(ks, tk_s);  // once per key and query tile
        __syncthreads();
      }
      value_product_t<NA, KS, C::GA>(qa, das, PS, ks, XS, r0w, n0a, lane);
      if constexpr (PG)
        value_product_t<NA, KS, C::GA>(qu, das + KS * PS, PS, tk_s, XS, r0w, n0a, lane);
    }
  }
  cp_async_wait<0>();
  if (b >= 0) flush();
}

template <int D, bool PG, typename T>
__global__ void __launch_bounds__(32 * TileDkv<D, T, PG>::NW, 1)
tile_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const uint8_t* __restrict__ mask, const int* __restrict__ list,
                const int* __restrict__ off, const int* __restrict__ seed_ptr, uint32_t thresh,
                float keep_scale, uint32_t bag0, const T* __restrict__ dout,
                const float* __restrict__ l, const float* __restrict__ m,
                const float* __restrict__ di, const float* __restrict__ dssq,
                const float* __restrict__ dsumw, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ scr, int B, int N, int M, int NP, float scale) {
  using C = TileDkv<D, T, PG>;
  using Tl = typename C::Tl;
  constexpr int KR = C::KR, QC = C::QC, XS = C::XS, SS = C::SS;
  constexpr int NT = Tl::NT, NA = Tl::NA, PART = C::WK * KR * SS, NTH = 32 * C::NW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + KR * XS;
  T* ring = v_s + KR * XS;
  T* tk_s = ring + C::NSLOT * C::SLOT;
  T* tq_s = tk_s + (PG ? KR * XS : 0);
  float* a_s = reinterpret_cast<float*>(tq_s + (PG ? QC * XS : 0));  // then da
  float* p_s = a_s + PART;                                            // dp, then pd
  float* g_s = p_s + PART;                                            // PG: g, then du
  float* st = g_s + (PG ? PART : 0);  // [5][NQ_MAX]: m, 1/l, di, dssq, dsumw

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tl tl(warp);
  const int n_tiles = (M + FK_BM - 1) / FK_BM, chunks = (N + QC - 1) / QC;
  const int per = units_per_block(off, B, gridDim.x);
  const int i0 = min(off[B], (int)blockIdx.x * per), i1 = min(off[B], i0 + per);
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const int r0w = 16 * tl.wr, n0a = 8 * NA * tl.wc;
  const int n0s = 8 * NT * tl.wn, k0s = Tl::KD * tl.wk;
  const int gq = lane >> 2, tq = lane & 3;

  // the block's row tiles in order: (list position, row tile of its unit);
  // next() moves to the following one (i == i1: none)
  struct RowCursor {
    int i, rt;
  };
  auto next = [&](RowCursor r) {
    const int t = list[r.i] % n_tiles;
    if (r.rt + 1 < FK_BM / KR && t * FK_BM + (r.rt + 1) * KR < M) return RowCursor{r.i, r.rt + 1};
    return RowCursor{r.i + 1, 0};
  };
  auto bag_of = [&](RowCursor r) { return list[r.i] / n_tiles; };
  auto issue_rows = [&](RowCursor r) {  // a row tile's k and v rows
    const int u = list[r.i], r0 = (u % n_tiles) * FK_BM + r.rt * KR;
    load_tile_async<KR, D, XS>(k_s, k + (size_t)(u / n_tiles) * M * D, D, r0, M);
    load_tile_async<KR, D, XS>(v_s, v + (size_t)(u / n_tiles) * M * D, D, r0, M);
  };
  auto issue_chunk = [&](T* slot, int b, int c) {  // bag b's queries c QC .. and their dout
    load_tile_async<QC, D, XS>(slot, q + (size_t)b * N * D, D, c * QC, N);
    load_tile_async<QC, D, XS>(slot + QC * XS, dout + (size_t)b * N * D, D, c * QC, N);
  };

  RowCursor cur{i0, 0};
  if (cur.i < i1) {
    issue_rows(cur);
    issue_chunk(ring, bag_of(cur), 0);
  }
  cp_async_commit();
  int s = 0;  // the block's chunk step: its slot s % NSLOT
  for (; cur.i < i1; cur = next(cur)) {
    const int u = list[cur.i], b = u / n_tiles, t = u % n_tiles, rt = cur.rt;
    const int r0 = t * FK_BM + rt * KR;  // the row tile's first key
    const RowCursor nxt = next(cur);
    {
      float ka[NA][4], vv[NA][4], ku[PG ? NA : 1][4];
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        ka[x][0] = ka[x][1] = ka[x][2] = ka[x][3] = 0.f;
        vv[x][0] = vv[x][1] = vv[x][2] = vv[x][3] = 0.f;
        if constexpr (PG) ku[x][0] = ku[x][1] = ku[x][2] = ku[x][3] = 0.f;
      }
      for (int c = 0; c < chunks; ++c, ++s) {
        cp_async_wait<0>();
        __syncthreads();  // chunk c (and the rows) landed; the last step's products are done
        if (rt == 0 && c == 0) {  // a new unit: its bag's statistics (read past the next barrier)
          for (int n = tid; n < N; n += NTH) {
            const size_t bn = (size_t)b * N + n;
            const float lv = l[bn];
            st[n] = m[bn];
            st[NQ_MAX + n] = lv == 0.f ? 1.f : 1.f / lv;
            st[2 * NQ_MAX + n] = di[bn];
            st[3 * NQ_MAX + n] = dssq != nullptr ? dssq[bn] : 0.f;
            st[4 * NQ_MAX + n] = dsumw != nullptr ? dsumw[bn] : 0.f;
          }
        }
        T* nx = ring + ((s + 1) % C::NSLOT) * C::SLOT;  // read by step s - 1, done
        if (c + 1 < chunks)
          issue_chunk(nx, b, c + 1);
        else if (nxt.i < i1)  // the next row tile's first chunk
          issue_chunk(nx, bag_of(nxt), 0);
        cp_async_commit();
        const T* qs = ring + (s % C::NSLOT) * C::SLOT;
        const T* os = qs + QC * XS;
        const int nc = c * QC;  // the chunk's first query
        if constexpr (PG) {
          tanh_tile<QC, D, XS, NTH>(qs, tq_s);             // once per query and row tile
          if (c == 0) tanh_tile<KR, D, XS, NTH>(k_s, tk_s);  // once per key
          __syncthreads();
        }

        // ---- (keys x queries) a = k q^T, g = tanh(k) tanh(q)^T, dp = v dout^T ----
        {
          float cc[NT][4];
          zero_c<NT>(cc);
          score_product<NT, Tl::KD, Tl::GR, C::SU>(cc, k_s, XS, qs, XS, r0w, n0s, k0s, lane);
          store_c<NT>(cc, a_s + tl.wk * KR * SS, SS, r0w, n0s, lane);
          zero_c<NT>(cc);
          score_product<NT, Tl::KD, Tl::GR, C::SU>(cc, v_s, XS, os, XS, r0w, n0s, k0s, lane);
          store_c<NT>(cc, p_s + tl.wk * KR * SS, SS, r0w, n0s, lane);
          if constexpr (PG) {
            zero_c<NT>(cc);
            score_product<NT, Tl::KD, Tl::GR, C::SU>(cc, tk_s, XS, tq_s, XS, r0w, n0s, k0s,
                                                     lane);
            store_c<NT>(cc, g_s + tl.wk * KR * SS, SS, r0w, n0s, lane);
          }
        }
        __syncthreads();  // the scores are done with k and v: the next row tile's land
        if (c + 1 == chunks && nxt.i < i1) issue_rows(nxt);  // during the sums below
        cp_async_commit();

        // ---- da, du, pd per (key, query), over slice 0 ----
        for (int e = tid; e < KR * QC; e += NTH) {
          const int row = e / QC, col = e % QC, key = r0 + row, n = nc + col;
          float da = 0.f, du = 0.f, pd = 0.f;
          if (key < M && n < N) {
            float dot = 0.f, uu = 0.f, dp = 0.f;
#pragma unroll
            for (int w = 0; w < C::WK; ++w) {
              const int x = (w * KR + row) * SS + col;
              dot += a_s[x];
              dp += p_s[x];
              if constexpr (PG) uu += g_s[x];
            }
            const bool valid = mask == nullptr || mask[(size_t)b * M + key];
            const bool drop = thresh != 0u;
            const bool keep = drop && dropout_bits(seed, bag0 + (uint32_t)b, (uint32_t)n,
                                                   (uint32_t)key) >= thresh;
            const PkGrad gr = pk_grad<PG>(dot, uu, dp, valid, st[n], st[NQ_MAX + n],
                                          st[2 * NQ_MAX + n], st[3 * NQ_MAX + n],
                                          st[4 * NQ_MAX + n], drop, keep, keep_scale, scale);
            da = gr.da;
            du = gr.du;
            pd = gr.pd;
          }
          a_s[row * SS + col] = da;
          p_s[row * SS + col] = pd;
          if constexpr (PG) g_s[row * SS + col] = du;
          if (key < M && n < N) {  // for the dq pass: keys major, queries contiguous
            const size_t o = ((size_t)b * M + key) * NP + n;
            scr[o] = da;
            if constexpr (PG) scr[(size_t)B * M * NP + o] = du;
          }
        }
        __syncthreads();

        // ---- dk, dv sums: da q, du tanh(q), pd dout ----
        value_product<NA, QC, Tl::GA>(ka, a_s, SS, qs, XS, r0w, n0a, lane);
        value_product<NA, QC, Tl::GA>(vv, p_s, SS, os, XS, r0w, n0a, lane);
        if constexpr (PG) value_product<NA, QC, Tl::GA>(ku, g_s, SS, tq_s, XS, r0w, n0a, lane);
      }

      // ---- dk = ka + (1 - tanh(k)^2) ku, dv: the row tile's keys < M, once ----
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0w + gq + 8 * h, key = r0 + row;
        if (key < M) {
          const size_t o = ((size_t)b * M + key) * D + n0a + 2 * tq;
#pragma unroll
          for (int j = 0; j < NA; ++j) {
            float x0 = ka[j][2 * h], x1 = ka[j][2 * h + 1];
            if constexpr (PG) {
              const int col = n0a + 8 * j + 2 * tq;
              const float t0 = to_f32(tk_s[row * XS + col]), t1 = to_f32(tk_s[row * XS + col + 1]);
              x0 = fmaf(1.f - t0 * t0, ku[j][2 * h], x0);
              x1 = fmaf(1.f - t1 * t1, ku[j][2 * h + 1], x1);
            }
            store2(dk + o + 8 * j, x0, x1);
            store2(dv + o + 8 * j, vv[j][2 * h], vv[j][2 * h + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The forward's launches: the tile flags and list, tile_fwd_kernel on a grid
// (per_tile, S), S = ceil(N / QT) query tiles and per_tile = max(1, the
// blocks resident at once (at most max_blocks) / S), combine_kernel (o in T).
// Partials: [per_tile + B, N, *].
template <int D, bool PG, bool TRAIN, typename T>
int launch_tile_fwd(const T* q, const T* k, const T* v, const uint8_t* mask, const int* seed,
                    T* o, float* l, float* m, float* ssq, float* sumw, float* o_part,
                    float* ml_part, float* sq_part, uint8_t* flags, int* list, int* off, int B,
                    int N, int M, int max_blocks, float scale, uint32_t thresh, float keep_scale,
                    uint32_t bag0, cudaStream_t st) {
  using C = TileFwd<D, T, PG>;
  static bool allowed[64] = {};
  static int resident[64] = {};
  constexpr int smem = C::BYTES;
  int err = allow_dynamic_smem(tile_fwd_kernel<D, PG, TRAIN, T>, smem, allowed);
  if (err) return err;
  int blocks = 0;
  err = resident_blocks(tile_fwd_kernel<D, PG, TRAIN, T>, smem, max_blocks, resident, &blocks,
                        32 * C::NW);
  if (err) return err;
  launch_tile_list(mask, nullptr, nullptr, flags, list, off, B, M, 0, st);
  const int tiles = (N + C::QT - 1) / C::QT, per_tile = max(1, blocks / tiles);
  tile_fwd_kernel<D, PG, TRAIN, T><<<dim3(per_tile, tiles), 32 * C::NW, smem, st>>>(
      q, k, v, mask, list, off, o_part, ml_part, sq_part, seed, thresh, keep_scale, bag0, B, N, M,
      scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<T><<<dim3(B, N), THREADS, 0, st>>>(o_part, ml_part, TRAIN ? sq_part : nullptr,
                                                 o, l, m, ssq, TRAIN ? sumw : nullptr, N, D,
                                                 per_tile, off);
  return (int)cudaGetLastError();
}

// The backward's launches: the tile flags and list (writing dk = dv = 0 on
// the skipped tiles), tile_dkv_kernel over the blocks resident at once (dk,
// dv, and da (du) into the scratch), tile_dq_kernel on a grid (per_tile, S)
// as the forward, bwd_reduce_kernel (the dq partials in block order).
// dq_part holds [max(1, max_blocks / S) + B, N, D] partials, then the
// scratch [B, M, NP] (twice with the pre-gate), NP = S QT.
template <int D, bool PG, typename T>
int launch_tile_bwd(const T* q, const T* k, const T* v, const uint8_t* mask, const int* seed,
                    const T* dout, const float* l, const float* m, const float* di,
                    const float* dssq, const float* dsumw, T* dq, T* dk, T* dv, float* dq_part,
                    uint8_t* flags, int* list, int* off, int B, int N, int M, int max_blocks,
                    float scale, uint32_t thresh, float keep_scale, uint32_t bag0,
                    cudaStream_t st) {
  using Q = TileDq<D, T, PG>;
  using K = TileDkv<D, T, PG>;
  static bool allowed_dq[64] = {}, allowed_kv[64] = {};
  static int resident_dq[64] = {}, resident_kv[64] = {};
  int err = allow_dynamic_smem(tile_dq_kernel<D, PG, T>, Q::BYTES, allowed_dq);
  if (err) return err;
  err = allow_dynamic_smem(tile_dkv_kernel<D, PG, T>, K::BYTES, allowed_kv);
  if (err) return err;
  int dq_blocks = 0, kv_blocks = 0;
  err = resident_blocks(tile_dq_kernel<D, PG, T>, Q::BYTES, max_blocks, resident_dq, &dq_blocks,
                        32 * Q::NW);
  if (err) return err;
  err = resident_blocks(tile_dkv_kernel<D, PG, T>, K::BYTES, max_blocks, resident_kv, &kv_blocks,
                        32 * K::NW);
  if (err) return err;
  const int tiles = (N + Q::QT - 1) / Q::QT, per_tile = max(1, dq_blocks / tiles);
  const int NP = tiles * Q::QT;
  float* scr = dq_part + (size_t)(max(1, max_blocks / tiles) + B) * N * D;
  launch_tile_list(mask, dk, dv, flags, list, off, B, M, D, st, false, (int)sizeof(T));
  tile_dkv_kernel<D, PG, T><<<kv_blocks, 32 * K::NW, K::BYTES, st>>>(
      q, k, v, mask, list, off, seed, thresh, keep_scale, bag0, dout, l, m, di, dssq, dsumw, dk,
      dv, scr, B, N, M, NP, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  tile_dq_kernel<D, PG, T><<<dim3(per_tile, tiles), 32 * Q::NW, Q::BYTES, st>>>(
      q, k, list, off, scr, dq_part, B, N, M, NP);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)B * N * D;
  bwd_reduce_kernel<T><<<(int)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      dq_part, nullptr, nullptr, off, dq, nullptr, nullptr, B, per_tile, 0, 0, N, D, 0);
  return (int)cudaGetLastError();
}

}  // namespace mpo
