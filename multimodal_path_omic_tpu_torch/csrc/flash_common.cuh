// Shared by csrc/flash.cu (forward), csrc/flash_bwd.cu (backward) and,
// through fused_k_common.cuh, csrc/coattn.cu and csrc/coattn_bwd.cu (the
// fuse-K co-attention forward and backward): the mask value, the
// tile copies between device and shared memory (cp.async), the key-tile
// flags, and the two tensor-core products every phase of these kernels is
// made of.
//
// Products run on the tensor cores as warp-level
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 at float32 accuracy ("3xTF32",
// what CUTLASS's OpMultiplyAddFastF32 and PyTorch's float32
// memory-efficient attention do): each float32 operand x is split into
// big = tf32(x) and small = tf32(x - big) (x - big is exact), and a product
// a b is accumulated in float32 as a_big b_small + a_small b_big first, then
// a_big b_big. big + small carries 22 of float32's 24 significant bits, and
// the dropped a_small b_small term is ~2^-22 of a b, so a product is off
// float32's by a few units of 2^-22 relative where 1xTF32 (a_big b_big alone)
// is off by ~2^-11: 3xTF32 keeps the kernels within the float32 parity bar
// (1e-4 of the plain versions on the card), 1xTF32 does not
// (tests/test_torch_port_flash.py measures both).
//
// Operands sit in shared memory row-major, rows padded so that a warp's
// fragment loads hit distinct banks:
//   * "row" products C[16 x 8n] = X[16 rows][depth] Y[8n rows][depth]^T
//     (scores; A = X rows, B = Y rows, both indexed (row, depth));
//   * "acc" products C[16 x 8n] += P[16 rows][k] Y[k][8n columns]
//     (P V and its kin; A = P, B = Y indexed (k, column)), P optionally
//     read transposed.
// Either kind takes MR row groups of 16 at once (the _rows forms), splitting
// each B fragment once for all of them.
// Each 8-deep step sums in fresh registers and is added into the float32
// sums with a rounded add (mma_group).
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "coattn_common.cuh"

namespace mpo {

// ---------------------------------------------------------------------------
// Element types: float32, or bfloat16 through the intrinsics only
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
constexpr bool IS_BF16 = std::is_same<T, __nv_bfloat16>::value;

// x rounded to T's precision (round to nearest even), kept in float32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (IS_BF16<T>) return __bfloat162float(__float2bfloat16(x));
  else return x;
}

// Two consecutive outputs (dst 4- / 8-byte aligned) in T.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store1(float* dst, float a) { *dst = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float a) { *dst = __float2bfloat16(a); }

// Four consecutive values (16-byte aligned floats, 8-byte aligned bfloat16s)
// as float4.
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  return bf16x4_to_float4(*reinterpret_cast<const uint2*>(src));
}

// Register prefetch of bfloat16 values (the kernels' bfloat16 instances):
// four values fetched as raw bits (zeros without pred, reading nothing),
// then, once the product they overlap is done, stored as float32 into a
// shared tile.
__device__ __forceinline__ uint2 fetch_bf16x4(const __nv_bfloat16* src, bool pred) {
  return pred ? *reinterpret_cast<const uint2*>(src) : make_uint2(0u, 0u);
}
__device__ __forceinline__ void store_bf16x4(float* dst, uint2 u) {
  *reinterpret_cast<float4*>(dst) = bf16x4_to_float4(u);
}

constexpr float MASK_NEG = -1e9f;  // ops/layers.py NEG_INF

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------

// 16 bytes device -> shared without a register stop; src_size 0 writes zeros
// (rows past L), reading nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

// Four bfloat16 values into four shared floats, synchronously (zeros
// without pred; the export passes' bfloat16 instances); the float32
// overload is cp_async16.
__device__ __forceinline__ void cp_async16(float* dst, const __nv_bfloat16* src, bool pred) {
  *reinterpret_cast<float4*>(dst) = pred ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight (the
// caller then needs a barrier before reading other threads' copies).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0+ROWS-1 of an operand [L][DH] (row stride sl floats, unit
// stride inside a row) into dst [ROWS][STRIDE], asynchronously; zero rows
// past L.
template <int ROWS, int DH, int STRIDE, typename T>
__device__ __forceinline__ void load_tile_async(float* __restrict__ dst,
                                                const T* __restrict__ src, long long sl,
                                                int r0, int L) {
  constexpr int V4 = DH / 4;
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += blockDim.x) {
    const int row = idx / V4, c = idx % V4;
    const bool ok = r0 + row < L;
    cp_async16(dst + row * STRIDE + 4 * c, ok ? src + (long long)(r0 + row) * sl + 4 * c : src,
               ok);
  }
}

// The same, synchronous and multiplied by `scale` (the rows a block holds for
// its whole life).
template <int ROWS, int DH, int STRIDE>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          long long sl, int r0, int L, float scale) {
  constexpr int V4 = DH / 4;
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += blockDim.x) {
    const int row = idx / V4, c = idx % V4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < L) x = *reinterpret_cast<const float4*>(src + (long long)(r0 + row) * sl + 4 * c);
    *reinterpret_cast<float4*>(dst + row * STRIDE + 4 * c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// ---------------------------------------------------------------------------
// Key-tile flags. With at least one valid key in the bag, a tile whose keys
// are all masked adds exactly 0 to every output (its weights exp(-1e9 - m)
// underflow to 0, its ds is 0 by the mask's where), so the kernels skip it.
// A bag without a valid key is computed in full (every weight is 1/L).
// Every thread of the block must call these (block-wide barriers).
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool bag_has_valid_key(const uint8_t* __restrict__ mask_b, int L) {
  if (mask_b == nullptr) return true;
  for (int base = 0; base < L; base += blockDim.x) {
    const int key = base + threadIdx.x;
    if (__syncthreads_or(key < L && mask_b[key] != 0)) return true;
  }
  return false;
}

// The first tile from `t` on (tiles of BC keys) that holds a valid key, or
// n_tiles; with `skip` false simply t.
template <int BC>
__device__ __forceinline__ int next_tile(const uint8_t* __restrict__ mask_b, int t, int n_tiles,
                                         int L, bool skip) {
  static_assert(BC <= 256, "one thread a key");
  if (!skip) return t;
  for (; t < n_tiles; ++t) {
    const int key = t * BC + threadIdx.x;
    if (__syncthreads_or(threadIdx.x < BC && key < L && mask_b[key] != 0)) break;
  }
  return t;
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows r0.. (16) and columns k0.. (8) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                       const float* __restrict__ tile, int stride, int r0, int k0,
                                       int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * stride + k0 + (lane & 3);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * stride], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * stride + 4], big[3], small[3]);
}

// c[j0 + u] += a b_u for G column tiles u at float32 accuracy: three rounds
// of G independent MMAs (the two cross terms, then big x big) into fresh
// sums, then one float32 add into c per element. The tensor cores' adds do
// not round to nearest; accumulating a whole row of k-steps in them would let
// that error grow with the depth (enough to move l past its 1e-5 relative
// limit at width 256), where the fresh sums keep it to one 8-deep step and
// the adds into c round to nearest. Independent MMAs in flight between
// dependent ones keep the tensor cores fed.
template <int NT, int G>
__device__ __forceinline__ void mma_group(float (&c)[NT][4], int j0, const uint32_t (&a_big)[4],
                                          const uint32_t (&a_small)[4],
                                          const uint32_t (&b_big)[G][2],
                                          const uint32_t (&b_small)[G][2]) {
  float t[G][4];
#pragma unroll
  for (int u = 0; u < G; ++u) t[u][0] = t[u][1] = t[u][2] = t[u][3] = 0.f;
#pragma unroll
  for (int u = 0; u < G; ++u) mma_tf32(t[u], a_big, b_small[u]);
#pragma unroll
  for (int u = 0; u < G; ++u) mma_tf32(t[u], a_small, b_big[u]);
#pragma unroll
  for (int u = 0; u < G; ++u) mma_tf32(t[u], a_big, b_big[u]);
#pragma unroll
  for (int u = 0; u < G; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j0 + u][e] += t[u][e];
}

// "row" product over MR row groups at once: c[i][j] += X[r0 + 16 i .. +16][k]
// Y[n0 + 8j .. +8][k]^T over depths k0 .. k0+KD-1, for NT column tiles of 8,
// G at a time; each B fragment is split once for all MR row groups.
template <int MR, int NT, int KD, int G>
__device__ __forceinline__ void row_product_rows(float (&c)[MR][NT][4],
                                                 const float* __restrict__ x, int xs,
                                                 const float* __restrict__ y, int ys, int r0,
                                                 int n0, int k0, int lane) {
  static_assert(NT % G == 0, "column tile groups");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < KD; kk += 8) {
    uint32_t ab[MR][4], as[MR][4];
#pragma unroll
    for (int i = 0; i < MR; ++i) load_a(ab[i], as[i], x, xs, r0 + 16 * i, k0 + kk, lane);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      uint32_t bb[G][2], bs[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float* p = y + (n0 + 8 * (j0 + u) + g) * ys + k0 + kk + t;
        split_tf32(p[0], bb[u][0], bs[u][0]);
        split_tf32(p[4], bb[u][1], bs[u][1]);
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) mma_group<NT, G>(c[i], j0, ab[i], as[i], bb, bs);
    }
  }
}

// "row" product of one row group: c[j] += X[r0.. +16][k] Y[n0 + 8j .. +8][k]^T.
template <int NT, int KD, int G>
__device__ __forceinline__ void row_product(float (&c)[NT][4], const float* __restrict__ x,
                                            int xs, const float* __restrict__ y, int ys, int r0,
                                            int n0, int k0, int lane) {
  row_product_rows<1, NT, KD, G>(*reinterpret_cast<float(*)[1][NT][4]>(&c), x, xs, y, ys, r0,
                                 n0, k0, lane);
}

// "acc" product over MR row groups at once: c[i][j] += P[r0 + 16 i .. +16][k]
// Y[k][n0 + 8j .. +8] over k in 0 .. KC-1, for NT column tiles of 8, G at a
// time; each B fragment is split once for all MR row groups. The 8 k of a
// step are taken in the order lane t holds k = 2t, 2t+1 (a0/a2 and b0/b1),
// not t, t+4: the sum is the same, the A pair is one 8-byte load, and with
// the row strides of Tiles (P: 8 mod 32 floats, Y: 4 mod 32) no load of the
// step has a bank conflict. TA: P lies transposed, element (row, k) at
// p[k * ps + row] (an A fragment read column-major: kvT dk, whose kv tile
// lies [keys][features]); conflict free with ps = 4 mod 32.
template <int MR, int NT, int KC, int G, bool TA = false>
__device__ __forceinline__ void acc_product_rows(float (&c)[MR][NT][4],
                                                 const float* __restrict__ p, int ps,
                                                 const float* __restrict__ y, int ys, int r0,
                                                 int n0, int lane) {
  static_assert(NT % G == 0, "column tile groups");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t ab[MR][4], as[MR][4];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = r0 + 16 * i + g;
      float x0, x1, x2, x3;  // (r, 2t), (r + 8, 2t), (r, 2t + 1), (r + 8, 2t + 1)
      if constexpr (TA) {
        const float* pk = p + (kk + 2 * t) * ps + r;
        x0 = pk[0]; x1 = pk[8]; x2 = pk[ps]; x3 = pk[ps + 8];
      } else {
        const float2 lo = *reinterpret_cast<const float2*>(p + r * ps + kk + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(p + (r + 8) * ps + kk + 2 * t);
        x0 = lo.x; x1 = hi.x; x2 = lo.y; x3 = hi.y;
      }
      split_tf32(x0, ab[i][0], as[i][0]);
      split_tf32(x1, ab[i][1], as[i][1]);
      split_tf32(x2, ab[i][2], as[i][2]);
      split_tf32(x3, ab[i][3], as[i][3]);
    }
    const float* yk = y + (kk + 2 * t) * ys + n0 + g;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      uint32_t bb[G][2], bs[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        split_tf32(yk[8 * (j0 + u)], bb[u][0], bs[u][0]);
        split_tf32(yk[8 * (j0 + u) + ys], bb[u][1], bs[u][1]);
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) mma_group<NT, G>(c[i], j0, ab[i], as[i], bb, bs);
    }
  }
}

// "acc" product of one row group: c[j] += P[r0.. +16][k] Y[k][n0 + 8j .. +8].
template <int NT, int KC, int G>
__device__ __forceinline__ void acc_product(float (&c)[NT][4], const float* __restrict__ p,
                                            int ps, const float* __restrict__ y, int ys, int r0,
                                            int n0, int lane) {
  acc_product_rows<1, NT, KC, G>(*reinterpret_cast<float(*)[1][NT][4]>(&c), p, ps, y, ys, r0,
                                 n0, lane);
}

// A warp's C fragments (rows r0 .. r0+15, columns n0 .. n0+8*NT-1) into a
// row-major tile.
template <int NT>
__device__ __forceinline__ void store_c(const float (&c)[NT][4], float* __restrict__ tile,
                                        int stride, int r0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* p = tile + (r0 + g) * stride + n0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(p + 8 * stride) = make_float2(c[j][2], c[j][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero_c(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// ---------------------------------------------------------------------------
// bfloat16 tiles and products (the flash kernels' bfloat16 instances)
//
// Operands stay bfloat16 in shared memory: cp.async copies their bytes as
// they are (8 values a 16-byte copy), rows padded by 8 values so that a
// warp's 4-byte fragment loads and ldmatrix's 16-byte rows hit distinct
// banks. Products are mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: each
// product of two bfloat16 values is exact in float32, the sum float32.
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4, t = lane % 4,
// two values a register, the lower column (or k) in the low half:
//   A a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8.., n = g)
//   C as the TF32 form's
// The A operand and the B operand of a "row" product (Y indexed (n, k)) are
// pairs of neighbours in a row: one 4-byte load each. The B operand of an
// "acc" product (Y indexed (k, n), row-major) pairs two rows: ldmatrix
// .trans reads 8 x 8 blocks and hands each lane its transposed pair.
// ---------------------------------------------------------------------------

// 16 bytes device -> shared, the bytes as they are (zeros without pred).
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

// Rows r0 .. r0+ROWS-1 of a bfloat16 operand [L][DH] (row stride sl values,
// a multiple of 8) into a bfloat16 tile [ROWS][STRIDE], asynchronously;
// zero rows past L.
template <int ROWS, int DH, int STRIDE>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* __restrict__ dst,
                                                const __nv_bfloat16* __restrict__ src,
                                                long long sl, int r0, int L) {
  constexpr int V8 = DH / 8;
  for (int idx = threadIdx.x; idx < ROWS * V8; idx += blockDim.x) {
    const int row = idx / V8, c = idx % V8;
    const bool ok = r0 + row < L;
    cp_async16(dst + row * STRIDE + 8 * c, ok ? src + (long long)(r0 + row) * sl + 8 * c : src,
               ok);
  }
}

__device__ __forceinline__ uint32_t lds_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows r0.. (16) and columns k0.. (16) of a row-major tile.
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4], const __nv_bfloat16* __restrict__ x,
                                            int xs, int r0, int k0, int lane) {
  const __nv_bfloat16* p = x + (r0 + (lane >> 2)) * xs + k0 + 2 * (lane & 3);
  a[0] = lds_pair(p);
  a[1] = lds_pair(p + 8 * xs);
  a[2] = lds_pair(p + 8);
  a[3] = lds_pair(p + 8 * xs + 8);
}

// The B fragment of k rows k0 .. k0+15 and columns n0 .. n0+7 of a row-major
// tile Y[k][n] (rows 16-byte aligned): lanes 0-15 name the 16 rows.
__device__ __forceinline__ void load_b_trans_bf16(uint32_t (&b)[2],
                                                  const __nv_bfloat16* __restrict__ y, int ys,
                                                  int k0, int n0, int lane) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(y + (k0 + (lane & 15)) * ys + n0);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(s));
}

// "row" product, bfloat16 operands: c[j] += X[r0.. +16][k] Y[n0 + 8j .. +8][k]^T
// over depths k0 .. k0+KD-1 (the float32 form's arguments; G unused).
template <int NT, int KD, int G>
__device__ __forceinline__ void row_product(float (&c)[NT][4],
                                            const __nv_bfloat16* __restrict__ x, int xs,
                                            const __nv_bfloat16* __restrict__ y, int ys, int r0,
                                            int n0, int k0, int lane) {
  static_assert(KD % 16 == 0, "bfloat16 MMA depth");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = k0; kk < k0 + KD; kk += 16) {
    uint32_t a[4];
    load_a_bf16(a, x, xs, r0, kk, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* p = y + (n0 + 8 * j + g) * ys + kk + 2 * t;
      const uint32_t b[2] = {lds_pair(p), lds_pair(p + 8)};
      mma_bf16(c[j], a, b);
    }
  }
}

// "acc" product, bfloat16 operands: c[j] += P[r0.. +16][k] Y[k][n0 + 8j .. +8]
// over k in 0 .. KC-1 (the float32 form's arguments; G unused).
template <int NT, int KC, int G>
__device__ __forceinline__ void acc_product(float (&c)[NT][4],
                                            const __nv_bfloat16* __restrict__ p, int ps,
                                            const __nv_bfloat16* __restrict__ y, int ys, int r0,
                                            int n0, int lane) {
  static_assert(KC % 16 == 0, "bfloat16 MMA depth");
#pragma unroll 1
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t a[4];
    load_a_bf16(a, p, ps, r0, kk, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[2];
      load_b_trans_bf16(b, y, ys, kk, n0 + 8 * j, lane);
      mma_bf16(c[j], a, b);
    }
  }
}

// A bfloat16 value widened to float32: its own TF32 big part (small part 0),
// as the plain-K kernels' value products take a bfloat16 B operand.
__device__ __forceinline__ uint32_t bf16_tf32(__nv_bfloat16 x) {
  return __float_as_uint(__bfloat162float(x));
}

// The tile shape both kernels share. A block of NW warps owns BR rows (held in
// shared memory for its life) and walks the other side in tiles of BC rows.
//   * row products (BR x BC scores): warp w takes rows 16 (w % WR) and, of the
//     remaining NW / WR, column group and depth slice; WK depth slices write
//     partial tiles that the elementwise pass sums in a fixed order;
//   * acc products (BR x DH sums in registers): rows 16 (w % WR), columns
//     DH / WCA (w / WR).
template <int DH_, int BR_, int BC_, int WK_, int NW_>
struct Tiles {
  static constexpr int DH = DH_, BR = BR_, BC = BC_, WK = WK_, NW = NW_;
  static constexpr int WR = BR / 16;               // row groups
  static constexpr int WCA = NW / WR;              // column groups of the sums
  static constexpr int WN = WCA / WK;              // column groups of the scores
  static constexpr int NT = BC / 8 / WN;           // score column tiles a warp
  static constexpr int KD = DH / WK;               // depth a warp's score slice sums
  static constexpr int NA = DH / 8 / WCA;          // sum column tiles a warp
  static constexpr int XS = DH + 4;                // row stride of an operand tile
  static constexpr int SS = BC + 8;                // row stride of a score tile
  static constexpr int GR = NT < 4 ? NT : 4;       // column tiles in flight, scores
  static constexpr int GA = NA < 4 ? NA : 4;       // column tiles in flight, sums
  static_assert(WR * WCA == NW && WN * WK == WCA, "warp grid");
  static_assert(NT >= 1 && NT * 8 * WN == BC && KD % 8 == 0, "score tiles");
  static_assert(NA >= 1 && NA * 8 * WCA == DH, "sum tiles");

  int wr, wn, wk, wc;  // this warp's place
  __device__ __forceinline__ explicit Tiles(int warp)
      : wr(warp % WR), wn((warp / WR) % WN), wk(warp / WR / WN), wc(warp / WR) {}
};

// The attribute that allows more than 48 KB of dynamic shared memory belongs
// to (kernel instance, device): set once for each.
template <typename Kernel>
int allow_dynamic_smem(Kernel kernel, int bytes, bool (&allowed)[64]) {
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err) return err;
  if (device >= 64 || !allowed[device]) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    if (device < 64) allowed[device] = true;
  }
  return 0;
}

}  // namespace mpo
