// Streaming masked gated-MIL pooling for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel of multimodal_path_omic_tpu/ops/milpool.py
// (_kernel / fused_gated_mil_pool): for every bag b over its M patches x [M, D]
//   a = tanh(x Wa + ba),  g = sigmoid(x Wb + bb)            [M, H]
//   s = (a * g) . wc + bc                                    [M]  raw, emitted
//   w = softmax(where(mask, s, -1e9))                        [M]
//   pooled = w x                                             [D]
// The [M, H] branch activations never reach device memory. The mask value is
// the finite -1e9 of ops/layers.py (masked_softmax): a fully-masked bag pools
// uniformly over its M patches, never NaN. Patches at index >= M do not exist
// (weight exactly 0). The raw scores are written unmasked, pad patches too.
//
// What bounds it on an H100, and what the design does about it: the two
// gating products are 4*B*M*D*H float32 operations (34 GFLOP at B=8,
// M=16384, D=H=256: 0.51 ms at 67 TFLOP/s) against 134 MB of x (0.04 ms at
// 3.35 TB/s), so it is bound by operations. The TPU kernel walks a bag's
// tiles in order on one core with (m, l, acc) in scratch; here B=8 bags would
// fill 8 of 132 SMs that way, so a bag's 64-patch tiles are split over
// several blocks that write unnormalized (m, l, acc) partials, and a second
// small kernel merges them in a fixed order (l == 0 guard kept). Both
// products share the x tile: the weights come packed as [H/128][D][256] with
// columns [128 of Wa | the same 128 of Wb], and a tile is multiplied one pack
// at a time by a register-tiled SIMT GEMM (8 patches x 8 columns a thread:
// 4 of a and the matching 4 of g, so tanh * sigmoid * wc needs no exchange),
// the next depth chunk prefetched into registers during the math. The score
// is a warp-shuffle reduction over H; pooled += p * x re-reads the tile from
// L2. Products stay float32 FMAs (no TF32: the port is held to float32
// parity).
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launches (0 = success); allocates nothing, runs on the caller's stream.

#include "coattn_common.cuh"

namespace {

using namespace mpo;

constexpr float MASK_NEG = -1e9f;  // ops/layers.py NEG_INF
constexpr int HC = 128;            // hidden units per pack
constexpr int PC = 2 * HC;         // packed columns per pack: [a | g]
constexpr int DMAX = 1024;         // widest x row (4 columns per thread)

// One block = (bag b, split of the patch tiles). Writes the raw scores of its
// tiles and unnormalized partials o_part [B, P, D], ml_part [B, P, 2] (m, l).
template <int FC>
__global__ void __launch_bounds__(THREADS)
milpool_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ wc, const float* __restrict__ bc,
               float* __restrict__ scores, float* __restrict__ o_part,
               float* __restrict__ ml_part, int M, int D, int C, int tiles_per_split) {
  // Lane `lane` owns packed columns (j / 4) * 128 + 4 * lane + j % 4: hidden
  // units 4*lane .. 4*lane+3 of the pack, a for j < 4 and g for j >= 4; warp
  // w owns patch rows 8w .. 8w+7 of the tile. x_s is stored transposed, so a
  // warp's 8 rows at one depth are two broadcast float4 reads.
  constexpr int EPT = PC / 32;                     // packed columns per lane
  constexpr int W_V4 = FK_BF * PC / 4 / THREADS;   // weight float4s per thread per chunk
  __shared__ __align__(16) float x_s[FK_BF][FK_BM + 4];
  __shared__ __align__(16) float w_s[FK_BF][PC];
  __shared__ float p_s[FK_BM];
  __shared__ float alpha_s;

  const int b = blockIdx.x, split = blockIdx.y, P = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float m_run = -3.0e38f, l_run = 0.f;  // the softmax state (warp 0)
  float pacc[FC];
#pragma unroll
  for (int c = 0; c < FC; ++c) pacc[c] = 0.f;
  const float bcv = bc[0];

  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  const float* x_b = x + (size_t)b * M * D;
  const int x_row = tid >> 2, x_c4 = tid & 3;  // this thread's x float4 per chunk
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = t0; t < t1; ++t) {
    const int m0 = t * FK_BM;
    const bool x_ok = m0 + x_row < M;  // zero rows past M
    const float* x_src = x_b + (size_t)(m0 + x_row) * D + x_c4 * 4;
    float spart[FK_RPW];
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i) spart[i] = 0.f;

    for (int c = 0; c < C; ++c) {
      // ---- [a | g] pack c of the tile = x[m0:m0+64] @ w[c], register-tiled;
      //      the next depth chunk is prefetched into registers during the math
      const float* w_c = w + (size_t)c * D * PC;
      float acc[FK_RPW][EPT];
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
        for (int j = 0; j < EPT; ++j) acc[i][j] = 0.f;

      float4 xreg = x_ok ? *reinterpret_cast<const float4*>(x_src) : zero4;
      float4 wreg[W_V4];
#pragma unroll
      for (int v = 0; v < W_V4; ++v) {
        const int idx = tid + v * THREADS, r = idx / (PC / 4), cc = idx % (PC / 4);
        wreg[v] = reinterpret_cast<const float4*>(w_c + (size_t)r * PC)[cc];
      }
      for (int f0 = 0; f0 < D; f0 += FK_BF) {
        x_s[x_c4 * 4 + 0][x_row] = xreg.x;
        x_s[x_c4 * 4 + 1][x_row] = xreg.y;
        x_s[x_c4 * 4 + 2][x_row] = xreg.z;
        x_s[x_c4 * 4 + 3][x_row] = xreg.w;
#pragma unroll
        for (int v = 0; v < W_V4; ++v) {
          const int idx = tid + v * THREADS, r = idx / (PC / 4), cc = idx % (PC / 4);
          reinterpret_cast<float4*>(&w_s[r][0])[cc] = wreg[v];
        }
        __syncthreads();
        if (f0 + FK_BF < D) {  // prefetch the next chunk; lands during the math
          xreg = x_ok ? *reinterpret_cast<const float4*>(x_src + f0 + FK_BF) : zero4;
#pragma unroll
          for (int v = 0; v < W_V4; ++v) {
            const int idx = tid + v * THREADS, r = idx / (PC / 4), cc = idx % (PC / 4);
            wreg[v] = reinterpret_cast<const float4*>(w_c + (size_t)(f0 + FK_BF + r) * PC)[cc];
          }
        }
#pragma unroll
        for (int kk = 0; kk < FK_BF; ++kk) {
          float a[FK_RPW], wv[EPT];
          const float4 a0 = *reinterpret_cast<const float4*>(&x_s[kk][warp * FK_RPW]);
          const float4 a1 = *reinterpret_cast<const float4*>(&x_s[kk][warp * FK_RPW + 4]);
          a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
          a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
          for (int j4 = 0; j4 < EPT / 4; ++j4) {
            const float4 v4 = *reinterpret_cast<const float4*>(&w_s[kk][j4 * 128 + 4 * lane]);
            wv[4 * j4 + 0] = v4.x; wv[4 * j4 + 1] = v4.y; wv[4 * j4 + 2] = v4.z; wv[4 * j4 + 3] = v4.w;
          }
#pragma unroll
          for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
            for (int j = 0; j < EPT; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
        }
        __syncthreads();
      }

      // ---- epilogue of the pack: biases, tanh * sigmoid, the wc dot ----
      const float4 ba = *reinterpret_cast<const float4*>(bias + (size_t)c * PC + 4 * lane);
      const float4 bg = *reinterpret_cast<const float4*>(bias + (size_t)c * PC + HC + 4 * lane);
      const float4 wv = *reinterpret_cast<const float4*>(wc + (size_t)c * HC + 4 * lane);
      const float bav[4] = {ba.x, ba.y, ba.z, ba.w}, bgv[4] = {bg.x, bg.y, bg.z, bg.w};
      const float wcv[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < FK_RPW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float av = tanhf(acc[i][j] + bav[j]);
          const float gv = 1.f / (1.f + expf(-(acc[i][4 + j] + bgv[j])));
          spart[i] = fmaf(av * gv, wcv[j], spart[i]);
        }
    }

    // ---- raw score out; masked score -> p_s[row] ----
#pragma unroll
    for (int i = 0; i < FK_RPW; ++i) {
      const float s = warp_sum(spart[i]) + bcv;
      if (lane == i) {
        const int row = warp * FK_RPW + i, key = m0 + row;
        float sm = s;
        if (key >= M) {
          sm = -INFINITY;  // does not exist: weight exactly 0
        } else {
          scores[(size_t)b * M + key] = s;
          if (mask != nullptr && !mask[(size_t)b * M + key]) sm = MASK_NEG;
        }
        p_s[row] = sm;
      }
    }
    __syncthreads();

    // ---- online softmax of the one query (warp 0) ----
    if (warp == 0) {
      const float s0 = p_s[lane], s1 = p_s[lane + 32];
      const float m_new = fmaxf(m_run, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_run - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l_run = l_run * alpha + warp_sum(p0 + p1);
      m_run = m_new;
      p_s[lane] = p0;
      p_s[lane + 32] = p1;
      if (lane == 0) alpha_s = alpha;
    }
    __syncthreads();

    // ---- pooled[d] = alpha * pooled + sum_r p[r] * x[r, d] (x re-read, L2) ----
    const float alpha = alpha_s;
#pragma unroll
    for (int c = 0; c < FC; ++c) pacc[c] *= alpha;
    const int rows = min(FK_BM, M - m0);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const float* xr = x_b + (size_t)(m0 + r) * D;
      const float p = p_s[r];
#pragma unroll
      for (int c = 0; c < FC; ++c) {
        const int d = tid + THREADS * c;
        if (d < D) pacc[c] = fmaf(p, xr[d], pacc[c]);
      }
    }
    __syncthreads();  // p_s / alpha_s are rewritten by the next tile
  }

  const size_t pb = (size_t)b * P + split;
#pragma unroll
  for (int c = 0; c < FC; ++c) {
    const int d = tid + THREADS * c;
    if (d < D) o_part[pb * D + d] = pacc[c];
  }
  if (tid == 0) {
    ml_part[pb * 2 + 0] = m_run;
    ml_part[pb * 2 + 1] = l_run;
  }
}

// Merge a bag's P partials in a fixed order:
//   m = max_p m_p;  l = sum_p l_p e^(m_p - m);  pooled = sum_p o_p e^(m_p - m) / l
// with the l == 0 guard of the TPU kernel.
__global__ void __launch_bounds__(THREADS)
milpool_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                     float* __restrict__ pooled, int D, int P) {
  __shared__ float fac[MAX_PARTS];
  __shared__ float red[WARPS];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* ml = ml_part + (size_t)b * P * 2;

  float mx = -3.0e38f;
  for (int p = tid; p < P; p += THREADS) mx = fmaxf(mx, ml[p * 2]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();

  float lsum = 0.f;
  for (int p = tid; p < P; p += THREADS) {
    const float e = expf(ml[p * 2] - mx);
    fac[p] = e;
    lsum += ml[p * 2 + 1] * e;
  }
  lsum = warp_sum(lsum);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) l += red[w];
  const float l_inv = l == 0.f ? 1.f : 1.f / l;

  for (int d = tid; d < D; d += THREADS) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc = fmaf(o_part[((size_t)b * P + p) * D + d], fac[p], acc);
    pooled[(size_t)b * D + d] = acc * l_inv;
  }
}

}  // namespace

extern "C" {

// x [B, M, D], mask [B, M] bool or NULL, w [H/128, D, 256] (pack c holds
// columns [Wa[:, 128c:128c+128] | Wb[:, 128c:128c+128]]), bias [H/128, 256]
// packed alike, wc [H], bc [1]. Out: pooled [B, D], scores [B, M] (raw).
// Scratch: o_part [B, splits, D], ml_part [B, splits, 2]. D % 16 == 0,
// D <= 1024, H % 128 == 0; every split must own at least one 64-patch tile.
int mpo_milpool(const float* x, const uint8_t* mask, const float* w, const float* bias,
                const float* wc, const float* bc, float* pooled, float* scores,
                float* o_part, float* ml_part, int B, int M, int D, int H, int splits,
                void* stream) {
  const int n_tiles = (M + FK_BM - 1) / FK_BM;
  if (B < 1 || M < 1 || D < FK_BF || D % FK_BF != 0 || D > DMAX || H < HC || H % HC != 0 ||
      splits < 1 || splits > MAX_PARTS || splits > n_tiles)
    return (int)cudaErrorInvalidValue;
  const int per = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * per >= n_tiles) return (int)cudaErrorInvalidValue;  // an empty split
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, splits);
  const int C = H / HC;
#define MPO_POOL(FC_)                                                                  \
  milpool_kernel<FC_><<<grid, THREADS, 0, st>>>(x, mask, w, bias, wc, bc, scores, o_part, \
                                                ml_part, M, D, C, per)
  if (D <= 256) MPO_POOL(1);
  else if (D <= 512) MPO_POOL(2);
  else MPO_POOL(4);
#undef MPO_POOL
  int err = (int)cudaGetLastError();
  if (err) return err;
  milpool_merge_kernel<<<B, THREADS, 0, st>>>(o_part, ml_part, pooled, D, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
