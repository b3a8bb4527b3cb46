// K7: softmax attention backward over a packed [B, L, 3*H*hd] QKV tensor.
//
// Replaces geo_deep_learning_tpu/ops/pallas/mha.py::_bwd_kernel_packed (via
// _bwd_packed). Inputs are the forward's qkv (q heads | k heads | v heads),
// its output o [B, L, H*hd], the output's gradient g (same layout) and the
// forward's lse [B, H, L] f32; the output is dqkv [B, L, 3*H*hd] in the
// packing order, written in place with no concatenation. Numerics follow the
// TPU kernel: s = (q k^T) * scale and p = exp(s - lse) in f32 from bf16
// products with f32 accumulation; delta = rowsum(g * o) in f32;
// ds = p * (g v^T - delta); p and ds are cast to bf16 before their products
// (dv = p^T g, dq = ds k, dk = ds^T q), and scale multiplies dq and dk after
// their products.
//
// Bound on the H100: operations. The five products take 10*B*H*L^2*hd =
// 103 GFLOP at DOFA-base bs8 (L = 1297, H = 12, hd = 64), about 0.10 ms at
// the 989 TFLOP/s bf16 peak, against ~85 MB of traffic (25 us).
//
// Design: the TPU kernel keeps one head's whole K/V and [L, hd] f32 dk/dv
// accumulators resident and loops over 128-row q tiles; at L = 1297 K and V
// alone are ~332 KB, over a block's 227 KB of shared memory. So the work is
// split as FlashAttention-2 splits it, into three launches on one stream:
//   1. delta: one warp per token row computes rowsum(g * o) for every head;
//   2. dK/dV: one block of 4 warps per (batch, head, 64-key tile) keeps its
//      K and V tiles in shared memory, streams 64-row q tiles (q, g, lse,
//      delta), recomputes p^T, and accumulates dk and dv in f32 tensor-core
//      fragments; each warp owns 16 key rows;
//   3. dQ: one block per (batch, head, 64-query tile) streams 64-row K/V
//      tiles, recomputes p, and accumulates dq the same way.
// Every output element is written by exactly one block: no atomics, and the
// gradients are equal run to run. The price is recomputing s in both 2 and 3
// (seven products in place of five). Products run on tensor cores through
// nvcuda::wmma (bf16 in, f32 accumulate); the elementwise softmax work goes
// through a per-warp f32 tile in shared memory, where a pair of lanes owns
// one row. Ragged edges are zero-filled on load; rows past L get lse = +inf
// (so p = 0) and columns past L are masked to p = 0. No cp.async/TMA
// pipelining and no wgmma yet.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int AB_T = 64;             // rows of a q or k tile
constexpr int AB_WARPS = AB_T / 16;  // each warp owns 16 rows of its block's tile
constexpr int AB_PAD = 8;            // bf16 row padding: 16-byte rows, spread banks

template <int HD>
struct BwdSmem {
  static constexpr int LDH = HD + AB_PAD;                    // bf16 [64][HD] tiles
  static constexpr int LDP = AB_T + AB_PAD;                  // bf16 [64][64] tiles
  static constexpr int LDF = (AB_T > HD ? AB_T : HD) + 4;    // f32 staging tile
  // four [64][HD] bf16 tiles, one f32 tile, two bf16 [64][64] tiles, two f32 vectors
  static constexpr size_t bytes = sizeof(float) * AB_T * LDF +
                                  sizeof(bf16) * (4 * AB_T * LDH + 2 * AB_T * LDP) +
                                  sizeof(float) * 2 * AB_T;
};

// Copy rows [r0, r0 + 64) of one head's hd columns at column offset `col` of
// a [L, ld] bf16 matrix into a [64][LDH] tile, zero-filling rows past L.
template <int HD, int LDH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int col,
                                          int r0, int L) {
  constexpr int VPR = HD / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < AB_T * VPR; i += blockDim.x) {
    const int r = i / VPR, v = i % VPR;
    uint4 val = zero;
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + col + v * 8);
    *reinterpret_cast<uint4*>(dst + r * LDH + v * 8) = val;
  }
}

// Write this warp's 16 x HD f32 accumulator fragments, times `scale`, as bf16
// rows [row0, row0 + 16) at column `col` of a [L, ld] matrix (rows < L only).
template <int HD, int LDF>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16], float* stage,
    bf16* dst, long long ld, int col, int row0, int L, float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c)
    wmma::store_matrix_sync(stage + c * 16, acc[c], LDF, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, half = lane & 1;
  if (row0 + r < L) {
    bf16* out = dst + (long long)(row0 + r) * ld + col + half * (HD / 2);
    const float* src = stage + r * LDF + half * (HD / 2);
#pragma unroll
    for (int j = 0; j < HD / 2; j += 8) {
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = src[j + u] * scale;
      store_vec<bf16>(out + j, t);
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// 1. delta[b, h, l] = sum_j g[b, l, h*HD + j] * o[b, l, h*HD + j]
template <int HD>
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                           float* __restrict__ delta, int B, int L, int H) {
  constexpr int GROUP = HD / 8;  // lanes sharing one head (one 16-byte vector each)
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= (long long)B * L) return;
  const int D = H * HD;
  const long long b = row / L, l = row % L;
  for (int v0 = 0; v0 < D / 8; v0 += 32) {  // D / 8 is a multiple of GROUP
    const int vi = v0 + lane;
    float t = 0.f;
    if (vi < D / 8) {
      float ov[8], gv[8];
      load_vec<bf16>(o + row * D + vi * 8, ov);
      load_vec<bf16>(g + row * D + vi * 8, gv);
#pragma unroll
      for (int u = 0; u < 8; ++u) t += gv[u] * ov[u];
    }
#pragma unroll
    for (int off = GROUP / 2; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (vi < D / 8 && vi % GROUP == 0) delta[(b * H + vi / GROUP) * L + l] = t;
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV for one (batch, head, 64-key tile)
template <int HD>
__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dqkv, int L, int H, float scale) {
  using S = BwdSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sF = reinterpret_cast<float*>(smem_raw);  // [64][LDF] per-warp staging
  bf16* sK = reinterpret_cast<bf16*>(sF + AB_T * S::LDF);
  bf16* sV = sK + AB_T * S::LDH;
  bf16* sQ = sV + AB_T * S::LDH;
  bf16* sG = sQ + AB_T * S::LDH;
  bf16* sP = sG + AB_T * S::LDH;   // p^T    [64 k][64 q]
  bf16* sDS = sP + AB_T * S::LDP;  // ds^T   [64 k][64 q]
  float* sL = reinterpret_cast<float*>(sDS + AB_T * S::LDP);  // lse of the q tile
  float* sD = sL + AB_T;                                       // delta of the q tile

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * AB_T;
  const int D = H * HD;
  const long long ld = 3LL * D;
  const bf16* base = qkv + (long long)b * L * ld;
  const bf16* gbase = g + (long long)b * L * D;
  const float* lse_bh = lse + ((long long)b * H + h) * L;
  const float* delta_bh = delta + ((long long)b * H + h) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;  // lane pair (2r, 2r+1) owns row r

  load_tile<HD, S::LDH>(sK, base, ld, D + h * HD, k0, L);
  load_tile<HD, S::LDH>(sV, base, ld, 2 * D + h * HD, k0, L);

  float* fWarp = sF + warp * 16 * S::LDF;
  float* fRow = fWarp + r * S::LDF;
  bf16* pWarp = sP + warp * 16 * S::LDP;
  bf16* dsWarp = sDS + warp * 16 * S::LDP;
  const bf16* kWarp = sK + warp * 16 * S::LDH;
  const bf16* vWarp = sV + warp * 16 * S::LDH;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[HD / 16], dv[HD / 16];
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    wmma::fill_fragment(dk[c], 0.f);
    wmma::fill_fragment(dv[c], 0.f);
  }

  for (int q0 = 0; q0 < L; q0 += AB_T) {
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<HD, S::LDH>(sQ, base, ld, h * HD, q0, L);
    load_tile<HD, S::LDH>(sG, gbase, D, h * HD, q0, L);
    for (int i = threadIdx.x; i < AB_T; i += blockDim.x) {
      const bool in = q0 + i < L;
      sL[i] = in ? lse_bh[q0 + i] : INFINITY;  // p = 0 on rows past L
      sD[i] = in ? delta_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T for this warp's 16 key rows x 64 q columns
#pragma unroll
    for (int c = 0; c < AB_T / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, kWarp + kk * 16, S::LDH);
        wmma::load_matrix_sync(bfr, sQ + c * 16 * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(fWarp + c * 16, acc, S::LDF, wmma::mem_row_major);
    }
    __syncwarp();
    float p[AB_T / 2];
#pragma unroll
    for (int j = 0; j < AB_T / 2; ++j) {
      const int col = half * (AB_T / 2) + j;
      p[j] = expf(fRow[col] * scale - sL[col]);
      pWarp[r * S::LDP + col] = __float2bfloat16(p[j]);
    }
    __syncwarp();

    // dv += p^T g
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
#pragma unroll
      for (int kk = 0; kk < AB_T / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, pWarp + kk * 16, S::LDP);
        wmma::load_matrix_sync(bfr, sG + kk * 16 * S::LDH + c * 16, S::LDH);
        wmma::mma_sync(dv[c], af, bfr, dv[c]);
      }
    }

    // dp^T = v g^T, into the (consumed) staging tile
#pragma unroll
    for (int c = 0; c < AB_T / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, vWarp + kk * 16, S::LDH);
        wmma::load_matrix_sync(bfr, sG + c * 16 * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(fWarp + c * 16, acc, S::LDF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < AB_T / 2; ++j) {
      const int col = half * (AB_T / 2) + j;
      dsWarp[r * S::LDP + col] = __float2bfloat16(p[j] * (fRow[col] - sD[col]));
    }
    __syncwarp();

    // dk += ds^T q
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
#pragma unroll
      for (int kk = 0; kk < AB_T / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, dsWarp + kk * 16, S::LDP);
        wmma::load_matrix_sync(bfr, sQ + kk * 16 * S::LDH + c * 16, S::LDH);
        wmma::mma_sync(dk[c], af, bfr, dk[c]);
      }
    }
  }

  bf16* out = dqkv + (long long)b * L * ld;
  const int row0 = k0 + warp * 16;
  store_rows<HD, S::LDF>(dk, fWarp, out, ld, D + h * HD, row0, L, scale);
  store_rows<HD, S::LDF>(dv, fWarp, out, ld, 2 * D + h * HD, row0, L, 1.f);
}

// ---------------------------------------------------------------------------
// 3. dQ for one (batch, head, 64-query tile)
template <int HD>
__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dqkv, int L, int H, float scale) {
  using S = BwdSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sF = reinterpret_cast<float*>(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(sF + AB_T * S::LDF);
  bf16* sG = sQ + AB_T * S::LDH;
  bf16* sK = sG + AB_T * S::LDH;
  bf16* sV = sK + AB_T * S::LDH;
  bf16* sDS = sV + AB_T * S::LDH;  // ds [64 q][64 k]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * AB_T;
  const int D = H * HD;
  const long long ld = 3LL * D;
  const bf16* base = qkv + (long long)b * L * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + r;
  const bool qin = qrow < L;
  const float row_lse = qin ? lse[((long long)b * H + h) * L + qrow] : INFINITY;
  const float row_delta = qin ? delta[((long long)b * H + h) * L + qrow] : 0.f;

  load_tile<HD, S::LDH>(sQ, base, ld, h * HD, q0, L);
  load_tile<HD, S::LDH>(sG, g + (long long)b * L * D, D, h * HD, q0, L);

  float* fWarp = sF + warp * 16 * S::LDF;
  float* fRow = fWarp + r * S::LDF;
  bf16* dsWarp = sDS + warp * 16 * S::LDP;
  const bf16* qWarp = sQ + warp * 16 * S::LDH;
  const bf16* gWarp = sG + warp * 16 * S::LDH;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[HD / 16];
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) wmma::fill_fragment(dq[c], 0.f);

  for (int k0 = 0; k0 < L; k0 += AB_T) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD, S::LDH>(sK, base, ld, D + h * HD, k0, L);
    load_tile<HD, S::LDH>(sV, base, ld, 2 * D + h * HD, k0, L);
    __syncthreads();

    // s = q k^T
#pragma unroll
    for (int c = 0; c < AB_T / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, qWarp + kk * 16, S::LDH);
        wmma::load_matrix_sync(bfr, sK + c * 16 * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(fWarp + c * 16, acc, S::LDF, wmma::mem_row_major);
    }
    __syncwarp();
    float p[AB_T / 2];
#pragma unroll
    for (int j = 0; j < AB_T / 2; ++j) {
      const int col = half * (AB_T / 2) + j;
      p[j] = k0 + col < L ? expf(fRow[col] * scale - row_lse) : 0.f;
    }
    __syncwarp();

    // dp = g v^T
#pragma unroll
    for (int c = 0; c < AB_T / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, gWarp + kk * 16, S::LDH);
        wmma::load_matrix_sync(bfr, sV + c * 16 * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(fWarp + c * 16, acc, S::LDF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < AB_T / 2; ++j) {
      const int col = half * (AB_T / 2) + j;
      dsWarp[r * S::LDP + col] = __float2bfloat16(p[j] * (fRow[col] - row_delta));
    }
    __syncwarp();

    // dq += ds k
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
#pragma unroll
      for (int kk = 0; kk < AB_T / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, dsWarp + kk * 16, S::LDP);
        wmma::load_matrix_sync(bfr, sK + kk * 16 * S::LDH + c * 16, S::LDH);
        wmma::mma_sync(dq[c], af, bfr, dq[c]);
      }
    }
  }

  store_rows<HD, S::LDF>(dq, fWarp, dqkv + (long long)b * L * ld, ld, h * HD,
                         q0 + warp * 16, L, scale);
}

template <int HD>
static int launch_attention_bwd(const void* qkv, const void* o, const void* g, const void* lse,
                                void* delta, void* dqkv, int B, int L, int H, float scale,
                                cudaStream_t stream) {
  const long long rows = (long long)B * L;
  attention_bwd_delta_kernel<HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const bf16*)o, (const bf16*)g, (float*)delta, B, L, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = BwdSmem<HD>::bytes;
  dim3 grid((unsigned)((L + AB_T - 1) / AB_T), (unsigned)H, (unsigned)B);
  e = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_dkdv_kernel<HD><<<grid, AB_WARPS * 32, smem, stream>>>(
      (const bf16*)qkv, (const bf16*)g, (const float*)lse, (const float*)delta, (bf16*)dqkv, L,
      H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(attention_bwd_dq_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_dq_kernel<HD><<<grid, AB_WARPS * 32, smem, stream>>>(
      (const bf16*)qkv, (const bf16*)g, (const float*)lse, (const float*)delta, (bf16*)dqkv, L,
      H, scale);
  return (int)cudaGetLastError();
}

// qkv, dqkv: [B, L, 3*H*hd] bf16; o, g: [B, L, H*hd] bf16; lse: [B, H, L] f32;
// delta: [B, H, L] f32 scratch. All contiguous, 16-byte aligned. hd in {32, 64, 128}.
extern "C" int gdl_attention_bwd_packed(const void* qkv, const void* o, const void* g,
                                        const void* lse, void* delta, void* dqkv, int B, int L,
                                        int H, int hd, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch_attention_bwd<32>(qkv, o, g, lse, delta, dqkv, B, L, H, scale, st);
    case 64: return launch_attention_bwd<64>(qkv, o, g, lse, delta, dqkv, B, L, H, scale, st);
    case 128: return launch_attention_bwd<128>(qkv, o, g, lse, delta, dqkv, B, L, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
