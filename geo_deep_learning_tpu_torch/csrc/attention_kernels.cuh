// Device code of the attention kernels, shared by the packed pair K4/K7
// (attention.cu, attention_bwd.cu) and the head-major pair K8/K9
// (attention_hm.cu, attention_hm_bwd.cu).
//
// The two pairs compute the same function with the same numerics (bf16
// products with f32 accumulation, softmax in f32, unnormalized
// probabilities cast to bf16 before P.V and the output divided by the f32
// row sum; the backward recomputes p = exp(s - lse), takes
// delta = rowsum(g * o), casts p and ds = p * (g v^T - delta) to bf16
// before their products and scales dq and dk after theirs). They differ
// only in where one (batch, head)'s rows live, which an AttnLayout of run-time
// strides states: the packed pair passes the column slices of one
// [B, L, 3*H*hd] tensor (q, k, v and dq, dk, dv) and of [B, L, H*hd] (o, g);
// the head-major pair passes the [B, H, L, hd] views its caller holds, which
// may be those same slices. The kernels are templates on the head dim only.
//
// Design (bound: operations, see each entry point's note): the TPU kernels
// keep a head's whole K/V in VMEM; on Hopper that is ~332 KB at L = 1297,
// above a block's 227 KB of shared memory. So the forward takes one 64-row
// q tile of one (batch, head) per block of 4 warps and streams 64-row K/V
// tiles through shared memory with an online softmax; the backward is split
// as FlashAttention-2 splits it (a delta pass, a dK/dV kernel over key tiles
// and a dQ kernel over query tiles), so every output element is written by
// one block: no atomics, equal run to run. Products run on tensor cores
// through nvcuda::wmma (bf16 in, f32 out); the elementwise softmax work goes
// through a per-warp f32 tile in shared memory, where a pair of lanes owns
// one row. Rows and columns past L are zero-filled on load and masked, so no
// operand is padded. Simple and right first: no cp.async/TMA pipelining and
// no wgmma yet.
#pragma once

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

// Element strides of an operand's batch, head and row dimensions; a row's hd
// elements are contiguous, and every stride is a multiple of 8 (16 bytes).
struct AttnLayout {
  long long b, h, row;
  __device__ __forceinline__ long long at(int bi, int hi) const { return bi * b + hi * h; }
};

// q, k, v of the QKV projection's packed [B, L, 3*H*hd] output, and o or g
// as [B, L, H*hd] (K4/K7).
inline AttnLayout packed_qkv_layout(int L, int H, int hd) {
  const long long ld = 3LL * H * hd;
  return {ld * L, hd, ld};
}
inline AttnLayout packed_out_layout(int L, int H, int hd) {
  const long long ld = (long long)H * hd;
  return {ld * L, hd, ld};
}

inline bool attention_args_ok(int B, int L, int H, int hd) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && L >= 1 &&
         (hd == 32 || hd == 64 || hd == 128);
}

// ---------------------------------------------------------------------------
// Forward (K4 / K8)

constexpr int AT_BQ = 64;     // q rows per block
constexpr int AT_BK = 64;     // kv rows per streamed tile
constexpr int AT_WARPS = AT_BQ / 16;
constexpr int AT_PAD = 8;     // bf16 row padding: keeps rows 32-byte aligned, spreads banks

template <int HD>
struct AttnSmem {
  static constexpr int LDH = HD + AT_PAD;     // Q, K, V tiles (bf16)
  static constexpr int LDP = AT_BK + AT_PAD;  // probabilities (bf16)
  static constexpr int LDF = (AT_BK > HD ? AT_BK : HD) + 4;  // scores / PV tile (f32)
  static constexpr size_t bytes =
      sizeof(float) * AT_BQ * LDF + sizeof(bf16) * (AT_BQ * LDH + 2 * AT_BK * LDH + AT_BQ * LDP);
};

template <int HD>
__global__ void __launch_bounds__(AT_WARPS * 32)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, AttnLayout in, AttnLayout ol, int L, int H,
                     float scale) {
  using S = AttnSmem<HD>;
  constexpr int VPR = HD / 8;   // 16-byte vectors per head row
  constexpr int HALF = HD / 2;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sF = reinterpret_cast<float*>(smem_raw);  // [BQ][LDF]: scores, then PV tile
  bf16* sQ = reinterpret_cast<bf16*>(sF + AT_BQ * S::LDF);
  bf16* sK = sQ + AT_BQ * S::LDH;
  bf16* sV = sK + AT_BK * S::LDH;
  bf16* sP = sV + AT_BK * S::LDH;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * AT_BQ;
  const long long in0 = in.at(b, h), ld = in.row;
  const bf16* qb = q + in0;
  const bf16* kb = k + in0;
  const bf16* vb = v + in0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < AT_BQ * VPR; i += blockDim.x) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = zero;
    if (q0 + r < L) val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * ld + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * S::LDH + c * 8) = val;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * S::LDH + kk * 16, S::LDH);

  const int r = lane >> 1, half = lane & 1;  // lane pair (2r, 2r+1) owns row r
  float* fRow = sF + (warp * 16 + r) * S::LDF;
  bf16* pRow = sP + (warp * 16 + r) * S::LDP;
  float* fWarp = sF + warp * 16 * S::LDF;
  bf16* pWarp = sP + warp * 16 * S::LDP;
  float m = -INFINITY, l = 0.f;
  float o[HALF];
#pragma unroll
  for (int j = 0; j < HALF; ++j) o[j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += AT_BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < 2 * AT_BK * VPR; i += blockDim.x) {
      const int which = i / (AT_BK * VPR);  // 0: K, 1: V
      const int rr = (i / VPR) % AT_BK, c = i % VPR;
      uint4 val = zero;
      if (k0 + rr < L)
        val = *reinterpret_cast<const uint4*>((which ? vb : kb) + (long long)(k0 + rr) * ld + c * 8);
      *reinterpret_cast<uint4*>((which ? sV : sK) + rr * S::LDH + c * 8) = val;
    }
    __syncthreads();

    // scores of this warp's 16 rows against the 64 tile columns
#pragma unroll
    for (int c = 0; c < AT_BK / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + c * 16 * S::LDH + kk * 16, S::LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(fWarp + c * 16, acc, S::LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: this lane covers 32 of the row's 64 tile columns
    float sv[AT_BK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < AT_BK / 2; ++j) {
      const int col = half * (AT_BK / 2) + j;
      const float s = (k0 + col < L) ? fRow[col] * scale : -INFINITY;
      sv[j] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);  // finite: every tile holds a column < L
    const float alpha = expf(m - m_new);
    float tsum = 0.f;
#pragma unroll
    for (int j = 0; j < AT_BK / 2; ++j) {
      const float p = expf(sv[j] - m_new);
      tsum += p;
      pRow[half * (AT_BK / 2) + j] = __float2bfloat16(p);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * alpha + tsum;
    m = m_new;
    __syncwarp();

    // PV tile of this warp's rows, staged in the (consumed) score buffer
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < AT_BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, pWarp + kk * 16, S::LDP);
        wmma::load_matrix_sync(vf, sV + kk * 16 * S::LDH + c * 16, S::LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(fWarp + c * 16, acc, S::LDF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HALF; ++j) o[j] = o[j] * alpha + fRow[half * HALF + j];
  }

  const int qrow = q0 + warp * 16 + r;
  if (qrow < L) {
    bf16* orow = out + ol.at(b, h) + (long long)qrow * ol.row + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; j += 8) {
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = o[j + u] / l;
      store_vec<bf16>(orow + j, t);
    }
    if (half == 0) lse[((long long)b * H + h) * L + qrow] = m + logf(l);
  }
}

template <int HD>
static int launch_attention_fwd_hd(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                   float* lse, AttnLayout in, AttnLayout ol, int B, int L, int H,
                                   float scale, cudaStream_t stream) {
  const size_t smem = AttnSmem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(attention_fwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((L + AT_BQ - 1) / AT_BQ), (unsigned)H, (unsigned)B);
  attention_fwd_kernel<HD><<<grid, AT_WARPS * 32, smem, stream>>>(q, k, v, out, lse, in, ol, L,
                                                                  H, scale);
  return (int)cudaGetLastError();
}

// q, k, v: [B, H, L, hd] views with layout `in`; out: a view with layout `ol`;
// lse: [B, H, L] f32.
static int launch_attention_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                float* lse, AttnLayout in, AttnLayout ol, int B, int L, int H,
                                int hd, float scale, cudaStream_t stream) {
  if (!attention_args_ok(B, L, H, hd)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_attention_fwd_hd<32>(q, k, v, out, lse, in, ol, B, L, H, scale, stream);
    case 64: return launch_attention_fwd_hd<64>(q, k, v, out, lse, in, ol, B, L, H, scale, stream);
    default: return launch_attention_fwd_hd<128>(q, k, v, out, lse, in, ol, B, L, H, scale, stream);
  }
}

// ---------------------------------------------------------------------------
// Backward (K7 / K9)

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

// Copy rows [r0, r0 + 64) of an [L, HD] row view with row stride `ld` into a
// [64][LDH] tile, zero-filling rows past L.
template <int HD, int LDH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int r0, int L) {
  constexpr int VPR = HD / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < AB_T * VPR; i += blockDim.x) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = zero;
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDH + c * 8) = val;
  }
}

// Write this warp's 16 x HD f32 accumulator fragments, times `scale`, as bf16
// rows [row0, row0 + 16) of an [L, HD] row view with stride `ld` (rows < L only).
template <int HD, int LDF>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HD / 16], float* stage,
    bf16* dst, long long ld, int row0, int L, float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c)
    wmma::store_matrix_sync(stage + c * 16, acc[c], LDF, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, half = lane & 1;
  if (row0 + r < L) {
    bf16* out = dst + (long long)(row0 + r) * ld + half * (HD / 2);
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

// 1. delta[(b * H + h) * L + l] = sum_j g[b, h, l, j] * o[b, h, l, j]: HD / 8
// lanes (one 16-byte vector each) per (b, h, l) row, 32 / (HD / 8) rows a warp.
template <int HD>
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                           float* __restrict__ delta, AttnLayout ol, AttnLayout gl, int B,
                           int L, int H) {
  constexpr int GROUP = HD / 8;
  constexpr int ROWS = 32 / GROUP;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const long long row = warp * ROWS + lane / GROUP;
  const int c = lane % GROUP;
  const bool in = row < (long long)B * H * L;
  float t = 0.f;
  if (in) {
    const int l = (int)(row % L);
    const long long bh = row / L;
    const int h = (int)(bh % H), b = (int)(bh / H);
    float ov[8], gv[8];
    load_vec<bf16>(o + ol.at(b, h) + (long long)l * ol.row + c * 8, ov);
    load_vec<bf16>(g + gl.at(b, h) + (long long)l * gl.row + c * 8, gv);
#pragma unroll
    for (int u = 0; u < 8; ++u) t += gv[u] * ov[u];
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  if (in && c == 0) delta[row] = t;
}

// 2. dK, dV for one (batch, head, 64-key tile): K and V tiles stay in shared
// memory while 64-row q tiles (q, g, lse, delta) stream past; p^T is
// recomputed and dk, dv accumulate in f32 fragments; each warp owns 16 key rows.
template <int HD>
__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, AttnLayout in,
                          AttnLayout gl, int L, int H, float scale) {
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
  const long long in0 = in.at(b, h), ld = in.row;
  const bf16* gb = g + gl.at(b, h);
  const long long gld = gl.row;
  const float* lse_bh = lse + ((long long)b * H + h) * L;
  const float* delta_bh = delta + ((long long)b * H + h) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;  // lane pair (2r, 2r+1) owns row r

  load_tile<HD, S::LDH>(sK, k + in0, ld, k0, L);
  load_tile<HD, S::LDH>(sV, v + in0, ld, k0, L);

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
    load_tile<HD, S::LDH>(sQ, q + in0, ld, q0, L);
    load_tile<HD, S::LDH>(sG, gb, gld, q0, L);
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

  const int row0 = k0 + warp * 16;
  store_rows<HD, S::LDF>(dk, fWarp, dk_out + in0, ld, row0, L, scale);
  store_rows<HD, S::LDF>(dv, fWarp, dv_out + in0, ld, row0, L, 1.f);
}

// 3. dQ for one (batch, head, 64-query tile): 64-row K/V tiles stream past,
// p is recomputed and dq accumulates the same way.
template <int HD>
__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq_out, AttnLayout in, AttnLayout gl, int L, int H,
                        float scale) {
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
  const long long in0 = in.at(b, h), ld = in.row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + r;
  const bool qin = qrow < L;
  const float row_lse = qin ? lse[((long long)b * H + h) * L + qrow] : INFINITY;
  const float row_delta = qin ? delta[((long long)b * H + h) * L + qrow] : 0.f;

  load_tile<HD, S::LDH>(sQ, q + in0, ld, q0, L);
  load_tile<HD, S::LDH>(sG, g + gl.at(b, h), gl.row, q0, L);

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
    load_tile<HD, S::LDH>(sK, k + in0, ld, k0, L);
    load_tile<HD, S::LDH>(sV, v + in0, ld, k0, L);
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

  store_rows<HD, S::LDF>(dq, fWarp, dq_out + in0, ld, q0 + warp * 16, L, scale);
}

template <int HD>
static int launch_attention_bwd_hd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                                   const bf16* g, const float* lse, float* delta, bf16* dq,
                                   bf16* dk, bf16* dv, AttnLayout in, AttnLayout ol,
                                   AttnLayout gl, int B, int L, int H, float scale,
                                   cudaStream_t stream) {
  constexpr int ROWS_PER_BLOCK = 8 * (32 / (HD / 8));  // 8 warps a block
  const long long rows = (long long)B * H * L;
  attention_bwd_delta_kernel<HD>
      <<<(unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK), 256, 0, stream>>>(
          o, g, delta, ol, gl, B, L, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = BwdSmem<HD>::bytes;
  dim3 grid((unsigned)((L + AB_T - 1) / AB_T), (unsigned)H, (unsigned)B);
  e = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_dkdv_kernel<HD><<<grid, AB_WARPS * 32, smem, stream>>>(
      q, k, v, g, lse, delta, dk, dv, in, gl, L, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(attention_bwd_dq_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_dq_kernel<HD><<<grid, AB_WARPS * 32, smem, stream>>>(
      q, k, v, g, lse, delta, dq, in, gl, L, H, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dq, dk, dv: [B, H, L, hd] views with layout `in`; o: layout `ol`;
// g: layout `gl`; lse [B, H, L] f32; delta [B, H, L] f32 scratch.
static int launch_attention_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                                const bf16* g, const float* lse, float* delta, bf16* dq,
                                bf16* dk, bf16* dv, AttnLayout in, AttnLayout ol, AttnLayout gl,
                                int B, int L, int H, int hd, float scale, cudaStream_t stream) {
  if (!attention_args_ok(B, L, H, hd)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch_attention_bwd_hd<32>(q, k, v, o, g, lse, delta, dq, dk, dv, in, ol, gl, B, L,
                                         H, scale, stream);
    case 64:
      return launch_attention_bwd_hd<64>(q, k, v, o, g, lse, delta, dq, dk, dv, in, ol, gl, B, L,
                                         H, scale, stream);
    default:
      return launch_attention_bwd_hd<128>(q, k, v, o, g, lse, delta, dq, dk, dv, in, ol, gl, B,
                                          L, H, scale, stream);
  }
}
