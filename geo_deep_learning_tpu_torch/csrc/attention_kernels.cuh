// Device code of the attention forward, shared by the packed K4
// (attention.cu) and the head-major K8 (attention_hm.cu). The backward
// (K7/K9) is attention_bwd_kernels.cuh; layouts and argument checks are
// attention_layout.cuh.
//
// Both compute the same function with the same numerics (bf16 products
// with f32 accumulation, softmax in f32, unnormalized probabilities cast to
// bf16 before P.V and the output divided by the f32 row sum, lse per row)
// and differ only in the AttnLayout of run-time strides they pass. The
// kernel is a template on the head dim only.
//
// Design (bound: operations, see each entry point's note): the TPU kernels
// keep a head's whole K/V in VMEM; on Hopper that is ~332 KB at L = 1297,
// above a block's 227 KB of shared memory. So the forward takes one 64-row
// q tile of one (batch, head) per block of 4 warps and streams 64-row K/V
// tiles through shared memory with an online softmax. Products run on
// tensor cores through nvcuda::wmma (bf16 in, f32 out); the elementwise
// softmax work goes through a per-warp f32 tile in shared memory, where a
// pair of lanes owns one row. Rows and columns past L are zero-filled on
// load and masked, so no operand is padded. Still the first, simple design:
// no TMA ring, no wgmma and no register-resident score tile yet (the
// backward has all three).
#pragma once

#include <mma.h>

#include "attention_layout.cuh"

using namespace nvcuda;

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
