// K2 / K3: LayerNorm forward over the last dim, plain and residual-fused.
//
// Replaces geo_deep_learning_tpu/ops/pallas/layernorm.py::_fwd_kernel (via
// _fwd) and ::_fwd_res_kernel (via _fwd_res):
//   K2: y = LN(x)                      -> y, mu, rstd
//   K3: s = x + branch; y = LN(s)      -> s, y, mu, rstd
// with f32 statistics, var = max(E[x^2] - E[x]^2, 0) and rstd = 1/sqrt(var+eps),
// exactly the TPU kernel's fast-variance form. mu and rstd are plain [rows]
// f32 vectors (the TPU kernel's 8-wide trailing copies were a tiling artifact).
//
// Bound on the H100: bytes. At DOFA-base bs8 (10376 rows x 768, bf16) K2 moves
// ~32 MB (x in, y out) and K3 ~64 MB (x, branch in; s, y out), 10-20 us at
// 3.35 TB/s; the arithmetic is a few flops per element.
//
// Design: one warp per token row. Each lane reads its share of the row with
// 16-byte vector loads and keeps it in registers (up to 64 floats), so the
// row is read from device memory once; the two sums are reduced with warp
// shuffles, and the row is normalized and written from registers. No shared
// memory and no block-wide synchronization.
#include "common.cuh"

constexpr int LN_WARPS = 8;           // rows per block
constexpr int LN_MAX_PER_LANE = 64;   // f32 values a lane keeps in registers

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ branch,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     T* __restrict__ s_out, T* __restrict__ y,
                     float* __restrict__ mu_out, float* __restrict__ rstd_out,
                     long long rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int MAXV = LN_MAX_PER_LANE / VEC;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / VEC;
  const long long base = row * d;

  float v[MAXV][VEC];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      load_vec<T>(x + base + vi * VEC, v[i]);
      if (RESIDUAL) {
        float br[VEC];
        load_vec<T>(branch + base + vi * VEC, br);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[i][j] += br[j];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sum += v[i][j];
        sq += v[i][j] * v[i][j];
      }
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / (float)d;
  const float var = fmaxf(sq / (float)d - mu * mu, 0.f);
  const float rstd = 1.f / sqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      const int col = vi * VEC;
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out[j] = ((v[i][j] - mu) * rstd) * gamma[col + j] + beta[col + j];
      store_vec<T>(y + base + col, out);
      if (RESIDUAL) store_vec<T>(s_out + base + col, v[i]);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T>
static int launch_ln(const void* x, const void* branch, const void* gamma, const void* beta,
                     void* s, void* y, void* mu, void* rstd, long long rows, int d,
                     float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (d % VEC != 0 || d > 32 * LN_MAX_PER_LANE) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + LN_WARPS - 1) / LN_WARPS);
  if (branch != nullptr) {
    layernorm_fwd_kernel<T, true><<<blocks, LN_WARPS * 32, 0, stream>>>(
        (const T*)x, (const T*)branch, (const float*)gamma, (const float*)beta,
        (T*)s, (T*)y, (float*)mu, (float*)rstd, rows, d, eps);
  } else {
    layernorm_fwd_kernel<T, false><<<blocks, LN_WARPS * 32, 0, stream>>>(
        (const T*)x, nullptr, (const float*)gamma, (const float*)beta,
        nullptr, (T*)y, (float*)mu, (float*)rstd, rows, d, eps);
  }
  return (int)cudaGetLastError();
}

// x, branch, s, y: [rows, d] of bf16 (is_bf16 != 0) or f32, contiguous and
// 16-byte aligned; gamma, beta: [d] f32; mu, rstd: [rows] f32.
// branch == s == NULL selects K2, otherwise K3.
extern "C" int gdl_layernorm_fwd(const void* x, const void* branch, const void* gamma,
                                 const void* beta, void* s, void* y, void* mu, void* rstd,
                                 long long rows, int d, float eps, int is_bf16,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) return launch_ln<bf16>(x, branch, gamma, beta, s, y, mu, rstd, rows, d, eps, st);
  return launch_ln<float>(x, branch, gamma, beta, s, y, mu, rstd, rows, d, eps, st);
}
