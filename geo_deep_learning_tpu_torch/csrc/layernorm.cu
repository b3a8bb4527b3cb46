// K2 / K3: LayerNorm forward over the last dim, plain and residual-fused.
// K5 / K6: their backward passes.
//
// Replaces geo_deep_learning_tpu/ops/pallas/layernorm.py::_fwd_kernel (via
// _fwd), ::_fwd_res_kernel (via _fwd_res), ::_bwd_kernel (via _bwd) and
// ::_bwd_res_kernel (via _bwd_res):
//   K2: y = LN(x)                      -> y, mu, rstd
//   K3: s = x + branch; y = LN(s)      -> s, y, mu, rstd
//   K5: a = dy*gamma; xhat = (x - mu)*rstd;
//       dx = rstd*(a - mean(a) - xhat*mean(a*xhat)); dgamma = sum dy*xhat,
//       dbeta = sum dy over rows
//   K6: K5 on the rounded residual sum s, plus ds_in: dx = ds_in + LN_dx(dy)
// with f32 statistics, var = max(E[x^2] - E[x]^2, 0) and rstd = 1/sqrt(var+eps),
// exactly the TPU kernel's fast-variance form. mu and rstd are plain [rows]
// f32 vectors (the TPU kernel's 8-wide trailing copies were a tiling artifact).
//
// Bound on the H100: bytes. At DOFA-base bs8 (10376 rows x 768, bf16) K2 moves
// ~32 MB (x in, y out), K3 ~64 MB (x, branch in; s, y out), K5 ~48 MB (x, dy
// in; dx out) and K6 ~64 MB (s, dy, ds_in in; dx out): 10-20 us at 3.35 TB/s;
// the arithmetic is a few flops per element.
//
// Design: one warp per token row. Each lane reads its share of the row with
// 16-byte vector loads and keeps it in registers (up to 64 floats), so the
// row is read from device memory once; the row sums are reduced with warp
// shuffles, and the row's outputs are written from registers. The forward
// needs no shared memory and no block-wide synchronization. The backward's
// dgamma/dbeta are sums over all rows: a fixed grid of blocks strides over
// the rows, each lane accumulates its columns in registers, the block's
// warps are summed through shared memory in a fixed order, and each block
// writes one f32 partial row that the wrapper sums (as the JAX package sums
// its per-tile partials). No atomics, so the gradients are equal run to run.
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

// ---------------------------------------------------------------------------
// K5 / K6: backward.

constexpr int LN_BWD_MAX_BLOCKS = 264;  // 2 per SM on 132 SMs; sets the partials' rows

template <typename T, int NV, bool RESIDUAL>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const T* __restrict__ ds_in, const float* __restrict__ gamma,
                     const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
                     T* __restrict__ dx, float* __restrict__ dg_part,
                     float* __restrict__ db_part, long long rows, int d) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float red[];  // [LN_WARPS][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = d / VEC;

  float g[NV][VEC], acc_g[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + i * 32;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc_g[i][j] = 0.f;
      acc_b[i][j] = 0.f;
      g[i][j] = vi < nvec ? gamma[vi * VEC + j] : 0.f;
    }
  }

  for (long long row = (long long)blockIdx.x * LN_WARPS + warp; row < rows;
       row += (long long)gridDim.x * LN_WARPS) {
    const long long base = row * d;
    const float mu = mu_in[row], rstd = rstd_in[row];
    float xh[NV][VEC], a[NV][VEC];
    float sum_a = 0.f, sum_ax = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float dyv[VEC];
        load_vec<T>(x + base + vi * VEC, xh[i]);
        load_vec<T>(dy + base + vi * VEC, dyv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          xh[i][j] = (xh[i][j] - mu) * rstd;
          a[i][j] = dyv[j] * g[i][j];
          sum_a += a[i][j];
          sum_ax += a[i][j] * xh[i][j];
          acc_g[i][j] += dyv[j] * xh[i][j];
          acc_b[i][j] += dyv[j];
        }
      }
    }
    const float t1 = warp_sum(sum_a) / (float)d;
    const float t2 = warp_sum(sum_ax) / (float)d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float out[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) out[j] = rstd * (a[i][j] - t1 - xh[i][j] * t2);
        if (RESIDUAL) {
          float r[VEC];
          load_vec<T>(ds_in + base + vi * VEC, r);
#pragma unroll
          for (int j = 0; j < VEC; ++j) out[j] += r[j];
        }
        store_vec<T>(dx + base + vi * VEC, out);
      }
    }
  }

  // block partials of dgamma, then dbeta, through shared memory
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[warp * d + vi * VEC + j] = pass == 0 ? acc_g[i][j] : acc_b[i][j];
      }
    }
    __syncthreads();
    float* part = pass == 0 ? dg_part : db_part;
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < LN_WARPS; ++w) t += red[w * d + col];
      part[(long long)blockIdx.x * d + col] = t;
    }
    __syncthreads();
  }
}

template <typename T, int NV>
static int launch_ln_bwd_nv(const void* x, const void* dy, const void* ds_in, const void* gamma,
                            const void* mu, const void* rstd, void* dx, void* dg_part,
                            void* db_part, long long rows, int d, int blocks,
                            cudaStream_t stream) {
  const size_t smem = sizeof(float) * LN_WARPS * d;
  if (ds_in != nullptr) {
    cudaError_t e = cudaFuncSetAttribute(layernorm_bwd_kernel<T, NV, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    layernorm_bwd_kernel<T, NV, true><<<blocks, LN_WARPS * 32, smem, stream>>>(
        (const T*)x, (const T*)dy, (const T*)ds_in, (const float*)gamma, (const float*)mu,
        (const float*)rstd, (T*)dx, (float*)dg_part, (float*)db_part, rows, d);
  } else {
    cudaError_t e = cudaFuncSetAttribute(layernorm_bwd_kernel<T, NV, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    layernorm_bwd_kernel<T, NV, false><<<blocks, LN_WARPS * 32, smem, stream>>>(
        (const T*)x, (const T*)dy, nullptr, (const float*)gamma, (const float*)mu,
        (const float*)rstd, (T*)dx, (float*)dg_part, (float*)db_part, rows, d);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_ln_bwd(const void* x, const void* dy, const void* ds_in, const void* gamma,
                         const void* mu, const void* rstd, void* dx, void* dg_part,
                         void* db_part, long long rows, int d, int blocks, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (d % VEC != 0) return (int)cudaErrorInvalidValue;
  const int nv = (d / VEC + 31) / 32;  // 16-byte vectors per lane
#define GDL_LN_BWD(NV) \
  case NV: return launch_ln_bwd_nv<T, NV>(x, dy, ds_in, gamma, mu, rstd, dx, dg_part, db_part, rows, d, blocks, st);
  switch (nv) {
    GDL_LN_BWD(1) GDL_LN_BWD(2) GDL_LN_BWD(3) GDL_LN_BWD(4)
    GDL_LN_BWD(5) GDL_LN_BWD(6) GDL_LN_BWD(7) GDL_LN_BWD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GDL_LN_BWD
}

// Number of blocks (= rows of each partial) the backward uses for `rows` rows.
extern "C" int gdl_layernorm_bwd_blocks(long long rows) {
  const long long need = (rows + LN_WARPS - 1) / LN_WARPS;
  return (int)(need < LN_BWD_MAX_BLOCKS ? need : LN_BWD_MAX_BLOCKS);
}

// x (K5: the forward's input; K6: the forward's rounded sum s), dy, ds_in, dx:
// [rows, d] of bf16 (is_bf16 != 0) or f32, contiguous and 16-byte aligned;
// gamma: [d] f32; mu, rstd: [rows] f32; dg_part, db_part: [blocks, d] f32 with
// blocks = gdl_layernorm_bwd_blocks(rows). ds_in == NULL selects K5, else K6.
extern "C" int gdl_layernorm_bwd(const void* x, const void* dy, const void* ds_in,
                                 const void* gamma, const void* mu, const void* rstd, void* dx,
                                 void* dg_part, void* db_part, long long rows, int d,
                                 int blocks, int is_bf16, void* stream) {
  if (rows < 1 || blocks != gdl_layernorm_bwd_blocks(rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_ln_bwd<bf16>(x, dy, ds_in, gamma, mu, rstd, dx, dg_part, db_part, rows, d, blocks, st);
  return launch_ln_bwd<float>(x, dy, ds_in, gamma, mu, rstd, dx, dg_part, db_part, rows, d, blocks, st);
}
