// K1: fused uint8 -> normalized image.
//
// Replaces geo_deep_learning_tpu/ops/pallas/preprocess.py::_kernel (launched
// by _pallas_call): out = (x * (1/255) - mean[b,c]) * inv_std[b,c], NHWC.
//
// Bound on the H100: bytes. Each pixel is read once (1 B) and written once
// (2 B in bf16, 4 B in f32); at DOFA bs8 512^2 RGB that is 6.3 MB in and
// 12.6 MB out, about 5.6 us at 3.35 TB/s, with ~3 flops per byte.
//
// Design: one block row per sample (blockIdx.y), so the sample's C means and
// inverse deviations sit in shared memory for the whole block; each thread
// moves 16 pixels with one 16-byte load and one or more 16-byte stores.
// The arithmetic uses explicitly rounded operations (no FMA contraction), so
// f32 results equal the plain PyTorch version bit for bit.
#include "common.cuh"

constexpr int PP_CHUNK = 16;   // uint8 values per thread: one 16-byte load
constexpr int PP_THREADS = 256;
constexpr int PP_MAX_C = 64;   // channels held in shared memory

__device__ __forceinline__ float pp_norm(uint8_t px, float mean, float inv) {
  return __fmul_rn(__fsub_rn(__fmul_rn((float)px, 1.0f / 255.0f), mean), inv);
}

template <typename T>
__global__ void __launch_bounds__(PP_THREADS)
preprocess_kernel(const uint8_t* __restrict__ img, const float* __restrict__ mean,
                  const float* __restrict__ inv, T* __restrict__ out,
                  long long n, int c, int vec) {
  __shared__ float s_mean[PP_MAX_C];
  __shared__ float s_inv[PP_MAX_C];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    s_mean[i] = mean[b * c + i];
    s_inv[i] = inv[b * c + i];
  }
  __syncthreads();

  const long long start = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * PP_CHUNK;
  if (start >= n) return;
  const uint8_t* src = img + (long long)b * n;
  T* dst = out + (long long)b * n;
  int ch = (int)(start % c);
  if (vec && start + PP_CHUNK <= n) {
    __align__(16) uint8_t px[PP_CHUNK];
    *reinterpret_cast<uint4*>(px) = *reinterpret_cast<const uint4*>(src + start);
    float v[PP_CHUNK];
#pragma unroll
    for (int i = 0; i < PP_CHUNK; ++i) {
      v[i] = pp_norm(px[i], s_mean[ch], s_inv[ch]);
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
    constexpr int PER_STORE = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < PP_CHUNK; i += PER_STORE) store_vec<T>(dst + start + i, v + i);
  } else {
    const long long end = start + PP_CHUNK < n ? start + PP_CHUNK : n;
    for (long long e = start; e < end; ++e) {
      dst[e] = from_f32<T>(pp_norm(src[e], s_mean[ch], s_inv[ch]));
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
  }
}

// img: [batch, n] uint8 (n = H*W*C, channel fastest); mean, inv: [batch, c] f32;
// out: [batch, n] bf16 (out_bf16 != 0) or f32. vec != 0 only when n % 16 == 0
// and img is 16-byte aligned.
extern "C" int gdl_preprocess(const void* img, const void* mean, const void* inv,
                              void* out, int out_bf16, long long batch, long long n,
                              int c, int vec, void* stream) {
  if (c < 1 || c > PP_MAX_C || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const long long chunks = (n + PP_CHUNK - 1) / PP_CHUNK;
  dim3 grid((unsigned)((chunks + PP_THREADS - 1) / PP_THREADS), (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)img;
  if (out_bf16) {
    preprocess_kernel<bf16><<<grid, PP_THREADS, 0, s>>>(
        x, (const float*)mean, (const float*)inv, (bf16*)out, n, c, vec);
  } else {
    preprocess_kernel<float><<<grid, PP_THREADS, 0, s>>>(
        x, (const float*)mean, (const float*)inv, (float*)out, n, c, vec);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gdl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
