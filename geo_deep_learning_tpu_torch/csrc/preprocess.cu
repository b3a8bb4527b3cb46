// K1: fused uint8 -> normalized image.
//
// Replaces geo_deep_learning_tpu/ops/pallas/preprocess.py::_kernel (launched
// by _pallas_call): out = (x * (1/255) - mean[b,c]) * (1/std[b,c]), NHWC.
//
// Bound on the H100: bytes. Each pixel is read once (1 B) and written once
// (2 B in bf16, 4 B in f32); at DOFA bs8 512^2 RGB that is 6.3 MB in and
// 12.6 MB out, about 5.6 us at 3.35 TB/s, with ~3 flops per byte.
//
// Design (sm_90a): one launch a call. The statistics are folded in: the
// kernel reads mean and std as the caller gives them, [C] (per-sample stride
// 0) or [B, C] (stride C) f32, and forms 1/std with __frcp_rn (IEEE round to
// nearest), bit for bit the `1.0 / std` of the plain version. Persistent
// blocks walk tiles of PP_TILE_BYTES bytes of one sample: block p takes
// tiles p, p + grid, ...; tile t is sample t / tps at byte offset (t % tps)
// * PP_TILE_BYTES, the last tile of a sample shorter. PP_TILE_BYTES is a
// multiple of 48 = lcm(16, 3), so a tile starts at channel 0 of its sample.
// One thread of a producer warp brings each tile into a ring of PP_STAGES
// shared-memory stages with a 1-D bulk copy (cp.async.bulk, an L2
// evict-first hint: the input is read once) completing on the stage's
// mbarrier, up to PP_STAGES - 1 tiles ahead of the consumers. Eight
// consumer warps read the sample's C means and stds into registers before
// they wait on the tile, so that load
// overlaps the copy, then take the tile output vector by output vector:
// thread i the 16-byte vectors i, i + 256, ..., so that a warp's stores
// cover 512 contiguous bytes (a thread that took 48 contiguous input bytes
// would store 16 bytes of every 96 in bf16, of every 192 in f32, which the
// card ran far slower). A vector's E = 16 / sizeof(T) input bytes start at
// channel (E v) % C: 0 for C = 4; for C = 3 the thread's phase (E i) % 3
// plus a term with period 3 in the vector's round, so the statistics are
// rotated once to the thread's phase and every element's channel is a
// compile-time register index in a loop unrolled by three; any other C (up
// to 64) finds the vector's channel once with 32-bit arithmetic and reads
// its statistics per element through the read-only cache; a block reloads
// them only when a tile's sample has others than its last tile's (with [C]
// statistics, once). A byte's x / 255 comes from a byte permute and one
// exact fused multiply-add, not a quarter-rate conversion and a product.
// Every step rounds as the plain PyTorch version does (no contraction that
// changes a result), so f32 results equal it bit for bit. The outputs keep
// default caching (the model's first convolution reads them next) and go out
// as 16-byte stores from registers: on the card they beat a bulk store from
// a shared-memory staging stage, and the ring's tile and depth were chosen
// by timing (PERF.md).
//
// The bulk copy needs 16-byte aligned addresses and sizes. A call whose
// sample size n is not a multiple of 16, or whose image is not 16-byte
// aligned (a view at an offset), takes the generic path of the same launch:
// the consumers walk the same tiles with byte loads from global memory and
// scalar stores, same arithmetic, and the producer idles.
#include <algorithm>
#include <climits>

#include "hopper.cuh"

constexpr int PP_WARPS = 8;  // consumer warps; then a producer warp
constexpr int PP_CONSUMERS = PP_WARPS * 32;
constexpr int PP_THREADS = PP_CONSUMERS + 32;
// a tile: three 16-byte bf16 output vectors (six f32) for each consumer
// thread; the design test reads it from here
constexpr int PP_TILE_BYTES = 6144;
constexpr int PP_STAGES = 2;
constexpr int PP_MAX_C = 64;
static_assert(PP_TILE_BYTES % 48 == 0, "a tile starts at channel 0 for C = 3 and C = 4");

// (x * (1/255) - mean) * inv from xk = fl(x * (1/255)), each step rounded.
__device__ __forceinline__ float pp_scaled(float xk, float mean, float inv) {
  return __fmul_rn(__fsub_rn(xk, mean), inv);
}

// fl(x k), k = fl(1/255), of byte j of w: the plain version's first
// product. A byte permute builds the float 2^23 + x, and one fused
// multiply-add (2^23 + x) k + (-2^23 k) rounds the exact x k once (2^23 k is
// exact, a power-of-two multiple of k). No quarter-rate integer-to-float
// conversion, and one instruction for the conversion's and the product's
// two.
__device__ __forceinline__ float byte_scaled(uint32_t w, int j) {
  const float f = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | j));
  return __fmaf_rn(f, 1.0f / 255.0f, -8388608.0f * (1.0f / 255.0f));
}

// One sample's statistics. C = 3 or 4: C means and stds in registers,
// loaded before the tile's wait, inverted after it, and for C = 3 rotated to
// the thread's channel phase; element channels are then compile-time
// indices. C = 0 (any other count): read per element through the
// read-only cache.
template <int C>
struct PpStats {
  float m[C], inv[C];
  __device__ __forceinline__ void load(const float* mean, const float* sd, long long base) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      m[i] = __ldg(mean + base + i);
      inv[i] = __ldg(sd + base + i);
    }
  }
  __device__ __forceinline__ void invert() {
#pragma unroll
    for (int i = 0; i < C; ++i) inv[i] = __frcp_rn(inv[i]);
  }
  // Channel ch selected from the registers, never indexed: ch known at
  // compile time once unrolled costs nothing, at run time C - 1 selects.
  __device__ __forceinline__ float norm(float xk, int ch) const {
    float mm = m[0], ii = inv[0];
#pragma unroll
    for (int i = 1; i < C; ++i) {
      mm = ch == i ? m[i] : mm;
      ii = ch == i ? inv[i] : ii;
    }
    return pp_scaled(xk, mm, ii);
  }
  // Entry k becomes channel (phase + k) % C.
  __device__ __forceinline__ void rotate(int phase) {
    float rm[C], ri[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int ch = (phase + k) % C;
      rm[k] = m[0];
      ri[k] = inv[0];
#pragma unroll
      for (int i = 1; i < C; ++i) {
        rm[k] = ch == i ? m[i] : rm[k];
        ri[k] = ch == i ? inv[i] : ri[k];
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      m[k] = rm[k];
      inv[k] = ri[k];
    }
  }
};

template <>
struct PpStats<0> {
  const float* m;
  const float* s;
  __device__ __forceinline__ void load(const float* mean, const float* sd, long long base) {
    m = mean + base;
    s = sd + base;
  }
  __device__ __forceinline__ void invert() {}
  __device__ __forceinline__ void rotate(int) {}
  __device__ __forceinline__ float norm(float xk, int ch) const {
    return pp_scaled(xk, __ldg(m + ch), __frcp_rn(__ldg(s + ch)));
  }
};

// Input bytes of one 16-byte output vector: E = 8 (bf16, a uint2) or 4
// (f32, a uint32).
template <int E>
struct InWords;
template <>
struct InWords<8> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const unsigned char* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <>
struct InWords<4> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const unsigned char* p) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
};

// 16 bytes of outputs.
__device__ __forceinline__ void store16(bf16* dst, const float (&y)[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                                              pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
}
__device__ __forceinline__ void store16(float* dst, const float (&y)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
}

// minBlocks 1: without it ptxas capped an instance at 32 registers and
// spilled.
template <typename T, int C>
__global__ void __launch_bounds__(PP_THREADS, 1)
preprocess_kernel(const uint8_t* __restrict__ img, const float* __restrict__ mean,
                  const float* __restrict__ sd, int stat_stride, T* __restrict__ out, int n,
                  int c, int tps, int tiles, int bulk) {
  constexpr int E = 16 / sizeof(T);  // outputs of one 16-byte store, and their input bytes
  __shared__ __align__(128) unsigned char ring[PP_STAGES * PP_TILE_BYTES];
  // full barriers bars[s], empty bars[PP_STAGES + s] (one arrival per consumer warp)
  __shared__ uint64_t bars[2 * PP_STAGES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (!bulk) {
    // generic path: byte loads and scalar stores, same tiles, same arithmetic
    if (warp >= PP_WARPS) return;
    const int tid = threadIdx.x;
    const int cc = C == 0 ? c : C;
    const int step = PP_CONSUMERS % cc;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int b = t / tps;
      const int off = (t - b * tps) * PP_TILE_BYTES;
      const int rem = min(PP_TILE_BYTES, n - off);
      PpStats<C> st;
      st.load(mean, sd, (long long)b * stat_stride);
      st.invert();
      const uint8_t* src = img + (long long)b * n + off;
      T* dst = out + (long long)b * n + off;
      int ch = (off + tid) % cc;
      for (int e = tid; e < rem; e += PP_CONSUMERS) {
        dst[e] = from_f32<T>(st.norm(__fmul_rn((float)__ldg(src + e), 1.0f / 255.0f), ch));
        ch += step;
        ch -= ch >= cc ? cc : 0;
      }
    }
    return;
  }

  // The producer's thread sets up the barriers and issues its first
  // PP_STAGES copies before the block's one barrier, so the loads are in
  // flight while the other warps start.
  auto produce = [&](int t, int slot) {
    const int b = t / tps;
    const int off = (t - b * tps) * PP_TILE_BYTES;
    const uint32_t bytes = (uint32_t)min(PP_TILE_BYTES, n - off);
    const uint32_t full = smem_addr(&bars[slot]);
    mbar_arrive_tx(full, bytes);
    bulk_load_1d_hint(smem_addr(ring + slot * PP_TILE_BYTES), img + (long long)b * n + off, bytes,
                      full, l2_evict_first());
  };
  int pt = blockIdx.x, pk = 0;  // the producer's next tile, and its count
  if (threadIdx.x == PP_CONSUMERS) {
    for (int s = 0; s < PP_STAGES; ++s) {
      mbar_init(smem_addr(&bars[s]), 1);
      mbar_init(smem_addr(&bars[PP_STAGES + s]), PP_WARPS);
    }
    mbar_init_fence();
    for (; pt < tiles && pk < PP_STAGES; pt += gridDim.x, ++pk) produce(pt, pk);
  }
  __syncthreads();

  if (warp == PP_WARPS) {  // producer: the rest of its tiles, as stages come free
    if (lane == 0) {
      for (; pt < tiles; pt += gridDim.x, ++pk) {
        const int slot = pk % PP_STAGES;
        mbar_wait(smem_addr(&bars[PP_STAGES + slot]), ((pk / PP_STAGES) & 1) ^ 1);
        produce(pt, slot);
      }
    }
    return;
  }

  // consumers: thread i takes the tile's 16-byte output vectors i, i + 256,
  // ..., so a warp stores 512 contiguous bytes; vector v holds the E
  // outputs of input bytes E v .. E v + E - 1. The tile starts at channel
  // 0, so vector v starts at channel (E v) % C: for C = 3 the thread's
  // phase (E i) % 3 plus a term of r (v = i + 256 r) with period 3 in r,
  // compile-time in a loop unrolled by three, once the statistics are
  // rotated to the thread's phase; for C = 4, channel 0.
  const int i = threadIdx.x;
  constexpr int PHASE_STEP = (E * PP_CONSUMERS) % 3;  // C = 3: phase added per r
  PpStats<C> st;
  long long held = -1;  // the offset of the statistics in registers
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int b = t / tps;
    const int off = (t - b * tps) * PP_TILE_BYTES;
    const int nvec = min(PP_TILE_BYTES, n - off) / E;
    const long long base = (long long)b * stat_stride;
    const bool fresh = base != held;
    if (fresh) st.load(mean, sd, base);  // in flight during the wait
    const int slot = k % PP_STAGES;
    mbar_wait(smem_addr(&bars[slot]), (k / PP_STAGES) & 1);
    if (fresh) {
      st.invert();
      if constexpr (C == 3) st.rotate((E * i) % 3);
      held = base;
    }
    const unsigned char* in = ring + slot * PP_TILE_BYTES;
    T* dst = out + (long long)b * n + off;
    for (int v0 = i; v0 < nvec; v0 += 3 * PP_CONSUMERS) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int v = v0 + r * PP_CONSUMERS;
        if (v < nvec) {
          InWords<E> x;
          x.load(in + E * v);
          float y[E];
          int ch = 0;
          if constexpr (C == 0) ch = (off + E * v) % c;  // the vector's channel, once
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const float xk = byte_scaled(x.w[j / 4], j % 4);
            if constexpr (C == 0) {
              y[j] = st.norm(xk, ch);
              ch = ch + 1 == c ? 0 : ch + 1;
            } else {
              y[j] = st.norm(xk, C == 3 ? (r * PHASE_STEP + j) % 3 : j % C);
            }
          }
          store16(dst + E * v, y);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&bars[PP_STAGES + slot]));
  }
}

template <typename T, int C>
static int launch_pp(const uint8_t* img, const float* mean, const float* sd, int stat_stride,
                     void* out, int n, int c, int tps, int tiles, int bulk, cudaStream_t s) {
  int err = 0;
  const long long cap =
      block_capacity((const void*)preprocess_kernel<T, C>, PP_THREADS, 0, &err);
  if (err != 0) return err;
  const int grid = (int)std::min((long long)tiles, cap);
  preprocess_kernel<T, C><<<grid, PP_THREADS, 0, s>>>(img, mean, sd, stat_stride, (T*)out, n,
                                                        c, tps, tiles, bulk);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_pp_c(const uint8_t* img, const float* mean, const float* sd, int stat_stride,
                       void* out, int n, int c, int tps, int tiles, int bulk, cudaStream_t s) {
  if (c == 3) return launch_pp<T, 3>(img, mean, sd, stat_stride, out, n, c, tps, tiles, bulk, s);
  if (c == 4) return launch_pp<T, 4>(img, mean, sd, stat_stride, out, n, c, tps, tiles, bulk, s);
  return launch_pp<T, 0>(img, mean, sd, stat_stride, out, n, c, tps, tiles, bulk, s);
}

// img: [batch, n] uint8 (n = H*W*C, channel fastest); mean, std: f32, the
// statistics of sample b at mean + b * stat_stride (stat_stride 0 for [C],
// C for [B, C]); out: [batch, n] bf16 (out_bf16 != 0) or f32. bulk != 0
// (the bulk-copy path) only when n % 16 == 0 and img is 16-byte aligned.
extern "C" int gdl_preprocess(const void* img, const void* mean, const void* stdev,
                              int stat_stride, void* out, int out_bf16, long long batch,
                              long long n, int c, int bulk, void* stream) {
  if (c < 1 || c > PP_MAX_C || batch < 1 || n < 1 || n > INT_MAX - PP_TILE_BYTES ||
      (stat_stride != 0 && stat_stride != c))
    return (int)cudaErrorInvalidValue;
  if (bulk && (n % 16 != 0 || reinterpret_cast<uintptr_t>(img) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const long long tps = (n + PP_TILE_BYTES - 1) / PP_TILE_BYTES;
  if (batch > INT_MAX / tps) return (int)cudaErrorInvalidValue;
  const int tiles = (int)(batch * tps);
  const uint8_t* x = (const uint8_t*)img;
  const float* m = (const float*)mean;
  const float* sd = (const float*)stdev;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return launch_pp_c<bf16>(x, m, sd, stat_stride, out, (int)n, c, (int)tps, tiles, bulk, s);
  return launch_pp_c<float>(x, m, sd, stat_stride, out, (int)n, c, (int)tps, tiles, bulk, s);
}

extern "C" const char* gdl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
