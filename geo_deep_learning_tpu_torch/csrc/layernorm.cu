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
// exactly the TPU kernel's fast-variance form (E[x]^2 rounded before the
// subtraction, as the plain versions compute it: no fused multiply-add).
// mu and rstd are plain [rows] f32 vectors (the TPU kernel's 8-wide trailing
// copies were a tiling artifact).
//
// Bound on the H100: bytes. At DOFA-base bs8 (10376 rows x 768, bf16) K2 moves
// ~32 MB (x in, y out), K3 ~64 MB (x, branch in; s, y out), K5 ~48 MB (x, dy
// in; dx out) and K6 ~64 MB (s, dy, ds_in in; dx out): 10-20 us at 3.35 TB/s;
// the arithmetic is a few flops per element.
//
// Design (sm_90a): persistent blocks fed by a ring of row tiles. A tile is R
// contiguous rows, so each of its inputs is one contiguous span of R*d
// elements; one thread of a producer warp brings it into shared memory with a
// 1-D bulk copy (cp.async.bulk, no tensor map) that completes on the stage's
// mbarrier, keeping up to S - 1 tiles in flight ahead of the consumers. The
// ragged last tile copies only its rows. Eight consumer warps take the
// tile's rows in turn (warp w: rows w, w + 8, ...): a lane reads its 16-byte
// vectors of the row from shared memory (conflict free), the row sums are
// warp shuffles, and the outputs go from registers to global memory with
// 16-byte stores; a warp releases the stage when it is done with the tile.
// The grid is min(tiles, SMs x resident blocks at the ring's shared memory),
// each block walking the tiles with a stride of the grid. Widths are a
// compile-time count of vectors per lane (NV). Gamma and beta sit in
// registers, loaded once per warp as 16-byte vectors (in shared memory for
// rows wider than 32 values a lane); a row is read from the staged tile
// twice, for its sums and for its outputs, rather than held, so that two
// blocks of 8 consumer warps fit on an SM at d = 768.
//
// The backward stages x (or s), dy and, for K6, ds_in of a tile through the
// same ring, so all of a row's inputs arrive before its reductions. A thread
// keeps its columns' dgamma/dbeta accumulators in registers, gamma sits in
// shared memory once per block, and xhat and a are recomputed from the
// staged row for dx rather than kept, so that 16 consumer warps of 96
// registers fill an SM at d = 768 (one block an SM; ln_bwd_warps). After
// its last tile each block sums its warps' accumulators through shared
// memory in warp order into one partial row. The last block of each group
// of LN_GROUP blocks to finish (a ticket from a global counter, after a
// fence) sums the group's partials in block order; the last group to
// finish sums the group rows in group order and writes the final f32
// dgamma and dbeta; both bring the rows into shared memory by bulk copies.
// No float atomics: the order of every sum is fixed, so the gradients are
// equal run to run. The counters are int32s the caller allocates zeroed
// once for each device and stream; the last block of each level resets
// its counter to 0, which assumes the calls that share them run in order.
#include <algorithm>
#include <mutex>
#include <vector>

#include "hopper.cuh"

constexpr int LN_WARPS = 8;                    // the forward's consumer warps, and a producer
constexpr int LN_THREADS = (LN_WARPS + 1) * 32;
constexpr int LN_MAX_STAGES = 8;
constexpr int LN_MAX_TILE_ROWS = 32;           // a lane holds one row's mu/rstd
constexpr int LN_GROUP = 16;                   // blocks whose partials one block sums
constexpr int LN_COUNTERS = 256;               // per-group tickets, the last one for the groups
constexpr int LN_SMEM_MAX = 227 * 1024;

// Vectors per lane of a compiled instance: ceil(vectors / 32) rounded up to
// one of 1, 2, 3, 4, 6, 8, 12, 16.
static int ln_nv(int nvec) {
  const int n = (nvec + 31) / 32;
  return n <= 4 ? n : n <= 6 ? 6 : n <= 8 ? 8 : n <= 12 ? 12 : 16;
}

// A 16-byte vector from shared memory, kept packed, and its element j
// (a compile-time index once unrolled) widened to f32.
__device__ __forceinline__ uint4 ld_vec(const void* p) { return *reinterpret_cast<const uint4*>(p); }

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int j);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int j) {
  return __uint_as_float(word(v, j));
}
template <>
__device__ __forceinline__ float elem<bf16>(const uint4& v, int j) {
  const uint32_t w = word(v, j >> 1);
  return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&dst)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

// Stage s: full barrier bars[s] (one arrival, the producer's, plus the
// copies' bytes), empty barrier bars[LN_MAX_STAGES + s] (one arrival per
// consumer warp); the backward's final sum takes bars[2 LN_MAX_STAGES].
__device__ __forceinline__ void ln_ring_init(uint64_t* bars, int stages, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&bars[s]), 1);
      mbar_init(smem_addr(&bars[LN_MAX_STAGES + s]), consumers);
    }
    mbar_init(smem_addr(&bars[2 * LN_MAX_STAGES]), 1);
    mbar_init_fence();
  }
}

// The producer: streams this block's tiles (blockIdx.x, blockIdx.x +
// gridDim.x, ...) into the ring, NIN inputs a tile, each input's rows
// contiguous at tile_rows * row_bytes apart within the stage; the k-th tile
// goes to stage k % stages once the consumers have released its previous
// round.
template <int NIN>
__device__ __forceinline__ void ln_produce(const unsigned char* src0, const unsigned char* src1,
                                           const unsigned char* src2, unsigned char* ring,
                                           uint64_t* bars, long long rows, int tile_rows,
                                           int stages, uint32_t row_bytes) {
  const unsigned char* src[3] = {src0, src1, src2};
  const uint32_t in_bytes = (uint32_t)tile_rows * row_bytes;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  int k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int slot = k % stages;
    if (k >= stages) mbar_wait(smem_addr(&bars[LN_MAX_STAGES + slot]), ((k / stages) & 1) ^ 1);
    const long long r0 = t * tile_rows;
    const uint32_t bytes = (uint32_t)min((long long)tile_rows, rows - r0) * row_bytes;
    const uint32_t full = smem_addr(&bars[slot]);
    mbar_arrive_tx(full, NIN * bytes);
    unsigned char* dst = ring + (size_t)slot * NIN * in_bytes;
#pragma unroll
    for (int i = 0; i < NIN; ++i)
      bulk_load_1d(smem_addr(dst + i * in_bytes), src[i] + r0 * row_bytes, bytes, full);
  }
}

// Two blocks an SM up to 24 values a lane (d = 768 in bf16 or f32).
template <typename T, int NV, bool RESIDUAL>
__global__ void __launch_bounds__(LN_THREADS, NV * (16 / sizeof(T)) <= 24 ? 2 : 1)
layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ branch,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     T* __restrict__ s_out, T* __restrict__ y,
                     float* __restrict__ mu_out, float* __restrict__ rstd_out,
                     long long rows, int d, int tile_rows, int stages, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NIN = RESIDUAL ? 2 : 1;
  constexpr bool AFFINE_REGS = NV * VEC <= 32;
  constexpr int NG = AFFINE_REGS ? NV : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[2 * LN_MAX_STAGES + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  const uint32_t in_bytes = (uint32_t)tile_rows * row_bytes;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  float* affine = reinterpret_cast<float*>(smem + (size_t)stages * NIN * in_bytes);  // [2][d]

  ln_ring_init(bars, stages, LN_WARPS);
  if constexpr (!AFFINE_REGS) {
    for (int c = threadIdx.x; c < d; c += LN_THREADS) {
      affine[c] = gamma[c];
      affine[d + c] = beta[c];
    }
  }
  __syncthreads();
  if (warp == LN_WARPS) {
    if (lane == 0)
      ln_produce<NIN>(reinterpret_cast<const unsigned char*>(x),
                      reinterpret_cast<const unsigned char*>(branch), nullptr, smem, bars, rows,
                      tile_rows, stages, row_bytes);
    return;
  }

  float g[NG][VEC], b[NG][VEC];
  if constexpr (AFFINE_REGS) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        load_f32<VEC>(gamma + vi * VEC, g[i]);
        load_f32<VEC>(beta + vi * VEC, b[i]);
      }
    }
  }

  // The row's values (K3: x + branch, unrounded) are read from the staged
  // tile twice, for the sums and for the outputs, rather than kept: the
  // registers go to gamma and beta, and to a second block on the SM.
  int k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int slot = k % stages;
    mbar_wait(smem_addr(&bars[slot]), (k / stages) & 1);
    const long long r0 = t * tile_rows;
    const int n = (int)min((long long)tile_rows, rows - r0);
    const T* xs = reinterpret_cast<const T*>(smem + (size_t)slot * NIN * in_bytes);
    for (int r = warp; r < n; r += LN_WARPS) {
      const T* xr = xs + (size_t)r * d;
      const T* brr = xr + (size_t)tile_rows * d;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = lane + i * 32;
        if (vi < nvec) {
          const uint4 xv = ld_vec(xr + vi * VEC);
          const uint4 bv = RESIDUAL ? ld_vec(brr + vi * VEC) : xv;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float v = RESIDUAL ? elem<T>(xv, j) + elem<T>(bv, j) : elem<T>(xv, j);
            sum += v;
            sq += v * v;
          }
        }
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mu = sum / (float)d;
      const float var = fmaxf(__fsub_rn(sq / (float)d, __fmul_rn(mu, mu)), 0.f);
      const float rstd = 1.f / sqrtf(var + eps);
      const long long base = (r0 + r) * d;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = lane + i * 32;
        if (vi < nvec) {
          const int col = vi * VEC;
          const uint4 xv = ld_vec(xr + col);
          const uint4 bv = RESIDUAL ? ld_vec(brr + col) : xv;
          float v[VEC], gv[VEC], bt[VEC], out[VEC];
          if constexpr (AFFINE_REGS) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              gv[j] = g[i][j];
              bt[j] = b[i][j];
            }
          } else {
            load_f32<VEC>(affine + col, gv);
            load_f32<VEC>(affine + d + col, bt);
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            v[j] = RESIDUAL ? elem<T>(xv, j) + elem<T>(bv, j) : elem<T>(xv, j);
            out[j] = ((v[j] - mu) * rstd) * gv[j] + bt[j];
          }
          store_vec<T>(y + base + col, out);
          if (RESIDUAL) store_vec<T>(s_out + base + col, v);
        }
      }
      if (lane == 0) {
        mu_out[r0 + r] = mu;
        rstd_out[r0 + r] = rstd;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&bars[LN_MAX_STAGES + slot]));
  }
}

// Shared memory of a ring of `stages` tiles of NIN inputs.
static size_t ln_ring_bytes(int nin, int tile_rows, int stages, int d, int elt) {
  return (size_t)stages * nin * tile_rows * d * elt;
}

// SMs x resident blocks of `kernel` with `threads` threads and `smem` bytes
// of dynamic shared memory on the current device: found at the first
// launch of a (kernel, device, size) and kept, since neither changes
// between calls, so a launch costs the host a table lookup. The kernel's
// shared-memory attribute is raised to the largest size it has been
// asked for there and never lowered, so every kept size stays launchable.
// 0 with *err set if the launch cannot be made.
static long long ln_capacity(const void* kernel, int threads, size_t smem, int* err) {
  struct Seen {
    const void* kernel;
    int dev;
    size_t smem;
    long long cap;
  };
  static std::mutex lock;
  static std::vector<Seen> seen;
  *err = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) {
    *err = (int)e;
    return 0;
  }
  std::lock_guard<std::mutex> hold(lock);
  for (const Seen& c : seen)
    if (c.kernel == kernel && c.dev == dev && c.smem == smem) return c.cap;
  if (smem > (size_t)LN_SMEM_MAX) {
    *err = (int)cudaErrorInvalidValue;
    return 0;
  }
  size_t top = smem;
  for (const Seen& c : seen)
    if (c.kernel == kernel && c.dev == dev && c.smem > top) top = c.smem;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)top);
  int occ = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
  const long long cap = (long long)sm_count() * occ;
  if (e != cudaSuccess || cap < 1) {
    *err = (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    return 0;
  }
  seen.push_back({kernel, dev, smem, cap});
  return cap;
}

template <typename T, int NV, bool RESIDUAL>
static int launch_ln_nv(const void* x, const void* branch, const void* gamma, const void* beta,
                        void* s, void* y, void* mu, void* rstd, long long rows, int d,
                        int tile_rows, int stages, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t affine = NV * VEC <= 32 ? 0 : 2 * sizeof(float) * d;
  const size_t smem = ln_ring_bytes(RESIDUAL ? 2 : 1, tile_rows, stages, d, sizeof(T)) + affine;
  int err = 0;
  const long long cap =
      ln_capacity((const void*)layernorm_fwd_kernel<T, NV, RESIDUAL>, LN_THREADS, smem, &err);
  if (err != 0) return err;
  const int grid = (int)std::min((rows + tile_rows - 1) / tile_rows, cap);
  layernorm_fwd_kernel<T, NV, RESIDUAL><<<grid, LN_THREADS, smem, stream>>>(
      (const T*)x, (const T*)branch, (const float*)gamma, (const float*)beta, (T*)s, (T*)y,
      (float*)mu, (float*)rstd, rows, d, tile_rows, stages, eps);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
static int launch_ln_fwd_nv(const void* x, const void* branch, const void* gamma,
                            const void* beta, void* s, void* y, void* mu, void* rstd,
                            long long rows, int d, int tile_rows, int stages, float eps,
                            cudaStream_t st) {
  if (branch != nullptr)
    return launch_ln_nv<T, NV, true>(x, branch, gamma, beta, s, y, mu, rstd, rows, d, tile_rows,
                                     stages, eps, st);
  return launch_ln_nv<T, NV, false>(x, nullptr, gamma, beta, nullptr, y, mu, rstd, rows, d,
                                    tile_rows, stages, eps, st);
}

static bool ln_ring_ok(long long rows, int tile_rows, int stages) {
  return rows >= 1 && tile_rows >= 1 && tile_rows <= LN_MAX_TILE_ROWS && stages >= 2 &&
         stages <= LN_MAX_STAGES;
}

template <typename T>
static int launch_ln(const void* x, const void* branch, const void* gamma, const void* beta,
                     void* s, void* y, void* mu, void* rstd, long long rows, int d,
                     int tile_rows, int stages, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (d % VEC != 0 || d > 2048 || !ln_ring_ok(rows, tile_rows, stages))
    return (int)cudaErrorInvalidValue;
#define GDL_LN_FWD(NV)                                                                       \
  case NV:                                                                                   \
    return launch_ln_fwd_nv<T, NV>(x, branch, gamma, beta, s, y, mu, rstd, rows, d, tile_rows, \
                                   stages, eps, st);
  switch (ln_nv(d / VEC)) {
    GDL_LN_FWD(1) GDL_LN_FWD(2) GDL_LN_FWD(3) GDL_LN_FWD(4) GDL_LN_FWD(6) GDL_LN_FWD(8)
    default: break;
  }
  if constexpr (VEC == 4) {  // f32 rows above 1024 values
    switch (ln_nv(d / VEC)) {
      GDL_LN_FWD(12) GDL_LN_FWD(16)
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef GDL_LN_FWD
}

// x, branch, s, y: [rows, d] of bf16 (is_bf16 != 0) or f32, contiguous and
// 16-byte aligned, d a multiple of 16 bytes up to 2048 elements; gamma,
// beta: [d] f32, 16-byte aligned; mu, rstd: [rows] f32. The ring holds
// `stages` (2-8) tiles of `tile_rows` (1-32) rows. branch == s == NULL
// selects K2, otherwise K3.
extern "C" int gdl_layernorm_fwd(const void* x, const void* branch, const void* gamma,
                                 const void* beta, void* s, void* y, void* mu, void* rstd,
                                 long long rows, int d, int tile_rows, int stages, float eps,
                                 int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_ln<bf16>(x, branch, gamma, beta, s, y, mu, rstd, rows, d, tile_rows, stages,
                           eps, st);
  return launch_ln<float>(x, branch, gamma, beta, s, y, mu, rstd, rows, d, tile_rows, stages,
                          eps, st);
}

// ---------------------------------------------------------------------------
// K5 / K6: backward.

// Consumer warps of a backward block, one block an SM: 16 up to 24 values
// a lane (d <= 768), 8 up to 32 (d <= 1024), and 4 above (d <= 2048 in
// bf16), whose accumulators need the registers a 160-thread block leaves
// a thread. One block of 16 warps beat two of 8 on the H100: half the
// partial rows for the final sum.
template <typename T, int NV>
__host__ __device__ constexpr int ln_bwd_warps() {
  return NV * (16 / (int)sizeof(T)) <= 24 ? 16 : NV * (16 / (int)sizeof(T)) <= 32 ? 8 : 4;
}

// t[k] (float4 column threadIdx.x + k NTHR of rows of 2d floats) plus, in
// order, the `n` rows at `rows`: chunks of up to `fit` rows come into the
// shared buffer `buf` by bulk copies that thread 0 issues on the mbarrier
// `bar` (a few DMA transfers instead of every thread's loads, whose
// latency bounds a single block's sum), and each thread adds its columns
// row by row. The rows were written by other blocks and published by
// their fences and tickets, which thread 0 has acquired: its proxy fence
// orders that before the copies' reads.
template <int NTHR, int K>
__device__ __forceinline__ void ln_sum_rows(float4 (&t)[K], const float* rows, int n, int d,
                                            unsigned char* buf, int fit, uint32_t bar,
                                            uint32_t& phase) {
  const uint32_t row_bytes = 8u * d;
  const int cols4 = d / 2;
  for (int r0 = 0; r0 < n; r0 += fit) {
    const int m = min(fit, n - r0);
    fence_proxy_async();  // this thread's accesses of buf before the copies overwrite it
    named_sync(1, NTHR);
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      mbar_arrive_tx(bar, m * row_bytes);
      for (int i = 0; i < m; ++i)
        bulk_load_1d(smem_addr(buf + i * row_bytes), rows + (size_t)(r0 + i) * 2 * d, row_bytes,
                     bar);
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    for (int i = 0; i < m; ++i) {
      const float4* row = reinterpret_cast<const float4*>(buf + i * row_bytes);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c4 = threadIdx.x + k * NTHR;
        if (c4 < cols4) {
          const float4 v = row[c4];
          t[k].x += v.x;
          t[k].y += v.y;
          t[k].z += v.z;
          t[k].w += v.w;
        }
      }
    }
  }
}

// Called by the NTHR consumer threads of every block once its partial row
// (2d floats: dgamma's, then dbeta's) is in part[blockIdx.x] and the block
// is done with its shared memory (`buf`, room for `fit` rows). The last
// block of the group to arrive sums the group's partials in block order
// into group_part[group]; the last group to arrive sums the group rows in
// group order into dgamma and dbeta. Thread 0 publishes the block's
// writes, which the named barrier has ordered before it, with a fence
// before its ticket.
template <int NTHR, int K>
__device__ __forceinline__ void ln_final_sum(const float* part, float* group_part,
                                             float* __restrict__ dgamma,
                                             float* __restrict__ dbeta, int* counters, int d,
                                             unsigned char* buf, int fit, uint32_t bar) {
  __shared__ int last;
  const int tid = threadIdx.x;
  const int group = blockIdx.x / LN_GROUP, first = group * LN_GROUP;
  const int members = min(LN_GROUP, (int)gridDim.x - first);
  const int groups = (gridDim.x + LN_GROUP - 1) / LN_GROUP;
  const size_t cols = 2 * (size_t)d;
  const int cols4 = d / 2;
  uint32_t phase = 0;
  float4 t[K];

  named_sync(1, NTHR);
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&counters[group], 1) == members - 1;
    if (last) atomicExch(&counters[group], 0);
    __threadfence();
  }
  named_sync(1, NTHR);
  if (!last) return;
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  ln_sum_rows<NTHR>(t, part + first * cols, members, d, buf, fit, bar, phase);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (tid + k * NTHR < cols4)
      reinterpret_cast<float4*>(group_part + group * cols)[tid + k * NTHR] = t[k];

  named_sync(1, NTHR);
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&counters[LN_COUNTERS - 1], 1) == groups - 1;
    if (last) atomicExch(&counters[LN_COUNTERS - 1], 0);
    __threadfence();
  }
  named_sync(1, NTHR);
  if (!last) return;
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  ln_sum_rows<NTHR>(t, group_part, groups, d, buf, fit, bar, phase);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c4 = tid + k * NTHR;
    if (c4 < cols4) *reinterpret_cast<float4*>(4 * c4 < d ? dgamma + 4 * c4 : dbeta + (4 * c4 - d)) = t[k];
  }
}

template <typename T, int NV, bool RESIDUAL>
__global__ void __launch_bounds__((ln_bwd_warps<T, NV>() + 1) * 32, 1)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const T* __restrict__ ds_in, const float* __restrict__ gamma,
                     const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
                     T* __restrict__ dx, float* part, float* __restrict__ dgamma,
                     float* __restrict__ dbeta, int* counters, long long rows, int d,
                     int tile_rows, int stages) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NIN = RESIDUAL ? 3 : 2;
  constexpr int W = ln_bwd_warps<T, NV>(), NTHR = W * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[2 * LN_MAX_STAGES + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  const uint32_t in_bytes = (uint32_t)tile_rows * row_bytes;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  // the ring, then gamma (once for the block: the registers go to the
  // accumulators, and to a second block on the SM); the ring is at least
  // W x d floats, which the block partial takes over at the end
  const size_t ring = (size_t)stages * NIN * in_bytes;
  const size_t red_bytes = sizeof(float) * W * d;
  float* gsm = reinterpret_cast<float*>(smem + (ring > red_bytes ? ring : red_bytes));

  ln_ring_init(bars, stages, W);
  __syncthreads();
  if (warp == W) {
    if (lane == 0)
      ln_produce<NIN>(reinterpret_cast<const unsigned char*>(x),
                      reinterpret_cast<const unsigned char*>(dy),
                      reinterpret_cast<const unsigned char*>(ds_in), smem, bars, rows, tile_rows,
                      stages, row_bytes);
    return;
  }
  for (int c = threadIdx.x; c < d; c += NTHR) gsm[c] = gamma[c];
  named_sync(1, NTHR);

  float acc_g[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc_g[i][j] = 0.f;
      acc_b[i][j] = 0.f;
    }

  // mu and rstd of a tile's rows, lane r holding row r, loaded one tile ahead
  auto stats = [&](long long tile, float& m, float& s) {
    const long long row = tile * tile_rows + lane;
    if (tile < tiles && lane < tile_rows && row < rows) {
      m = mu_in[row];
      s = rstd_in[row];
    }
  };
  float mu_next = 0.f, rs_next = 0.f;
  stats(blockIdx.x, mu_next, rs_next);

  int k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const float mu_tile = mu_next, rs_tile = rs_next;
    stats(t + gridDim.x, mu_next, rs_next);
    const int slot = k % stages;
    mbar_wait(smem_addr(&bars[slot]), (k / stages) & 1);
    const long long r0 = t * tile_rows;
    const int n = (int)min((long long)tile_rows, rows - r0);
    const T* xs = reinterpret_cast<const T*>(smem + (size_t)slot * NIN * in_bytes);
    for (int r = warp; r < n; r += W) {
      const float mu = __shfl_sync(0xffffffffu, mu_tile, r);
      const float rstd = __shfl_sync(0xffffffffu, rs_tile, r);
      const T* xr = xs + (size_t)r * d;
      const T* dyr = xr + (size_t)tile_rows * d;
      float sum_a = 0.f, sum_ax = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = lane + i * 32;
        if (vi < nvec) {
          const uint4 xv = ld_vec(xr + vi * VEC), dv = ld_vec(dyr + vi * VEC);
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q) {
            const float4 g4 = reinterpret_cast<const float4*>(gsm + vi * VEC)[q];
            const float gq[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = 4 * q + u;
              const float dyj = elem<T>(dv, j);
              const float xh = (elem<T>(xv, j) - mu) * rstd;
              const float a = dyj * gq[u];
              sum_a += a;
              sum_ax += a * xh;
              acc_g[i][j] += dyj * xh;
              acc_b[i][j] += dyj;
            }
          }
        }
      }
      const float t1 = warp_sum(sum_a) / (float)d;
      const float t2 = warp_sum(sum_ax) / (float)d;
      const long long base = (r0 + r) * d;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = lane + i * 32;
        if (vi < nvec) {
          const uint4 xv = ld_vec(xr + vi * VEC), dv = ld_vec(dyr + vi * VEC);
          float out[VEC];
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q) {
            const float4 g4 = reinterpret_cast<const float4*>(gsm + vi * VEC)[q];
            const float gq[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = 4 * q + u;
              const float xh = (elem<T>(xv, j) - mu) * rstd;
              const float a = elem<T>(dv, j) * gq[u];
              out[j] = rstd * (a - t1 - xh * t2);
            }
          }
          if (RESIDUAL) {
            const uint4 rv = ld_vec(dyr + (size_t)tile_rows * d + vi * VEC);
#pragma unroll
            for (int j = 0; j < VEC; ++j) out[j] += elem<T>(rv, j);
          }
          store_vec<T>(dx + base + vi * VEC, out);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&bars[LN_MAX_STAGES + slot]));
  }

  // the block's partial row: dgamma, then dbeta, the warps' accumulators
  // summed in warp order through shared memory (every consumer is past its
  // last tile, so the ring is idle)
  float* red = reinterpret_cast<float*>(smem);  // [W][d]
  float* mine = part + (size_t)blockIdx.x * 2 * d;
  named_sync(1, NTHR);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float(&a)[VEC] = pass == 0 ? acc_g[i] : acc_b[i];
          reinterpret_cast<float4*>(red + warp * d + vi * VEC)[q] =
              make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
        }
      }
    }
    named_sync(1, NTHR);
    for (int c = threadIdx.x; c < d; c += NTHR) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) t += red[w * d + c];
      mine[pass * d + c] = t;
    }
    named_sync(1, NTHR);
  }
  constexpr int K = (NV * VEC * 16 + NTHR - 1) / NTHR;  // float4 columns a thread sums
  const size_t buf = ring > red_bytes ? ring : red_bytes;
  ln_final_sum<NTHR, K>(part, part + (size_t)gridDim.x * 2 * d, dgamma, dbeta, counters, d, smem,
                        (int)(buf / (8u * d)), smem_addr(&bars[2 * LN_MAX_STAGES]));
}

// The backward's scratch, in floats, for a grid of `blocks`: a partial row
// (2d floats) for each block, then one for each group.
static long long ln_scratch_floats(long long blocks, int d) {
  return (blocks + (blocks + LN_GROUP - 1) / LN_GROUP) * 2 * (long long)d;
}

// Launches the backward or, with `need` set, writes there the scratch
// floats that the instance's largest grid takes (and launches nothing).
template <typename T, int NV, bool RESIDUAL>
static int launch_ln_bwd_nv(const void* x, const void* dy, const void* ds_in, const void* gamma,
                            const void* mu, const void* rstd, void* dx, void* dgamma, void* dbeta,
                            void* scratch, long long scratch_floats, void* counters,
                            long long rows, int d, int tile_rows, int stages, long long* need,
                            cudaStream_t stream) {
  constexpr int threads = (ln_bwd_warps<T, NV>() + 1) * 32;
  const size_t ring = ln_ring_bytes(RESIDUAL ? 3 : 2, tile_rows, stages, d, sizeof(T));
  const size_t red = sizeof(float) * ln_bwd_warps<T, NV>() * d;
  const size_t smem = (ring > red ? ring : red) + sizeof(float) * d;
  int err = 0;
  long long cap =
      ln_capacity((const void*)layernorm_bwd_kernel<T, NV, RESIDUAL>, threads, smem, &err);
  if (err != 0) return err;
  cap = std::min(cap, (long long)(LN_COUNTERS - 1) * LN_GROUP);  // a ticket for each group
  if (need != nullptr) {
    *need = ln_scratch_floats(cap, d);
    return 0;
  }
  const int grid = (int)std::min((rows + tile_rows - 1) / tile_rows, cap);
  if (scratch_floats < ln_scratch_floats(grid, d)) return (int)cudaErrorInvalidValue;
  layernorm_bwd_kernel<T, NV, RESIDUAL><<<grid, threads, smem, stream>>>(
      (const T*)x, (const T*)dy, (const T*)ds_in, (const float*)gamma, (const float*)mu,
      (const float*)rstd, (T*)dx, (float*)scratch, (float*)dgamma, (float*)dbeta,
      (int*)counters, rows, d, tile_rows, stages);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_ln_bwd(const void* x, const void* dy, const void* ds_in, const void* gamma,
                         const void* mu, const void* rstd, void* dx, void* dgamma, void* dbeta,
                         void* scratch, long long scratch_floats, void* counters, long long rows,
                         int d, int tile_rows, int stages, long long* need, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (d % VEC != 0 || d / VEC > 32 * 8 || !ln_ring_ok(rows, tile_rows, stages))
    return (int)cudaErrorInvalidValue;
#define GDL_LN_BWD(NV)                                                                          \
  case NV:                                                                                      \
    return ds_in != nullptr                                                                     \
               ? launch_ln_bwd_nv<T, NV, true>(x, dy, ds_in, gamma, mu, rstd, dx, dgamma, dbeta, \
                                               scratch, scratch_floats, counters, rows, d,      \
                                               tile_rows, stages, need, st)                     \
               : launch_ln_bwd_nv<T, NV, false>(x, dy, nullptr, gamma, mu, rstd, dx, dgamma,    \
                                                dbeta, scratch, scratch_floats, counters, rows, \
                                                d, tile_rows, stages, need, st);
  switch (ln_nv(d / VEC)) {
    GDL_LN_BWD(1) GDL_LN_BWD(2) GDL_LN_BWD(3) GDL_LN_BWD(4) GDL_LN_BWD(6) GDL_LN_BWD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GDL_LN_BWD
}

// The backward's workspace for rows of width d through a ring of `stages`
// tiles of `tile_rows` rows (residual != 0: K6) on the current device:
// *scratch_floats, enough for any row count, and *counters, the int32
// tickets. Returns a CUDA error code, 0 on success.
extern "C" int gdl_layernorm_bwd_workspace(int d, int tile_rows, int stages, int is_bf16,
                                           int residual, long long* scratch_floats,
                                           int* counters) {
  const void* ds = residual ? (const void*)1 : nullptr;  // selects the instance only
  *counters = LN_COUNTERS;
  return is_bf16 ? launch_ln_bwd<bf16>(nullptr, nullptr, ds, nullptr, nullptr, nullptr, nullptr,
                                       nullptr, nullptr, nullptr, 0, nullptr, 1, d, tile_rows,
                                       stages, scratch_floats, nullptr)
                 : launch_ln_bwd<float>(nullptr, nullptr, ds, nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, 0, nullptr, 1, d, tile_rows,
                                        stages, scratch_floats, nullptr);
}

// x (K5: the forward's input; K6: the forward's rounded sum s), dy, ds_in,
// dx: [rows, d] of bf16 (is_bf16 != 0) or f32, contiguous and 16-byte
// aligned, at most 8 vectors of 16 bytes a lane (d <= 2048 in bf16, 1024
// in f32); gamma: [d] f32, 16-byte aligned; mu, rstd: [rows] f32; dgamma,
// dbeta: [d] f32, the final sums; scratch: scratch_floats f32 and
// counters: int32, as gdl_layernorm_bwd_workspace gives them, the counters
// zero before the first call and left zero by every call that completes,
// used by the calls of one stream in order. ds_in == NULL selects K5,
// else K6.
extern "C" int gdl_layernorm_bwd(const void* x, const void* dy, const void* ds_in,
                                 const void* gamma, const void* mu, const void* rstd, void* dx,
                                 void* dgamma, void* dbeta, void* scratch,
                                 long long scratch_floats, void* counters, long long rows, int d,
                                 int tile_rows, int stages, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_ln_bwd<bf16>(x, dy, ds_in, gamma, mu, rstd, dx, dgamma, dbeta, scratch,
                               scratch_floats, counters, rows, d, tile_rows, stages, nullptr, st);
  return launch_ln_bwd<float>(x, dy, ds_in, gamma, mu, rstd, dx, dgamma, dbeta, scratch,
                              scratch_floats, counters, rows, d, tile_rows, stages, nullptr, st);
}
