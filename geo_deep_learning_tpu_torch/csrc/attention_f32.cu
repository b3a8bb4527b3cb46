// f32 instances of the softmax attention kernels: the forward that K4
// (packed) and K8 (head-major) run on float32 inputs, and the backward that
// K7 and K9 run on them.
//
// Replaces, for float32 inputs, geo_deep_learning_tpu/ops/pallas/mha.py::
// _fwd_kernel_packed and _fwd_kernel (forward), _bwd_kernel_packed and
// _bwd_kernel (backward): the Pallas kernels take any dtype, so a 32-true
// DOFA runs them in f32 on a TPU. The bf16 kernels (attention_kernels.cuh,
// attention_bwd_kernels.cuh) stay as they are.
//
// Both pairs take q, k, v (and dq, dk, dv) as [B, H, L, hd] views with one
// AttnLayout of run-time strides, o and g with their own: the packed pair
// passes the head slices of [B, L, 3*H*hd] and [B, L, H*hd], the head-major
// pair the views its caller holds.
//
// Forward: on the f32 FMA pipes, in full f32 (no TF32, no rounding of p),
// the numerics of the plain f32 version up to summation order and exp2 in
// place of exp. A block of 256 threads owns a 64 x 64 tile of scores:
// thread t holds rows 4*(t/16) + i and columns (t%16) + 16*j (i, j < 4) in
// registers, so a row's 16 owners are one half-warp and its max and sum are
// four shuffles. Tiles of 64 rows of q, k, v sit in shared memory with
// padded rows (hd + 4 where a half-warp broadcasts a row, hd + 1 where
// sixteen lanes read sixteen rows), conflict-free both ways; p goes through
// a 64 x 68 shared tile. One block per (64-query tile, head, batch); K/V
// tiles of 64 keys streamed through shared memory, an online softmax in
// exp2, P.V accumulated in registers (4 rows x hd/16 columns a thread), o
// divided by the row sum and lse = m*ln2 + log(l) written at the end. The
// ragged last tile is masked, not padded: rows past L load as zeros, their
// scores count for nothing and nothing is stored for them. Bound on the
// H100: operations, 4*B*H*L^2*hd = 41.3 GFLOP at DOFA-base 512^2, bs 8
// (L = 1297, H = 12, hd 64): 0.62 ms on the f32 pipe (67 TFLOP/s), 0.26 ms
// as 3xTF32 on the tensor cores (the card's fastest route at f32 accuracy).
//
// Backward: the delta pass (rowsum(g*o), a warp a row) below, then the
// dK/dV and dQ kernels of attention_bwd_tf32.cuh: products as 3xTF32 on
// wgmma (f32 accuracy at tensor-core rate), TMA-fed, no atomics, equal run
// to run; its note gives the numerics, the bound (0.638 ms at DOFA-base
// 512^2, 1.558 ms at 640^2) and the design. It replaces a first design on
// the f32 FMA pipe (67 TFLOP/s in all) that issued 8 shared-memory loads
// for 16 FMAs a thread, loaded tiles synchronously between barriers in
// 256-thread blocks, sent p and ds through a shared tile and ran seven
// products: the tensor cores now run the products, TMA keeps the next
// stages in flight, p and ds stay in registers.
#include "attention_bwd_tf32.cuh"
#include "attention_layout.cuh"

namespace f32attn {

constexpr int T = 64;          // rows of a tile (queries or keys)
constexpr int THREADS = 256;   // 16 row groups x 16 column lanes
constexpr int PS = T + 4;      // row stride of the shared p / ds tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Dims {
  static constexpr int R = HD + 4;  // rows a half-warp broadcasts
  static constexpr int C = HD + 1;  // rows sixteen lanes read at once
  static constexpr int NC = HD / 16;  // output columns a thread holds
};

// Rows [row0, row0 + T) of one (batch, head) into a shared tile of row
// stride `ld`; rows at or past L are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long rs,
                                          int row0, int L) {
  constexpr int V4 = HD / 4;
  for (int idx = threadIdx.x; idx < T * V4; idx += THREADS) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L) v = *reinterpret_cast<const float4*>(src + (row0 + r) * rs + c);
    float* d = dst + r * ld + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// acc[i][j] += sum_d a[(4*rg + i) * LA + d] * b[(cl + 16*j) * LB + d]
template <int HD, int LA, int LB>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a, const float* b,
                                         int rg, int cl) {
  const float* ar = a + 4 * rg * LA;
  const float* bc = b + cl * LB;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ar[i * LA + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = bc[16 * j * LB + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// out[i][n] += sum_k p[(4*rg + i) * PS + k] * m[k * LM + cl + 16*n], k < T
template <int HD, int LM>
__device__ __forceinline__ void pv_tile(float (&out)[4][HD / 16], const float* p, const float* m,
                                        int rg, int cl) {
  const float* pr = p + 4 * rg * PS;
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = pr[i * PS + k];
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      const float y = m[k * LM + cl + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][n] = fmaf(x[i], y, out[i][n]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o,
                             float* __restrict__ lse, AttnLayout in, AttnLayout out, int H, int L,
                             float scale_log2) {
  using D = Dims<HD>;
  extern __shared__ float smem[];
  float* sq = smem;              // [T][R]
  float* sk = sq + T * D::R;     // [T][C]
  float* sv = sk + T * D::C;     // [T][C]
  float* sp = sv + T * D::C;     // [T][PS]
  const int q0 = blockIdx.x * T, hi = blockIdx.y, bi = blockIdx.z;
  const int rg = threadIdx.x >> 4, cl = threadIdx.x & 15;
  const long long base = in.at(bi, hi);
  load_tile<HD>(sq, D::R, q + base, in.row, q0, L);

  float acc[4][HD / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) acc[i][n] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += T) {
    load_tile<HD>(sk, D::C, k + base, in.row, k0, L);
    load_tile<HD>(sv, D::C, v + base, in.row, k0, L);
    __syncthreads();
    float s[4][4] = {};
    dot_tile<HD, D::R, D::C>(s, sq, sk, rg, cl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + cl + 16 * j < L) ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);  // finite: key k0 is always < L
      const float alpha = exp2f(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        sp[(4 * rg + i) * PS + cl + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = mx;
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();
    pv_tile<HD, D::C>(acc, sp, sv, rg, cl);
    __syncthreads();
  }
  const long long obase = out.at(bi, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= L) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) o[obase + row * out.row + cl + 16 * n] = acc[i][n] * inv;
    if (cl == 0) lse[((long long)bi * H + hi) * L + row] = m[i] * LN2 + logf(l[i]);
  }
}

// delta[b, h, i] = sum_d g[i][d] * o[i][d], a warp a row.
__global__ void attention_delta_f32_kernel(const float* __restrict__ o,
                                           const float* __restrict__ g, float* __restrict__ delta,
                                           AttnLayout ol, AttnLayout gl, int H, int L, int hd) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int hi = blockIdx.y, bi = blockIdx.z, lane = threadIdx.x & 31;
  if (row >= L) return;
  const float* orow = o + ol.at(bi, hi) + row * ol.row;
  const float* grow = g + gl.at(bi, hi) + row * gl.row;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(grow[d], orow[d], s);
  s = warp_sum(s);
  if (lane == 0) delta[((long long)bi * H + hi) * L + row] = s;
}

template <int HD>
constexpr int fwd_smem() {
  return (T * (Dims<HD>::R + 2 * Dims<HD>::C) + T * PS) * 4;
}

// Raise a kernel's dynamic shared-memory limit to its one size, once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int HD>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
               AttnLayout in, AttnLayout out, int B, int L, int H, float scale,
               cudaStream_t stream) {
  static bool ready = false;
  constexpr int smem = fwd_smem<HD>();
  if (cudaError_t e = allow_smem(attention_fwd_f32_kernel<HD>, smem, ready)) return e;
  const dim3 grid((L + T - 1) / T, H, B);
  attention_fwd_f32_kernel<HD>
      <<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, in, out, H, L, scale * LOG2E);
  return cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v, const float* o, const float* g,
               const float* lse, float* delta, float* dq, float* dk, float* dv, AttnLayout in,
               AttnLayout ol, AttnLayout gl, int B, int L, int H, float scale,
               cudaStream_t stream) {
  const dim3 rows((L + THREADS / 32 - 1) / (THREADS / 32), H, B);
  attention_delta_f32_kernel<<<rows, THREADS, 0, stream>>>(o, g, delta, ol, gl, H, L, HD);
  if (cudaError_t e = cudaGetLastError()) return e;
  return tf32bwd::launch_bwd_tf32<HD>(q, k, v, g, lse, delta, dq, dk, dv, in, gl, B, L, H, scale,
                                      stream);
}

}  // namespace f32attn

// q, k, v: [B, H, L, hd] f32 views sharing the element strides in_*; out:
// strides out_*. Rows contiguous, strides multiples of 4, 16-byte aligned.
// lse: [B, H, L] f32. hd in {32, 64, 128}; scale > 0.
extern "C" int gdl_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int B, int L, int H, int hd, long long in_b,
                                     long long in_h, long long in_row, long long out_b,
                                     long long out_h, long long out_row, float scale,
                                     void* stream) {
  if (!attention_args_ok(B, L, H, hd)) return cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(out), *fl = static_cast<float*>(lse);
  const AttnLayout in{in_b, in_h, in_row}, ol{out_b, out_h, out_row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return f32attn::launch_fwd<32>(fq, fk, fv, fo, fl, in, ol, B, L, H, scale, s);
    case 64: return f32attn::launch_fwd<64>(fq, fk, fv, fo, fl, in, ol, B, L, H, scale, s);
    default: return f32attn::launch_fwd<128>(fq, fk, fv, fo, fl, in, ol, B, L, H, scale, s);
  }
}

// q, k, v, dq, dk, dv: [B, H, L, hd] f32 views sharing the strides in_*; o:
// strides o_*; g: strides g_*. lse: [B, H, L] f32; delta: [B, H, L] f32
// scratch. hd in {32, 64, 128}.
extern "C" int gdl_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                     const void* g, const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int B, int L, int H, int hd,
                                     long long in_b, long long in_h, long long in_row,
                                     long long o_b, long long o_h, long long o_row, long long g_b,
                                     long long g_h, long long g_row, float scale, void* stream) {
  if (!attention_args_ok(B, L, H, hd)) return cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(o),
              *fg = static_cast<const float*>(g), *fl = static_cast<const float*>(lse);
  float *fd = static_cast<float*>(delta), *dq_ = static_cast<float*>(dq),
        *dk_ = static_cast<float*>(dk), *dv_ = static_cast<float*>(dv);
  const AttnLayout in{in_b, in_h, in_row}, ol{o_b, o_h, o_row}, gl{g_b, g_h, g_row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return f32attn::launch_bwd<32>(fq, fk, fv, fo, fg, fl, fd, dq_, dk_, dv_, in, ol, gl, B, L,
                                     H, scale, s);
    case 64:
      return f32attn::launch_bwd<64>(fq, fk, fv, fo, fg, fl, fd, dq_, dk_, dv_, in, ol, gl, B, L,
                                     H, scale, s);
    default:
      return f32attn::launch_bwd<128>(fq, fk, fv, fo, fg, fl, fd, dq_, dk_, dv_, in, ol, gl, B,
                                      L, H, scale, s);
  }
}

// Dynamic shared memory a block of the 3xTF32 backward takes at head dim
// hd: the dK/dV kernel (kernel 0) or the dQ kernel (kernel 1); 0 for any
// other head dim.
extern "C" int gdl_attention_bwd_f32_smem(int hd, int kernel) {
  switch (hd) {
    case 32: return (int)(kernel ? tf32bwd::Smem<32, 6>::BYTES : tf32bwd::Smem<32, 8>::BYTES);
    case 64: return (int)(kernel ? tf32bwd::Smem<64, 6>::BYTES : tf32bwd::Smem<64, 8>::BYTES);
    case 128: return (int)(kernel ? tf32bwd::Smem<128, 6>::BYTES : tf32bwd::Smem<128, 8>::BYTES);
    default: return 0;
  }
}
