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
// Forward: attention_fwd_tf32.cuh, one kernel: both products as 3xTF32
// on wgmma (f32 accuracy at tensor-core rate), q k^T summed in groups of
// 16 head-dim columns, the online softmax in f32 registers in exp2, each
// stage's p v promoted into the running rows, TMA-fed through a splitter
// warpgroup, equal run to run; its note gives the numerics, the bound
// (0.263 ms at DOFA-base 512^2, 0.641 ms at 640^2) and the design.
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
#include "attention_fwd_tf32.cuh"

namespace f32attn {

constexpr int THREADS = 256;  // threads of a delta block, a warp a row

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
// lse: [B, H, L] f32. hd in {32, 64, 128}; scale > 0 (the row maxima are
// taken on the raw scores).
extern "C" int gdl_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int B, int L, int H, int hd, long long in_b,
                                     long long in_h, long long in_row, long long out_b,
                                     long long out_h, long long out_row, float scale,
                                     void* stream) {
  if (!attention_args_ok(B, L, H, hd) || !(scale > 0.f && scale < INFINITY))
    return cudaErrorInvalidValue;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(out), *fl = static_cast<float*>(lse);
  const AttnLayout in{in_b, in_h, in_row}, ol{out_b, out_h, out_row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return tf32fwd::launch_fwd_tf32<32>(fq, fk, fv, fo, fl, in, ol, B, L, H, scale, s);
    case 64: return tf32fwd::launch_fwd_tf32<64>(fq, fk, fv, fo, fl, in, ol, B, L, H, scale, s);
    default: return tf32fwd::launch_fwd_tf32<128>(fq, fk, fv, fo, fl, in, ol, B, L, H, scale, s);
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

// Dynamic shared memory a block of the 3xTF32 forward takes at head dim hd;
// 0 for any other head dim.
extern "C" int gdl_attention_fwd_f32_smem(int hd) {
  switch (hd) {
    case 32: return (int)tf32fwd::Smem<32>::BYTES;
    case 64: return (int)tf32fwd::Smem<64>::BYTES;
    case 128: return (int)tf32fwd::Smem<128>::BYTES;
    default: return 0;
  }
}
