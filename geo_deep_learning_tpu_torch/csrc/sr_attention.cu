// K10: spatial-reduction attention forward, o = softmax(q k^T * scale) v.
//
// Replaces geo_deep_learning_tpu/ops/pallas/sr_attention.py::_attn_kernel
// (via _pallas_attention). q is [B, H, Lq, D], k and v are [B, H, Lk, D],
// read through their strides (the last dimension contiguous), so the
// port's q, k and v come straight out of their projections' [B, L, H, D]
// outputs without a transpose. o has the same shape, written through its
// own strides. Inputs are bf16 or f32; every product, the softmax and the
// PV sum run in f32 (p is never rounded to the input dtype), and o is
// written in the input dtype, as the TPU kernel does.
//
// Bound on the H100: operations. At MiT-b0 stage 1, 512^2, bs 8 (q
// [8,1,16384,32], k/v [8,1,256,32]) the call moves ~17 MB (5 us at
// 3.35 TB/s) and does 2*B*H*Lq*Lk*D = 2.1 GFLOP of q.k^T and as much of
// p.v. The card's fastest route at f32 accuracy runs both on bf16 tensor
// cores, p.v as two passes with p split into bf16 hi + lo halves (6.5 us
// at 989 TFLOP/s), plus the softmax's exp work at the f32 rate (2.5 us):
// ~9 us. This kernel runs both products as f32 FMAs instead, whose
// 4.3 GFLOP alone take 64 us at the 67 TFLOP/s f32 rate.
//
// Design: the TPU kernel holds one head's whole K/V and a 512-row score
// tile in VMEM and normalizes the row before p.v. Here one thread owns one
// q row: its q values, its f32 output accumulator and its softmax state
// live in registers, and a block of 128 threads (128 consecutive q rows of
// one (batch, head)) streams K/V through shared memory in 32-row f32 tiles
// with an online softmax, so any Lk runs; rows past Lk are zero-filled and
// masked to -inf. Every K/V value a warp reads from shared memory is a
// broadcast, so the two products run as plain f32 FMAs without bank
// conflicts. The result differs from the TPU kernel's normalize-first order
// by f32 rounding only. Simple and right first: no tensor cores, no
// cp.async/TMA pipelining yet.
#include "common.cuh"

constexpr int SR_BQ = 128;  // q rows per block, one per thread
constexpr int SR_BK = 32;   // K/V rows per shared-memory tile

struct SrStrides {
  long long b, h, l;  // elements; the last dimension is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(SR_BQ)
sr_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H, int Lq, int Lk,
                        SrStrides qs, SrStrides ks, SrStrides vs, SrStrides os, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = D / VEC;         // vectors per row
  __shared__ __align__(16) float sK[SR_BK][D];
  __shared__ __align__(16) float sV[SR_BK][D];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * SR_BQ + tid;
  const bool live = row < Lq;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  float qr[D];
  if (live) {
    const T* qrow = q + b * qs.b + h * qs.h + (long long)row * qs.l;
#pragma unroll
    for (int i = 0; i < VPR; ++i) load_vec<T>(qrow + i * VEC, qr + i * VEC);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += SR_BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < 2 * SR_BK * VPR; i += SR_BQ) {
      const int which = i / (SR_BK * VPR);  // 0: K, 1: V
      const int r = (i / VPR) % SR_BK, c = (i % VPR) * VEC;
      float tmp[VEC];
      if (k0 + r < Lk) {
        load_vec<T>(which ? vb + (long long)(k0 + r) * vs.l + c
                          : kb + (long long)(k0 + r) * ks.l + c, tmp);
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) tmp[u] = 0.f;
      }
      float* dst = which ? &sV[r][c] : &sK[r][c];
#pragma unroll
      for (int u = 0; u < VEC; u += 4)
        *reinterpret_cast<float4*>(dst + u) = make_float4(tmp[u], tmp[u + 1], tmp[u + 2], tmp[u + 3]);
    }
    __syncthreads();

    const int n = min(SR_BK, Lk - k0);
    float s[SR_BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < SR_BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&sK[j][d]);
        dot = fmaf(qr[d], kv.x, dot);
        dot = fmaf(qr[d + 1], kv.y, dot);
        dot = fmaf(qr[d + 2], kv.z, dot);
        dot = fmaf(qr[d + 3], kv.w, dot);
      }
      s[j] = j < n ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);   // finite: the tile holds a row < Lk
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < SR_BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&sV[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    T* orow = o + b * os.b + h * os.h + (long long)row * os.l;
#pragma unroll
    for (int i = 0; i < VPR; ++i) {
      float t[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) t[u] = acc[i * VEC + u] / l;
      store_vec<T>(orow + i * VEC, t);
    }
  }
}

template <typename T, int D>
static int launch_sr_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Lq, int Lk, SrStrides qs, SrStrides ks, SrStrides vs,
                               SrStrides os, float scale, cudaStream_t stream) {
  dim3 grid((unsigned)((Lq + SR_BQ - 1) / SR_BQ), (unsigned)(B * H));
  sr_attention_fwd_kernel<T, D><<<grid, SR_BQ, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Lq, Lk, qs, ks, vs, os, scale);
  return (int)cudaGetLastError();
}

// q [B,H,Lq,D], k/v [B,H,Lk,D], o [B,H,Lq,D], each given by (batch, head,
// row) strides in elements with a contiguous last dimension; every row
// start 16-byte aligned. D in {32, 64}; is_bf16 selects bf16 over f32.
extern "C" int gdl_sr_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Lq, int Lk, int D, int is_bf16,
                                    long long qsb, long long qsh, long long qsl,
                                    long long ksb, long long ksh, long long ksl,
                                    long long vsb, long long vsh, long long vsl,
                                    long long osb, long long osh, long long osl,
                                    float scale, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 65535 || Lq < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  const SrStrides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl}, os{osb, osh, osl};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    switch (D) {
      case 32: return launch_sr_attention<bf16, 32>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
      case 64: return launch_sr_attention<bf16, 64>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 32: return launch_sr_attention<float, 32>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
    case 64: return launch_sr_attention<float, 64>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
