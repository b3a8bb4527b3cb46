// Device code of the f32 attention forward: the float32 instances of K4
// (packed) and K8 (head-major), reached through gdl_attention_fwd_f32
// (attention_f32.cu).
//
// Replaces, for float32 inputs, geo_deep_learning_tpu/ops/pallas/mha.py
// :255 _fwd_kernel_packed (K4) and :56 _fwd_kernel (K8): a 32-true DOFA
// runs the Pallas kernels in f32 on a TPU. On f32 inputs they compute s =
// q k^T scale, m = rowmax(s), p = exp(s - m) in f32, o = (p v) / sum(p) and
// lse = m + log sum(p).
//
// Numerics: both products as 3xTF32 on wgmma m64nNk8 (attention_tf32.cuh),
// f32 accuracy, not TF32's 1e-3. q k^T is summed in groups of two k8
// slices (16 columns of the head dim), each group's three passes into a
// fresh accumulator, and the groups added in order with round-to-nearest
// f32 adds. At inputs x 4 (|lse| near 90) the plain f32 version's lse is
// itself 1.9e-5 to 3.8e-5 from the exact value; in a CPU model of the
// tensor core's truncating sums (tools/tf32_sum_model.py) one accumulator
// over the whole head dim put lse up to 7.5e-5 from it, the groups 0.8e-5
// to 2.2e-5. The
// softmax runs online over stages of BN keys in f32 registers, in the exp2
// domain: m in log2 units, p = exp2(fma(s, scale log2 e, -m)), alpha =
// exp2(m_old - m), l = l alpha + rowsum(p) (a thread's partial sums,
// added over the four lanes of a row at the end). exp2 is ex2.approx.ftz,
// as in the bf16 kernels (exp2f in its place ran the kernel 3-4.5 % slower
// in an A/B on an H100, chip_ab.py). p is split into its hi
// and lo A fragments in registers; each stage's p v goes into a fresh
// accumulator and is added to the running rows as o = fma(o, alpha, part)
// (promote with the rescale folded in). o (1 / l) and lse = m ln 2 +
// log(l) are written at the end. Keys at or past L are masked to -inf in
// the last stage only; rows past L load as zeros and store nothing. Every
// output is written by one thread of one block in a fixed order: equal run
// to run, and the packed and head-major entry points (the same arithmetic
// over other strides) agree bit for bit.
//
// Bound on the H100: operations. The two products, 4 * B * H * L^2 * hd
// flops, run three times at the 495 TFLOP/s dense TF32 rate, plus the
// softmax's 5 * B * H * L^2 f32 operations at 67 TFLOP/s: 0.263 ms at
// DOFA-base 512^2, bs 8 ([8, 1297, 2304], 12 heads, hd 64), 0.641 ms at
// 640^2 ([8, 12, 2026, 64]).
//
// Design: the backward's plan (Cfg). One block per (batch, head, BM-query
// tile): a splitter warpgroup and NCW consumer warpgroups of 64 query rows
// each. Thread 0 of the splitter issues the TMA loads: the block's q tile,
// raw into its hi slot, once, and each stage's raw k and v tiles through
// a ring of RAW stages. Its 128 threads round q in place and write its lo
// copy, then per stage write k's hi and lo tiles (natural, as q k^T reads
// k K-major) and v's transposed hi and lo tiles ([HD][BN], k permuted
// within groups of 8, so that s's accumulator registers are p's A
// fragments with no shuffle), every load of a stage issued before its
// first store (the splitter's four warps are bound by the latency of their
// loads: against splitting k, then v, a unit at a time, the forward ran
// 8-9 % faster in an A/B on an H100, chip_ab.py). The split tiles are a ring of SPL stages with a pair of
// mbarriers each (filled, released), so the splitter runs up to SPL stages
// ahead. Both sides fence the async proxy (wgmma, TMA) against the generic
// one before they arrive. Per stage a
// consumer warpgroup runs q k^T (A = q hi / lo, B = k hi / lo from shared
// memory), the softmax, then p v (A = p from registers, B = v^T).
// Shared memory at head dim 64: q hi and lo (2 x 32 KB), SPL = 2 split
// stages of four 8 KB tiles, RAW = 3 raw stages of two 8 KB tiles: 181,312
// bytes with barriers and alignment; one block an SM. Its time on the card
// at DOFA-base 512^2: 0.63 ms, 2.4x the bound, against SDPA's f32 forward
// 1.39 ms (H100 80GB HBM3, 700 W). Each m64n32k8 instruction of q k^T
// reads 3 KB of shared memory for 16 cycles of tensor-core work, more than
// the 128 bytes a cycle shared memory serves: wider stages (N = 64) would
// halve q's reads a key, but need registers the grouped sums now hold.
//
// What this does about the first design it replaces (f32 FMAs: 256 threads
// owning a 64 x 64 score tile, tiles loaded synchronously between barriers,
// eight shared-memory loads for every 16 FMAs, p through a shared tile):
// the products on the tensor cores, TMA and the splitter keeping the next
// stages ready, p in registers.
#pragma once

#include "attention_tf32.cuh"

namespace tf32fwd {

using namespace tf32x3;

constexpr int RAW = 3;  // raw ring depth (a stage's k and v tiles)
constexpr int SPL = 2;  // split stages in flight

// Shared memory from a 1024-byte aligned base: q hi and lo, SPL split
// stages of four tiles (k hi, k lo, v^T hi, v^T lo), RAW raw stages of two
// tiles (k, v), mbarriers.
template <int HD>
struct Smem {
  using C = Cfg<HD>;
  static constexpr int OFF_SPLIT = 2 * C::RES;
  static constexpr int OFF_RAW = OFF_SPLIT + SPL * 4 * C::STR;
  static constexpr int OFF_BAR = OFF_RAW + RAW * 2 * C::STR;
  static constexpr size_t BYTES = OFF_BAR + (RAW + 1 + 2 * SPL) * 8 + 1024;  // + base alignment
  static_assert(BYTES <= SMEM_MAX_BYTES, "shared memory plan exceeds a block's 227 KB");
  uint32_t base;
  __device__ explicit Smem(unsigned char* raw) : base((smem_addr(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t res(int i) const { return base + i * C::RES; }
  __device__ uint32_t split(int slot, int i) const {
    return base + OFF_SPLIT + (4 * slot + i) * C::STR;
  }
  __device__ uint32_t raw(int stage, int i) const {
    return base + OFF_RAW + (2 * stage + i) * C::STR;
  }
  __device__ uint32_t full(int stage) const { return base + OFF_BAR + stage * 8; }
  __device__ uint32_t resident() const { return base + OFF_BAR + RAW * 8; }
  // a split slot filled / released
  __device__ uint32_t ready(int slot) const { return base + OFF_BAR + (RAW + 1 + slot) * 8; }
  __device__ uint32_t done(int slot) const { return base + OFF_BAR + (RAW + 1 + SPL + slot) * 8; }
};

// The splitter warpgroup: q's load and split, then per stage t (slot t %
// SPL, once the consumers have released stage t - SPL) the split of its k
// and v, and the load of stage t + RAW into the raw stage it frees.
template <int HD>
__device__ __forceinline__ void splitter(const Smem<HD>& sm, const CUtensorMap* tq,
                                         const CUtensorMap* tk, const CUtensorMap* tv, int q0,
                                         int h, int b, int tiles) {
  using C = Cfg<HD>;
  const int tid = threadIdx.x;
  const auto load = [&](int t) {
    const int stage = t % RAW;
    mbar_arrive_tx(sm.full(stage), 2 * C::STR);
    tma_rows_f32<HD>(sm.raw(stage, 0), tk, C::BN, C::BN, t * C::BN, h, b, sm.full(stage));
    tma_rows_f32<HD>(sm.raw(stage, 1), tv, C::BN, C::BN, t * C::BN, h, b, sm.full(stage));
  };
  if (tid == 0) {
    mbar_arrive_tx(sm.resident(), C::RES);
    tma_rows_f32<HD>(sm.res(0), tq, C::BM, C::BN, q0, h, b, sm.resident());
    for (int t = 0; t < RAW && t < tiles; ++t) load(t);
  }
  mbar_wait(sm.resident(), 0);
  split_tile<C::RES>(sm.res(0), sm.res(0), sm.res(1), tid);  // ready with stage 0's k
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % RAW, slot = t % SPL;
    mbar_wait(sm.full(stage), (t / RAW) & 1);
    float4 kx[Natural<C::STR>::N], vx[Transposed<HD>::N];
    Natural<C::STR>::load(kx, sm.raw(stage, 0), tid);
    Transposed<HD>::load(vx, sm.raw(stage, 1), tid);
    if (t >= SPL) mbar_wait(sm.done(slot), (t / SPL - 1) & 1);  // stage t - SPL's release
    Natural<C::STR>::store(kx, sm.split(slot, 0), sm.split(slot, 1), tid);
    Transposed<HD>::store(vx, sm.split(slot, 2), sm.split(slot, 3), tid);
    fence_proxy_async();
    mbar_arrive(sm.ready(slot));
    named_sync(1, 128);  // every splitter thread is done reading this raw stage
    if (tid == 0 && t + RAW < tiles) load(t + RAW);
  }
}

// o and lse for one (batch, head, BM-query tile).
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    attention_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, float* __restrict__ out,
                              float* __restrict__ lse, AttnLayout ol, int L, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int G = HD / 16;  // groups of two k8 slices in q k^T
  extern __shared__ unsigned char smem_raw[];
  const Smem<HD> sm(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::BM;
  const int tiles = (L + C::BN - 1) / C::BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW; ++s) mbar_init(sm.full(s), 1);
    mbar_init(sm.resident(), 1);
    for (int slot = 0; slot < SPL; ++slot) {
      mbar_init(sm.ready(slot), 128);
      mbar_init(sm.done(slot), 128 * C::NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    splitter<HD>(sm, &tq, &tk, &tv, q0, h, b, tiles);
    return;
  }
  const int row0 = (threadIdx.x / 128 - 1) * 64;  // this warpgroup's queries in the tile
  const int lane = threadIdx.x % 32, c = (lane % 4) * 2;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    const int slot = t % SPL;
    const uint32_t phase = (t / SPL) & 1;
    mbar_wait(sm.ready(slot), phase);
    // s = q k^T: row = query, column = key j of the stage
    float s[C::BN / 2];
    {
      float sg[G][C::BN / 2];
      wg_fence();
#pragma unroll
      for (int g = 0; g < G; ++g)
        mma3_ss<HD, C::BN, 2>(sg[g], sm.res(0), sm.res(1), C::BM, row0, sm.split(slot, 0),
                              sm.split(slot, 1), 2 * g);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int g = 0; g < G; ++g) reg_fence(sg[g]);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {
        s[i] = sg[0][i];
#pragma unroll
        for (int g = 1; g < G; ++g) s[i] += sg[g][i];
      }
    }
    if (t == tiles - 1) {  // keys at or past L
      const int kc = t * C::BN + c;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kc + 8 * j + (e & 1) >= L) s[4 * j + e] = -INFINITY;
    }
    // the rows' new maxima (scale > 0: the max of the raw scores), p in s
    float alpha[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * u], s[4 * j + 2 * u + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[u], mx * scale_log2);  // finite: a key < L
      alpha[u] = exp2_approx(m[u] - m_new);
      m[u] = m_new;
      l[u] *= alpha[u];
    }
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) {
      s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
    // this stage's p v, summed alone, then o = o alpha + part
    uint32_t ph[C::BN / 8][4], pl[C::BN / 8][4];
    tf32_frags<C::BN>(s, ph, pl);
    float part[HD / 2];
    wg_fence();
    mma3_rs<HD, C::BN / 8>(part, ph, pl, sm.split(slot, 2), sm.split(slot, 3));
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
    reg_fence(ph);
    reg_fence(pl);
    fence_proxy_async();  // this stage's wgmma reads before the splitter's next writes
    mbar_arrive(sm.done(slot));
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], part[i]);
  }
  float inv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    inv[u] = 1.f / l[u];
  }
  store_rows<HD>(o, out + ol.at(b, h), ol.row, q0 + row0, L, inv);
  const int r = q0 + row0 + (threadIdx.x % 128 / 32) * 16 + lane / 4;  // rows r, r + 8
  const long long bh = ((long long)b * gridDim.y + h) * L;
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (c == 0 && r + 8 * u < L) lse[bh + r + 8 * u] = m[u] * LN2 + logf(l[u]);
}

// ---------------------------------------------------------------------------
// Host side

// q, k, v with layout `in`, o with `ol`; lse [B, H, L]. scale > 0.
template <int HD>
int launch_fwd_tf32(const float* q, const float* k, const float* v, float* o, float* lse,
                    AttnLayout in, AttnLayout ol, int B, int L, int H, float scale,
                    cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr size_t smem = Smem<HD>::BYTES;
  static bool ready = false;
  if (cudaError_t e = allow_smem(attention_fwd_tf32_kernel<HD>, smem, ready)) return e;
  CUtensorMap tq, tk, tv;
  if (tma_encoder() == nullptr) return cudaErrorNotSupported;
  if (!encode_rows_f32<HD>(&tq, q, in, B, L, H) || !encode_rows_f32<HD>(&tk, k, in, B, L, H) ||
      !encode_rows_f32<HD>(&tv, v, in, B, L, H))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((L + C::BM - 1) / C::BM), (unsigned)H, (unsigned)B);
  attention_fwd_tf32_kernel<HD>
      <<<grid, C::THREADS, smem, stream>>>(tq, tk, tv, o, lse, ol, L, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tf32fwd
