// Device code of the f32 attention backward: the float32 instances of K7
// (packed) and K9 (head-major), reached through gdl_attention_bwd_f32
// (attention_f32.cu), which runs the delta pass and then the two kernels
// below.
//
// Replaces, for float32 inputs, geo_deep_learning_tpu/ops/pallas/mha.py
// :299 _bwd_kernel_packed (K7) and :85 _bwd_kernel (K9): a 32-true DOFA
// runs the Pallas kernels in f32 on a TPU.
//
// Numerics: 3xTF32 products at f32 accuracy (attention_tf32.cuh, which
// also holds the tile plan, the split helpers and the products both f32
// kernels share). The tensor core's round-toward-zero sums were measured
// on the card at dQ 3.5e-5 of its largest value at L = 2026 when every
// stage accumulated into one accumulator; so each stage's dV, dK and dQ
// product goes into a fresh accumulator and is added to the running f32
// rows with round-to-nearest adds (promote).
// p = exp2(s * scale * log2 e - lse * log2 e) and ds = p (dp - delta) stay
// f32 and are split in registers just before they are an A operand; dk and
// dq are scaled after their products; delta = rowsum(g * o) in f32. Rows
// and columns at or past L add nothing and get no gradient written. Every
// output element is written by one thread of one block in a fixed order:
// no atomics, equal run to run, and the packed and head-major entry points
// (the same arithmetic over other strides) agree bit for bit.
//
// Bound on the H100: operations. The function's five products,
// 10 * B * H * L^2 * hd flops, run three times at the 495 TFLOP/s dense
// TF32 rate, plus the softmax's 5 * B * H * L^2 f32 operations at 67
// TFLOP/s: 0.638 ms at DOFA-base 512^2, bs 8 ([8, 1297, 2304], 12 heads,
// hd 64), 1.558 ms at 640^2 ([8, 12, 2026, 64]). The split below runs
// seven products (s and dp again in the dQ kernel).
//
// Design: the FlashAttention-2 split on wgmma m64nNk8 tf32 and TMA.
//   1. delta pass (attention_f32.cu): rowsum(g * o), bound by bytes.
//   2. dK/dV (attention_bwd_dkdv_tf32_kernel): one block per (batch, head,
//      BM-key tile), BM = 64 per consumer warpgroup. Per stage of BN
//      queries: s^T = k q^T, dp^T = v g^T (A = k, v from shared memory,
//      B = q, g K-major as TMA lands them); p^T and ds^T in registers;
//      dV += p^T g and dK += ds^T q with p^T, ds^T as register A operands
//      and B = g^T, q^T.
//   3. dQ (attention_bwd_dq_tf32_kernel): one block per (batch, head,
//      BM-query tile): s = q k^T, dp = g v^T (A = q, g resident), p and
//      ds in registers (keys at or past L masked to p = 0), dQ += ds k
//      with B = k^T.
// For .tf32 wgmma takes no transpose: both shared-memory operands are
// K-major. So g^T, q^T (dK/dV) and k^T (dQ) are written into shared memory
// by threads, and so are the lo copies of every operand. Warpgroup 0 of a
// block is the splitter: its thread 0 issues the TMA loads (the block's
// resident tiles, raw into their hi slots, and the streamed raw tiles
// through a ring of RAW stages), and its 128 threads round the resident
// tiles in place and write their lo copies, then per stage turn the raw
// tiles into the hi, lo, transposed hi and transposed lo tiles the
// consumer warpgroups read, with the stage's lse and delta. One set of
// split tiles in two halves with a pair of mbarriers each: the natural
// tiles, which only a stage's score products (s, dp) read, and the
// transposed ones, which only its dV/dK (dQ) products read. So the
// splitter writes stage t + 1's natural tiles while the consumers run
// stage t's dV/dK, and its transposed tiles while they run stage t + 1's
// score products; lse and delta alternate between two buffers. Both sides
// fence the async proxy (wgmma, TMA) against the generic one (the
// splitter's loads and stores) before they arrive: the splitter after its
// writes, a consumer after the wgmma that read the tiles it releases.
//
// Register A fragments: p^T, ds^T (dK/dV) and ds (dQ) become A operands
// with no shuffle, the k index permuted within groups of 8 in the
// transposed B tiles (tf32_frags).
//
// Tile plan (Cfg): head dims 32 and 64 take two consumer warpgroups
// (BM = 128 keys or queries, 384 threads) and stages of BN = 32 rows; head
// dim 128 one consumer warpgroup (BM = 64, 256 threads) and BN = 16, which
// halves the rows to fit. Shared memory, the binding constraint, at head
// dim 64: four resident 32 KB tiles (k, v hi and lo), eight 8 KB split
// tiles, a raw ring of two stages of two 8 KB tiles: 230,968 bytes with
// lse, delta, barriers and alignment, of the 232,448 a block may have (the
// dQ kernel, six split tiles, 214,584); one block an SM. Its time on the
// card at DOFA-base 512^2: 2.10 ms, 3.3x the bound (H100 80GB HBM3, 700 W).
#pragma once

#include "attention_tf32.cuh"

namespace tf32bwd {

using namespace tf32x3;

constexpr int RAW = 2;  // raw ring depth

// Shared memory of a kernel with NS split tiles, from a 1024-byte aligned
// base: 4 resident tiles (a hi, a lo, b hi, b lo), NS split tiles, RAW
// stages of two raw tiles, lse and delta of two stages, mbarriers.
template <int HD, int NS>
struct Smem {
  using C = Cfg<HD>;
  static constexpr int OFF_SPLIT = 4 * C::RES;
  static constexpr int OFF_RAW = OFF_SPLIT + NS * C::STR;
  static constexpr int OFF_VEC = OFF_RAW + 2 * RAW * C::STR;
  static constexpr int OFF_BAR = OFF_VEC + 4 * C::BN * 4;
  static constexpr size_t BYTES = OFF_BAR + (RAW + 5) * 8 + 1024;  // + base alignment
  static_assert(BYTES <= SMEM_MAX_BYTES, "shared memory plan exceeds a block's 227 KB");
  uint32_t base;
  __device__ explicit Smem(unsigned char* raw) : base((smem_addr(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t res(int i) const { return base + i * C::RES; }
  __device__ uint32_t split(int i) const { return base + OFF_SPLIT + i * C::STR; }
  __device__ uint32_t raw(int stage, int i) const {
    return base + OFF_RAW + (2 * stage + i) * C::STR;
  }
  // lse (i = 0) or delta (1) of stage t, in buffer t % 2
  __device__ uint32_t vec(int t, int i) const {
    return base + OFF_VEC + (2 * (t & 1) + i) * C::BN * 4;
  }
  __device__ uint32_t full(int stage) const { return base + OFF_BAR + stage * 8; }
  __device__ uint32_t resident() const { return base + OFF_BAR + RAW * 8; }
  // the natural-layout split tiles (0-3) filled / released, the
  // transposed ones (4-7) filled / released
  __device__ uint32_t nat_ready() const { return base + OFF_BAR + (RAW + 1) * 8; }
  __device__ uint32_t nat_done() const { return base + OFF_BAR + (RAW + 2) * 8; }
  __device__ uint32_t tr_ready() const { return base + OFF_BAR + (RAW + 3) * 8; }
  __device__ uint32_t tr_done() const { return base + OFF_BAR + (RAW + 4) * 8; }
};

// The resident tiles: raw f32 in the hi slots (0, 2), rounded in place,
// their lo copies into slots 1 and 3. 128 splitter threads.
template <int HD, int NS>
__device__ __forceinline__ void split_resident(const Smem<HD, NS>& sm, int tid) {
  for (int w = 0; w < 2; ++w)
    split_tile<Cfg<HD>::RES>(sm.res(2 * w), sm.res(2 * w), sm.res(2 * w + 1), tid);
}

// One stage's raw tiles a and b ([BN][HD]) into split tiles a hi, a lo,
// b hi, b lo (0-3) in the same layout, and the first NT of them as
// transposed hi and lo (4 + 2 i, 5 + 2 i).
template <int HD, int NS>
__device__ __forceinline__ void split_natural(const Smem<HD, NS>& sm, int stage, int tid) {
  for (int w = 0; w < 2; ++w)
    split_tile<Cfg<HD>::STR>(sm.raw(stage, w), sm.split(2 * w), sm.split(2 * w + 1), tid);
}
template <int HD, int NS, int NT>
__device__ __forceinline__ void split_transposed(const Smem<HD, NS>& sm, int stage, int tid) {
  for (int w = 0; w < NT; ++w)
    tf32x3::split_transposed<HD>(sm.raw(stage, w), sm.split(4 + 2 * w), sm.split(5 + 2 * w), tid);
}

// The splitter warpgroup: the resident tiles' loads and split, the first
// RAW stages' loads, then per stage its split and the next load.
// `stream_a`/`stream_b` are the streamed operands' maps, `res_a`/`res_b`
// the resident ones'; NT transposed pairs; with VEC, the stage's lse *
// log2 e (+inf past L) and delta beside its tiles.
template <int HD, int NS, int NT, bool VEC>
__device__ __forceinline__ void splitter(const Smem<HD, NS>& sm, const CUtensorMap* res_a,
                                         const CUtensorMap* res_b, const CUtensorMap* stream_a,
                                         const CUtensorMap* stream_b, int row0, int h, int b,
                                         int L, int tiles, const float* lse,
                                         const float* delta) {
  using C = Cfg<HD>;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_arrive_tx(sm.resident(), 2 * C::RES);
    tma_rows_f32<HD>(sm.res(0), res_a, C::BM, C::BN, row0, h, b, sm.resident());
    tma_rows_f32<HD>(sm.res(2), res_b, C::BM, C::BN, row0, h, b, sm.resident());
    for (int t = 0; t < RAW && t < tiles; ++t) {
      mbar_arrive_tx(sm.full(t), 2 * C::STR);
      tma_rows_f32<HD>(sm.raw(t, 0), stream_a, C::BN, C::BN, t * C::BN, h, b, sm.full(t));
      tma_rows_f32<HD>(sm.raw(t, 1), stream_b, C::BN, C::BN, t * C::BN, h, b, sm.full(t));
    }
  }
  mbar_wait(sm.resident(), 0);
  split_resident<HD, NS>(sm, tid);
  const long long bh = ((long long)b * gridDim.y + h) * L;
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % RAW;
    mbar_wait(sm.full(stage), (t / RAW) & 1);
    // the natural tiles, once the consumers' score products of stage t - 1
    // are done (they run its dV/dK meanwhile)
    if (t > 0) mbar_wait(sm.nat_done(), (t - 1) & 1);
    split_natural<HD, NS>(sm, stage, tid);
    if (VEC && tid < C::BN) {
      const int q = t * C::BN + tid;
      sts_f32(sm.vec(t, 0) + tid * 4, q < L ? lse[bh + q] * LOG2E : INFINITY);
      sts_f32(sm.vec(t, 1) + tid * 4, q < L ? delta[bh + q] : 0.f);
    }
    fence_proxy_async();
    mbar_arrive(sm.nat_ready());
    // the transposed tiles, once stage t - 1's dV/dK products are done
    // (the consumers run stage t's score products meanwhile)
    if (t > 0) mbar_wait(sm.tr_done(), (t - 1) & 1);
    split_transposed<HD, NS, NT>(sm, stage, tid);
    fence_proxy_async();
    named_sync(1, 128);  // every splitter thread is done reading this raw stage
    if (tid == 0 && t + RAW < tiles) {
      const int q0 = (t + RAW) * C::BN;
      mbar_arrive_tx(sm.full(stage), 2 * C::STR);
      tma_rows_f32<HD>(sm.raw(stage, 0), stream_a, C::BN, C::BN, q0, h, b, sm.full(stage));
      tma_rows_f32<HD>(sm.raw(stage, 1), stream_b, C::BN, C::BN, q0, h, b, sm.full(stage));
    }
    mbar_arrive(sm.tr_ready());
  }
}

template <int HD, int NS>
__device__ __forceinline__ void init_barriers(const Smem<HD, NS>& sm) {
  using C = Cfg<HD>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW; ++s) mbar_init(sm.full(s), 1);
    mbar_init(sm.resident(), 1);
    mbar_init(sm.nat_ready(), 128);
    mbar_init(sm.tr_ready(), 128);
    mbar_init(sm.nat_done(), 128 * C::NCW);
    mbar_init(sm.tr_done(), 128 * C::NCW);
    mbar_init_fence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// dK, dV for one (batch, head, BM-key tile). Split tiles: q hi, q lo, g hi,
// g lo, q^T hi, q^T lo, g^T hi, g^T lo.
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    attention_bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tg,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   float* __restrict__ dk_out, float* __restrict__ dv_out,
                                   AttnLayout in, int L, float scale) {
  using C = Cfg<HD>;
  using S = Smem<HD, 8>;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * C::BM;
  const int tiles = (L + C::BN - 1) / C::BN;
  init_barriers<HD, 8>(sm);
  if (threadIdx.x < 128) {
    splitter<HD, 8, 2, true>(sm, &tk, &tv, &tq, &tg, k0, h, b, L, tiles, lse, delta);
    return;
  }
  const int row0 = (threadIdx.x / 128 - 1) * 64;  // this warpgroup's keys in the tile
  const int c = (threadIdx.x % 4) * 2;
  const float scale_log2 = scale * LOG2E;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    mbar_wait(sm.nat_ready(), t & 1);
    float st[C::BN / 2], dpt[C::BN / 2];
    wg_fence();
    mma3_ss<HD, C::BN>(st, sm.res(0), sm.res(1), C::BM, row0, sm.split(0), sm.split(1));
    wg_commit();
    mma3_ss<HD, C::BN>(dpt, sm.res(2), sm.res(3), C::BM, row0, sm.split(2), sm.split(3));
    wg_commit();
    // p^T (row = key, column = query j of the stage) while dp^T runs
    wg_wait<1>();
    reg_fence(st);
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      const float2 l2 = lds_f32x2(sm.vec(t, 0) + (8 * j + c) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * j + e] = exp2f(st[4 * j + e] * scale_log2 - (e & 1 ? l2.y : l2.x));
    }
    wg_wait<0>();
    reg_fence(dpt);
    fence_proxy_async();  // the score products' reads before the splitter's next writes
    mbar_arrive(sm.nat_done());
    // ds^T = p^T (dp^T - delta)
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
      const float2 d2 = lds_f32x2(sm.vec(t, 1) + (8 * j + c) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x));
    }
    // this stage's dV and dK, each summed alone and then added to its row
    mbar_wait(sm.tr_ready(), t & 1);
    float part[HD / 2];
    {
      uint32_t ph[C::BN / 8][4], pl[C::BN / 8][4];
      tf32_frags<C::BN>(st, ph, pl);
      wg_fence();
      mma3_rs<HD, C::BN / 8>(part, ph, pl, sm.split(6), sm.split(7));
      wg_commit();
      wg_wait<0>();
      reg_fence(part);
      reg_fence(ph);
      reg_fence(pl);
    }
    promote(dv, part);
    {
      uint32_t dh[C::BN / 8][4], dl[C::BN / 8][4];
      tf32_frags<C::BN>(dpt, dh, dl);
      wg_fence();
      mma3_rs<HD, C::BN / 8>(part, dh, dl, sm.split(4), sm.split(5));
      wg_commit();
      wg_wait<0>();
      reg_fence(part);
      reg_fence(dh);
      reg_fence(dl);
    }
    promote(dk, part);
    fence_proxy_async();
    mbar_arrive(sm.tr_done());
  }
  const long long off = in.at(b, h);
  store_rows<HD>(dk, dk_out + off, in.row, k0 + row0, L, {scale, scale});
  store_rows<HD>(dv, dv_out + off, in.row, k0 + row0, L, {1.f, 1.f});
}

// ---------------------------------------------------------------------------
// dQ for one (batch, head, BM-query tile). Split tiles: k hi, k lo, v hi,
// v lo, k^T hi, k^T lo.
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    attention_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tg,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dq_out, AttnLayout in, int L, float scale) {
  using C = Cfg<HD>;
  using S = Smem<HD, 6>;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::BM;
  const int tiles = (L + C::BN - 1) / C::BN;
  init_barriers<HD, 6>(sm);
  if (threadIdx.x < 128) {
    splitter<HD, 6, 1, false>(sm, &tq, &tg, &tk, &tv, q0, h, b, L, tiles, lse, delta);
    return;
  }
  const int row0 = (threadIdx.x / 128 - 1) * 64;  // this warpgroup's queries in the tile
  const int lane = threadIdx.x % 32, c = (lane % 4) * 2;
  const int r = q0 + row0 + (threadIdx.x % 128 / 32) * 16 + lane / 4;  // rows r, r + 8
  const float scale_log2 = scale * LOG2E;
  const long long bh = ((long long)b * gridDim.y + h) * L;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const bool live = r + 8 * u < L;
    row_lse[u] = live ? lse[bh + r + 8 * u] * LOG2E : INFINITY;
    row_delta[u] = live ? delta[bh + r + 8 * u] : 0.f;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    mbar_wait(sm.nat_ready(), t & 1);
    float s[C::BN / 2], dp[C::BN / 2];
    wg_fence();
    mma3_ss<HD, C::BN>(s, sm.res(0), sm.res(1), C::BM, row0, sm.split(0), sm.split(1));
    wg_commit();
    mma3_ss<HD, C::BN>(dp, sm.res(2), sm.res(3), C::BM, row0, sm.split(2), sm.split(3));
    wg_commit();
    // p: row = query, column = key j of the stage; keys at or past L masked
    wg_wait<1>();
    reg_fence(s);
    const int kc = t * C::BN + c;
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = kc + 8 * j + (e & 1) < L
                           ? exp2f(s[4 * j + e] * scale_log2 - row_lse[e >> 1])
                           : 0.f;
    wg_wait<0>();
    reg_fence(dp);
    fence_proxy_async();
    mbar_arrive(sm.nat_done());
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - row_delta[e >> 1]);
    uint32_t dh[C::BN / 8][4], dl[C::BN / 8][4];
    tf32_frags<C::BN>(dp, dh, dl);
    mbar_wait(sm.tr_ready(), t & 1);
    float part[HD / 2];
    wg_fence();
    mma3_rs<HD, C::BN / 8>(part, dh, dl, sm.split(4), sm.split(5));
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
    reg_fence(dh);
    reg_fence(dl);
    promote(dq, part);
    fence_proxy_async();
    mbar_arrive(sm.tr_done());
  }
  store_rows<HD>(dq, dq_out + in.at(b, h), in.row, q0 + row0, L, {scale, scale});
}

// ---------------------------------------------------------------------------
// Host side

// The two kernels after the delta pass: q, k, v, dq, dk, dv with layout
// `in`, g with `gl`.
template <int HD>
int launch_bwd_tf32(const float* q, const float* k, const float* v, const float* g,
                    const float* lse, const float* delta, float* dq, float* dk, float* dv,
                    AttnLayout in, AttnLayout gl, int B, int L, int H, float scale,
                    cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr size_t smem_kv = Smem<HD, 8>::BYTES, smem_q = Smem<HD, 6>::BYTES;
  static bool ready_kv = false, ready_q = false;
  if (cudaError_t e = allow_smem(attention_bwd_dkdv_tf32_kernel<HD>, smem_kv, ready_kv)) return e;
  if (cudaError_t e = allow_smem(attention_bwd_dq_tf32_kernel<HD>, smem_q, ready_q)) return e;
  CUtensorMap tq, tk, tv, tg;
  if (tma_encoder() == nullptr) return cudaErrorNotSupported;
  if (!encode_rows_f32<HD>(&tq, q, in, B, L, H) || !encode_rows_f32<HD>(&tk, k, in, B, L, H) ||
      !encode_rows_f32<HD>(&tv, v, in, B, L, H) || !encode_rows_f32<HD>(&tg, g, gl, B, L, H))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((L + C::BM - 1) / C::BM), (unsigned)H, (unsigned)B);
  attention_bwd_dkdv_tf32_kernel<HD>
      <<<grid, C::THREADS, smem_kv, stream>>>(tq, tk, tv, tg, lse, delta, dk, dv, in, L, scale);
  if (cudaError_t e = cudaGetLastError()) return e;
  attention_bwd_dq_tf32_kernel<HD>
      <<<grid, C::THREADS, smem_q, stream>>>(tq, tk, tv, tg, lse, delta, dq, in, L, scale);
  return cudaGetLastError();
}

}  // namespace tf32bwd
