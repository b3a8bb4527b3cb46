// Device code of the attention backward, shared by the packed K7
// (attention_bwd.cu) and the head-major K9 (attention_hm_bwd.cu). The PTX
// building blocks (mbarriers, TMA, wgmma) are hopper.cuh's, shared with
// K10 and K11.
//
// Replaces geo_deep_learning_tpu/ops/pallas/mha.py:85 _bwd_kernel (K9) and
// :299 _bwd_kernel_packed (K7), with their numerics: bf16 products with
// f32 accumulation; p = exp(s * scale - lse) in f32, cast to bf16 before
// dV += p^T g; delta = rowsum(g * o) in f32; ds = p * (g v^T - delta), cast
// to bf16 before dq = ds k and dk = ds^T q; dq and dk scaled after their
// products; rows and columns at or past L add nothing and get no gradient
// written. Every output element is written by one thread of one block in a
// fixed order: no atomics, equal run to run.
//
// Bound on the H100: operations. The function needs five products of
// 2 * L^2 * hd flops per (batch, head): 10 * B * H * L^2 * hd, 252 GFLOP at
// [8, 12, 2026, 64] (0.25 ms at the 989 TFLOP/s bf16 peak) against 8 bf16
// [B, H, L, hd] tensors of traffic (0.06 ms at 3.35 TB/s); the f32
// softmax work, 5 * B * H * L^2, adds ~0.03 ms. The split below runs seven
// products, recomputing s and dp in the dQ kernel.
//
// Design: the FlashAttention-2 split on Hopper's wgmma and TMA.
//   1. delta pass (attention_bwd_delta_kernel): rowsum(g * o), bound by
//      bytes, microseconds.
//   2. dK/dV (attention_bwd_dkdv_wgmma_kernel): one block of 384 threads
//      per (batch, head, 128-key tile). Warpgroup 0 is the producer: one
//      lane issues TMA loads (K and V of the tile once, then the q-side
//      tiles q and g through a ring of STAGES stages, each held by a full
//      and an empty mbarrier) and its warp's lanes put the stage's lse
//      (times log2 e; +inf past L, so those rows add nothing) and delta
//      beside them. Warpgroups 1 and 2 are consumers of 64 key rows each
//      (wgmma's M). Per stage, from shared memory: s^T = k q^T and
//      dp^T = v g^T (m64nBNk16, both operands K-major); in registers:
//      p^T = exp2(s^T * scale * log2 e - lse * log2 e), converted to bf16
//      in registers and used directly as the register-sourced A operand of
//      dV += p^T g (the f32 accumulator layout of an m64n16 tile is the A
//      fragment layout of an m64k16 one); ds^T = p^T (dp^T - delta) the same
//      way into dK += ds^T q. g and q enter those two as the B operand
//      MN-major (wgmma's transpose bit). No score-sized tile touches shared
//      memory.
//   3. dQ (attention_bwd_dq_wgmma_kernel): one block per (batch, head,
//      128-query tile); q and g of the tile stay in shared memory, lse and
//      delta of a thread's two rows in registers, and K/V tiles stream
//      through the ring: s = q k^T, dp = g v^T (shared memory), p and ds in
//      registers (columns at or past L masked to p = 0: a zero-filled key
//      row would give p = exp(-lse)), dQ += ds k (k MN-major). Recomputing s
//      and dp here (1.4x the function's tensor work) buys a deterministic dQ
//      with no atomics, no f32 scratch and no ordering semaphores.
//   4. Epilogue: dk * scale, dv and dq * scale as bf16 straight from the
//      accumulator registers into the caller's strided views (two adjacent
//      columns a store), rows below L only.
// Registers: the producer gives its registers up (setmaxnreg 40) so each
// consumer thread may hold 232: at head dim 64 the dK and dV accumulators
// take 64, s^T and dp^T 64 more, the bf16 fragments of p^T and ds^T 32.
//
// What this does about the first design it replaces (nvcuda::wmma, as the
// forward also was until it too moved to wgmma): products on wgmma in place of 16x16x16
// mma.sync fragments reloaded from shared memory per product; score tiles
// kept in registers in place of two trips through shared memory (f32
// staging, then bf16 operand); TMA loads into a ring of STAGES stages
// overlapped with the products in place of a synchronous copy between two
// __syncthreads(); blocks of 2 x 64 rows and 8 consumer warps with 232
// registers a thread in place of 4 warps of 16 rows.
//
// Operands are TMA'd from 4-D tensor maps (hd, L, H, B) with the layouts'
// byte strides (multiples of 16, which AttnLayout requires), so rows past L
// load as zeros and no box crosses into the next batch's rows. A box is
// BOX_C columns wide, the swizzle span: 64 bf16 under the 128-byte swizzle
// (head dim 128 loads as two boxes), 32 under the 64-byte one (head dim 32).
//
// Tile plan (BwdCfg): blocks of 384 threads own 128 rows (two consumer
// warpgroups of 64); streamed tiles are 64 rows (32 at head dim 128, where
// the dK and dV accumulators alone take 128 registers); the ring holds 3
// stages. Dynamic shared memory per block: 43,576 bytes at head dim 32,
// 84,536 at 64 (two resident 16 KB tiles, 48 KB of ring, lse and delta,
// barriers, 1 KB of alignment), 116,536 at 128; one block an SM, which the
// registers force anyway. ptxas (-Xptxas -v, printed by chip_smoke.py's
// build phase; CUDA 12.9, sm_90a): both kernels 168 registers a thread at
// launch (setmaxnreg moves them to 40 / 232), no stack and no spills at head
// dims 32 and 64; the dK/dV kernel at head dim 128 spills 80 bytes.
#pragma once

#include "attention_layout.cuh"
#include "hopper.cuh"

constexpr float BWD_LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdCfg {
  static constexpr int BM = 128;                   // rows a block owns: 2 consumer warpgroups x 64
  static constexpr int BN = HD == 128 ? 32 : 64;   // rows of a streamed tile (registers at hd 128)
  static constexpr int STAGES = 3;                 // ring depth
  static constexpr int THREADS = 384;              // producer warpgroup + 2 consumer warpgroups
  static constexpr int BOX_C = Span<HD>::BOX_C;   // columns of a TMA box = the swizzle span
  static constexpr int NCH = Span<HD>::NCH;       // column chunks of a row
  static constexpr int RB = Span<HD>::RB;         // bytes of a chunk's row
  static constexpr int RES = BM * HD * 2;          // bytes of a resident [BM][HD] tile
  static constexpr int STR = BN * HD * 2;          // bytes of a streamed [BN][HD] tile
  static constexpr int PRODUCER_REGS = 40;   // setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168
  static constexpr int CONSUMER_REGS = 232;
  // smem: two resident tiles, then per stage two streamed tiles (and, in
  // the dK/dV kernel, lse and delta of the stage's rows), then mbarriers
  static constexpr int OFF_STAGE = 2 * RES;
  static constexpr int OFF_VEC = OFF_STAGE + STAGES * 2 * STR;
  static constexpr int OFF_BAR = OFF_VEC + STAGES * 2 * BN * 4;
  static constexpr size_t SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + base alignment
};

// Write a warpgroup's [64 x HD] accumulator, times `scale`, as bf16 rows
// row0 + (0..63) of a row view with stride `ld`, rows below L only. A
// thread holds rows r and r + 8 of its warp's 16 at columns 8 j + c, c + 1.
template <int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2], bf16* dst, long long ld,
                                          int row0, int L, float scale) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = row0 + (t / 32) * 16 + lane / 4, c = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      if (row < L)
        *reinterpret_cast<uint32_t*>(dst + (long long)row * ld + 8 * j + c) =
            pack_bf16(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
    }
}

// ---------------------------------------------------------------------------
// 1. delta[(b * H + h) * L + l] = sum_j g[b, h, l, j] * o[b, h, l, j]: HD / 8
// lanes (one 16-byte vector each) per (b, h, l) row, 32 / (HD / 8) rows a warp.
template <int HD>
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g,
                           float* __restrict__ delta, AttnLayout ol, AttnLayout gl, int B,
                           int L, int H) {
  constexpr int GROUP = HD / 8;
  constexpr int ROWS = 32 / GROUP;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const long long row = warp * ROWS + lane / GROUP;
  const int c = lane % GROUP;
  const bool in = row < (long long)B * H * L;
  float t = 0.f;
  if (in) {
    const int l = (int)(row % L);
    const long long bh = row / L;
    const int h = (int)(bh % H), b = (int)(bh / H);
    float ov[8], gv[8];
    load_vec<bf16>(o + ol.at(b, h) + (long long)l * ol.row + c * 8, ov);
    load_vec<bf16>(g + gl.at(b, h) + (long long)l * gl.row + c * 8, gv);
#pragma unroll
    for (int u = 0; u < 8; ++u) t += gv[u] * ov[u];
  }
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  if (in && c == 0) delta[row] = t;
}

// Shared memory of the two wgmma kernels, from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 1024 bytes).
template <int HD>
struct BwdSmem {
  using C = BwdCfg<HD>;
  uint32_t base;
  __device__ explicit BwdSmem(unsigned char* raw)
      : base((smem_addr(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t res(int i) const { return base + i * C::RES; }
  __device__ uint32_t str(int stage, int i) const {
    return base + C::OFF_STAGE + (stage * 2 + i) * C::STR;
  }
  __device__ uint32_t vec(int stage, int i) const {  // lse (0) or delta (1) of a stage
    return base + C::OFF_VEC + (stage * 2 + i) * C::BN * 4;
  }
  __device__ uint32_t full(int stage) const { return base + C::OFF_BAR + stage * 8; }
  __device__ uint32_t empty(int stage) const { return base + C::OFF_BAR + (C::STAGES + stage) * 8; }
  __device__ uint32_t resident() const { return base + C::OFF_BAR + 2 * C::STAGES * 8; }
};

// ---------------------------------------------------------------------------
// 2. dK, dV for one (batch, head, 128-key tile).
template <int HD>
__global__ void __launch_bounds__(384, 1)
attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tg,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                                AttnLayout in, int L, int H, float scale) {
  using C = BwdCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<HD> sm(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * C::BM;
  const int tiles = (L + C::BN - 1) / C::BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(sm.full(s), 32);   // the producer warp's lanes (lane 0 with the TMA bytes)
      mbar_init(sm.empty(s), 256); // every consumer thread
    }
    mbar_init(sm.resident(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_arrive_tx(sm.resident(), 2 * C::RES);
        tma_rows<HD>(sm.res(0), &tk, C::BM, C::BN, k0, h, b, sm.resident());
        tma_rows<HD>(sm.res(1), &tv, C::BM, C::BN, k0, h, b, sm.resident());
      }
      const long long bh = ((long long)b * H + h) * L;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(sm.empty(stage), phase ^ 1);
        const int q0 = t * C::BN;
        for (int i = lane; i < C::BN; i += 32) {
          const bool in_l = q0 + i < L;
          sts_f32(sm.vec(stage, 0) + i * 4, in_l ? lse[bh + q0 + i] * BWD_LOG2E : INFINITY);
          sts_f32(sm.vec(stage, 1) + i * 4, in_l ? delta[bh + q0 + i] : 0.f);
        }
        if (lane == 0) {
          mbar_arrive_tx(sm.full(stage), 2 * C::STR);
          tma_rows<HD>(sm.str(stage, 0), &tq, C::BN, C::BN, q0, h, b, sm.full(stage));
          tma_rows<HD>(sm.str(stage, 1), &tg, C::BN, C::BN, q0, h, b, sm.full(stage));
        } else {
          mbar_arrive(sm.full(stage));
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int row0 = (wg - 1) * 64;  // this warpgroup's key rows in the block's tile
    const int lane = threadIdx.x % 32, c = (lane % 4) * 2;
    const float scale_log2 = scale * BWD_LOG2E;
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint64_t ak = desc_k<HD>(sm.res(0), row0), av = desc_k<HD>(sm.res(1), row0);
    mbar_wait(sm.resident(), 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(sm.full(stage), phase);
      const uint32_t sq = sm.str(stage, 0), sg = sm.str(stage, 1);
      float st[C::BN / 2], dpt[C::BN / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<C::BN>(st, ak + k_step<HD>(C::BM, kk), desc_k<HD>(sq, 0) + k_step<HD>(C::BN, kk),
                        kk);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<C::BN>(dpt, av + k_step<HD>(C::BM, kk), desc_k<HD>(sg, 0) + k_step<HD>(C::BN, kk),
                        kk);
      wg_commit();

      // p^T (row = key, column = query j of the stage), while dp^T runs
      wg_wait<1>();
      reg_fence(st);
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j) {
        const float2 l2 = lds_f32x2(sm.vec(stage, 0) + (8 * j + c) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] = exp2_approx(st[4 * j + e] * scale_log2 - (e & 1 ? l2.y : l2.x));
      }
      // ds^T = p^T (dp^T - delta); both to bf16 A fragments, 16 columns at a
      // time, so the f32 tiles die as the fragments fill
      wg_wait<0>();
      reg_fence(dpt);
      uint32_t pa[C::BN / 16][4], da[C::BN / 16][4];
#pragma unroll
      for (int sl = 0; sl < C::BN / 16; ++sl) {
        float ds[8];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * sl + half;
          const float2 d2 = lds_f32x2(sm.vec(stage, 1) + (8 * j + c) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[4 * half + e] = st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pa[sl][u] = pack_bf16(st[8 * sl + 2 * u], st[8 * sl + 2 * u + 1]);
          da[sl][u] = pack_bf16(ds[2 * u], ds[2 * u + 1]);
        }
      }
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < C::BN / 16; ++ks)
        wgmma_rs<HD>(dv, pa[ks], desc_mn<HD>(sg, C::BN) + mn_step<HD>(ks), 1);
#pragma unroll
      for (int ks = 0; ks < C::BN / 16; ++ks)
        wgmma_rs<HD>(dk, da[ks], desc_mn<HD>(sq, C::BN) + mn_step<HD>(ks), 1);
      wg_commit();
      wg_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
      mbar_arrive(sm.empty(stage));
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    const long long off = in.at(b, h);
    store_acc<HD>(dk, dk_out + off, in.row, k0 + row0, L, scale);
    store_acc<HD>(dv, dv_out + off, in.row, k0 + row0, L, 1.f);
  }
}

// ---------------------------------------------------------------------------
// 3. dQ for one (batch, head, 128-query tile).
template <int HD>
__global__ void __launch_bounds__(384, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq_out, AttnLayout in, int L, int H,
                              float scale) {
  using C = BwdCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<HD> sm(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::BM;
  const int tiles = (L + C::BN - 1) / C::BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 256);
    }
    mbar_init(sm.resident(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_arrive_tx(sm.resident(), 2 * C::RES);
      tma_rows<HD>(sm.res(0), &tq, C::BM, C::BN, q0, h, b, sm.resident());
      tma_rows<HD>(sm.res(1), &tg, C::BM, C::BN, q0, h, b, sm.resident());
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(sm.empty(stage), phase ^ 1);
        mbar_arrive_tx(sm.full(stage), 2 * C::STR);
        tma_rows<HD>(sm.str(stage, 0), &tk, C::BN, C::BN, t * C::BN, h, b, sm.full(stage));
        tma_rows<HD>(sm.str(stage, 1), &tv, C::BN, C::BN, t * C::BN, h, b, sm.full(stage));
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int row0 = (wg - 1) * 64;  // this warpgroup's query rows in the block's tile
    const int lane = threadIdx.x % 32, c = (lane % 4) * 2;
    const int r = q0 + row0 + (threadIdx.x % 128 / 32) * 16 + lane / 4;  // rows r, r + 8
    const float scale_log2 = scale * BWD_LOG2E;
    const long long bh = ((long long)b * H + h) * L;
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool in_l = r + 8 * u < L;
      row_lse[u] = in_l ? lse[bh + r + 8 * u] * BWD_LOG2E : INFINITY;
      row_delta[u] = in_l ? delta[bh + r + 8 * u] : 0.f;
    }
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    const uint64_t aq = desc_k<HD>(sm.res(0), row0), ag = desc_k<HD>(sm.res(1), row0);
    mbar_wait(sm.resident(), 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(sm.full(stage), phase);
      const uint32_t sk = sm.str(stage, 0), sv = sm.str(stage, 1);
      float s[C::BN / 2], dp[C::BN / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<C::BN>(s, aq + k_step<HD>(C::BM, kk), desc_k<HD>(sk, 0) + k_step<HD>(C::BN, kk),
                        kk);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<C::BN>(dp, ag + k_step<HD>(C::BM, kk), desc_k<HD>(sv, 0) + k_step<HD>(C::BN, kk),
                        kk);
      wg_commit();

      // p: row = query, column = key j of the stage; keys at or past L masked
      wg_wait<1>();
      reg_fence(s);
      const int k0 = t * C::BN + c;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = k0 + 8 * j + (e & 1) < L
                             ? exp2_approx(s[4 * j + e] * scale_log2 - row_lse[e >> 1])
                             : 0.f;
      wg_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - row_delta[e >> 1]);
      uint32_t da[C::BN / 16][4];
      to_a_frags<C::BN>(dp, da);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < C::BN / 16; ++ks)
        wgmma_rs<HD>(dq, da[ks], desc_mn<HD>(sk, C::BN) + mn_step<HD>(ks), 1);
      wg_commit();
      wg_wait<0>();
      reg_fence(dq);
      mbar_arrive(sm.empty(stage));
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_acc<HD>(dq, dq_out + in.at(b, h), in.row, q0 + row0, L, scale);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches

template <int HD>
static int launch_attention_bwd_hd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                                   const bf16* g, const float* lse, float* delta, bf16* dq,
                                   bf16* dk, bf16* dv, AttnLayout in, AttnLayout ol,
                                   AttnLayout gl, int B, int L, int H, float scale,
                                   cudaStream_t stream) {
  using C = BwdCfg<HD>;
  constexpr int ROWS_PER_BLOCK = 8 * (32 / (HD / 8));  // 8 warps a block
  const long long rows = (long long)B * H * L;
  attention_bwd_delta_kernel<HD>
      <<<(unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK), 256, 0, stream>>>(
          o, g, delta, ol, gl, B, L, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  CUtensorMap tq, tk, tv, tg;
  if (tma_encoder() == nullptr) return (int)cudaErrorNotSupported;
  if (!encode_rows<HD>(&tq, q, in, B, L, H, C::BN) ||
      !encode_rows<HD>(&tk, k, in, B, L, H, C::BN) ||
      !encode_rows<HD>(&tv, v, in, B, L, H, C::BN) ||
      !encode_rows<HD>(&tg, g, gl, B, L, H, C::BN))
    return (int)cudaErrorInvalidValue;

  const dim3 grid((unsigned)((L + C::BM - 1) / C::BM), (unsigned)H, (unsigned)B);
  e = cudaFuncSetAttribute(attention_bwd_dkdv_wgmma_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_dkdv_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tg, lse, delta, dk, dv, in, L, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(attention_bwd_dq_wgmma_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_dq_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tg, lse, delta, dq, in, L, H, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dq, dk, dv: [B, H, L, hd] views with layout `in`; o: layout `ol`;
// g: layout `gl`; lse [B, H, L] f32; delta [B, H, L] f32 scratch.
static int launch_attention_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                                const bf16* g, const float* lse, float* delta, bf16* dq,
                                bf16* dk, bf16* dv, AttnLayout in, AttnLayout ol, AttnLayout gl,
                                int B, int L, int H, int hd, float scale, cudaStream_t stream) {
  if (!attention_args_ok(B, L, H, hd)) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch_attention_bwd_hd<32>(q, k, v, o, g, lse, delta, dq, dk, dv, in, ol, gl, B, L,
                                         H, scale, stream);
    case 64:
      return launch_attention_bwd_hd<64>(q, k, v, o, g, lse, delta, dq, dk, dv, in, ol, gl, B, L,
                                         H, scale, stream);
    default:
      return launch_attention_bwd_hd<128>(q, k, v, o, g, lse, delta, dq, dk, dv, in, ol, gl, B,
                                          L, H, scale, stream);
  }
}
