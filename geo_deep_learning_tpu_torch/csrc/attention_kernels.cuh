// Device code of the attention forward, shared by the packed K4
// (attention.cu) and the head-major K8 (attention_hm.cu). The backward
// (K7/K9) is attention_bwd_kernels.cuh; layouts, argument checks and TMA
// row loads are attention_layout.cuh; the PTX building blocks (mbarriers,
// TMA, wgmma) are hopper.cuh's.
//
// Both compute the same function with the numerics of the TPU kernels
// (mha.py _fwd_kernel and _fwd_kernel_packed): bf16 products with f32
// accumulation, the softmax in f32, the unnormalized probabilities cast to
// bf16 once before P.V, the output divided by the f32 row sum and written
// as bf16, lse = m + log(l) in f32 per row. They differ only in the
// AttnLayout of run-time strides they pass. The softmax runs online over
// key chunks in the exp2 domain (scale * log2 e folded into one FMA, m
// kept in log2 units and converted back for lse): the result differs from
// the TPU kernels' single pass by rounding only.
//
// Design: one block of three consumer warpgroups (384 threads, one block
// an SM) per (192-row q group, head, batch), the groups of one head next
// to each other in the grid so that its K/V stay in L2. No producer warp:
// 12 warps compile to 168 registers a thread, the budget every buffer
// below is sized for (a producer warpgroup with two consumers, given 40 /
// 232 registers by setmaxnreg, ran no faster in an A/B on the card).
//   - Loads by TMA from 4-D (hd, L, H, B) tensor maps with the layout's
//     byte strides: rows past L arrive as zeros. Thread 0 of the block
//     loads the block's q tiles (64 rows each, one per consumer) once and
//     the first SLOTS chunks of BN keys of K and V into a ring of slots,
//     each with a full mbarrier (a head's K/V, 332 KB at L = 1297, do not
//     fit in shared memory). A warpgroup releases a slot after its last
//     product on it (a named barrier over its four warps, then a counter
//     per slot in shared memory); the warpgroup that releases it last
//     issues the slot's next load, so no warpgroup waits for another to
//     refill it.
//   - Each consumer warpgroup owns one 64-row q tile (wgmma's M) and walks
//     the chunks. Per chunk n: s = q k_n^T with wgmma_ss (m64nBNk16, both
//     operands K-major) is issued together with o += p_{n-1} v_{n-1}
//     (register-A wgmma_rs, v as the MN-major B through the transpose
//     bit), so the previous chunk's P.V runs on the tensor cores while
//     this chunk's softmax runs on the SMs' FMA and exp2 units: row maxima
//     over a quad of lanes, p = exp2(s * scale log2 e - m) in registers,
//     the row sums and the rescale alpha = exp2(m_old - m). p becomes the
//     bf16 A fragments of the next P.V in registers (the f32 accumulator
//     layout of an m64nBN tile is the A fragment layout of m64k16 slices):
//     no score tile touches shared memory. Keys at or past L are masked to
//     -inf in the last chunk only, peeled out of the loop.
//   - The warpgroups issue their products in turn (0, 1, 2, 0, ...,
//     passed on through named barriers, as FlashAttention-3 orders its
//     consumers), so each one's softmax runs under the others' products
//     rather than all three contending for the tensor cores at once.
//   - Epilogue: o / l as bf16 from the accumulator registers into the
//     caller's strided view, two adjacent columns a store, rows below L
//     only; lse from one lane a row. Every output is written by one
//     thread in a fixed order: equal run to run.
// Chunks are 128 keys at head dims 32 and 64, 64 at 128, where the o
// accumulator alone takes 64 registers a thread. At head dim 64 a thread
// holds s (64 registers), p (32) and o (32). The ring holds 8 / 6 / 5
// chunks at head dims 32 / 64 / 128 (128 / 192 / 160 KB; two chunks ran
// far slower, six a little faster than four).
//
// What this does about the first design it replaces (nvcuda::wmma, one
// 64-row q tile per block of 4 warps, 64-key K/V tiles copied between two
// __syncthreads, f32 scores and bf16 probabilities staged through shared
// memory, a lane pair a row): products on wgmma, loads by TMA ahead of
// the products, scores and probabilities in registers, softmax work
// spread over four lanes a row and overlapped with the tensor cores.
#pragma once

#include "attention_layout.cuh"

constexpr float FWD_LOG2E = 1.4426950408889634f;
constexpr float FWD_LN2 = 0.6931471805599453f;

template <int HD>
struct FwdCfg {
  static constexpr int BM = 64;                    // q rows of a consumer warpgroup (wgmma M)
  static constexpr int BN = HD == 128 ? 64 : 128;  // keys of a K/V chunk (N of q k^T)
  static constexpr int CONSUMERS = 3;             // warpgroups: 12 warps, 168 registers each
  static constexpr int THREADS = 128 * CONSUMERS;
  static constexpr int SLOTS = HD == 32 ? 8 : HD == 64 ? 6 : 5;  // K/V ring: 128 / 192 / 160 KB
  static constexpr int QT = BM * HD * 2;           // bytes of a q tile
  static constexpr int KT = BN * HD * 2;           // bytes of a K (or V) chunk
  // smem: the consumers' q tiles, K/V slots (K then V), mbarriers (q, then
  // one a slot), release counters (one a slot)
  static constexpr int OFF_KV = CONSUMERS * QT;
  static constexpr int OFF_BAR = OFF_KV + SLOTS * 2 * KT;
  static constexpr int OFF_CNT = OFF_BAR + (1 + SLOTS) * 8;
  static constexpr size_t SMEM = OFF_CNT + SLOTS * 4 + 1024;  // + base alignment
};

// Shared memory of the forward, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 1024 bytes).
template <int HD>
struct FwdSmem {
  using C = FwdCfg<HD>;
  uint32_t base;
  __device__ explicit FwdSmem(unsigned char* raw) : base((smem_addr(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t q(int w) const { return base + w * C::QT; }
  __device__ uint32_t k(int slot) const { return base + C::OFF_KV + slot * 2 * C::KT; }
  __device__ uint32_t v(int slot) const { return k(slot) + C::KT; }
  __device__ uint32_t qfull() const { return base + C::OFF_BAR; }
  __device__ uint32_t full(int slot) const { return base + C::OFF_BAR + (1 + slot) * 8; }
};

// One chunk of a consumer warpgroup after the first: s = q k_n^T issued
// with o += p v_{n-1}; then, while P.V runs, the online softmax of s into
// p (registers) and the row state m, l (log2 units, this thread's partial
// sums); then o rescaled. MASK: the last chunk, keys at or past L to -inf.
// (The first chunk, which has no P.V to overlap, is written out in the
// kernel: folding it into this function as a fourth inlined instance ran
// both K4 and K8 about 3 % slower on the card.)
template <int HD, bool MASK, typename Turn, typename Pass>
__device__ __forceinline__ void fwd_chunk(float (&s)[FwdCfg<HD>::BN / 2],
                                          uint32_t (&p)[FwdCfg<HD>::BN / 16][4],
                                          float (&o)[HD / 2], float (&m)[2], float (&l)[2],
                                          uint32_t sq, uint32_t sk, uint32_t sv_prev, int key0,
                                          int L, float scale_log2, Turn turn, Pass pass) {
  using C = FwdCfg<HD>;
  turn();
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<C::BN>(s, desc_k<HD>(sq, 0) + k_step<HD>(C::BM, kk),
                    desc_k<HD>(sk, 0) + k_step<HD>(C::BN, kk), kk);
  wg_commit();
#pragma unroll
  for (int ks = 0; ks < C::BN / 16; ++ks)
    wgmma_rs<HD>(o, p[ks], desc_mn<HD>(sv_prev, C::BN) + mn_step<HD>(ks), 1);
  wg_commit();
  pass();
  wg_wait<1>();
  reg_fence(s);
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * j + (e & 1) >= L) s[4 * j + e] = -INFINITY;
  }
  // the rows' new maxima (scale > 0: the max of the raw scores)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float alpha[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    const float m_new = fmaxf(m[u], mx[u] * scale_log2);  // finite: a key < L
    alpha[u] = exp2_approx(m[u] - m_new);
    m[u] = m_new;
    l[u] *= alpha[u];
  }
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
  wg_wait<0>();  // P.V of the previous chunk is done with p and o
  reg_fence(o);
  reg_fence(p);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
  to_a_frags<C::BN>(s, p);
}

template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::THREADS, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                           float* __restrict__ lse, AttnLayout ol, int L, int H,
                           float scale_log2) {
  using C = FwdCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  const FwdSmem<HD> sm(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * C::CONSUMERS * C::BM;
  const int live = min(C::CONSUMERS, (L - q0 + C::BM - 1) / C::BM);  // tiles with rows below L
  const int nch = (L + C::BN - 1) / C::BN;
  const int w = threadIdx.x / 128;

  // per slot, how many warpgroup releases it has seen
  int* released =
      reinterpret_cast<int*>(smem_raw + (sm.base - smem_addr(smem_raw)) + C::OFF_CNT);
  if (threadIdx.x == 0) {
    mbar_init(sm.qfull(), 1);
    for (int slot = 0; slot < C::SLOTS; ++slot) {
      mbar_init(sm.full(slot), 1);
      released[slot] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  const CUtensorMap *tkp = &tk, *tvp = &tv;
  // K/V chunk n into slot n % SLOTS
  const auto load_kv = [&](int n) {
    const int slot = n % C::SLOTS;
    mbar_arrive_tx(sm.full(slot), 2 * C::KT);
    tma_rows<HD>(sm.k(slot), tkp, C::BN, C::BN, n * C::BN, h, b, sm.full(slot));
    tma_rows<HD>(sm.v(slot), tvp, C::BN, C::BN, n * C::BN, h, b, sm.full(slot));
  };
  if (threadIdx.x == 0) {
    mbar_arrive_tx(sm.qfull(), live * C::QT);
    for (int i = 0; i < live; ++i)
      tma_rows<HD>(sm.q(i), &tq, C::BM, C::BM, q0 + i * C::BM, h, b, sm.qfull());
    for (int n = 0; n < min(nch, C::SLOTS); ++n) load_kv(n);
  }
  if (w >= live) return;

  const int t = threadIdx.x % 128, lane = t % 32, c2 = (lane % 4) * 2;
  const int row = q0 + w * C::BM + (t / 32) * 16 + lane / 4;  // this thread's rows row, row + 8
  const uint32_t sq = sm.q(w);
  // release chunk n's slot: the warpgroup that releases it last refills it
  const auto release = [&](int n) {
    named_sync(4 + w, 128);  // every warp of this warpgroup is done with the slot
    if (t == 0 && n + C::SLOTS < nch &&
        atomicAdd(released + n % C::SLOTS, 1) == (n / C::SLOTS + 1) * live - 1)
      load_kv(n + C::SLOTS);
  };
  // the consumers issue their products in turn (0, 1, 2, 0, ...): barrier
  // 1 + w passes warpgroup w once the one before it has issued
  const auto turn = [&]() { named_sync(1 + w, 256); };
  const auto pass = [&]() { named_arrive(1 + (w + 1) % live, 256); };
  if (w == 0) named_arrive(1, 256);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float s[C::BN / 2];
  uint32_t p[C::BN / 16][4];
  float m[2], l[2];
  // chunk 0: scores and softmax, no P.V yet
  mbar_wait(sm.qfull(), 0);
  mbar_wait(sm.full(0), 0);
  turn();
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<C::BN>(s, desc_k<HD>(sq, 0) + k_step<HD>(C::BM, kk),
                    desc_k<HD>(sm.k(0), 0) + k_step<HD>(C::BN, kk), kk);
  wg_commit();
  pass();
  wg_wait<0>();
  reg_fence(s);
  if (nch == 1) {
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + c2 + (e & 1) >= L) s[4 * j + e] = -INFINITY;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * u], s[4 * j + 2 * u + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    m[u] = mx * scale_log2;
    l[u] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
  to_a_frags<C::BN>(s, p);

  for (int n = 1; n < nch - 1; ++n) {
    const int slot = n % C::SLOTS;
    mbar_wait(sm.full(slot), (n / C::SLOTS) & 1);
    fwd_chunk<HD, false>(s, p, o, m, l, sq, sm.k(slot), sm.v((n - 1) % C::SLOTS),
                         n * C::BN + c2, L, scale_log2, turn, pass);
    release(n - 1);
  }
  if (nch > 1) {
    const int n = nch - 1, slot = n % C::SLOTS;
    mbar_wait(sm.full(slot), (n / C::SLOTS) & 1);
    fwd_chunk<HD, true>(s, p, o, m, l, sq, sm.k(slot), sm.v((n - 1) % C::SLOTS),
                        n * C::BN + c2, L, scale_log2, turn, pass);
    release(n - 1);
  }
  // P.V of the last chunk
  turn();
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < C::BN / 16; ++ks)
    wgmma_rs<HD>(o, p[ks], desc_mn<HD>(sm.v((nch - 1) % C::SLOTS), C::BN) + mn_step<HD>(ks), 1);
  wg_commit();
  pass();
  wg_wait<0>();
  reg_fence(o);
  reg_fence(p);

  const long long bh = (long long)b * H + h;
  bf16* ob = out + ol.at(b, h);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    const int r = row + 8 * u;
    if (r < L) {
      const float inv = 1.f / l[u];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + (long long)r * ol.row + 8 * j + c2) =
            pack_bf16(o[4 * j + 2 * u] * inv, o[4 * j + 2 * u + 1] * inv);
      if (c2 == 0) lse[bh * L + r] = m[u] * FWD_LN2 + logf(l[u]);
    }
  }
}


template <int HD>
static int launch_attention_fwd_hd(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                   float* lse, AttnLayout in, AttnLayout ol, int B, int L, int H,
                                   float scale, cudaStream_t stream) {
  using C = FwdCfg<HD>;
  if (tma_encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_rows<HD>(&tq, q, in, B, L, H, C::BM) ||
      !encode_rows<HD>(&tk, k, in, B, L, H, C::BN) ||
      !encode_rows<HD>(&tv, v, in, B, L, H, C::BN))
    return (int)cudaErrorInvalidValue;
  const auto kernel = attention_fwd_wgmma_kernel<HD>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int rows = C::CONSUMERS * C::BM;
  const dim3 grid((unsigned)((L + rows - 1) / rows), (unsigned)H, (unsigned)B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, out, lse, ol, L, H,
                                                 scale * FWD_LOG2E);
  return (int)cudaGetLastError();
}

// q, k, v: [B, H, L, hd] views with layout `in`; out: a view with layout `ol`;
// lse: [B, H, L] f32. scale > 0 (the row maxima are taken on the raw scores).
static int launch_attention_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                float* lse, AttnLayout in, AttnLayout ol, int B, int L, int H,
                                int hd, float scale, cudaStream_t stream) {
  if (!attention_args_ok(B, L, H, hd) || !(scale > 0.f && scale < INFINITY))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_attention_fwd_hd<32>(q, k, v, out, lse, in, ol, B, L, H, scale, stream);
    case 64: return launch_attention_fwd_hd<64>(q, k, v, out, lse, in, ol, B, L, H, scale, stream);
    default: return launch_attention_fwd_hd<128>(q, k, v, out, lse, in, ol, B, L, H, scale, stream);
  }
}
