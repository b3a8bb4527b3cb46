// K10's backward: (dq, dk, dv) of o = softmax(q k^T * scale) v, on bf16
// q [B, H, Lq, D], k and v [B, H, Lk, D] and the output's gradient g
// [B, H, Lq, D], each read through its strides (the last dimension
// contiguous, every row on 16 bytes), so the projections' [B, L, H, D] and
// [B, Lk, 2, H, D] outputs go in without a transpose; dq, dk and dv come
// out in bf16 through their own strides.
//
// Replaces no TPU kernel: the JAX package's backward of K10
// (geo_deep_learning_tpu/ops/pallas/sr_attention.py::_attention_bwd) is
// einsums, and the port ran it as f32 PyTorch math (ops/cuda/
// sr_attention.py::sr_attention_bwd, still the plain version): five f32
// matmuls on the FMA pipe and a dozen f32 score-sized tensors written and
// read again, ~38 ms of a bs-32 MiT-B2 train step on an H100 (700 W).
//
// Arithmetic, that of K10's forward: q k^T and g v^T as bf16 products with
// f32 accumulation (exact products, as the f32 matmul on bf16-valued
// inputs); keys at or past Lk at -inf; row max m and sum l recomputed here
// (the forward writes no lse), p = exp2(s * scale log2 e - m) / l; Delta =
// rowsum(p * dp) formed in f32 from f32 p and dp (online over the key
// chunks, rescaled with the max), never from the bf16 output; ds = p (dp -
// Delta). P and dS are never rounded to bf16 as a whole: every product that
// takes them (dv = p^T g, dq = ds k, dk = ds^T q) runs as two bf16 products
// on hi = bf16(x) and lo = bf16(x - hi) (x to ~2^-17 relative). dq and dk
// are scaled after their products. No atomics: dK/dV partials over ranges
// of Lq are summed in range order by one thread an element, so two calls
// on the same inputs are equal.
//
// Bound on the H100: operations. The backward needs 10 * n * D tensor
// flops and ~5 * n f32 operations for n = B * H * Lq * Lk scores: at MiT-B2
// stage 1, bs 32 (q [32,1,16384,64] over 256 keys, n = 134 M) 86 GFLOP,
// 0.087 ms at 989 TFLOP/s, plus 0.010 ms of f32 work, against ~17 MB of
// traffic (5 us at 3.35 TB/s). The design below runs 24 * n * D flops
// (s and dp three times, each of dq, dk, dv as two products) and three
// exp2 a score: n * 3 exp2 on the SMs' 16 exp units a clock, not the
// tensor cores, is the practical floor (~0.06 ms at stage 1).
//
// Design: Lq >> Lk (16384 queries over 256 keys at stage 1, with B * H =
// 32), so every pass splits Lq over blocks to fill the 132 SMs.
//   1. dQ and the row statistics (sr_attention_bwd_dq_kernel), query-major,
//      the forward's structure: one block of three warpgroups per (split,
//      batch, head), one block an SM; K/V loaded once by TMA in 64-key
//      chunks into resident slots (Lk <= 1024 at D 32, <= 512 at D 64;
//      else streamed round after round through the slots as a ring, as
//      the forward streams them); each warpgroup its own two-stage ring of
//      64-row q and g tiles. Per tile two sweeps over the key chunks: the
//      first s = q k^T and dp = g v^T (wgmma m64n64k16 from shared memory)
//      for m, l and Delta, written out for pass 2 (m, 1 / l and Delta, 12
//      bytes a row); the second s and dp again, p and ds in registers,
//      dq += hi k + lo k (register-A wgmma, k MN-major).
//   2. dK/dV partials (sr_attention_bwd_dkdv_kernel), key-major, K7's
//      dK/dV structure: one block of a producer warpgroup and two consumer
//      warpgroups per (128-key tile, q range, batch, head), K and V of the
//      tile resident; the producer streams the range's q and g tiles by
//      TMA through a four-stage ring with their rows' m, 1 / l and Delta;
//      s^T = k q^T and dp^T = v g^T (shared memory), p^T and ds^T in
//      registers, dv += hi(p^T) g + lo(p^T) g and dk += hi(ds^T) q +
//      lo(ds^T) q (register-A wgmma, g and q MN-major); setmaxnreg gives the
//      consumers 232 registers. Each block writes its f32 partial rows
//      below Lk to scratch.
//   3. Reduce (sr_attention_bwd_reduce_kernel): per element, the ranges'
//      partials summed in range order; dk * scale and dv in bf16.
// The number of ranges of each pass is chosen from the SM count so that
// its grid's waves waste little (srb_plan). No score-sized tile leaves
// registers; the scratch is 12 bytes a q row and the partials (16.8 MB at
// MiT-B2 stage 1, bs 32).
#include <algorithm>
#include <climits>

#include "sr_attention.cuh"

constexpr int SRB_ROWS = 64;  // rows of every q, g, K and V tile (TMA box, wgmma M / N)

// ---------------------------------------------------------------------------
// 1. dQ and the row statistics

template <int D>
struct SrbQCfg {
  static constexpr int BM = SRB_ROWS;              // q rows of a consumer's tile
  static constexpr int BN = SRB_ROWS;              // keys of a K/V chunk
  static constexpr int QSTAGES = 2;                // q/g ring depth of each consumer
  static constexpr int SLOTS = D == 32 ? 16 : 8;   // K/V chunk slots: 128 KB
  static constexpr int CONSUMERS = 3;              // warpgroups: 12 warps, 168 registers each
  static constexpr int THREADS = 128 * CONSUMERS;
  static constexpr int QT = BM * D * 2;            // bytes of a q (or g) tile
  static constexpr int KT = BN * D * 2;            // bytes of a K (or V) chunk
  // smem: the consumers' q/g rings (q then g per stage), then K/V slots
  // (K then V), then mbarriers
  static constexpr int OFF_KV = CONSUMERS * QSTAGES * 2 * QT;
  static constexpr int OFF_BAR = OFF_KV + SLOTS * 2 * KT;
  static constexpr int NBAR = CONSUMERS * QSTAGES + 2 * SLOTS;
  static constexpr size_t SMEM = OFF_BAR + NBAR * 8 + 1024;  // + base alignment
};

template <int D>
struct SrbQSmem {
  using C = SrbQCfg<D>;
  uint32_t base;
  __device__ explicit SrbQSmem(unsigned char* raw) : base((smem_addr(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t q(int w, int s) const { return base + (w * C::QSTAGES + s) * 2 * C::QT; }
  __device__ uint32_t g(int w, int s) const { return q(w, s) + C::QT; }
  __device__ uint32_t k(int slot) const { return base + C::OFF_KV + slot * 2 * C::KT; }
  __device__ uint32_t v(int slot) const { return k(slot) + C::KT; }
  __device__ uint32_t qfull(int w, int s) const {
    return base + C::OFF_BAR + (w * C::QSTAGES + s) * 8;
  }
  __device__ uint32_t kvfull(int slot) const {
    return base + C::OFF_BAR + (C::CONSUMERS * C::QSTAGES + slot) * 8;
  }
  __device__ uint32_t kvempty(int slot) const { return kvfull(slot) + C::SLOTS * 8; }
};

// s = q k^T and dp = g v^T of one 64-row tile against one 64-key chunk:
// wgmma m64n64k16 from shared memory, both operands K-major.
template <int D>
__device__ __forceinline__ void srb_scores(float (&sc)[SRB_ROWS / 2], float (&dp)[SRB_ROWS / 2],
                                           uint32_t sq, uint32_t sg, uint32_t sk, uint32_t sv) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<SRB_ROWS>(sc, desc_k<D>(sq, 0) + k_step<D>(SRB_ROWS, kk),
                       desc_k<D>(sk, 0) + k_step<D>(SRB_ROWS, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<SRB_ROWS>(dp, desc_k<D>(sg, 0) + k_step<D>(SRB_ROWS, kk),
                       desc_k<D>(sv, 0) + k_step<D>(SRB_ROWS, kk), kk);
  wg_commit();
  wg_wait<0>();
  reg_fence(sc);
  reg_fence(dp);
}

// x split into bf16 A fragments hi = bf16(x) and lo = bf16(x - hi); slice
// s takes accumulator registers 8 s .. 8 s + 7, as to_a_frags.
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = x[8 * s + 2 * u], b = x[8 * s + 2 * u + 1];
      hi[s][u] = pack_bf16(a, b);
      lo[s][u] = pack_bf16(a - __uint_as_float(hi[s][u] << 16),
                           b - __uint_as_float(hi[s][u] & 0xffff0000u));
    }
}

template <int D, bool RING>
__global__ void __launch_bounds__(SrbQCfg<D>::THREADS, 1)
sr_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg, bf16* __restrict__ dq,
                           SrStrides dqs, float* __restrict__ stats, long long plane, int H,
                           int Lq, int Lk, float scale_log2, float scale) {
  using C = SrbQCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const SrbQSmem<D> sm(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int split = blockIdx.x, splits = gridDim.x;
  const int units = (Lq + C::BM - 1) / C::BM;                // q tiles of the head
  const int mine = (units - split + splits - 1) / splits;    // this block's: split < units
  const int rounds = (mine + C::CONSUMERS - 1) / C::CONSUMERS;
  const int nch = (Lk + C::BN - 1) / C::BN;
  const int fills = RING ? rounds * 2 * nch : nch;  // K/V chunk loads, in stream order
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::CONSUMERS * C::QSTAGES; ++i)
      mbar_init(sm.qfull(i / C::QSTAGES, i % C::QSTAGES), 1);
    for (int slot = 0; slot < C::SLOTS; ++slot) {
      mbar_init(sm.kvfull(slot), 1);
      mbar_init(sm.kvempty(slot), 128 * C::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const CUtensorMap *tqp = &tq, *tkp = &tk, *tvp = &tv, *tgp = &tg;
  // K/V chunk n of the stream (chunk n % nch) into its slot
  const auto load_kv = [&](int n) {
    const int slot = n % C::SLOTS, c = n % nch;
    mbar_arrive_tx(sm.kvfull(slot), 2 * C::KT);
    tma_load(sm.k(slot), tkp, 0, c * C::BN, h, b, sm.kvfull(slot));
    tma_load(sm.v(slot), tvp, 0, c * C::BN, h, b, sm.kvfull(slot));
  };
  // this consumer's tile `tl` (its rounds' tiles tl = rd * CONSUMERS + w):
  // q and g into stage (tl / CONSUMERS) % QSTAGES
  const auto load_q = [&](int tl) {
    const int s = (tl / C::CONSUMERS) % C::QSTAGES, row = (split + tl * splits) * C::BM;
    mbar_arrive_tx(sm.qfull(w, s), 2 * C::QT);
    tma_load(sm.q(w, s), tqp, 0, row, h, b, sm.qfull(w, s));
    tma_load(sm.g(w, s), tgp, 0, row, h, b, sm.qfull(w, s));
  };
  if (threadIdx.x == 0)
    for (int n = 0; n < min(fills, C::SLOTS); ++n) load_kv(n);
  if (t == 0)
    for (int i = 0; i < C::QSTAGES; ++i)
      if (w + i * C::CONSUMERS < mine) load_q(w + i * C::CONSUMERS);

  const int lane = t % 32, c2 = (lane % 4) * 2;
  const int r = (t / 32) * 16 + lane / 4;  // this thread's rows r and r + 8 of a tile
  int s = 0;
  uint32_t ph = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    const int tile = rd * C::CONSUMERS + w;
    const bool live = tile < mine;  // an idle consumer still walks a streamed round
    if (!live && !RING) break;
    const int row0 = (split + tile * splits) * C::BM + r;
    if (live) mbar_wait(sm.qfull(w, s), ph);
    // per row (r, r + 8): max in log2 units, then 1 / l; sum; Delta
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int c = 0; c < nch; ++c) {
        const int n = RING ? (2 * rd + sweep) * nch + c : c, slot = n % C::SLOTS;
        mbar_wait(sm.kvfull(slot), (n / C::SLOTS) & 1);
        if (live) {
          float sc[C::BN / 2], dp[C::BN / 2];
          srb_scores<D>(sc, dp, sm.q(w, s), sm.g(w, s), sm.k(slot), sm.v(slot));
          // q and g are read for the last time: their stage takes the tile after next
          if (sweep == 1 && c == nch - 1 && t == 0 && tile + C::QSTAGES * C::CONSUMERS < mine)
            load_q(tile + C::QSTAGES * C::CONSUMERS);
          if ((c + 1) * C::BN > Lk) {
            const int k0 = c * C::BN + c2;
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (k0 + 8 * j + (e & 1) >= Lk) sc[4 * j + e] = -INFINITY;
          }
          if (sweep == 0) {
            // online: the rows' maxima (scale > 0: the max of the raw
            // scores), l and Delta's sum rescaled, then this chunk's terms
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
              mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
              const float m_new = fmaxf(m[u], mx[u] * scale_log2);  // finite: a key < Lk
              const float alpha = exp2_approx(m[u] - m_new);        // 0 on the first chunk
              m[u] = m_new;
              l[u] *= alpha;
              dl[u] *= alpha;
            }
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float p = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
                l[e >> 1] += p;
                dl[e >> 1] = fmaf(p, dp[4 * j + e], dl[e >> 1]);
              }
          } else {
            // p = exp2(s c - m) / l (0 past Lk), ds = p (dp - Delta), then
            // dq += hi k + lo k
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int u = e >> 1;
                const float p = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -m[u])) * l[u];
                sc[4 * j + e] = p * (dp[4 * j + e] - dl[u]);
              }
            uint32_t hi[C::BN / 16][4], lo[C::BN / 16][4];
            split_frags<C::BN>(sc, hi, lo);
            wg_fence();
#pragma unroll
            for (int sl = 0; sl < C::BN / 16; ++sl)
              wgmma_rs<D>(acc, hi[sl], desc_mn<D>(sm.k(slot), C::BN) + mn_step<D>(sl), 1);
#pragma unroll
            for (int sl = 0; sl < C::BN / 16; ++sl)
              wgmma_rs<D>(acc, lo[sl], desc_mn<D>(sm.k(slot), C::BN) + mn_step<D>(sl), 1);
            wg_commit();
            wg_wait<0>();
            reg_fence(acc);
          }
        }
        if (RING) {
          mbar_arrive(sm.kvempty(slot));
          // once every consumer is done with it, the slot takes chunk n + SLOTS
          if (threadIdx.x == 0 && n + C::SLOTS < fills) {
            mbar_wait(sm.kvempty(slot), (n / C::SLOTS) & 1);
            load_kv(n + C::SLOTS);
          }
        }
      }
      if (sweep == 0 && live) {
        // the rows' sums over the quad; from here l holds 1 / l and dl Delta
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
          l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
          dl[u] += __shfl_xor_sync(0xffffffffu, dl[u], 1);
          dl[u] += __shfl_xor_sync(0xffffffffu, dl[u], 2);
          l[u] = 1.f / l[u];
          dl[u] *= l[u];
          const int row = row0 + 8 * u;
          if (c2 == 0 && row < Lq) {
            const long long at = (long long)bh * Lq + row;
            stats[at] = m[u];
            stats[plane + at] = l[u];
            stats[2 * plane + at] = dl[u];
          }
        }
      }
    }
    if (!live) continue;
    bf16* out = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row < Lq) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + (long long)row * dqs.l + 8 * j + c2) =
              pack_bf16(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
      }
    }
    if (++s == C::QSTAGES) {
      s = 0;
      ph ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK/dV partials over one range of q tiles

template <int D>
struct SrbKvCfg {
  static constexpr int BK = 2 * SRB_ROWS;  // keys a block owns: two consumer warpgroups x 64
  static constexpr int BQ = SRB_ROWS;      // q rows of a streamed tile
  static constexpr int STAGES = 4;         // ring depth
  static constexpr int THREADS = 384;      // producer warpgroup + 2 consumer warpgroups
  static constexpr int RES = BK * D * 2;   // bytes of the resident K (or V) tile
  static constexpr int STR = BQ * D * 2;   // bytes of a streamed q (or g) tile
  static constexpr int PRODUCER_REGS = 40;  // setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168
  static constexpr int CONSUMER_REGS = 232;
  // smem: K, V; per stage q and g; per stage m, 1 / l, Delta of its rows;
  // mbarriers
  static constexpr int OFF_STAGE = 2 * RES;
  static constexpr int OFF_VEC = OFF_STAGE + STAGES * 2 * STR;
  static constexpr int OFF_BAR = OFF_VEC + STAGES * 3 * BQ * 4;
  static constexpr size_t SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + base alignment
};

template <int D>
struct SrbKvSmem {
  using C = SrbKvCfg<D>;
  uint32_t base;
  __device__ explicit SrbKvSmem(unsigned char* raw) : base((smem_addr(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t res(int i) const { return base + i * C::RES; }  // K (0), V (1)
  __device__ uint32_t str(int stage, int i) const {                     // q (0), g (1)
    return base + C::OFF_STAGE + (stage * 2 + i) * C::STR;
  }
  __device__ uint32_t vec(int stage, int i) const {  // m (0), 1 / l (1), Delta (2)
    return base + C::OFF_VEC + (stage * 3 + i) * C::BQ * 4;
  }
  __device__ uint32_t full(int stage) const { return base + C::OFF_BAR + stage * 8; }
  __device__ uint32_t empty(int stage) const { return base + C::OFF_BAR + (C::STAGES + stage) * 8; }
  __device__ uint32_t resident() const { return base + C::OFF_BAR + 2 * C::STAGES * 8; }
};

// A warpgroup's [64 x D] f32 accumulator into rows row0 + (0..63) of a
// [Lk][D] partial, rows below Lk only.
template <int D>
__device__ __forceinline__ void store_partial(const float (&acc)[D / 2], float* dst, int row0,
                                              int Lk) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = row0 + (t / 32) * 16 + lane / 4, c = (lane % 4) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row < Lk) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + (long long)row * D + 8 * j + c) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
sr_attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tg,
                             const float* __restrict__ stats, long long plane,
                             float* __restrict__ part, int H, int Lq, int Lk, int per,
                             float scale_log2) {
  using C = SrbKvCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const SrbKvSmem<D> sm(smem_raw);
  const int k0 = blockIdx.x * C::BK, range = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, BH = gridDim.z;
  const int units = (Lq + C::BQ - 1) / C::BQ;
  const int first = range * per, tiles = max(0, min(units, first + per) - first);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(sm.full(s), 32);    // the producer warp's lanes (lane 0 with the TMA bytes)
      mbar_init(sm.empty(s), 256);  // every consumer thread
    }
    mbar_init(sm.resident(), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_arrive_tx(sm.resident(), 2 * C::RES);
        for (int i = 0; i < C::BK / SRB_ROWS; ++i) {
          const uint32_t off = i * SRB_ROWS * D * 2;
          tma_load(sm.res(0) + off, &tk, 0, k0 + i * SRB_ROWS, h, b, sm.resident());
          tma_load(sm.res(1) + off, &tv, 0, k0 + i * SRB_ROWS, h, b, sm.resident());
        }
      }
      const long long rows = (long long)bh * Lq;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(sm.empty(stage), phase ^ 1);
        const int q0 = (first + t) * C::BQ;
        // rows past Lq: m = +inf and 1 / l = 0, so they add nothing
        for (int i = lane; i < C::BQ; i += 32) {
          const bool in = q0 + i < Lq;
          const long long at = rows + q0 + i;
          sts_f32(sm.vec(stage, 0) + i * 4, in ? stats[at] : INFINITY);
          sts_f32(sm.vec(stage, 1) + i * 4, in ? stats[plane + at] : 0.f);
          sts_f32(sm.vec(stage, 2) + i * 4, in ? stats[2 * plane + at] : 0.f);
        }
        if (lane == 0) {
          mbar_arrive_tx(sm.full(stage), 2 * C::STR);
          tma_load(sm.str(stage, 0), &tq, 0, q0, h, b, sm.full(stage));
          tma_load(sm.str(stage, 1), &tg, 0, q0, h, b, sm.full(stage));
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
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint64_t ak = desc_k<D>(sm.res(0), row0), av = desc_k<D>(sm.res(1), row0);
    mbar_wait(sm.resident(), 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(sm.full(stage), phase);
      const uint32_t sq = sm.str(stage, 0), sg = sm.str(stage, 1);
      float st[C::BQ / 2], dpt[C::BQ / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BQ>(st, ak + k_step<D>(C::BK, kk), desc_k<D>(sq, 0) + k_step<D>(C::BQ, kk),
                        kk);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<C::BQ>(dpt, av + k_step<D>(C::BK, kk), desc_k<D>(sg, 0) + k_step<D>(C::BQ, kk),
                        kk);
      wg_commit();

      // p^T (row = key, column = query 8 j + c (+1) of the stage), while
      // dp^T runs
      wg_wait<1>();
      reg_fence(st);
#pragma unroll
      for (int j = 0; j < C::BQ / 8; ++j) {
        const float2 m2 = lds_f32x2(sm.vec(stage, 0) + (8 * j + c) * 4);
        const float2 r2 = lds_f32x2(sm.vec(stage, 1) + (8 * j + c) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] = exp2_approx(fmaf(st[4 * j + e], scale_log2, -(e & 1 ? m2.y : m2.x))) *
                          (e & 1 ? r2.y : r2.x);
      }
      // ds^T = p^T (dp^T - Delta)
      wg_wait<0>();
      reg_fence(dpt);
#pragma unroll
      for (int j = 0; j < C::BQ / 8; ++j) {
        const float2 d2 = lds_f32x2(sm.vec(stage, 2) + (8 * j + c) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x));
      }
      uint32_t pa[C::BQ / 16][4], pb[C::BQ / 16][4], da[C::BQ / 16][4], db[C::BQ / 16][4];
      split_frags<C::BQ>(st, pa, pb);
      split_frags<C::BQ>(dpt, da, db);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < C::BQ / 16; ++ks)
        wgmma_rs<D>(dv, pa[ks], desc_mn<D>(sg, C::BQ) + mn_step<D>(ks), 1);
#pragma unroll
      for (int ks = 0; ks < C::BQ / 16; ++ks)
        wgmma_rs<D>(dv, pb[ks], desc_mn<D>(sg, C::BQ) + mn_step<D>(ks), 1);
#pragma unroll
      for (int ks = 0; ks < C::BQ / 16; ++ks)
        wgmma_rs<D>(dk, da[ks], desc_mn<D>(sq, C::BQ) + mn_step<D>(ks), 1);
#pragma unroll
      for (int ks = 0; ks < C::BQ / 16; ++ks)
        wgmma_rs<D>(dk, db[ks], desc_mn<D>(sq, C::BQ) + mn_step<D>(ks), 1);
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
    // partials [2][ranges][B * H][Lk][D]: dK, then dV
    const long long slab = (long long)Lk * D, ranges = gridDim.y;
    float* pk = part + ((long long)range * BH + bh) * slab;
    store_partial<D>(dk, pk, k0 + row0, Lk);
    store_partial<D>(dv, pk + ranges * BH * slab, k0 + row0, Lk);
  }
}

// ---------------------------------------------------------------------------
// 3. dk = bf16(scale * sum of the dK partials), dv = bf16(sum of the dV
// partials), in range order; one thread four elements of a row.
__global__ void __launch_bounds__(256)
sr_attention_bwd_reduce_kernel(const float* __restrict__ part, int ranges, long long slab,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, SrStrides ks,
                               SrStrides vs, int H, int Lk, int D, float scale) {
  const long long quads = slab / 4;  // of one tensor's [B * H][Lk][D] elements
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * quads;
       i += (long long)gridDim.x * blockDim.x) {
    const int which = i >= quads;  // 0: dK, 1: dV
    const long long e = (i - which * quads) * 4;
    const float4* src = reinterpret_cast<const float4*>(part + which * ranges * slab + e);
    float4 a = src[0];
    for (int r = 1; r < ranges; ++r) {
      const float4 x = src[r * (slab / 4)];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float f = which ? 1.f : scale;
    const long long row = e / D;
    const int d0 = (int)(e % D), j = (int)(row % Lk), bh = (int)(row / Lk);
    const SrStrides st = which ? vs : ks;
    bf16* out = (which ? dv : dk) + (long long)(bh / H) * st.b + (long long)(bh % H) * st.h +
                (long long)j * st.l + d0;
    *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(a.x * f, a.y * f),
                                                pack_bf16(a.z * f, a.w * f));
  }
}

// ---------------------------------------------------------------------------
// Host side

// Grids of the two passes: the dQ kernel's splits of a head's q tiles, and
// the dK/dV kernel's ranges of `per` q tiles; each chosen to cut the waves
// of one block an SM times a block's work (plus a tile's worth of set-up)
// least, the fewest splits on a tie.
struct SrbPlan {
  int q_splits, ranges, per;
};

static SrbPlan srb_plan(int BH, int Lq, int Lk, int nsm) {
  const int units = (Lq + SRB_ROWS - 1) / SRB_ROWS;
  SrbPlan p{1, 1, units};
  long long best = LLONG_MAX;
  for (int s = 1; s <= (units + 2) / 3; ++s) {
    const long long waves = ((long long)BH * s + nsm - 1) / nsm;
    const long long cost = waves * (((units + s - 1) / s + 2) / 3 + 1);
    if (cost < best) {
      best = cost;
      p.q_splits = s;
    }
  }
  const long long blocks = (long long)BH * ((Lk + 127) / 128);
  best = LLONG_MAX;
  for (int r = 1; r <= std::min(units, 65535); ++r) {
    const int per = (units + r - 1) / r;
    if ((units + per - 1) / per != r) continue;  // the same ranges as fewer
    const long long cost = (blocks * r + nsm - 1) / nsm * (per + 2);
    if (cost < best) {
      best = cost;
      p.ranges = r;
      p.per = per;
    }
  }
  return p;
}

static bool srb_args_ok(int B, int H, int Lq, int Lk, int D) {
  return B >= 1 && H >= 1 && (long long)B * H <= 65535 && Lq >= 1 && Lk >= 1 &&
         (D == 32 || D == 64);
}

// floats of the row statistics (m, 1 / l, Delta), rounded up to 16 bytes
static long long srb_stats_floats(int B, int H, int Lq) {
  return (3LL * B * H * Lq + 3) / 4 * 4;
}

template <int D>
static int launch_sr_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   void* dq, void* dk, void* dv, float* work, int B, int H,
                                   int Lq, int Lk, const SrStrides* st, float scale,
                                   cudaStream_t stream) {
  using QC = SrbQCfg<D>;
  using KC = SrbKvCfg<D>;
  if (tma_encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tg;
  if (!encode_sr<D>(&tq, q, st[0], B, H, Lq, SRB_ROWS) ||
      !encode_sr<D>(&tk, k, st[1], B, H, Lk, SRB_ROWS) ||
      !encode_sr<D>(&tv, v, st[2], B, H, Lk, SRB_ROWS) ||
      !encode_sr<D>(&tg, g, st[3], B, H, Lq, SRB_ROWS))
    return (int)cudaErrorInvalidValue;
  const int nsm = sm_count();
  if (nsm < 1) return (int)cudaErrorInvalidDevice;
  const int BH = B * H;
  const SrbPlan p = srb_plan(BH, Lq, Lk, nsm);
  const long long plane = (long long)BH * Lq;
  float* stats = work;
  float* part = work + srb_stats_floats(B, H, Lq);
  const float scale_log2 = scale * SR_LOG2E;

  const bool ring = (Lk + QC::BN - 1) / QC::BN > QC::SLOTS;
  const auto dq_kernel = ring ? sr_attention_bwd_dq_kernel<D, true>
                              : sr_attention_bwd_dq_kernel<D, false>;
  cudaError_t e =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QC::SMEM);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<dim3((unsigned)p.q_splits, (unsigned)BH), QC::THREADS, QC::SMEM, stream>>>(
      tq, tk, tv, tg, (bf16*)dq, st[4], stats, plane, H, Lq, Lk, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(sr_attention_bwd_dkdv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KC::SMEM);
  if (e != cudaSuccess) return (int)e;
  sr_attention_bwd_dkdv_kernel<D>
      <<<dim3((unsigned)((Lk + KC::BK - 1) / KC::BK), (unsigned)p.ranges, (unsigned)BH),
         KC::THREADS, KC::SMEM, stream>>>(tq, tk, tv, tg, stats, plane, part, H, Lq, Lk, p.per,
                                          scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long slab = (long long)BH * Lk * D;
  const long long blocks = std::min<long long>((2 * slab / 4 + 255) / 256, 16LL * nsm);
  sr_attention_bwd_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      part, p.ranges, slab, (bf16*)dk, (bf16*)dv, st[5], st[6], H, Lk, D, scale);
  return (int)cudaGetLastError();
}

// The f32 scratch the backward needs at these sizes on the current device:
// the row statistics and the dK/dV partials.
extern "C" int gdl_sr_attention_bwd_workspace(int B, int H, int Lq, int Lk, int D,
                                              long long* floats) {
  if (!srb_args_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const int nsm = sm_count();
  if (nsm < 1) return (int)cudaErrorInvalidDevice;
  const SrbPlan p = srb_plan(B * H, Lq, Lk, nsm);
  *floats = srb_stats_floats(B, H, Lq) + 2LL * p.ranges * B * H * Lk * D;
  return 0;
}

// q, g, dq [B,H,Lq,D], k, v, dk, dv [B,H,Lk,D], bf16, each given by
// (batch, head, row) strides in elements with a contiguous last dimension;
// every row start 16-byte aligned. work: gdl_sr_attention_bwd_workspace's
// floats, 16-byte aligned. D in {32, 64}; sm_90a.
extern "C" int gdl_sr_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                    void* dq, void* dk, void* dv, void* work, int B, int H,
                                    int Lq, int Lk, int D, long long qsb, long long qsh,
                                    long long qsl, long long ksb, long long ksh, long long ksl,
                                    long long vsb, long long vsh, long long vsl, long long gsb,
                                    long long gsh, long long gsl, long long dqsb, long long dqsh,
                                    long long dqsl, long long dksb, long long dksh,
                                    long long dksl, long long dvsb, long long dvsh,
                                    long long dvsl, float scale, void* stream) {
  if (!srb_args_ok(B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const SrStrides st[7] = {{qsb, qsh, qsl},    {ksb, ksh, ksl},    {vsb, vsh, vsl},
                           {gsb, gsh, gsl},    {dqsb, dqsh, dqsl}, {dksb, dksh, dksl},
                           {dvsb, dvsh, dvsl}};
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)work;
  if (D == 32)
    return launch_sr_attention_bwd<32>(q, k, v, g, dq, dk, dv, w, B, H, Lq, Lk, st, scale, s);
  return launch_sr_attention_bwd<64>(q, k, v, g, dq, dk, dv, w, B, H, Lq, Lk, st, scale, s);
}
