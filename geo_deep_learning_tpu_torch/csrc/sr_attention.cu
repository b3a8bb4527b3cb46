// K10: spatial-reduction attention forward, o = softmax(q k^T * scale) v.
//
// Replaces geo_deep_learning_tpu/ops/pallas/sr_attention.py::_attn_kernel
// (via _pallas_attention). q is [B, H, Lq, D], k and v are [B, H, Lk, D],
// read through their strides (the last dimension contiguous, every row on
// 16 bytes), so the port's q, k and v come straight out of their
// projections' [B, L, H, D] and [B, Lk, 2, H, D] outputs without a
// transpose. o has the same shape, written through its own strides. The
// scores, the softmax and the PV sum are f32 (p is never rounded to the
// input dtype as a whole), o is written in the input dtype, as the TPU
// kernel does; the result differs from its normalize-first order by f32
// rounding only.
//
// Bound on the H100: operations. At MiT-b0 stage 1, 512^2, bs 8 (q
// [8,1,16384,32], k/v [8,1,256,32]) the call moves ~17 MB (5 us at
// 3.35 TB/s) and does 2*B*H*Lq*Lk*D = 2.1 GFLOP of q k^T and as much of
// p v. At f32 accuracy p v runs as two bf16 products (p split into hi +
// lo), 6.4 GFLOP on the tensor cores (6.5 us at 989 TFLOP/s); the
// softmax's 33.5 M exp2 a call take ~9 us on the SMs' 16 exp units a
// clock, the practical floor.
//
// bf16 design (sr_attention_fwd_wgmma_kernel): one block of three
// warpgroups per (split, batch, head), one block an SM; the grid splits
// each (batch, head)'s 64-row q tiles over enough blocks to fill the card,
// and a block walks its tiles (split, split + splits, ...) with K/V loaded
// once. No producer warp: 12 warps hold 168 registers each, and a 13th
// would cut that to 152.
//   - Loads by TMA. Thread 0 of the block loads K and V in 128-key
//     chunks: once, into resident slots, when every chunk fits (Lk <= 1024
//     at D 32, <= 512 at D 64), else streamed round after round through
//     the same slots as a ring, refilling a slot once all three
//     warpgroups are done with it. Each warpgroup's thread 0 keeps its own
//     two-stage ring of 64-row q tiles filled, loading the tile after next
//     as soon as a tile's last q k^T is done.
//   - Each warpgroup consumes its own q tiles: per chunk s = q k^T with
//     wgmma m64n128k16 from shared memory (both K-major); keys at or past
//     Lk (zero-filled by TMA) masked to -inf; an online softmax in exp2
//     with scale * log2 e folded into one FMA; p in registers, split into
//     hi = bf16(p) and lo = bf16(p - hi) (p to ~2^-17 relative); o += hi v
//     + lo v as register-A wgmma m64nDk16 with v as the MN-major B (the
//     transpose bit reads the TMA tile as it is). Three warpgroups an SM
//     keep the tensor cores, the exp units and the FMA pipes busy under
//     each other's waits.
//   - Epilogue: o / l in bf16 from the accumulator registers into the
//     caller's strided view, rows below Lq only. No atomics: every o row
//     is written by one thread of one block, equal run to run.
// Queries past Lq arrive as zero rows (TMA) and are not written.
//
// What this does about the first design (one thread a q row, f32 FMAs,
// K/V widened to f32 in 32-row tiles staged between two __syncthreads and
// re-staged by every 128-row block): both products on the tensor cores,
// K/V staged once a block by TMA, q streamed ahead of the products, the
// score tile never leaves registers.
//
// f32 design (sr_attention_fwd_kernel, the 32-true path): one thread owns
// one q row; its q values, its f32 output accumulator and its softmax
// state live in registers, and a block of 128 threads (128 consecutive q
// rows of one (batch, head)) streams K/V through shared memory in 32-row
// tiles with an online softmax, so any Lk runs; rows past Lk are
// zero-filled and masked to -inf. Every K/V value a warp reads from shared
// memory is a broadcast, so the two products run as plain f32 FMAs
// without bank conflicts.
#include <algorithm>

#include "sr_attention.cuh"

constexpr int SR_BQ = 128;  // q rows per block, one per thread
constexpr int SR_BK = 32;   // K/V rows per shared-memory tile

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

template <int D>
struct SrCfg {
  static constexpr int BM = 64;                  // q rows of a consumer's tile (wgmma M)
  static constexpr int BN = 128;                 // keys of a K/V chunk (N of q k^T)
  static constexpr int QSTAGES = 2;              // q ring depth of each consumer
  static constexpr int SLOTS = D == 32 ? 8 : 4;  // K/V chunk slots: 128 KB
  static constexpr int CONSUMERS = 3;            // warpgroups: 12 warps, 168 registers each
  static constexpr int THREADS = 128 * CONSUMERS;
  static constexpr int QT = BM * D * 2;          // bytes of a q tile
  static constexpr int KT = BN * D * 2;          // bytes of a K (or V) chunk
  // smem: the consumers' q rings, then K/V slots (K then V), then mbarriers
  static constexpr int OFF_KV = CONSUMERS * QSTAGES * QT;
  static constexpr int OFF_BAR = OFF_KV + SLOTS * 2 * KT;
  static constexpr int NBAR = CONSUMERS * QSTAGES + 2 * SLOTS;
  static constexpr size_t SMEM = OFF_BAR + NBAR * 8 + 1024;  // + base alignment
};

// Shared memory of the bf16 kernel, from a 1024-byte aligned base.
template <int D>
struct SrSmem {
  using C = SrCfg<D>;
  uint32_t base;
  __device__ explicit SrSmem(unsigned char* raw) : base((smem_addr(raw) + 1023u) & ~1023u) {}
  __device__ uint32_t q(int w, int s) const { return base + (w * C::QSTAGES + s) * C::QT; }
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

// s = q k^T of one 64-row q tile against one K chunk: wgmma m64n128k16
// from shared memory, both operands K-major.
template <int D>
__device__ __forceinline__ void sr_scores(float (&sc)[SrCfg<D>::BN / 2], uint32_t sq, uint32_t sk) {
  using C = SrCfg<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<C::BN>(sc, desc_k<D>(sq, 0) + k_step<D>(C::BM, kk),
                    desc_k<D>(sk, 0) + k_step<D>(C::BN, kk), kk);
  wg_commit();
  wg_wait<0>();
  reg_fence(sc);
}

// One chunk of the online softmax and o += p v: keys at or past Lk masked
// to -inf, the rows' maxima m and sums l (log2 units) updated, acc
// rescaled, p = exp2(s * scale log2 e - m) split into bf16 hi + lo A
// fragments, and two register-A wgmma against v (MN-major).
template <int D>
__device__ __forceinline__ void sr_update(float (&sc)[SrCfg<D>::BN / 2], float (&acc)[D / 2],
                                          float (&m)[2], float (&l)[2], uint32_t sv, int c,
                                          int Lk, float scale_log2, int c2) {
  using C = SrCfg<D>;
  if ((c + 1) * C::BN > Lk) {
    const int k0 = c * C::BN + c2;
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + (e & 1) >= Lk) sc[4 * j + e] = -INFINITY;
  }
  // the rows' new maxima (scale > 0: the max of the raw scores)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  float alpha[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    const float m_new = fmaxf(m[u], mx[u] * scale_log2);  // finite: a key < Lk
    alpha[u] = exp2_approx(m[u] - m_new);                 // 0 on the first chunk
    m[u] = m_new;
    l[u] *= alpha[u];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
  uint32_t hi[C::BN / 16][4], lo[C::BN / 16][4];
#pragma unroll
  for (int sl = 0; sl < C::BN / 16; ++sl)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 8 * sl + 2 * u, row = u & 1;
      const float p0 = exp2_approx(fmaf(sc[i], scale_log2, -m[row]));
      const float p1 = exp2_approx(fmaf(sc[i + 1], scale_log2, -m[row]));
      l[row] += p0 + p1;
      hi[sl][u] = pack_bf16(p0, p1);
      lo[sl][u] = pack_bf16(p0 - __uint_as_float(hi[sl][u] << 16),
                            p1 - __uint_as_float(hi[sl][u] & 0xffff0000u));
    }
  wg_fence();
#pragma unroll
  for (int sl = 0; sl < C::BN / 16; ++sl)
    wgmma_rs<D>(acc, hi[sl], desc_mn<D>(sv, C::BN) + mn_step<D>(sl), 1);
#pragma unroll
  for (int sl = 0; sl < C::BN / 16; ++sl)
    wgmma_rs<D>(acc, lo[sl], desc_mn<D>(sv, C::BN) + mn_step<D>(sl), 1);
  wg_commit();
  wg_wait<0>();
  reg_fence(acc);
}

// o = acc / l in bf16 into rows row0, row0 + 8 of (batch b, head h) of
// the strided view o, rows below Lq only (l summed over the quad first).
template <int D>
__device__ __forceinline__ void sr_store(const float (&acc)[D / 2], float (&l)[2], bf16* o,
                                         SrStrides os, int b, int h, int row0, int Lq, int c2) {
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row < Lq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + (long long)row * os.l + 8 * j + c2) =
            pack_bf16(acc[4 * j + 2 * half] / l[half], acc[4 * j + 2 * half + 1] / l[half]);
    }
  }
}

// RING: K/V streamed per round (more chunks than slots), else resident;
// the host picks the instance from Lk.
template <int D, bool RING>
__global__ void __launch_bounds__(SrCfg<D>::THREADS, 1)
sr_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                              SrStrides os, int H, int Lq, int Lk, float scale_log2) {
  using C = SrCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const SrSmem<D> sm(smem_raw);
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int split = blockIdx.x, splits = gridDim.x;
  const int units = (Lq + C::BM - 1) / C::BM;                // q tiles of the head
  const int mine = (units - split + splits - 1) / splits;    // this block's: split < units
  const int rounds = (mine + C::CONSUMERS - 1) / C::CONSUMERS;
  const int nch = (Lk + C::BN - 1) / C::BN;
  const int fills = RING ? rounds * nch : nch;  // K/V chunk loads, in stream order
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
  const CUtensorMap *tqp = &tq, *tkp = &tk, *tvp = &tv;
  // K/V chunk n of the stream (chunk n % nch) into its slot
  const auto load_kv = [&](int n) {
    const int slot = n % C::SLOTS, c = n % nch;
    mbar_arrive_tx(sm.kvfull(slot), 2 * C::KT);
    tma_load(sm.k(slot), tkp, 0, c * C::BN, h, b, sm.kvfull(slot));
    tma_load(sm.v(slot), tvp, 0, c * C::BN, h, b, sm.kvfull(slot));
  };
  // this consumer's tile `tl` (its rounds' tiles tl = rd * CONSUMERS + w)
  // into q stage (tl / CONSUMERS) % QSTAGES
  const auto load_q = [&](int tl) {
    const uint32_t bar = sm.qfull(w, (tl / C::CONSUMERS) % C::QSTAGES);
    mbar_arrive_tx(bar, C::QT);
    tma_load(sm.q(w, (tl / C::CONSUMERS) % C::QSTAGES), tqp, 0, (split + tl * splits) * C::BM, h,
             b, bar);
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
    const uint32_t sq = sm.q(w, s);
    if (live) mbar_wait(sm.qfull(w, s), ph);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // per row, log2 units
    for (int c = 0; c < nch; ++c) {
      const int n = RING ? rd * nch + c : c, slot = n % C::SLOTS;
      mbar_wait(sm.kvfull(slot), (n / C::SLOTS) & 1);
      if (live) {
        float sc[C::BN / 2];
        sr_scores<D>(sc, sq, sm.k(slot));
        // q is read for the last time: its stage takes the tile after next
        if (c == nch - 1 && t == 0 && tile + C::QSTAGES * C::CONSUMERS < mine)
          load_q(tile + C::QSTAGES * C::CONSUMERS);
        sr_update<D>(sc, acc, m, l, sm.v(slot), c, Lk, scale_log2, c2);
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
    if (!live) continue;
    sr_store<D>(acc, l, o, os, b, h, (split + tile * splits) * C::BM + r, Lq, c2);
    if (++s == C::QSTAGES) {
      s = 0;
      ph ^= 1;
    }
  }
}

template <int D>
static int launch_sr_attention_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                                     int H, int Lq, int Lk, SrStrides qs, SrStrides ks,
                                     SrStrides vs, SrStrides os, float scale,
                                     cudaStream_t stream) {
  using C = SrCfg<D>;
  if (tma_encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_sr<D>(&tq, q, qs, B, H, Lq, C::BM) || !encode_sr<D>(&tk, k, ks, B, H, Lk, C::BN) ||
      !encode_sr<D>(&tv, v, vs, B, H, Lk, C::BN))
    return (int)cudaErrorInvalidValue;
  const int nsm = sm_count();
  if (nsm < 1) return (int)cudaErrorInvalidDevice;
  const int units = (Lq + C::BM - 1) / C::BM;
  const int splits =
      std::max(1, std::min((units + C::CONSUMERS - 1) / C::CONSUMERS, nsm / (B * H)));
  const bool ring = (Lk + C::BN - 1) / C::BN > C::SLOTS;
  const auto kernel = ring ? sr_attention_fwd_wgmma_kernel<D, true>
                           : sr_attention_fwd_wgmma_kernel<D, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)splits, (unsigned)(B * H)), C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, (bf16*)o, os, H, Lq, Lk, scale * SR_LOG2E);
  return (int)cudaGetLastError();
}

// q [B,H,Lq,D], k/v [B,H,Lk,D], o [B,H,Lq,D], each given by (batch, head,
// row) strides in elements with a contiguous last dimension; every row
// start 16-byte aligned. D in {32, 64}; is_bf16 selects the bf16 wgmma
// kernel (sm_90a) over the f32 one.
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
      case 32: return launch_sr_attention_wgmma<32>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
      case 64: return launch_sr_attention_wgmma<64>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 32: return launch_sr_attention<float, 32>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
    case 64: return launch_sr_attention<float, 64>(q, k, v, o, B, H, Lq, Lk, qs, ks, vs, os, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
