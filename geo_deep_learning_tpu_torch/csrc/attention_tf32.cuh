// What the f32 attention kernels of attention_fwd_tf32.cuh (K4-f32 /
// K8-f32) and attention_bwd_tf32.cuh (K7-f32 / K9-f32) share: their tile
// plan, the K-major f32 tiles wgmma reads, the TMA row loads, the split of
// f32 tiles into tf32 hi and lo halves, and the 3xTF32 products.
//
// Numerics: f32 accuracy from the tensor cores, 3xTF32. Each f32 operand x
// is split into hi = tf32_rna(x) and lo = tf32_rna(x - hi); a product
// accumulates a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, small terms first
// (every k8 slice's a_lo b_hi, then a_hi b_lo, then a_hi b_hi), as
// CUTLASS's OpMultiplyAddFastF32 splits it (only lo lo, below 2^-22 of a
// term, is left out). The explicit rounding makes the result independent
// of which mantissa bits the tensor core ignores. The tensor core rounds
// each instruction's sum toward zero, a bias that grows with the number of
// instructions summed into one accumulator; so the kernels sum short runs
// of instructions into fresh accumulators and add those with
// round-to-nearest f32 adds (promote).
//
// Shared-memory tiles are K-major, 32 f32 columns (128 bytes) a row under
// the 128-byte swizzle (16 columns, 64 bytes, under the 64-byte swizzle for
// the transposed tiles of a 16-row stage), in chunks of 32 columns, as TMA
// writes a box of 32 columns; a k8 slice advances a descriptor by 32 bytes.
// Rows past L load as zeros. For .tf32 wgmma takes no transpose: an
// operand whose depth runs along a tile's rows (v in p v, g, q and k in
// the backward's second products) is written transposed into shared memory
// by threads, its rows permuted within groups of 8 (see tf32_frags).
#pragma once

#include "attention_layout.cuh"
#include "hopper.cuh"

namespace tf32x3 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tile plan: head dims 32 and 64 take two consumer warpgroups (BM = 128
// rows a block owns, 384 threads with the splitter warpgroup) and stages of
// BN = 32 streamed rows; head dim 128 one consumer warpgroup (BM = 64, 256
// threads) and BN = 16, which halves the rows to fit.
template <int HD>
struct Cfg {
  static constexpr int NCW = HD == 128 ? 1 : 2;   // consumer warpgroups
  static constexpr int BM = 64 * NCW;             // rows a block owns
  static constexpr int BN = HD == 128 ? 16 : 32;  // rows of a stage
  static constexpr int THREADS = 128 * (NCW + 1);
  static constexpr int RES = BM * HD * 4;         // bytes of a resident tile
  static constexpr int STR = BN * HD * 4;         // bytes of a stage tile, either orientation
};

// A K-major f32 tile of COLS columns: chunks of BOX_C columns, each
// [rows][BOX_C] with RB-byte rows, swizzled in 8-row atoms.
template <int COLS>
struct KTile {
  static constexpr int BOX_C = COLS < 32 ? COLS : 32;
  static constexpr int RB = BOX_C * 4;            // 128 or 64 bytes
  static constexpr int SWZ = RB == 128 ? 1 : 2;   // descriptor swizzle mode
  static constexpr int ATOM = 8 * RB;
  static constexpr int SHIFT = RB == 128 ? 0 : 1;  // row bits that pick the XOR
  static constexpr int MASK = RB / 16 - 1;
  static_assert(RB == 128 || RB == 64, "tiles are 32 or 16 f32 columns wide");

  // byte offset of (row, col) in a [rows][COLS] tile
  __device__ static __forceinline__ uint32_t at(int rows, int row, int col) {
    const int c = col / BOX_C, cc = col % BOX_C;
    return c * rows * RB + row * RB + ((((cc >> 2) ^ (row >> SHIFT)) & MASK) << 4) +
           (cc & 3) * 4;
  }
  // descriptor of rows [row0, row0 + 64) (or all N of a B operand), slice 0
  __device__ static __forceinline__ uint64_t desc(uint32_t tile, int row0) {
    return smem_desc(tile + row0 * RB, 16, ATOM, SWZ);
  }
  // what k8 slice kk of a [rows][COLS] tile adds to its descriptor
  __device__ static __forceinline__ constexpr uint64_t step(int rows, int kk) {
    return (uint64_t)((((kk * 8) / BOX_C) * rows * RB + ((kk * 8) % BOX_C) * 4) >> 4);
  }
};

// Rows [row0, row0 + rows) of one (batch, head) as [rows][HD] in 32-column
// chunks, boxes of `box` rows (`box` divides `rows`).
template <int HD>
__device__ __forceinline__ void tma_rows_f32(uint32_t dst, const CUtensorMap* map, int rows,
                                             int box, int row0, int h, int b, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < HD / 32; ++c)
    for (int r = 0; r < rows; r += box)
      tma_load(dst + (c * rows + r) * 128, map, c * 32, row0 + r, h, b, bar);
}

// The split of raw f32 tiles by the 128 splitter threads, in two halves so
// that a caller can issue every load of a stage before its first store
// (the splitter runs on four warps, one a scheduler: its loads' latency,
// not its bandwidth, bounds it; against a unit at a time, loads first ran
// the backward 15-16 % and the forward 8-9 % faster in an A/B on an H100,
// chip_ab.py). Natural: a tile of BYTES bytes into hi
// and lo tiles of the same layout, 16 bytes a unit, thread tid taking units
// tid, tid + 128, ...
template <int BYTES>
struct Natural {
  static_assert(BYTES % (16 * 128) == 0, "a tile is whole 16-byte units of 128 threads");
  static constexpr int N = BYTES / 16 / 128;  // units a thread
  __device__ static __forceinline__ void load(float4 (&x)[N], uint32_t raw, int tid) {
#pragma unroll
    for (int it = 0; it < N; ++it) x[it] = lds_f32x4(raw + (tid + it * 128) * 16);
  }
  __device__ static __forceinline__ void store(const float4 (&x)[N], uint32_t hi, uint32_t lo,
                                               int tid) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const uint32_t off = (tid + it * 128) * 16;
      const float h0 = tf32_rna(x[it].x), h1 = tf32_rna(x[it].y), h2 = tf32_rna(x[it].z),
                  h3 = tf32_rna(x[it].w);
      sts_f32x4(hi + off, h0, h1, h2, h3);
      sts_f32x4(lo + off, tf32_rna(x[it].x - h0), tf32_rna(x[it].y - h1),
                tf32_rna(x[it].z - h2), tf32_rna(x[it].w - h3));
    }
  }
};

// Transposed: one stage's raw tile ([BN][HD]) into transposed hi and lo
// tiles ([HD][BN]), the rows of each group of 8 at positions kappa(e) = e /
// 2 + 4 (e % 2), 4 columns of one row a unit. A warp takes the 32 rows of
// one 4-column unit (BN = 32): its reads and writes meet no bank twice.
template <int HD>
struct Transposed {
  static constexpr int BN = Cfg<HD>::BN;
  static constexpr int UNITS = BN * HD / 4;
  static_assert(UNITS % 128 == 0, "a tile is whole 4-column units of 128 threads");
  static constexpr int N = UNITS / 128;  // units a thread
  __device__ static __forceinline__ void load(float4 (&x)[N], uint32_t raw, int tid) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int m = tid + it * 128;
      x[it] = lds_f32x4(raw + KTile<HD>::at(BN, m % BN, (m / BN) * 4));
    }
  }
  __device__ static __forceinline__ void store(const float4 (&x)[N], uint32_t hi, uint32_t lo,
                                               int tid) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int m = tid + it * 128;
      const int i = m % BN, col = (m / BN) * 4;
      const int kappa = (i & ~7) | ((i & 7) >> 1) | ((i & 1) << 2);
      const float v[4] = {x[it].x, x[it].y, x[it].z, x[it].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t o = KTile<BN>::at(HD, col + w, kappa);
        const float h = tf32_rna(v[w]);
        sts_f32(hi + o, h);
        sts_f32(lo + o, tf32_rna(v[w] - h));
      }
    }
  }
};

// A raw tile of BYTES bytes at `raw` into its hi half at `hi` (which may be
// `raw`: rounded in place) and its lo half at `lo`.
template <int BYTES>
__device__ __forceinline__ void split_tile(uint32_t raw, uint32_t hi, uint32_t lo, int tid) {
  float4 x[Natural<BYTES>::N];
  Natural<BYTES>::load(x, raw, tid);
  Natural<BYTES>::store(x, hi, lo, tid);
}

// A stage's raw tile into transposed hi and lo tiles.
template <int HD>
__device__ __forceinline__ void split_transposed(uint32_t raw, uint32_t hi, uint32_t lo,
                                                 int tid) {
  float4 x[Transposed<HD>::N];
  Transposed<HD>::load(x, raw, tid);
  Transposed<HD>::store(x, hi, lo, tid);
}

// d = a b^T over the KS k8 slices from k0 of HD columns, 3xTF32, small
// terms first: a_lo b_hi over every slice (the first overwrites d), then
// a_hi b_lo, then a_hi b_hi. a: rows [row0, row0 + 64) of [arows][HD] hi /
// lo tiles; b: the N rows of [N][HD] hi / lo tiles.
template <int HD, int N, int KS = HD / 8>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint32_t ah, uint32_t al, int arows,
                                        int row0, uint32_t bh, uint32_t bl, int k0 = 0) {
  using K = KTile<HD>;
  const uint64_t dah = K::desc(ah, row0), dal = K::desc(al, row0);
  const uint64_t dbh = K::desc(bh, 0), dbl = K::desc(bl, 0);
#pragma unroll
  for (int i = 0; i < KS; ++i)
    wgmma_tf32_ss<N>(d, dal + K::step(arows, k0 + i), dbh + K::step(N, k0 + i), i);
#pragma unroll
  for (int i = 0; i < KS; ++i)
    wgmma_tf32_ss<N>(d, dah + K::step(arows, k0 + i), dbl + K::step(N, k0 + i), 1);
#pragma unroll
  for (int i = 0; i < KS; ++i)
    wgmma_tf32_ss<N>(d, dah + K::step(arows, k0 + i), dbh + K::step(N, k0 + i), 1);
}

// d = a b, 3xTF32 in the same order, a [64][K] from register fragments
// (hi, lo), b the K x N operand as [N][K] hi / lo tiles (K = 8 KS, k
// permuted within groups of 8). The first product overwrites d.
template <int N, int KS>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&ah)[KS][4],
                                        const uint32_t (&al)[KS][4], uint32_t bh, uint32_t bl) {
  using K = KTile<8 * KS>;
  const uint64_t dbh = K::desc(bh, 0), dbl = K::desc(bl, 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) wgmma_tf32_rs<N>(d, al[ks], dbh + K::step(N, ks), ks);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) wgmma_tf32_rs<N>(d, ah[ks], dbl + K::step(N, ks), 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) wgmma_tf32_rs<N>(d, ah[ks], dbh + K::step(N, ks), 1);
}

// acc += part, in f32 with round-to-nearest: the tensor core's own
// accumulation rounds each instruction's sum toward zero, a bias that over
// a whole row of stages (hundreds of instructions) would reach 1e-5, so
// each stage's product is summed alone and added here.
template <int M>
__device__ __forceinline__ void promote(float (&acc)[M], const float (&part)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] += part[i];
}

// The hi and lo tf32 A fragments of an f32 accumulator tile [64 x N], k
// permuted within each group of 8. In an 8-column group of an m64nN f32
// accumulator a thread holds columns 2c and 2c + 1 (c = lane % 4); the
// m64k8 tf32 A fragment wants columns c and c + 4. The k index is summed
// over, so the kernels permute it within each group of 8: position kappa
// of a group in the transposed B tiles holds row sigma(kappa) = 0, 2, 4, 6,
// 1, 3, 5, 7 of the group, and the accumulator registers (2c, 2c + 1) of
// rows r, r + 8 become the fragment (a[0], a[2], a[1], a[3]) with no
// shuffle: slice j takes registers 4 j, 4 j + 2, 4 j + 1, 4 j + 3.
template <int N>
__device__ __forceinline__ void tf32_frags(const float (&x)[N / 2], uint32_t (&hi)[N / 8][4],
                                           uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float v = x[4 * j + ((u & 1) << 1) + (u >> 1)];
      const float h = tf32_rna(v);
      hi[j][u] = __float_as_uint(h);
      lo[j][u] = __float_as_uint(tf32_rna(v - h));
    }
}

// Write a warpgroup's [64 x HD] accumulator, times scale[u] on rows r + 8 u
// (see below), as f32 rows row0 + (0..63) of a row view with stride `ld`,
// rows below L only.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float* dst, long long ld,
                                           int row0, int L, const float (&scale)[2]) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = row0 + (t / 32) * 16 + lane / 4, c = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      if (row < L)
        *reinterpret_cast<float2*>(dst + (long long)row * ld + 8 * j + c) =
            make_float2(acc[4 * j + 2 * half] * scale[half],
                        acc[4 * j + 2 * half + 1] * scale[half]);
    }
}

// A 4-D (hd, L, H, B) f32 map of [B, H, L, hd] rows with layout `lay`:
// boxes of 32 columns x BN rows under the 128-byte swizzle; rows past L
// read as zeros, and no box crosses into the next head's or batch's rows.
template <int HD>
inline bool encode_rows_f32(CUtensorMap* map, const float* base, AttnLayout lay, int B, int L,
                            int H) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)lay.row * 4, (cuuint64_t)lay.h * 4,
                                 (cuuint64_t)lay.b * 4};
  const cuuint32_t boxes[4] = {32, (cuuint32_t)Cfg<HD>::BN, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4, dims, strides, boxes,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// Raise a kernel's dynamic shared-memory limit to its one size, once.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace tf32x3
