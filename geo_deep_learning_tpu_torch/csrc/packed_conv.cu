// K11: W-packed 3x3 conv with the BatchNorm-train statistics of its output.
//
// Replaces geo_deep_learning_tpu/ops/pallas/packed_conv.py::_kernel (via
// packed_conv_bn_stats). Input x is the W-packed [B, H, Wp, 128] bf16 tensor
// (pixel pairs of a 64-channel map side by side); kp the [3, 3, 128, 128]
// block-packed kernel (HWIO). Per leg:
//   - optional prologue relu(x * scale + shift) per packed slot, rounded
//     back to bf16 (two f32 roundings, as the plain version does them);
//   - a zero halo AFTER the prologue: out-of-range taps read 0, not
//     relu(shift);
//   - the SAME 3x3 conv of the packed tensor, bf16 products with f32
//     accumulation; y stored in bf16;
//   - sum(y) and sum(y^2) per packed slot over (B, H, Wp), taken from the
//     f32 accumulator before y is rounded.
//
// Bound on the H100: at the UNet++ finest column ([32, 256, 256, 64]
// unpacked) the unpacked conv is 154.6 GFLOP (0.156 ms at 989 TFLOP/s) and
// its bf16 input and output 2 x 268.4 MB (0.160 ms at 3.35 TB/s): bytes, by
// a hair. The packed kernel multiplies the block kernel's structural zeros
// too (309 GFLOP), so at the tensor-core peak it would take twice its bound.
//
// Design: an implicit GEMM, M = B*H*Wp packed pixels, N = 128 output slots,
// K = 9 taps x 128 channels. One block of 8 warps owns a tile of 4 rows x 32
// packed columns (M = 128). It stages the (4+2) x (32+2) halo tile once,
// applying the prologue on the way in and zero-filling what lies outside the
// image, then loops over the 9 taps: each tap's 128 x 128 weights go to
// shared memory and every warp runs its 32 x 64 output patch on tensor cores
// (nvcuda::wmma m16n16k16, bf16 in, f32 out). A fragment's 16 rows are 16
// neighbouring pixels of one tile row, so a tap's A operand is the staged
// tile read at a shifted pixel offset with the same row stride: no im2col
// buffer. The f32 results go to shared memory (aliasing the consumed input
// and weights), from where the block writes y in bf16 and one row of
// per-slot partial sums, in a fixed order. A second kernel sums the partial
// rows in a fixed order, so the statistics are equal run to run (no
// atomics). Any H and Wp: ragged tiles are masked on load and store.
// Simple and right first: no cp.async/TMA pipelining of the weights, no
// wgmma, and the zero blocks of kp are multiplied like any other.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int PC_C = 128;                       // packed channels (2 slots x 64)
constexpr int PC_TH = 4;                        // tile rows
constexpr int PC_TW = 32;                       // tile packed columns
constexpr int PC_M = PC_TH * PC_TW;             // pixels per tile
constexpr int PC_HALO_W = PC_TW + 2;
constexpr int PC_PIX = (PC_TH + 2) * PC_HALO_W; // staged pixels
constexpr int PC_VPP = PC_C / 8;                // 16-byte vectors per pixel
// bf16 row strides of 144 elements (288 bytes): every pixel row starts on a
// 32-byte boundary, as wmma's loads require at any pixel offset
constexpr int PC_LDA = PC_C + 16;
constexpr int PC_LDB = PC_C + 16;
constexpr int PC_LDS = PC_C + 4;                // f32 staging stride
constexpr int PC_THREADS = 256;
constexpr size_t PC_SMEM_MAIN = sizeof(bf16) * (PC_PIX * PC_LDA + PC_C * PC_LDB);
// scale, shift and the two rows that combine the block's half sums
constexpr size_t PC_SMEM = PC_SMEM_MAIN + sizeof(float) * 4 * PC_C;
static_assert(sizeof(float) * PC_M * PC_LDS <= PC_SMEM_MAIN, "the f32 staging must fit");
static_assert(PC_THREADS == 2 * PC_C, "two threads per output slot in the statistics");

__global__ void __launch_bounds__(PC_THREADS, 2)
packed_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kp,
                   const float* __restrict__ scale, const float* __restrict__ shift,
                   bf16* __restrict__ y, float* __restrict__ part, int H, int Wp,
                   int tiles_h, int tiles_w, int apply_bn_relu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sIn = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sIn + PC_PIX * PC_LDA;
  float* sStage = reinterpret_cast<float*>(smem_raw);  // after the last tap
  float* sScale = reinterpret_cast<float*>(smem_raw + PC_SMEM_MAIN);
  float* sShift = sScale + PC_C;
  float* sComb = sShift + PC_C;

  const int tile = blockIdx.x;
  const int tw = tile % tiles_w;
  const int th = (tile / tiles_w) % tiles_h;
  const int b = tile / (tiles_w * tiles_h);
  const int h0 = th * PC_TH, w0 = tw * PC_TW;
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long image = (long long)H * Wp * PC_C;

  if (tid < PC_C && apply_bn_relu) {
    sScale[tid] = scale[tid];
    sShift[tid] = shift[tid];
  }
  __syncthreads();

  // stage the halo tile, prologue applied, zeros outside the image
  const bf16* xb = x + b * image;
  for (int i = tid; i < PC_PIX * PC_VPP; i += PC_THREADS) {
    const int p = i / PC_VPP, v = i % PC_VPP;
    const int hh = h0 + p / PC_HALO_W - 1, ww = w0 + p % PC_HALO_W - 1;
    __align__(16) bf16 e[8];
    *reinterpret_cast<uint4*>(e) = make_uint4(0u, 0u, 0u, 0u);
    if (hh >= 0 && hh < H && ww >= 0 && ww < Wp) {
      *reinterpret_cast<uint4*>(e) =
          *reinterpret_cast<const uint4*>(xb + ((long long)hh * Wp + ww) * PC_C + v * 8);
      if (apply_bn_relu) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = v * 8 + u;
          const float t = __fadd_rn(__fmul_rn(__bfloat162float(e[u]), sScale[c]), sShift[c]);
          e[u] = __float2bfloat16(t < 0.f ? 0.f : t);
        }
      }
    }
    *reinterpret_cast<uint4*>(sIn + p * PC_LDA + v * 8) = *reinterpret_cast<const uint4*>(e);
  }

  // warp (wm, wn): tile row wm, output slots [64 wn, 64 wn + 64)
  const int wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[f][j], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
    __syncthreads();  // the previous tap's weights are consumed (tap 0: the tile is staged)
    const bf16* kt = kp + (long long)tap * PC_C * PC_C;
    for (int i = tid; i < PC_C * PC_VPP; i += PC_THREADS) {
      const int r = i / PC_VPP, v = i % PC_VPP;
      *reinterpret_cast<uint4*>(sW + r * PC_LDB + v * 8) =
          *reinterpret_cast<const uint4*>(kt + r * PC_C + v * 8);
    }
    __syncthreads();
    // output pixel (wm, c) reads staged pixel (wm + dh, c + dw)
    const bf16* aBase = sIn + ((wm + dh) * PC_HALO_W + dw) * PC_LDA;
#pragma unroll
    for (int kk = 0; kk < PC_C / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int f = 0; f < 2; ++f)
        wmma::load_matrix_sync(a[f], aBase + f * 16 * PC_LDA + kk * 16, PC_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, sW + kk * 16 * PC_LDB + wn * 64 + j * 16, PC_LDB);
        wmma::mma_sync(acc[0][j], a[0], bw, acc[0][j]);
        wmma::mma_sync(acc[1][j], a[1], bw, acc[1][j]);
      }
    }
  }
  __syncthreads();  // every warp is done with the tile and weights the staging aliases
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sStage + (wm * PC_TW + f * 16) * PC_LDS + wn * 64 + j * 16,
                              acc[f][j], PC_LDS, wmma::mem_row_major);
  __syncthreads();

  bf16* yb = y + b * image;
  for (int i = tid; i < PC_M * PC_VPP; i += PC_THREADS) {
    const int m = i / PC_VPP, v = i % PC_VPP;
    const int hh = h0 + m / PC_TW, ww = w0 + m % PC_TW;
    if (hh < H && ww < Wp)
      store_vec<bf16>(yb + ((long long)hh * Wp + ww) * PC_C + v * 8, sStage + m * PC_LDS + v * 8);
  }

  if (part != nullptr) {
    // slot n: thread n sums the tile's first 64 pixels, thread 128 + n the
    // rest; the block's row is their sum, always in this order
    const int n = tid & (PC_C - 1), half = tid / PC_C;
    float s = 0.f, sq = 0.f;
    for (int m = half * (PC_M / 2); m < (half + 1) * (PC_M / 2); ++m) {
      const int hh = h0 + m / PC_TW, ww = w0 + m % PC_TW;
      if (hh < H && ww < Wp) {
        const float v = sStage[m * PC_LDS + n];
        s += v;
        sq += v * v;
      }
    }
    if (half) {
      sComb[n] = s;
      sComb[PC_C + n] = sq;
    }
    __syncthreads();
    if (!half) {
      float* row = part + (long long)blockIdx.x * 2 * PC_C;
      row[n] = s + sComb[n];
      row[PC_C + n] = sq + sComb[PC_C + n];
    }
  }
}

constexpr int CS_WARPS = 32;

// out[c] = sum over r of part[r, c], in a fixed order: warp w sums rows
// w, w + 32, ... of 32 neighbouring columns, then warp 0 sums the 32 warps.
__global__ void __launch_bounds__(CS_WARPS * 32)
column_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, int cols) {
  __shared__ float s[CS_WARPS][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int r = warp; r < rows; r += CS_WARPS) acc += part[(long long)r * cols + col];
  }
  s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.f;
    for (int w = 0; w < CS_WARPS; ++w) t += s[w][lane];
    out[col] = t;
  }
}

// Rows of the partial sums (= conv blocks) for a [B, H, Wp, 128] input, or -1
// if the grid would exceed 2^31 - 1 blocks.
extern "C" int gdl_packed_conv_blocks(int B, int H, int Wp) {
  if (B < 1 || H < 1 || Wp < 1) return -1;
  const long long n = (long long)B * ((H + PC_TH - 1) / PC_TH) * ((Wp + PC_TW - 1) / PC_TW);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// x, y: [B, H, Wp, 128] bf16, contiguous, 16-byte aligned; kp: [3, 3, 128,
// 128] bf16; scale, shift: [128] f32 (read only with apply_bn_relu); part:
// [blocks, 256] f32 scratch with blocks = gdl_packed_conv_blocks(B, H, Wp) and
// stats: [2, 128] f32, both null to skip the statistics.
extern "C" int gdl_packed_conv_bn_stats(const void* x, const void* kp, const void* scale,
                                        const void* shift, void* y, void* part, void* stats,
                                        int B, int H, int Wp, int blocks, int apply_bn_relu,
                                        void* stream) {
  if (blocks < 1 || blocks != gdl_packed_conv_blocks(B, H, Wp) ||
      (part == nullptr) != (stats == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(packed_conv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PC_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(packed_conv_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  packed_conv_kernel<<<(unsigned)blocks, PC_THREADS, PC_SMEM, st>>>(
      (const bf16*)x, (const bf16*)kp, (const float*)scale, (const float*)shift, (bf16*)y,
      (float*)part, H, Wp, (H + PC_TH - 1) / PC_TH, (Wp + PC_TW - 1) / PC_TW, apply_bn_relu);
  e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return (int)e;
  column_sum_kernel<<<(2 * PC_C + 31) / 32, CS_WARPS * 32, 0, st>>>(
      (const float*)part, (float*)stats, blocks, 2 * PC_C);
  return (int)cudaGetLastError();
}
