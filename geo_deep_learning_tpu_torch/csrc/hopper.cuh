// Hopper building blocks shared by the wgmma kernels: the attention
// forward K4/K8 (attention_kernels.cuh) and backward K7/K9
// (attention_bwd_kernels.cuh), the spatial-reduction attention K10
// (sr_attention.cu) and the W-packed conv K11 (packed_conv.cu); the
// LayerNorm kernels K2/K3/K5/K6 (layernorm.cu) and the normalize K1
// (preprocess.cu) take the mbarriers, the 1-D bulk copies and the host's
// block capacity. sm_90a only: wgmma and setmaxnreg exist for no other
// target.
//
// - mbarriers, with a wait that traps after 10 s so a lost load fails the
//   launch instead of hanging the card;
// - TMA loads of 2-D and 4-D tensor maps, and the host lookup of
//   cuTensorMapEncodeTiled; 1-D bulk copies of contiguous bytes into
//   shared memory, optionally with an L2 evict-first hint;
// - wgmma shared-memory descriptors of 64- and 128-byte swizzled tiles as
//   TMA writes them, in both operand roles (K-major, and MN-major through
//   the transpose bit);
// - wgmma m64nNk16 bf16 -> f32 with both operands from shared memory
//   (wgmma_ss) or A from registers (wgmma_rs), fences, commit and wait;
// - register helpers: bf16 packing, the A fragments of an accumulator
//   tile, exp2, ldmatrix;
// - host: the SMs x resident blocks of a persistent kernel, found once and
//   kept.
#pragma once

#include <cuda.h>

#include <mutex>
#include <vector>

#include "common.cuh"

// ---------------------------------------------------------------------------
// Shared-memory addresses and mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the phase of parity `parity` has completed. A wait of seconds
// means a lost load or a miscounted barrier: trap, so that the launch fails
// with an error the wrapper raises instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's generic shared-memory writes before later accesses by
// the async proxy (TMA, wgmma) to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads: wait,
// or only arrive.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA

// One box of a 4-D tensor map into shared memory; coordinates are signed,
// and what lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// One box of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A contiguous span of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, no tensor map; its bytes count
// towards the transaction of the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// An L2 policy that evicts first the lines it tags: for inputs read once,
// so they do not push out what the next kernel reads.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// bulk_load_1d with an L2 cache policy (l2_evict_first) on the source.
__device__ __forceinline__ void bulk_load_1d_hint(uint32_t dst, const void* src, uint32_t bytes,
                                                  uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma shared-memory descriptors

// Start address, leading and stride byte offsets (16-byte units), swizzle
// mode in bits 62-63 (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

// How TMA lays out a tile of rows of COLS bf16 columns: BOX_C-column chunks
// (the swizzle span: 64 columns under the 128-byte swizzle, 32 under the
// 64-byte one), each chunk [rows][BOX_C] with 8-row atoms of ATOM bytes.
template <int COLS>
struct Span {
  static constexpr int BOX_C = COLS < 64 ? COLS : 64;
  static constexpr int NCH = COLS / BOX_C;         // column chunks of a row
  static constexpr int RB = BOX_C * 2;             // bytes of a chunk's row
  static constexpr int SWZ = RB == 128 ? 1 : 2;    // descriptor layout: 128- or 64-byte swizzle
  static constexpr int ATOM = 8 * RB;              // bytes of 8 swizzled rows
  static constexpr CUtensorMapSwizzle TMA_SWZ =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// K-major operand: rows [row0, row0 + 64) (or all N) of a [rows][COLS]
// tile, depth slice 0; 8-row groups are ATOM bytes apart. Slice kk
// (columns 16 kk .. 16 kk + 15) adds k_step to the start address: 32 bytes
// within a swizzled row, a chunk of rows * RB bytes past every BOX_C columns.
template <int COLS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0) {
  using S = Span<COLS>;
  return smem_desc(tile + row0 * S::RB, 16, S::ATOM, S::SWZ);
}
template <int COLS>
__device__ __forceinline__ constexpr uint64_t k_step(int rows, int kk) {
  using S = Span<COLS>;
  return (uint64_t)((((kk * 16) / S::BOX_C) * rows * S::RB + ((kk * 16) % S::BOX_C) * 2) >> 4);
}

// MN-major operand (transposed B): all COLS columns of a [rows][COLS] tile
// as N, its rows as the depth; 8-row groups along the depth are ATOM bytes
// apart (SBO), BOX_C-column chunks along N rows * RB apart (LBO). Depth
// slice ks (rows 16 ks .. 16 ks + 15) adds mn_step.
template <int COLS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows) {
  using S = Span<COLS>;
  return smem_desc(tile, rows * S::RB, S::ATOM, S::SWZ);
}
template <int COLS>
__device__ __forceinline__ constexpr uint64_t mn_step(int ks) {
  return (uint64_t)((ks * 16 * Span<COLS>::RB) >> 4);
}

// ---------------------------------------------------------------------------
// wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of wgmma registers across this
// point (accumulators, or A fragments that an asynchronous wgmma still
// reads: fenced after its wait, they stay live and unreused until then).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) asm volatile("" : "+r"(r[i][u])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 accumulators; A and B
// from shared memory, both K-major.
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] B[16 x N]; A from registers (four bf16 pairs a
// thread), B from shared memory MN-major.
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Registers

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 A fragments of an f32 accumulator tile [64 x N]: slice s takes
// accumulator registers 8 s .. 8 s + 7, in order.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s)
#pragma unroll
    for (int u = 0; u < 4; ++u) a[s][u] = pack_bf16(x[8 * s + 2 * u], x[8 * s + 2 * u + 1]);
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register i holds matrix i. Matrices (rows 0-7,
// k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) make a
// warp's 16 rows of a wgmma A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---------------------------------------------------------------------------
// Host: tensor maps

typedef CUresult (*TmaEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver call, through the runtime's entry-point
// query (the library links no libcuda).
inline TmaEncodeFn tma_encoder() {
  static const TmaEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TmaEncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first): extents `dims`,
// byte strides of dimensions 1.. `strides`, boxes `box`; what lies outside
// the extents reads as zeros.
inline bool encode_bf16(CUtensorMap* map, const void* base, cuuint32_t rank,
                        const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const TmaEncodeFn encode = tma_encoder();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current card's number of SMs, for grids of one block an SM; 0 if the
// runtime cannot say.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

constexpr int SMEM_MAX_BYTES = 227 * 1024;  // dynamic shared memory a block can have

// SMs x resident blocks of `kernel` with `threads` threads and `smem` bytes
// of dynamic shared memory on the current device: found at the first
// launch of a (kernel, device, size) and kept, since neither changes
// between calls, so a launch costs the host a table lookup. The kernel's
// shared-memory attribute is raised to the largest size it has been
// asked for there and never lowered, so every kept size stays launchable.
// 0 with *err set if the launch cannot be made.
inline long long block_capacity(const void* kernel, int threads, size_t smem, int* err) {
  struct Seen {
    const void* kernel;
    int dev;
    size_t smem;
    long long cap;
  };
  static std::mutex lock;
  static std::vector<Seen> seen;
  *err = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) {
    *err = (int)e;
    return 0;
  }
  std::lock_guard<std::mutex> hold(lock);
  for (const Seen& c : seen)
    if (c.kernel == kernel && c.dev == dev && c.smem == smem) return c.cap;
  if (smem > (size_t)SMEM_MAX_BYTES) {
    *err = (int)cudaErrorInvalidValue;
    return 0;
  }
  size_t top = smem;
  for (const Seen& c : seen)
    if (c.kernel == kernel && c.dev == dev && c.smem > top) top = c.smem;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)top);
  int occ = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
  const long long cap = (long long)sm_count() * occ;
  if (e != cudaSuccess || cap < 1) {
    *err = (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    return 0;
  }
  seen.push_back({kernel, dev, smem, cap});
  return cap;
}
