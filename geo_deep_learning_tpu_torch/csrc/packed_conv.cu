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
// a hair. The block kernel kp of pack_w_kernel holds the unpacked kernel
// once and zeros elsewhere: of its 36 64x64 blocks ((dh, dw) x in-slot x
// out-slot) only 18 are non-zero (dw = 0 only in-slot 1 -> out-slot 0, dw =
// 2 only in-slot 0 -> out-slot 1), so multiplying them all would double
// the work to 309 GFLOP.
//
// Design: an implicit GEMM on wgmma, M = pixels, N = 64 output channels
// (one out-slot) a warpgroup, K = 9 taps x 128 channels, over the blocks
// of kp that hold a non-zero.
//   - packed_conv_flags_kernel, a pre-pass in the same call, flags the
//     non-zero 64x64 blocks of kp (no host sync). The main kernel takes
//     exactly those: a zero block costs no load and no product, and any
//     kp, dense or block-structured, gives the same function.
//   - packed_conv_wgmma_kernel: one block of four warpgroups an SM, in two
//     pairs. A pair walks its own tiles of 4 rows x 16 packed columns (64
//     pixels, one wgmma M) in a fixed order (tile blockIdx + i * gridDim,
//     so statistics and y are equal run to run); in a pair, warpgroup o
//     computes out-slot o of the tile, over its own flagged blocks, so
//     each runs one uniform loop of m64n64k16 products (a product on a
//     divergent path makes ptxas serialize every wgmma of the kernel).
//     No producer warp: 16 warps hold 128 registers each (acc, A, the
//     running statistics), and a 17th would force a smaller budget.
//   - Loads by TMA. A pair's thread 0 loads its next 6 x 18-pixel halo
//     tile (two 64-channel boxes, signed coordinates, zeros outside the
//     image) as soon as both its warpgroups' last ldmatrix of the tile is
//     done, under the epilogue and the other pair's work. Thread 0 of the
//     block loads the flagged weight blocks (64 x 64, 8 KB each) once:
//     they stay resident when they fit (<= 18 blocks, 144 KB: every kp
//     pack_w_kernel makes), else they stream through the same 18 slots as
//     a ring, round after round, in the order of their ranks, every
//     warpgroup taking its own and freeing the others, thread 0 refilling
//     a slot once all four are done with it. Shared memory: 144 KB of
//     weights beside one 28 KB halo tile a pair (single-buffered; the two
//     pairs overlap one's loads with the other's products).
//   - The BN prologue runs in shared memory, split over the pair's 256
//     threads, on pixels inside the image only, so TMA's zero halo stays 0
//     and does not become relu(shift); fence.proxy.async then orders those
//     generic writes before the async proxy's next load into the tile.
//   - Tap shifts: a tap's A operand is the halo tile shifted by (dh, dw)
//     pixels, and a 128-byte-swizzled wgmma descriptor cannot start one
//     pixel into a swizzle atom. So A comes from registers (design (b)):
//     ldmatrix reads a warp's 16 pixels of a tap at any pixel offset
//     (undoing the swizzle in its addresses, conflict-free) straight into
//     the A fragment of a register-A wgmma, with the weight block as the
//     MN-major B. Per-dw TMA copies (design (a)) would need three tiles'
//     room beside the resident weights.
//   - Epilogue from the f32 accumulator registers: y in bf16 (pixels inside
//     the image), and per-thread running sums and sums of squares of its
//     columns over all its tiles, reduced at the end by shuffles, then
//     across the 8 warps of each out-slot in a fixed order, into one
//     partial row per block; column_sum_kernel sums the rows in a fixed
//     order: no atomics.
// The flags live in a device global written by the pre-pass and read by
// the main kernel of the same call, so two calls must not run at once on
// two streams of one card (the port issues every launch on the current
// stream).
#include <algorithm>

#include "hopper.cuh"

constexpr int PC_C = 128;  // packed channels (2 slots x 64)

struct PcCfg {
  static constexpr int TH = 4, TW = 16;             // tile rows, packed columns: 64 pixels
  static constexpr int HH = TH + 2, HW = TW + 2;    // halo tile
  static constexpr int HPIX = HH * HW;
  static constexpr int HALF_BYTES = HPIX * 128;     // one 64-channel half of the halo tile
  static constexpr int HALF = (HALF_BYTES + 1023) / 1024 * 1024;  // the 128-byte swizzle's period
  static constexpr int TILE = 2 * HALF;
  static constexpr int WB = 64 * 64 * 2;            // a weight block
  static constexpr int NBLK = 36;                   // kp's 64 x 64 blocks
  static constexpr int WSLOTS = 18;                 // resident weight slots
  static constexpr int PAIRS = 2;                   // halo tiles in flight, a warpgroup pair each
  static constexpr int THREADS = 256 * PAIRS;       // warpgroup 2 p + o: tile pair p, out-slot o
  // smem: the pairs' halo tiles (at the end the statistics' warp rows),
  // weight slots, scale and shift, block lists, mbarriers
  static constexpr int OFF_W = PAIRS * TILE;
  static constexpr int OFF_VEC = OFF_W + WSLOTS * WB;
  static constexpr int OFF_SLOT = OFF_VEC + 2 * PC_C * 4;
  static constexpr int OFF_BAR = OFF_SLOT + (2 * NBLK + 4) * 4;
  static constexpr int NBAR = PAIRS + 2 * WSLOTS;
  static constexpr size_t SMEM = OFF_BAR + NBAR * 8 + 1024;  // + base alignment
};

// Block f = ((dh * 3 + dw) * 2 + in-slot) * 2 + out-slot of kp holds a
// non-zero value (written by the pre-pass of each call).
__device__ int pc_flags[PcCfg::NBLK];

// One block per weight block: 64 rows x 64 columns of kp viewed [1152, 128].
__global__ void __launch_bounds__(256) packed_conv_flags_kernel(const bf16* __restrict__ kp) {
  const int f = blockIdx.x;
  const int row0 = (f >> 2) * PC_C + ((f >> 1) & 1) * 64, col0 = (f & 1) * 64;
  uint32_t nz = 0;
#pragma unroll
  for (int v = threadIdx.x; v < 64 * 8; v += 256) {
    const uint4 d =
        *reinterpret_cast<const uint4*>(kp + (row0 + v / 8) * PC_C + col0 + (v % 8) * 8);
    nz |= (d.x | d.y | d.z | d.w) & 0x7fff7fffu;  // -0 is a zero
  }
  const int any = __syncthreads_or(nz != 0);
  if (threadIdx.x == 0) pc_flags[f] = any;
}

// What a warpgroup needs to run its blocks of one tile.
struct PcGroups {
  uint32_t tile, wslots, wfull, wempty;  // smem: halo tile, weight slot 0, their barriers 0
  int pos0;                              // ring position of the round's first block
  int warp, l_px, l_kc;                  // ldmatrix: tile row, this lane's pixel and chunk
  bool refill;                           // this thread refills freed ring slots
  int fills, nblk;                       // ring positions in all; blocks a round
  const int* blk;                        // rank -> block
  const CUtensorMap* tw;                 // the weight map
};

// Weight block f of kp into a slot: TMA of its 64 x 64 box.
__device__ __forceinline__ void load_w(const CUtensorMap* tw, uint32_t slot, uint32_t bar, int f) {
  mbar_arrive_tx(bar, PcCfg::WB);
  tma_load_2d(slot, tw, (f & 1) * 64, (f >> 2) * 128 + ((f >> 1) & 1) * 64, bar);
}

// The A fragments of block f's group (dh, dw, in-slot) = f / 2 for this
// warp's 16 pixels: the halo tile at the tap's pixel offset, 4 slices of
// 16 channels, each by one ldmatrix.x4 that undoes the 128-byte swizzle.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const PcGroups& g, int f) {
  const int grp = f >> 1;
  const int dh = grp / 6, dw = (grp >> 1) % 3, in = grp & 1;
  const int hp = (g.warp + dh) * PcCfg::HW + g.l_px + dw;
  const uint32_t row = g.tile + in * PcCfg::HALF + hp * 128;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(a[ks], row + (((2 * ks + g.l_kc) ^ (hp & 7)) << 4));
}

// The 4 products of a block into acc: A from registers, the block's slot
// as the MN-major B.
__device__ __forceinline__ void block_products(float (&acc)[32], const uint32_t (&a)[4][4],
                                               uint32_t slot) {
  const uint64_t b = desc_mn<64>(slot, 64);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_rs<64>(acc, a[ks], b + mn_step<64>(ks), 1);
}

// Ring mode: wait for stream position p's slot, and free it once done;
// the refilling thread then loads position p + WSLOTS into it as soon as
// every warpgroup has freed it.
__device__ __forceinline__ void ring_wait(const PcGroups& g, int p) {
  mbar_wait(g.wfull + (p % PcCfg::WSLOTS) * 8, (p / PcCfg::WSLOTS) & 1);
}
__device__ __forceinline__ void ring_free(const PcGroups& g, int p) {
  const int s = p % PcCfg::WSLOTS;
  mbar_arrive(g.wempty + s * 8);
  const int q = p + PcCfg::WSLOTS;
  if (g.refill && q < g.fills) {
    mbar_wait(g.wempty + s * 8, (p / PcCfg::WSLOTS) & 1);
    load_w(g.tw, g.wslots + s * PcCfg::WB, g.wfull + s * 8, g.blk[q % g.nblk]);
  }
}

// This warpgroup's blocks of one tile (own: their ranks, in order), each
// as ldmatrix of its A fragments, then its 4 products as one commit group.
// Resident weights: slot = rank, a loop with no branch (one with the
// streamed path's branches in it ran 5 % slower). Streamed weights: every
// block of the round is taken in order, the warpgroup's own multiplied,
// the others only freed.
__device__ __forceinline__ void own_blocks(const PcGroups& g, bool ring, const int* own, int n,
                                           float (&acc)[32]) {
  uint32_t a[4][4];
  if (!ring) {
    for (int i = 0; i < n; ++i) {
      load_a(a, g, g.blk[own[i]]);
      wg_fence();
      block_products(acc, a, g.wslots + own[i] * PcCfg::WB);
      wg_commit();
      wg_wait<0>();
    }
    reg_fence(acc);
    return;
  }
  int q = 0;  // the round's next rank to take
  for (int i = 0; i < n; ++i) {
    const int r = own[i];
    for (; q < r; ++q) {
      ring_wait(g, g.pos0 + q);
      ring_free(g, g.pos0 + q);
    }
    const int p = g.pos0 + r;
    ring_wait(g, p);
    load_a(a, g, g.blk[r]);
    wg_fence();
    block_products(acc, a, g.wslots + (p % PcCfg::WSLOTS) * PcCfg::WB);
    wg_commit();
    wg_wait<0>();
    ring_free(g, p);
    q = r + 1;
  }
  for (; q < g.nblk; ++q) {
    ring_wait(g, g.pos0 + q);
    ring_free(g, g.pos0 + q);
  }
  reg_fence(acc);
}

// One reduce-scatter step over lane bit N (16, 8, 4): values [0, N) and
// [N, 2N); a lane keeps the half its bit selects and adds its partner's.
template <int N>
__device__ __forceinline__ void reduce_half(float (&v)[32], int lane) {
  const bool upper = (lane & N) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? v[i] : v[i + N];
    const float keep = upper ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

// This warpgroup's out-slot of a finished tile from its accumulator (rows
// r = 16 warp + lane / 4 and r + 8 of the tile's 64 pixels, columns 8 j +
// c2, c2 + 1): y in bf16 for pixels inside the image, and this thread's
// running sums (st[2 j + e]) and sums of squares (st[16 + 2 j + e]) of its
// columns, from the f32 values.
__device__ __forceinline__ void tile_out(const float (&acc)[32], float (&st)[32], bf16* y0, int H,
                                         int Wp, int h0, int w0, int t) {
  const int warp = t / 32, lane = t % 32, c2 = (lane % 4) * 2;
  const int hh = h0 + warp, ww = w0 + lane / 4;
  const bool in0 = hh < H && ww < Wp, in1 = hh < H && ww + 8 < Wp;
  bf16* yp = y0 + ((long long)hh * Wp + ww) * PC_C + c2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (in0) *reinterpret_cast<uint32_t*>(yp + 8 * j) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (in1)
      *reinterpret_cast<uint32_t*>(yp + 8 * PC_C + 8 * j) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = in0 ? acc[4 * j + e] : 0.f, a1 = in1 ? acc[4 * j + 2 + e] : 0.f;
      st[2 * j + e] += a0 + a1;
      st[16 + 2 * j + e] += a0 * a0 + a1 * a1;
    }
  }
}

// The running statistics summed over the 8 lanes of this lane's column
// group c2 = 2 (lane % 4), by reduce-scatter: at each step a lane keeps
// half its values and adds its partner's copy of them, so lane 4 g + c
// ends with st[0 .. 3] = the group's values 4 g .. 4 g + 3. The order is
// fixed: equal run to run.
__device__ __forceinline__ void reduce_stats(float (&st)[32], int lane) {
  reduce_half<16>(st, lane);
  reduce_half<8>(st, lane);
  reduce_half<4>(st, lane);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// The BN prologue on a halo tile, in place, by the 256 threads of a pair:
// per 64-channel half, pixels x 8 vectors of 8 channels; a warp covers 4
// neighbouring pixels (512 bytes), four vectors a thread at a time (loads
// first, then the arithmetic). Pixels outside the image keep TMA's zeros:
// the halo is 0 after the prologue. Only a tile whose halo crosses the
// image border checks its pixels.
__device__ __forceinline__ void prologue(uint32_t tb, const float* sScale, const float* sShift,
                                         int pt, int h0, int w0, int H, int Wp) {
  using C = PcCfg;
  constexpr int NV = C::HPIX * 8, BATCH = 4;
  const int j = pt & 7;  // the thread's 8 channels within each half
  const bool edge = h0 == 0 || w0 == 0 || h0 + C::TH >= H || w0 + C::TW >= Wp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sc[8], sh[8];
#pragma unroll
    for (int u = 0; u < 8; u += 4) {
      const float4 a = *reinterpret_cast<const float4*>(sScale + half * 64 + j * 8 + u);
      const float4 c = *reinterpret_cast<const float4*>(sShift + half * 64 + j * 8 + u);
      sc[u] = a.x, sc[u + 1] = a.y, sc[u + 2] = a.z, sc[u + 3] = a.w;
      sh[u] = c.x, sh[u + 1] = c.y, sh[u + 2] = c.z, sh[u + 3] = c.w;
    }
    for (int v0 = pt; v0 < NV; v0 += BATCH * 256) {
      uint32_t addr[BATCH];
      bool ok[BATCH];
      uint4 d[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int px = (v0 + q * 256) >> 3;
        ok[q] = v0 + q * 256 < NV &&
                (!edge || (h0 - 1 + px / C::HW >= 0 && h0 - 1 + px / C::HW < H &&
                           w0 - 1 + px % C::HW >= 0 && w0 - 1 + px % C::HW < Wp));
        addr[q] = tb + half * C::HALF + px * 128 + ((j ^ (px & 7)) << 4);
        if (ok[q]) d[q] = lds128(addr[q]);
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        if (!ok[q]) continue;
        uint32_t* e = reinterpret_cast<uint32_t*>(&d[q]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float x0 = __fadd_rn(__fmul_rn(__uint_as_float(e[u] << 16), sc[2 * u]), sh[2 * u]);
          const float x1 = __fadd_rn(
              __fmul_rn(__uint_as_float(e[u] & 0xffff0000u), sc[2 * u + 1]), sh[2 * u + 1]);
          e[u] = pack_bf16(x0 < 0.f ? 0.f : x0, x1 < 0.f ? 0.f : x1);  // relu, NaN kept
        }
        sts128(addr[q], d[q]);
      }
    }
  }
}

__global__ void __launch_bounds__(PcCfg::THREADS, 1)
packed_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const float* __restrict__ scale, const float* __restrict__ shift,
                         bf16* __restrict__ y, float* __restrict__ part, int H, int Wp,
                         int tiles_h, int tiles_w, int ntiles, int apply_bn_relu) {
  using C = PcCfg;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same bytes, generic
  float* sScale = reinterpret_cast<float*>(gbase + C::OFF_VEC);
  float* sShift = sScale + PC_C;
  int* sBlk = reinterpret_cast<int*>(gbase + C::OFF_SLOT);  // rank -> block, ascending
  int* sOwn = sBlk + C::NBLK;        // per out-slot: its blocks' ranks (NBLK / 2 at most)
  int* sCount = sOwn + C::NBLK;      // blocks; blocks of out-slot 0, 1
  const auto tile_at = [&](int p) { return base + p * C::TILE; };
  const auto wslot = [&](int s) { return base + C::OFF_W + s * C::WB; };
  const auto tfull = [&](int p) { return base + C::OFF_BAR + p * 8; };
  const auto wfull = [&](int s) { return base + C::OFF_BAR + (C::PAIRS + s) * 8; };
  const auto wempty = [&](int s) { return base + C::OFF_BAR + (C::PAIRS + C::WSLOTS + s) * 8; };

  const int tid = threadIdx.x, wgi = tid / 128, t = tid % 128;
  const int pr = wgi >> 1, o = wgi & 1, pt = tid % 256;  // pair, out-slot, thread in the pair
  if (tid < PC_C && apply_bn_relu) {
    sScale[tid] = scale[tid];
    sShift[tid] = shift[tid];
  }
  if (tid == 0) {
    int n = 0, n1 = 0;
    for (int f = 0; f < C::NBLK; ++f)
      if (pc_flags[f]) {
        if (f & 1) sOwn[C::NBLK / 2 + n1++] = n;
        else sOwn[n - n1] = n;
        sBlk[n++] = f;
      }
    sCount[0] = n;
    sCount[1] = n - n1;
    sCount[2] = n1;
    for (int i = 0; i < C::PAIRS; ++i) mbar_init(tfull(i), 1);
    for (int i = 0; i < C::WSLOTS; ++i) {
      mbar_init(wfull(i), 1);
      mbar_init(wempty(i), C::THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int nblk = sCount[0];
  const bool ring = nblk > C::WSLOTS;  // weights streamed per round, else resident
  const int G = gridDim.x;
  const int mine = (ntiles - (int)blockIdx.x + G - 1) / G;  // blockIdx.x < ntiles
  const int rounds = (mine + C::PAIRS - 1) / C::PAIRS;
  const int fills = ring ? rounds * nblk : nblk;  // weight loads, in stream order
  // tile -> (batch, first row, first packed column)
  const auto decode = [&](int tl, int& b, int& h0, int& w0) {
    const int id = (int)blockIdx.x + tl * G;
    w0 = (id % tiles_w) * C::TW;
    h0 = ((id / tiles_w) % tiles_h) * C::TH;
    b = id / (tiles_w * tiles_h);
  };
  // this pair's tile `tl` into its halo buffer: two 64-channel boxes of
  // 6 x 18 pixels from (h0 - 1, w0 - 1), zeros outside the image
  const CUtensorMap* txp = &tx;
  const auto load_tile = [&](int tl) {
    int b, h0, w0;
    decode(tl, b, h0, w0);
    mbar_arrive_tx(tfull(pr), 2 * C::HALF_BYTES);
    for (int i = 0; i < 2; ++i)
      tma_load(tile_at(pr) + i * C::HALF, txp, 64 * i, w0 - 1, h0 - 1, b, tfull(pr));
  };
  if (tid == 0)
    for (int n = 0; n < min(fills, C::WSLOTS); ++n)
      load_w(&tw, wslot(n), wfull(n), sBlk[n % nblk]);
  if (pt == 0 && pr < mine) load_tile(pr);

  const int warp = t / 32, lane = t % 32, c2 = (lane % 4) * 2;
  // ldmatrix: lane gives row (pixel) lane % 8 + 8 (q & 1) of matrix q =
  // lane / 8, whose 8 channels are chunk q / 2 of a 16-channel slice
  const int lq = lane >> 3, l_px = (lane & 7) + ((lq & 1) << 3), l_kc = lq >> 1;
  const int* own = sOwn + C::NBLK / 2 * o;
  const int nown = sCount[1 + o];
  // running statistics of this thread's columns of out-slot o (tile_out)
  float st[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f;
  if (!ring)
    for (int s = 0; s < nblk; ++s) mbar_wait(wfull(s), 0);
  uint32_t ph = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    const int tile = rd * C::PAIRS + pr;
    const bool live = tile < mine;  // an idle pair still walks a streamed round
    if (!live && !ring) break;
    const uint32_t tb = tile_at(pr);
    const PcGroups g{tb,   base + C::OFF_W, wfull(0), wempty(0), ring ? rd * nblk : 0,
                     warp, l_px,          l_kc,     tid == 0,  fills,
                     nblk, sBlk,          &tw};
    if (!live) {
      for (int q = 0; q < nblk; ++q) {
        ring_wait(g, g.pos0 + q);
        ring_free(g, g.pos0 + q);
      }
      continue;
    }
    int b, h0, w0;
    decode(tile, b, h0, w0);
    mbar_wait(tfull(pr), ph);
    ph ^= 1;
    if (apply_bn_relu) {
      prologue(tb, sScale, sShift, pt, h0, w0, H, Wp);
      fence_proxy_async();
      named_sync(1 + pr, 256);
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    own_blocks(g, ring, own, nown, acc);
    // every ldmatrix of the pair is done: the buffer takes the pair's next tile
    fence_proxy_async();
    named_sync(1 + pr, 256);
    if (pt == 0 && tile + C::PAIRS < mine) load_tile(tile + C::PAIRS);
    tile_out(acc, st, y + (long long)b * H * Wp * PC_C + 64 * o, H, Wp, h0, w0, t);
  }
  if (part != nullptr) {
    // each warp's row (in the halo tiles, free at the end), then the 8
    // warps of each out-slot in a fixed order
    __syncthreads();
    float* sRed = reinterpret_cast<float*>(gbase);
    float* red = sRed + (wgi * 4 + warp) * PC_C;  // [stat][64 columns of out-slot o]
    reduce_stats(st, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * (lane / 4) + i, stat = q / 16, col = q % 16;
      red[stat * 64 + (col / 2) * 8 + c2 + (col & 1)] = st[i];
    }
    __syncthreads();
    if (tid < 2 * PC_C) {
      const int stat = tid / PC_C, ch = tid % PC_C, oo = ch / 64;
      float total = 0.f;
      for (int p = 0; p < C::PAIRS; ++p)
        for (int wp = 0; wp < 4; ++wp)
          total += sRed[((2 * p + oo) * 4 + wp) * PC_C + stat * 64 + ch % 64];
      part[(long long)blockIdx.x * 2 * PC_C + tid] = total;
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

// Tiles of 4 rows x 16 packed columns of a [B, H, Wp, 128] input.
static long long packed_conv_tiles(int B, int H, int Wp) {
  return (long long)B * ((H + PcCfg::TH - 1) / PcCfg::TH) * ((Wp + PcCfg::TW - 1) / PcCfg::TW);
}

// Rows of the partial sums (= blocks of the main kernel, one an SM at most)
// for a [B, H, Wp, 128] input, or -1 if the input cannot be tiled.
extern "C" int gdl_packed_conv_blocks(int B, int H, int Wp) {
  if (B < 1 || H < 1 || Wp < 1) return -1;
  const long long tiles = packed_conv_tiles(B, H, Wp);
  const int nsm = sm_count();
  if (tiles > 0x7fffffffLL || nsm < 1) return -1;
  return (int)std::min<long long>(nsm, (tiles + PcCfg::PAIRS - 1) / PcCfg::PAIRS);
}

// x, y: [B, H, Wp, 128] bf16, contiguous, 16-byte aligned; kp: [3, 3, 128,
// 128] bf16; scale, shift: [128] f32 (read only with apply_bn_relu); part:
// [blocks, 256] f32 scratch with blocks = gdl_packed_conv_blocks(B, H, Wp) and
// stats: [2, 128] f32, both null to skip the statistics.
extern "C" int gdl_packed_conv_bn_stats(const void* x, const void* kp, const void* scale,
                                        const void* shift, void* y, void* part, void* stats,
                                        int B, int H, int Wp, int blocks, int apply_bn_relu,
                                        void* stream) {
  using C = PcCfg;
  if (blocks < 1 || blocks != gdl_packed_conv_blocks(B, H, Wp) ||
      (part == nullptr) != (stats == nullptr))
    return (int)cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return (int)cudaErrorNotSupported;
  // x as (channel, packed column, row, batch), boxes of one half's 64
  // channels over the 6 x 18-pixel halo tile; kp as [9 * 128, 128] rows,
  // boxes of one 64 x 64 block
  CUtensorMap tx, tw;
  const cuuint64_t xdims[4] = {PC_C, (cuuint64_t)Wp, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {PC_C * 2, (cuuint64_t)Wp * PC_C * 2,
                                  (cuuint64_t)H * Wp * PC_C * 2};
  const cuuint32_t xbox[4] = {64, C::HW, C::HH, 1};
  const cuuint64_t wdims[2] = {PC_C, 9 * PC_C};
  const cuuint64_t wstrides[1] = {PC_C * 2};
  const cuuint32_t wbox[2] = {64, 64};
  if (!encode_bf16(&tx, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(&tw, kp, 2, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  packed_conv_flags_kernel<<<C::NBLK, 256, 0, st>>>((const bf16*)kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(packed_conv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles_h = (H + C::TH - 1) / C::TH, tiles_w = (Wp + C::TW - 1) / C::TW;
  packed_conv_wgmma_kernel<<<(unsigned)blocks, C::THREADS, C::SMEM, st>>>(
      tx, tw, (const float*)scale, (const float*)shift, (bf16*)y, (float*)part, H, Wp, tiles_h,
      tiles_w, (int)packed_conv_tiles(B, H, Wp), apply_bn_relu);
  e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return (int)e;
  column_sum_kernel<<<(2 * PC_C + 31) / 32, CS_WARPS * 32, 0, st>>>(
      (const float*)part, (float*)stats, blocks, 2 * PC_C);
  return (int)cudaGetLastError();
}
