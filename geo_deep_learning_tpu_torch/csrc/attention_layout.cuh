// Layouts, argument checks and TMA row loads shared by the attention
// kernels: the forward (attention_kernels.cuh, K4/K8) and the backward
// (attention_bwd_kernels.cuh, K7/K9).
//
// The packed pair (K4/K7) passes the column slices of one [B, L, 3*H*hd]
// tensor (q, k, v and dq, dk, dv) and of [B, L, H*hd] (o, g); the
// head-major pair (K8/K9) passes the [B, H, L, hd] views its caller holds,
// which may be those same slices. An AttnLayout of run-time strides states
// where one (batch, head)'s rows live.
#pragma once

#include "hopper.cuh"

// Element strides of an operand's batch, head and row dimensions; a row's hd
// elements are contiguous, and every stride is a multiple of 8 (16 bytes).
struct AttnLayout {
  long long b, h, row;
  __device__ __forceinline__ long long at(int bi, int hi) const { return bi * b + hi * h; }
};

// q, k, v of the QKV projection's packed [B, L, 3*H*hd] output, and o or g
// as [B, L, H*hd] (K4/K7).
inline AttnLayout packed_qkv_layout(int L, int H, int hd) {
  const long long ld = 3LL * H * hd;
  return {ld * L, hd, ld};
}
inline AttnLayout packed_out_layout(int L, int H, int hd) {
  const long long ld = (long long)H * hd;
  return {ld * L, hd, ld};
}

inline bool attention_args_ok(int B, int L, int H, int hd) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && L >= 1 &&
         (hd == 32 || hd == 64 || hd == 128);
}

// Rows [row0, row0 + rows) of one (batch, head) into a [rows][HD] tile kept
// as Span<HD>::NCH swizzled [rows][BOX_C] chunks, one box of `box` rows at
// a time (`box` divides `rows`).
template <int HD>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, int rows, int box,
                                         int row0, int h, int b, uint32_t bar) {
  using S = Span<HD>;
#pragma unroll
  for (int c = 0; c < S::NCH; ++c)
    for (int r = 0; r < rows; r += box)
      tma_load(dst + (c * rows + r) * S::RB, map, c * S::BOX_C, row0 + r, h, b, bar);
}

// A 4-D (hd, L, H, B) map of [B, H, L, hd] rows with layout `lay`, boxes of
// BOX_C columns x `box` rows; rows past L read as zeros, and no box crosses
// into the next head's or batch's rows.
template <int HD>
inline bool encode_rows(CUtensorMap* map, const bf16* base, AttnLayout lay, int B, int L, int H,
                        int box) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)lay.row * 2, (cuuint64_t)lay.h * 2,
                                 (cuuint64_t)lay.b * 2};
  const cuuint32_t boxes[4] = {(cuuint32_t)Span<HD>::BOX_C, (cuuint32_t)box, 1, 1};
  return encode_bf16(map, base, 4, dims, strides, boxes, Span<HD>::TMA_SWZ);
}
