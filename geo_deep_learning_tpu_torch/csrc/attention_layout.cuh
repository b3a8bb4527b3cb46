// Layouts and argument checks shared by the attention kernels: the forward
// (attention_kernels.cuh, K4/K8) and the backward (attention_bwd_kernels.cuh,
// K7/K9).
//
// The packed pair (K4/K7) passes the column slices of one [B, L, 3*H*hd]
// tensor (q, k, v and dq, dk, dv) and of [B, L, H*hd] (o, g); the
// head-major pair (K8/K9) passes the [B, H, L, hd] views its caller holds,
// which may be those same slices. An AttnLayout of run-time strides states
// where one (batch, head)'s rows live.
#pragma once

#include "common.cuh"

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
