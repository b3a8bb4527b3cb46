// Layout helpers shared by the spatial-reduction attention's forward K10
// (sr_attention.cu) and its backward (sr_attention_bwd.cu): the strides of
// a [B, H, L, D] view and its TMA row map.
#pragma once

#include "hopper.cuh"

struct SrStrides {
  long long b, h, l;  // elements; the last dimension is contiguous
};

constexpr float SR_LOG2E = 1.4426950408889634f;

// A 4-D (d, l, h, b) map of rows with strides `st` (elements), boxes of
// D columns x `rows` rows; rows past L read as zeros.
template <int D>
static bool encode_sr(CUtensorMap* map, const void* base, SrStrides st, int B, int H, int L,
                      int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.l * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)rows, 1, 1};
  return encode_bf16(map, base, 4, dims, strides, box, Span<D>::TMA_SWZ);
}
