// K7: softmax attention backward over a packed [B, L, 3*H*hd] QKV tensor.
//
// Replaces geo_deep_learning_tpu/ops/pallas/mha.py::_bwd_kernel_packed (via
// _bwd_packed). Inputs are the forward's qkv (q heads | k heads | v heads),
// its output o [B, L, H*hd], the output's gradient g (same layout) and the
// forward's lse [B, H, L] f32; the output is dqkv [B, L, 3*H*hd] in the
// packing order, written in place with no concatenation. Numerics and design
// (delta pass, then a dK/dV kernel over 128-key tiles and a dQ kernel over
// 128-query tiles on wgmma, fed by TMA through an mbarrier ring, score
// tiles in registers, no atomics): attention_bwd_kernels.cuh. The tensor
// maps are 4-D (hd, L, H, B) over the column slices of qkv and g, with the
// packed row stride of 3*H*hd (or H*hd) elements.
//
// Bound on the H100: operations. The five products take 10*B*H*L^2*hd =
// 103 GFLOP at DOFA-base bs8 (L = 1297, H = 12, hd = 64), about 0.10 ms at
// the 989 TFLOP/s bf16 peak, against ~85 MB of traffic (25 us). The split
// recomputes s and dp in the dQ kernel (seven products in place of five).
#include "attention_bwd_kernels.cuh"

// qkv, dqkv: [B, L, 3*H*hd] bf16; o, g: [B, L, H*hd] bf16; lse: [B, H, L] f32;
// delta: [B, H, L] f32 scratch. All contiguous, 16-byte aligned. hd in {32, 64, 128}.
extern "C" int gdl_attention_bwd_packed(const void* qkv, const void* o, const void* g,
                                        const void* lse, void* delta, void* dqkv, int B, int L,
                                        int H, int hd, float scale, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  const long long D = (long long)H * hd;
  const AttnLayout out = packed_out_layout(L, H, hd);
  return launch_attention_bwd(
      q, q + D, q + 2 * D, static_cast<const bf16*>(o), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<float*>(delta), dq, dq + D, dq + 2 * D,
      packed_qkv_layout(L, H, hd), out, out, B, L, H, hd, scale,
      static_cast<cudaStream_t>(stream));
}
