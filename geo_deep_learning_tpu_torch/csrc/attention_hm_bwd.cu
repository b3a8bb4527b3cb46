// K9: softmax attention backward over head-major [B, H, L, hd] q, k, v.
//
// Replaces geo_deep_learning_tpu/ops/pallas/mha.py::_bwd_kernel (via
// _bwd_pallas). Inputs are the forward's q, k, v, its output o, the
// output's gradient g (all [B, H, L, hd] views with run-time strides, as
// K8 takes them) and its lse [B, H, L] f32; outputs dq, dk, dv, views with
// q's strides (the attention route passes the head slices of one packed
// dqkv tensor). The TPU kernel runs one program per (batch,
// head) with the head's K/V and f32 dk/dv accumulators resident, unrolled
// over 256-row query tiles; here the work is split as FlashAttention-2
// splits it (delta pass, dK/dV kernel over 128-key tiles, dQ kernel over
// 128-query tiles, on wgmma with TMA-fed rings), with no atomics, so the
// gradients are equal run to run. Columns past L get zero gradient, as the
// TPU kernel's padded columns do. Numerics and design:
// attention_bwd_kernels.cuh (the device code K7 runs, on the head-major
// layout: the tensor maps take these views' strides).
//
// Bound on the H100: operations. The five products take 10*B*H*L^2*hd =
// 252 GFLOP at DOFA-base bs8 and 640^2 (L = 2026, H = 12, hd = 64), about
// 0.25 ms at the 989 TFLOP/s bf16 peak, plus the f32 softmax work (0.03 ms).
#include "attention_bwd_kernels.cuh"

// q, k, v, dq, dk, dv: [B, H, L, hd] bf16 views sharing the element strides
// in_*; o: strides o_*; g: strides g_*. Rows contiguous, strides multiples of
// 8, 16-byte aligned. lse: [B, H, L] f32; delta: [B, H, L] f32 scratch. hd in
// {32, 64, 128}.
extern "C" int gdl_attention_bwd_hm(const void* q, const void* k, const void* v, const void* o,
                                    const void* g, const void* lse, void* delta, void* dq,
                                    void* dk, void* dv, int B, int L, int H, int hd,
                                    long long in_b, long long in_h, long long in_row,
                                    long long o_b, long long o_h, long long o_row, long long g_b,
                                    long long g_h, long long g_row, float scale, void* stream) {
  return launch_attention_bwd(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), AttnLayout{in_b, in_h, in_row}, AttnLayout{o_b, o_h, o_row},
      AttnLayout{g_b, g_h, g_row}, B, L, H, hd, scale, static_cast<cudaStream_t>(stream));
}
