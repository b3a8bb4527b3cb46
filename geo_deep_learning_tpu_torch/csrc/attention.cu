// K4: softmax attention forward over a packed [B, L, 3*H*hd] QKV tensor.
//
// Replaces geo_deep_learning_tpu/ops/pallas/mha.py::_fwd_kernel_packed (via
// _fwd_packed). Column order of the input is q heads | k heads | v heads, as
// the QKV projection writes it; the kernel reads each head's column slice in
// place through TMA tensor maps with the packed row stride (no transpose, no
// pad). Outputs o [B, L, H*hd] in the same packing and lse [B, H, L] f32
// (the TPU kernel's 8-wide copies were a tiling artifact). Numerics and
// design: attention_kernels.cuh (three consumer warpgroups of 64 q rows a
// block, K/V streamed by TMA through a ring of 128-key chunks, q k^T and
// P.V on wgmma with the scores and probabilities in registers, an online
// softmax in exp2).
//
// Bound on the H100: operations. 4*B*H*L^2*hd = 41.3 GFLOP of products at
// DOFA-base bs8 (L = 1297, H = 12, hd 64), 42 us at the 989 TFLOP/s bf16
// peak, plus ~5*B*H*L^2 = 0.8 GFLOP of f32 softmax work (12 us at 67
// TFLOP/s): 54 us, against ~50 MB of traffic (15 us). The grid has 7
// q groups x 96 (batch, head) = 672 blocks of one an SM: 5.09 waves on 132
// SMs, so the last wave runs 12 blocks.
#include "attention_kernels.cuh"

// qkv: [B, L, 3*H*hd] bf16, contiguous, 16-byte aligned; out: [B, L, H*hd] bf16;
// lse: [B, H, L] f32. hd in {32, 64, 128}; scale > 0.
extern "C" int gdl_attention_fwd_packed(const void* qkv, void* out, void* lse, int B, int L,
                                        int H, int hd, float scale, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const long long D = (long long)H * hd;
  return launch_attention_fwd(q, q + D, q + 2 * D, static_cast<bf16*>(out),
                              static_cast<float*>(lse), packed_qkv_layout(L, H, hd),
                              packed_out_layout(L, H, hd), B, L, H, hd, scale,
                              static_cast<cudaStream_t>(stream));
}
