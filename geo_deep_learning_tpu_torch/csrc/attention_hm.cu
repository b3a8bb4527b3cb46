// K8: softmax attention forward over head-major [B, H, L, hd] q, k, v.
//
// Replaces geo_deep_learning_tpu/ops/pallas/mha.py::_fwd_kernel (via _fwd),
// the kernel the JAX package takes where the packed kernel's VMEM budget
// refuses the shape (a DOFA token count of 1593-2304 at head dim 64, e.g.
// 2026 tokens at a 640^2 input) or on a tensor-parallel mesh. Outputs o
// [B, H, L, hd] and lse [B, H, L] f32. The TPU kernel takes contiguous
// head-major tensors, pads L to a multiple of 256, masks the padded columns
// to -1e30, holds each head's K/V whole in VMEM and stores lse broadcast to
// [.., 8]; here q, k, v and o are any [B, H, L, hd] views with run-time
// strides (the attention route passes the head slices of the packed QKV
// tensor and of a [B, L, H*hd] output, so nothing is transposed: TMA reads
// the slices through tensor maps with their strides), the ragged chunk is
// masked instead of padded, K/V stream through a ring of shared-memory
// chunks with an online softmax, and lse is a plain vector. Numerics and
// design: attention_kernels.cuh (the device code K4 runs: wgmma, TMA,
// scores and probabilities in registers).
//
// Bound on the H100: operations. 4*B*H*L^2*hd = 100.9 GFLOP at DOFA-base
// bs8 and 640^2 (L = 2026, H = 12, hd = 64), 0.102 ms at the 989 TFLOP/s
// bf16 peak, plus the f32 softmax (2.0 GFLOP, 0.029 ms at 67 TFLOP/s):
// 0.131 ms, against ~80 MB of traffic (24 us). 11 q groups x 96 (batch,
// head) = 1056 blocks make exactly 8 waves on 132 SMs.
#include "attention_kernels.cuh"

// q, k, v: [B, H, L, hd] bf16 views sharing the element strides in_*; out: a
// [B, H, L, hd] bf16 view with strides out_*. Rows contiguous, strides
// multiples of 8, 16-byte aligned. lse: [B, H, L] f32. hd in {32, 64, 128}; scale > 0.
extern "C" int gdl_attention_fwd_hm(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int B, int L, int H, int hd, long long in_b,
                                    long long in_h, long long in_row, long long out_b,
                                    long long out_h, long long out_row, float scale,
                                    void* stream) {
  return launch_attention_fwd(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), AttnLayout{in_b, in_h, in_row},
      AttnLayout{out_b, out_h, out_row}, B, L, H, hd, scale, static_cast<cudaStream_t>(stream));
}
