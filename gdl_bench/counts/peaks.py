"""The yardstick's constants: one H100's peaks, the least time of a piece of
work, and the kernel-name families.

Copied from the port's chip smoke test (``chip_smoke.py``: the H100 peaks,
``bound`` and ``FAMILIES``) so that the benchmark keeps them when the
program changes. Peaks are NVIDIA's data sheet for the H100 SXM part,
dense rates, at the 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
F32_FLOPS = 67e12


def bound(rec: dict) -> tuple[float, str]:
    """The least time in ms for a record's work: its bytes at the HBM rate,
    or its operations (bf16 and tf32 tensor-core flops at their rates, the
    rest on the f32 pipe), whichever is longer."""
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = (rec["tensor_flops"] / BF16_TENSOR_FLOPS
             + rec.get("tf32_flops", 0.0) / TF32_TENSOR_FLOPS + rec["f32_flops"] / F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# kernel-name fragments -> family, tried in order (cuDNN's convolution
# kernels are xmma kernels too, so they are matched first)
FAMILIES = (
    ("K1-K11", ("preprocess_kernel", "layernorm_fwd_kernel", "layernorm_bwd_kernel",
                "attention_fwd_wgmma_kernel", "attention_bwd_", "sr_attention_fwd_",
                "attention_fwd_tf32_kernel", "attention_delta_f32_kernel",
                "packed_conv_", "column_sum_kernel")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma")),
)


def family(kernel_name: str) -> str:
    """The family of a kernel by its name, ``other`` when none matches."""
    low = kernel_name.lower()
    return next((f for f, keys in FAMILIES if any(k.lower() in low for k in keys)), "other")
