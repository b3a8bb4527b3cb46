"""Operation and byte counts of single kernels, from their shapes.

The packed attention forward (K4) and backward (K7) and the spatial-
reduction attention forward (K10) are copied from the records of the
port's chip smoke test (``chip_smoke.py``: ``kernels_phase`` and
``sr_record``), which give the "Bound ms" column of ``PERF.md``; the SR
attention's backward is counted here the way K7 is. Each record holds
``bytes`` (each input read once, each output written once),
``tensor_flops`` (tensor-core work, counted at the bf16 rate) and
``f32_flops`` (softmax and exponentials on the f32 pipe).
"""

from __future__ import annotations


def attention_fwd_packed(b: int, l: int, h: int, hd: int) -> dict:
    """K4 on a packed bf16 ``[b, l, 3 h hd]`` input: o bf16 and lse f32 out."""
    return {
        "bytes": b * l * 3 * h * hd * 2 + b * l * h * hd * 2 + b * h * l * 4,
        "tensor_flops": 4.0 * b * h * l * l * hd,
        "f32_flops": 5.0 * b * h * l * l,
    }


def attention_bwd_packed(b: int, l: int, h: int, hd: int) -> dict:
    """K7: qkv and dqkv, o and do, lse; five products (the scores again,
    then dV, dP, dQ, dK)."""
    return {
        "bytes": b * l * 3 * h * hd * 2 * 2 + 2 * b * l * h * hd * 2 + b * h * l * 4,
        "tensor_flops": 10.0 * b * h * l * l * hd,
        "f32_flops": 5.0 * b * h * l * l,
    }


def sr_attention_fwd(b: int, h: int, lq: int, lk: int, d: int) -> dict:
    """K10 on bf16 q ``[b, h, lq, d]`` and k, v ``[b, h, lk, d]``: q k^T on
    bf16 tensor cores and p v there as two bf16 passes (p split into hi +
    lo halves); only the softmax and exp work at the f32 rate."""
    n_s = b * h * lq * lk
    return {
        "bytes": 2 * (2 * b * h * lq * d + 2 * b * h * lk * d),
        "tensor_flops": 2.0 * n_s * d + 2 * 2.0 * n_s * d,
        "f32_flops": 5.0 * n_s,
    }


def sr_attention_bwd(b: int, h: int, lq: int, lk: int, d: int) -> dict:
    """The SR attention's backward as K7 counts its own: q, k, v and do read,
    dq, dk, dv written (bf16), five products (the scores again, then dV,
    dP, dQ, dK) at the bf16 tensor rate, the softmax's work on the f32 pipe."""
    n_s = b * h * lq * lk
    return {
        "bytes": 2 * (3 * b * h * lq * d + 4 * b * h * lk * d),
        "tensor_flops": 10.0 * n_s * d,
        "f32_flops": 5.0 * n_s,
    }
