"""Time the UNet++ finest dense column: kernel K11 chained against cuDNN.

Port of ``scripts/bench_pallas_column.py``. The column runs at the UNet++
finest-column shapes (bs 32, 256^2, 64 channels): 4 nodes x 2 legs, each
leg BN-apply + ReLU with the previous leg's statistics -> 3x3 conv 64->64
-> BatchNorm-train statistics. Variants:

- ``torch``  -- ``F.conv2d`` (cuDNN, bf16, channels-last) and the BN
  prologue and statistics in PyTorch (:func:`column_torch`);
- ``kernel`` -- pack once, chain eight K11 legs with
  :func:`finalize_packed_stats` between them, unpack once
  (:func:`column_kernel`).

Both run the same two-pass BN-train math (the statistics of leg k feed the
prologue of leg k + 1) in bf16 with f32 statistics; K11 takes them from
its f32 accumulator, the torch column from the bf16 conv output. Forward
only. On a CPU tensor the kernel column runs K11's plain version.

Usage::

    python -m geo_deep_learning_tpu_torch.tools.bench_column [--iters 20] [--batch 32] [--size 256]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from geo_deep_learning_tpu_torch.core.device import resolve_device
from geo_deep_learning_tpu_torch.ops.cuda import packed_conv as PC

N_NODES = 4
LEGS = 2  # convs per node
C = 64
EPS = 1e-5
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
BF16_TENSOR_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def finalize_packed_stats(stats: torch.Tensor, n: int, gamma, beta):
    """``[2, 128]`` packed sums -> packed ``(scale, shift)`` for the next
    leg's prologue. The two slots hold disjoint W positions of the same
    channels, so the per-channel sums are the slot sums."""
    s = stats[0, :C] + stats[0, C:]
    sq = stats[1, :C] + stats[1, C:]
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    scale = gamma * torch.rsqrt(var + EPS)
    shift = beta - mean * scale
    return scale.repeat(2), shift.repeat(2)


def column_kernel(x, kps, gammas, betas):
    """The column through K11: ``x`` ``[B, H, W, 64]`` NHWC, ``kps``
    ``[8, 3, 3, 128, 128]`` block kernels -> ``(y, scale, shift)``."""
    b, h, w, _ = x.shape
    n = b * h * w
    xp = PC.pack_nhwc(x)
    scale = torch.ones(2 * C, dtype=torch.float32, device=x.device)  # identity prologue, leg 0
    shift = torch.zeros(2 * C, dtype=torch.float32, device=x.device)
    i = 0
    for _node in range(N_NODES):
        for _leg in range(LEGS):
            xp, stats = PC.packed_conv_bn_stats(xp, kps[i], scale, shift, apply_bn_relu=i > 0)
            scale, shift = finalize_packed_stats(stats, n, gammas[i], betas[i])
            i += 1
    return PC.unpack_nhwc(xp), scale, shift


def column_torch(x, ks, gammas, betas):
    """The same column with ``F.conv2d`` on channels-last NCHW views and the
    statistics of the rounded conv output: ``ks`` ``[8, 3, 3, 64, 64]``
    HWIO in f32, cast to ``x.dtype`` -> ``(y, scale, shift)``."""
    y = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last NCHW view
    scale = torch.ones(C, dtype=torch.float32, device=x.device)
    shift = torch.zeros(C, dtype=torch.float32, device=x.device)
    i = 0
    for _node in range(N_NODES):
        for _leg in range(LEGS):
            if i > 0:
                y = torch.relu(y.float() * scale[:, None, None] + shift[:, None, None]).to(x.dtype)
            w = ks[i].to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            y = F.conv2d(y, w, padding=1)
            yf = y.float()
            mean = yf.mean(dim=(0, 2, 3))
            var = torch.clamp((yf * yf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            scale = gammas[i] * torch.rsqrt(var + EPS)
            shift = betas[i] - mean * scale
            i += 1
    return y.permute(0, 2, 3, 1), scale, shift


def inputs(batch: int, size: int, device: torch.device):
    """The JAX script's inputs from ``default_rng(0)``: ``(x, ks, kps,
    gammas, betas)`` with ``x`` and ``kps`` in bf16."""
    rng = np.random.default_rng(0)
    n_convs = N_NODES * LEGS
    x = torch.from_numpy(rng.normal(size=(batch, size, size, C)).astype(np.float32))
    ks = torch.from_numpy((rng.normal(size=(n_convs, 3, 3, C, C)) * 0.05).astype(np.float32))
    gammas = torch.from_numpy(rng.uniform(0.5, 1.5, (n_convs, C)).astype(np.float32))
    betas = torch.from_numpy((rng.normal(size=(n_convs, C)) * 0.1).astype(np.float32))
    kps = torch.stack([PC.pack_w_kernel(k) for k in ks])
    x, kps = x.to(torch.bfloat16), kps.to(torch.bfloat16)
    return tuple(t.to(device) for t in (x, ks, kps, gammas, betas))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(fn, args, iters: int, device: torch.device):
    """Median of three host-clock runs of ``iters`` calls, each ended by a
    synchronize; one warm-up call first. Returns ``(seconds per call,
    last output)``."""
    out = fn(*args)
    _sync(device)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _sync(device)
        times.append((time.perf_counter() - t0) / iters)
    return sorted(times)[1], out


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / (want.abs().max() + 1e-9))


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    b, hw = args.batch, args.size
    x, ks, kps, gammas, betas = inputs(b, hw, device)
    t_torch, out_t = bench(column_torch, (x, ks, gammas, betas), args.iters, device)
    t_kernel, out_k = bench(column_kernel, (x, kps, gammas, betas), args.iters, device)
    err = relative_error(out_k[0], out_t[0])

    n_convs = N_NODES * LEGS
    flops_unpacked = 2 * b * hw * hw * 9 * C * C * n_convs
    bound = max(flops_unpacked / BF16_TENSOR_FLOPS, 2 * 2 * b * hw * hw * C * n_convs / HBM_BYTES_PER_S)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"column fwd ({n_convs} convs @ [{b},{hw},{hw},{C}] bf16, BN-train stats each) on {name}:")
    print(f"  torch  : {t_torch * 1e3:8.3f} ms  ({flops_unpacked / t_torch / 1e12:.1f} TF/s eff)")
    print(f"  kernel : {t_kernel * 1e3:8.3f} ms  ({flops_unpacked / t_kernel / 1e12:.1f} TF/s eff "
          f"unpacked-FLOPs; K11 skips the block kernel's zero blocks, its plain version does 2x)")
    print(f"  H100 bound (unpacked convs' FLOPs or bf16 bytes, no stats): {bound * 1e3:.3f} ms")
    print(f"  speedup torch/kernel: {t_torch / t_kernel:.3f}x   rel-err {err:.2e}")
    return {
        "torch_ms": t_torch * 1e3,
        "kernel_ms": t_kernel * 1e3,
        "bound_ms": bound * 1e3,
        "rel_err": err,
        "kernel_calls": 1 + 3 * args.iters,
        "device": name,
    }


if __name__ == "__main__":
    main()
