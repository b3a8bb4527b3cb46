#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``geo_deep_learning_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device  -- the card's name and power limit (``nvidia-smi``); the card
   must be Hopper (compute capability 9.0).
2. build   -- the port's CUDA kernels: one ``nvcc`` per source, all
   started together, then one link into one library.
3. kernels -- each kernel (K1-K7, K10) against its plain PyTorch version
   on the card, at the main paths' shapes and at ragged ones, with its
   time, the plain version's time, one library call's time where PyTorch
   has one (a yardstick only; the port never calls it) and the least time
   the card could take for the same bytes or operations. Then the autograd
   Functions around K2/K3/K4 and K10 on the card against the same
   Functions on CPU copies of their inputs.

Then, for each model path -- DOFA-base + UperNet, and SegFormer mit_b0 +
all-MLP decoder -- at full width with seeded random weights:

4. serving path -- the full-width model on two crops (DOFA 128^2,
   SegFormer whole 512^2 patches) on the card (bf16, kernels) against the
   same weights on the CPU (f32, plain versions); the CLI's ``run(config,
   "test")`` over the 100 patches of the ``tst`` split of
   ``data/waterloo``, then ``run(config, "predict")`` into a temporary
   directory, with exact launch counts per batch (DOFA K1-K4 1/4/20/12,
   SegFormer K1 1 and K10 6); a host-loader / eval-step breakdown; for
   SegFormer, one forward of the Dynamic MiT on a 4-band batch (K1 1, K10
   6).
5. training path -- one full-width train step, card (bf16, kernels)
   against CPU (f32, plain versions) with the plain bf16 path as the
   yardstick: loss and gradient cosines (DOFA per encoder-block tensor on
   128^2 crops, then a frozen-encoder step that must launch no K5-K7;
   SegFormer per encoder stage on whole 512^2 patches); then ``run(config,
   "fit")`` for 2 epochs over CSVs written to a temporary directory
   (``trn`` = ``tst`` rows 0-79, ``val`` = rows 80-99, ``tst`` = all 100),
   whose launch counts must be exact per train step (DOFA K1-K7
   1/4/20/12/4/20/12, SegFormer K1 1 and K10 6: its backward is torch
   math) plus the forward's per evaluated batch, and ``run(config,
   "test")`` from its best checkpoint, which must agree with the fit's
   auto-test. Train steps on resident batches, a checkpoint write and a
   profiler breakdown by kernel family are timed apart.

Prints one JSON line of kernel records (``launches``: the kernel's count
over the two ``fit`` runs), the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero; without CUDA, or outside a checkout, it exits
non-zero before printing any result. A watchdog ends a hung run after 900 s.
"""

from __future__ import annotations

import collections
import copy
import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

WATCHDOG_S = 900
ROOT = Path(__file__).resolve().parent
DATA = ROOT / "data" / "waterloo"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

BATCH = 8
N_TST = 100
N_TRN, N_VAL = 80, 20  # fit: trn = tst rows 0-79, val = rows 80-99
FIT_EPOCHS = 2
# kernel launches per 512^2 DOFA-base forward: K1 once; K2 at blocks 0, 5,
# 7, 11 (each starts without a pending branch: taps 4, 6, 10, 11); K3 at
# norm1 of the other 8 blocks and norm2 of all 12; K4 once per block
PER_BATCH = {
    "preprocess": 1,
    "layernorm_fwd": 4,
    "layernorm_residual_fwd": 20,
    "attention_fwd_packed": 12,
}
# and per train step, the forward's plus one backward per forward launch:
# K5 per K2, K6 per K3, K7 per K4 (the unused final norm launches nothing)
PER_TRAIN_STEP = {
    **PER_BATCH,
    "layernorm_bwd": 4,
    "layernorm_residual_bwd": 20,
    "attention_bwd_packed": 12,
}
BACKWARD = ("layernorm_bwd", "layernorm_residual_bwd", "attention_bwd_packed")
# SegFormer mit_b0 at 512^2: K10 in both blocks of stages 1-3 (Lq 16384,
# 4096, 1024 over Lk 256); stage 4 (Lq 256) takes the einsum; its backward
# is torch math, so a train step launches what its forward does
SEG_PER_BATCH = {"preprocess": 1, "sr_attention_fwd": 6}
SEG_PER_TRAIN_STEP = dict(SEG_PER_BATCH)
SEG_COS_GAP = 2.5e-4  # most 1 - cosine of a SegFormer stage's gradients to f32
SOURCES = {
    "preprocess": ("geo_deep_learning_tpu_torch/csrc/preprocess.cu",
                   "geo_deep_learning_tpu/ops/pallas/preprocess.py:33"),
    "layernorm_fwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                      "geo_deep_learning_tpu/ops/pallas/layernorm.py:50"),
    "layernorm_residual_fwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                               "geo_deep_learning_tpu/ops/pallas/layernorm.py:93"),
    "attention_fwd_packed": ("geo_deep_learning_tpu_torch/csrc/attention.cu",
                             "geo_deep_learning_tpu/ops/pallas/mha.py:255"),
    "layernorm_bwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                      "geo_deep_learning_tpu/ops/pallas/layernorm.py:64"),
    "layernorm_residual_bwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                               "geo_deep_learning_tpu/ops/pallas/layernorm.py:116"),
    "attention_bwd_packed": ("geo_deep_learning_tpu_torch/csrc/attention_bwd.cu",
                             "geo_deep_learning_tpu/ops/pallas/mha.py:299"),
    "sr_attention_fwd": ("geo_deep_learning_tpu_torch/csrc/sr_attention.cu",
                         "geo_deep_learning_tpu/ops/pallas/sr_attention.py:34"),
}

# the port config (geo_deep_learning_tpu_torch/configs/dofa_upernet_waterloo.yaml)
# as a dict: the machine with the card has no YAML parser
CONFIG = {
    "seed_everything": 42,
    "trainer": {
        "max_epochs": 10,
        "precision": "bf16-mixed",
        "gradient_clip_val": 1.0,
        "default_root_dir": "runs/torch_dofa_waterloo",
        "callbacks": [
            {"class_path": "lightning.pytorch.callbacks.EarlyStopping",
             "init_args": {"monitor": "val_loss", "mode": "min", "patience": 20}},
            {"class_path": "lightning.pytorch.callbacks.ModelCheckpoint",
             "init_args": {"monitor": "val_loss", "mode": "min", "save_top_k": 1}},
        ],
    },
    "model": {
        "class_path": "geo_deep_learning_tpu_torch.tasks.SegmentationDOFA",
        "init_args": {
            "encoder": "dofa_base",
            "pretrained": False,
            "image_size": [512, 512],
            "num_classes": 1,
            "wavelengths": [0.665, 0.549, 0.481],
            # random weights, so the encoder trains too (the recipe freezes
            # a pretrained one); this is the path that runs K5-K7
            "freeze_layers": [],
            "loss": {
                "class_path": "geo_deep_learning_tpu_torch.ops.losses.DiceLoss",
                "init_args": {"mode": "binary"},
            },
            "optimizer": {"class_path": "torch.optim.Adam", "init_args": {"lr": 6.0e-5}},
            "scheduler": {
                "class_path": "torch.optim.lr_scheduler.ReduceLROnPlateau",
                "init_args": {"mode": "min", "factor": 0.1, "patience": 10, "cooldown": 1,
                              "min_lr": 6.0e-8},
            },
            "class_labels": ["background", "building"],
        },
    },
    "data": {
        "class_path": "geo_deep_learning_tpu_torch.data.datamodule.CSVDataModule",
        "init_args": {
            "csv_root_folder": "data/waterloo",
            "patches_root_folder": "data/waterloo",
            "batch_size": BATCH,
            "mean": [0.405, 0.432, 0.397],
            "std": [0.165, 0.161, 0.174],
            "patch_size": [512, 512],
            "device_preprocess": True,
        },
    },
    "ckpt_path": None,
}

# the port config (geo_deep_learning_tpu_torch/configs/segformer_waterloo.yaml)
# as a dict
SEGFORMER_CONFIG = {
    "seed_everything": 42,
    "trainer": {
        "max_epochs": 10,
        "precision": "bf16-mixed",
        "gradient_clip_val": 1.0,
        "default_root_dir": "runs/torch_segformer_waterloo",
        "callbacks": CONFIG["trainer"]["callbacks"],
    },
    "model": {
        "class_path": "geo_deep_learning_tpu_torch.tasks.SegmentationSegformer",
        "init_args": {
            "encoder": "mit_b0",
            "image_size": [512, 512],
            "in_channels": 3,
            # the recipe's ImageNet weights are not in the repository
            "weights": None,
            "num_classes": 1,
            "use_dynamic_encoder": False,
            "loss": CONFIG["model"]["init_args"]["loss"],
            "optimizer": CONFIG["model"]["init_args"]["optimizer"],
            "scheduler": CONFIG["model"]["init_args"]["scheduler"],
            "scheduler_config": {"interval": "epoch", "frequency": 1, "monitor": "val_loss"},
            "class_labels": ["background", "building"],
        },
    },
    "data": CONFIG["data"],
    "ckpt_path": None,
}


class ModelPath(NamedTuple):
    """One model family's main path: its config, its exact kernel launches
    per evaluated batch and per train step, the crop size of its card-vs-CPU
    forward check, its train-step check and any further serving checks,
    each called as ``check(torch, config)``."""

    label: str
    config: dict
    per_batch: dict
    per_step: dict
    ref_size: int
    train_check: Callable
    serving_checks: tuple = ()


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: ok in {time.perf_counter() - self.t0:.1f} s", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_phase(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, capability {cap}")
    check(cap == (9, 0), f"expected a Hopper card (9, 0), got {cap}")
    return smi


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after
    flushing the 50 MB L2 with a 64 MB write (the main path finds its
    inputs cold), timed with CUDA events around ``fn`` alone. A spin of
    about 0.5 ms on the card before each launch lets the host enqueue the
    events and ``fn``'s launches ahead of the card, so the events time the
    device work and not the Python wrapper's overhead."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def max_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def kernels_phase(torch) -> dict[str, dict]:
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.ops.cuda import layernorm as LN
    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA
    from geo_deep_learning_tpu_torch.ops.cuda import preprocess as PP

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def compare(name, got, want, tol):
        err = max_err(got, want)
        print(f"  {name}: max_abs_err {err:.3g} (tolerance {tol:g})")
        check(math.isfinite(err) and err <= tol, f"{name}: error {err} above {tol}")
        return err

    records = {}
    mean = torch.tensor([0.405, 0.432, 0.397], device="cuda")
    std = torch.tensor([0.165, 0.161, 0.174], device="cuda")
    # tolerances: f32 kernels repeat the plain arithmetic up to summation
    # order; bf16 outputs may differ by rounding of the last bit (1 ulp is
    # 2^-6 for |y| in [2, 4)); attention outputs are averages of bf16
    # values with bf16 probabilities
    tol = {("preprocess", f32): 1e-6, ("preprocess", bf16): 1.6e-2,
           ("ln", f32): 1e-5, ("ln", bf16): 3.2e-2, ("attn", bf16): 2e-2}

    # K1
    for shape in ((BATCH, 512, 512, 3), (3, 37, 41, 3)):
        img = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
        m, inv = PP._stats(mean, std, img)
        for dt in (bf16, f32):
            err = compare(
                f"preprocess {list(shape)} {dt}",
                PP.fused_normalize_standardize(img, mean, std, dt),
                PP.normalize_reference(img, m, inv, dt), tol[("preprocess", dt)],
            )
            if shape[0] == BATCH and dt == bf16:
                n = img.numel()
                records["preprocess"] = {
                    "max_abs_err": err,
                    "ms": time_ms(torch, lambda: PP.fused_normalize_standardize(img, mean, std, bf16), 50),
                    "plain_ms": time_ms(torch, lambda: PP.normalize_reference(img, m, inv, bf16), 20),
                    "library_ms": None,
                    "bytes": n * (1 + 2) + 2 * 4 * mean.numel() * shape[0],
                    "tensor_flops": 0.0,
                    "f32_flops": 3.0 * n,
                }

    # K2 / K3
    d = 768
    gamma = 1.0 + 0.1 * randn((d,), f32)
    beta = 0.1 * randn((d,), f32)
    for b, l in ((BATCH, 1297), (2, 1297), (2, 197)):
        for dt in (bf16, f32):
            x, br = randn((b, l, d), dt), randn((b, l, d), dt)
            e2 = compare(f"layernorm_fwd [{b},{l},{d}] {dt}", LN.layernorm(x, gamma, beta),
                         LN.layernorm_reference(x, gamma, beta), tol[("ln", dt)])
            e3 = compare(f"layernorm_residual_fwd [{b},{l},{d}] {dt}",
                         LN.layernorm_residual(x, br, gamma, beta),
                         LN.layernorm_residual_reference(x, br, gamma, beta), tol[("ln", dt)])
            if b == BATCH and dt == bf16:
                rows = b * l
                records["layernorm_fwd"] = {
                    "max_abs_err": e2,
                    "ms": time_ms(torch, lambda: LN.layernorm(x, gamma, beta), 50),
                    "plain_ms": time_ms(torch, lambda: LN.layernorm_reference(x, gamma, beta), 20),
                    "library_ms": time_ms(torch, lambda: F.layer_norm(x, (d,), gamma.to(dt), beta.to(dt), 1e-6), 50),
                    "bytes": rows * d * 2 * 2 + 2 * d * 4 + rows * 8,
                    "tensor_flops": 0.0,
                    "f32_flops": 8.0 * rows * d,
                }
                records["layernorm_residual_fwd"] = {
                    "max_abs_err": e3,
                    "ms": time_ms(torch, lambda: LN.layernorm_residual(x, br, gamma, beta), 50),
                    "plain_ms": time_ms(torch, lambda: LN.layernorm_residual_reference(x, br, gamma, beta), 20),
                    "library_ms": time_ms(torch, lambda: F.layer_norm(x + br, (d,), gamma.to(dt), beta.to(dt), 1e-6), 50),
                    "bytes": rows * d * 2 * 4 + 2 * d * 4 + rows * 8,
                    "tensor_flops": 0.0,
                    "f32_flops": 9.0 * rows * d,
                }

    # K4
    for b, l, h, hd in ((BATCH, 1297, 12, 64), (2, 1297, 12, 64), (2, 197, 12, 64), (2, 37, 4, 32)):
        qkv = randn((b, l, 3 * h * hd), bf16)
        scale = 1.0 / math.sqrt(hd)
        err = compare(f"attention_fwd_packed [{b},{l},{3 * h * hd}] H={h}",
                      MHA.attention_packed(qkv, h), MHA.attention_reference(qkv, h, scale),
                      tol[("attn", bf16)])
        if b == BATCH:
            q, k, v = (t.unflatten(-1, (h, hd)).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            records["attention_fwd_packed"] = {
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: MHA.attention_packed(qkv, h), 20),
                "plain_ms": time_ms(torch, lambda: MHA.attention_reference(qkv, h, scale), 5),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 20),
                "bytes": qkv.numel() * 2 + b * l * h * hd * 2 + b * h * l * 4,
                "tensor_flops": 4.0 * b * h * l * l * hd,
                "f32_flops": 5.0 * b * h * l * l,
            }

    # K5 / K6: dx to the LayerNorm tolerances; dgamma/dbeta are f32 sums
    # over up to 10376 rows taken in another order (1e-2 on sums of order
    # 100 in bf16 inputs, 1e-3 in f32)
    aten = torch.ops.aten
    for b, l in ((BATCH, 1297), (2, 197), (3, 37)):
        for dt in (bf16, f32):
            x, dy, ds = randn((b, l, d), dt), randn((b, l, d), dt), randn((b, l, d), dt)
            _, mu, rstd = LN.layernorm(x, gamma, beta)
            sum_tol = 1e-2 if dt == bf16 else 1e-3
            errs = []
            for name, fn, ref in (
                ("layernorm_bwd", lambda: LN.layernorm_bwd(x, dy, gamma, mu, rstd),
                 lambda: LN.layernorm_bwd_reference(x, dy, gamma, mu, rstd)),
                ("layernorm_residual_bwd", lambda: LN.layernorm_residual_bwd(x, dy, ds, gamma, mu, rstd),
                 lambda: LN.layernorm_residual_bwd_reference(x, dy, ds, gamma, mu, rstd)),
            ):
                got, want = fn(), ref()
                errs.append(compare(f"{name} [{b},{l},{d}] {dt} dx", got[0], want[0], tol[("ln", dt)]))
                compare(f"{name} [{b},{l},{d}] {dt} dgamma, dbeta", got[1:], want[1:], sum_tol)
                check(all(torch.equal(u, v) for u, v in zip(got, fn())), f"{name}: not deterministic")
            if b == BATCH and dt == bf16:
                rows = b * l
                gd, bd = gamma.to(dt), beta.to(dt)
                _, amean, arstd = aten.native_layer_norm(x, [d], gd, bd, 1e-6)
                lib_bwd = lambda: aten.native_layer_norm_backward(  # noqa: E731
                    dy, x, [d], amean, arstd, gd, bd, [True, True, True])
                records["layernorm_bwd"] = {
                    "max_abs_err": errs[0],
                    "ms": time_ms(torch, lambda: LN.layernorm_bwd(x, dy, gamma, mu, rstd), 50),
                    "plain_ms": time_ms(torch, lambda: LN.layernorm_bwd_reference(x, dy, gamma, mu, rstd), 20),
                    "library_ms": time_ms(torch, lib_bwd, 50),
                    "bytes": rows * d * 2 * 3 + d * 4 * 3 + rows * 8,
                    "tensor_flops": 0.0,
                    "f32_flops": 14.0 * rows * d,
                }
                records["layernorm_residual_bwd"] = {
                    "max_abs_err": errs[1],
                    "ms": time_ms(torch, lambda: LN.layernorm_residual_bwd(x, dy, ds, gamma, mu, rstd), 50),
                    "plain_ms": time_ms(torch, lambda: LN.layernorm_residual_bwd_reference(x, dy, ds, gamma, mu, rstd), 20),
                    "library_ms": time_ms(torch, lambda: lib_bwd()[0] + ds, 50),
                    "bytes": rows * d * 2 * 4 + d * 4 * 3 + rows * 8,
                    "tensor_flops": 0.0,
                    "f32_flops": 15.0 * rows * d,
                }

    # K7: bf16 gradients of order 1, a few ulps apart where the f32 sums
    # differ in order; two hard cases at full length: a head whose scores
    # are all equal (q = 0) and rows with a large lse (inputs x 4)
    cases = [(BATCH, 1297, 12, 64, 1.0, False), (2, 1297, 12, 64, 1.0, True),
             (2, 1297, 12, 64, 4.0, False), (2, 197, 12, 64, 1.0, False),
             (2, 37, 4, 32, 1.0, False), (1, 300, 2, 128, 1.0, False)]
    for b, l, h, hd, amp, zero_q in cases:
        qkv = randn((b, l, 3 * h * hd), bf16) * amp
        if zero_q:
            qkv[..., : h * hd] = 0
        g = randn((b, l, h * hd), bf16)
        scale = 1.0 / math.sqrt(hd)
        o, lse = MHA.attention_packed(qkv, h, scale)
        want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
        # one bf16 ulp of the largest gradient, at least 2e-2
        atol = max(2e-2, 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7))
        tag = " equal scores" if zero_q else (f" inputs x{amp:g}, lse up to {float(lse.max()):.1f}" if amp != 1.0 else "")
        err = compare(f"attention_bwd_packed [{b},{l},{3 * h * hd}] H={h}{tag}",
                      MHA.attention_bwd_packed(qkv, o, g, lse, h, scale), want, atol)
        check(torch.equal(MHA.attention_bwd_packed(qkv, o, g, lse, h, scale),
                          MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)),
              "attention_bwd_packed: not deterministic")
        if b == BATCH:
            q, k, v = (t.unflatten(-1, (h, hd)).transpose(1, 2).detach().requires_grad_()
                       for t in qkv.chunk(3, dim=-1))
            lib_out = F.scaled_dot_product_attention(q, k, v)
            lib_g = g.unflatten(-1, (h, hd)).transpose(1, 2)
            records["attention_bwd_packed"] = {
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: MHA.attention_bwd_packed(qkv, o, g, lse, h, scale), 20),
                "plain_ms": time_ms(torch, lambda: MHA.attention_bwd_reference(qkv, o, g, lse, h, scale), 5),
                "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (q, k, v), lib_g, retain_graph=True), 20),
                "bytes": qkv.numel() * 2 * 2 + 2 * b * l * h * hd * 2 + b * h * l * 4,
                "tensor_flops": 10.0 * b * h * l * l * hd,
                "f32_flops": 5.0 * b * h * l * l,
            }
    records["sr_attention_fwd"] = sr_attention_records(torch, randn, compare)
    return records


# K10 shapes: SegFormer mit_b0 at 512^2, bs 8 (stages 1-3), the b1-b5
# head dim at stage 1, and a ragged longer KV (Lk 1000: not a multiple of
# the kernel's 32-row K/V tile)
SR_SHAPES = ((BATCH, 1, 16384, 256, 32), (BATCH, 2, 4096, 256, 32), (BATCH, 5, 1024, 256, 32),
             (BATCH, 1, 16384, 256, 64), (2, 3, 1536, 1000, 32))


def sr_attention_records(torch, randn, compare) -> dict:
    """K10 against its plain version in bf16 and f32, twice (it must be
    deterministic), on q/k/v laid out as the path makes them: views of the
    projections' [B, L, H, D] and [B, Lk, 2, H, D] outputs. f32 to 1e-5;
    bf16 to one bf16 ulp of the largest |o| of the plain version (its f32
    result rounded to bf16; |o| <= max |v|, every row a convex mix of v
    rows). Returns the record of the stage-1 bf16 shape; prints the times
    of the others."""
    import torch.nn.functional as F

    from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as SR

    record = None
    for b, h, lq, lk, d in SR_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q = randn((b, lq, h, d), dt).transpose(1, 2)
            kv = randn((b, lk, 2, h, d), dt)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
            scale = d**-0.5
            want = SR.sr_attention_plain(q, k, v, scale)
            top = float(want.float().abs().max())
            tol = 1e-5 if dt == torch.float32 else 2.0 ** (math.floor(math.log2(top)) - 7)
            got = SR.sr_attention_fwd(q, k, v, scale)
            err = compare(f"sr_attention_fwd q [{b},{h},{lq},{d}] kv {lk} {dt}", got, want, tol)
            check(torch.equal(got, SR.sr_attention_fwd(q, k, v, scale)),
                  "sr_attention_fwd: not deterministic")
            if dt != torch.bfloat16:
                continue
            n_s = b * h * lq * lk
            rec = {
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: SR.sr_attention_fwd(q, k, v, scale), 20),
                "plain_ms": time_ms(torch, lambda: SR.sr_attention_plain(q, k, v, scale), 5),
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20),
                "bytes": 2 * (2 * b * h * lq * d + 2 * b * h * lk * d),
                # the card's fastest route at f32 accuracy: q k^T on bf16
                # tensor cores, and p v there too as two bf16 passes (p
                # split into hi + lo halves, v exact in bf16); only the
                # softmax and exp work runs at the f32 rate
                "tensor_flops": 2.0 * n_s * d + 2 * 2.0 * n_s * d,
                "f32_flops": 5.0 * n_s,
            }
            bound_ms, bound_by = bound(rec)
            print(f"    {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, SDPA "
                  f"{rec['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            record = record or rec
    return record


def functions_phase(torch) -> None:
    """The autograd Functions around K2/K3/K4 and K10 on the card (forward
    and backward kernels) against the same Functions on CPU copies of the
    inputs (plain versions), bf16 activations and f32 parameters as under
    autocast: dx, dqkv to the kernels' bf16 tolerances, dgamma/dbeta to
    1e-2 (f32 sums over 394 rows of bf16 products)."""
    from geo_deep_learning_tpu_torch.ops.cuda import layernorm as LN
    from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA
    from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as SR

    gen = torch.Generator().manual_seed(1)
    b, l, d, h = 2, 197, 768, 12
    x, br, dy, ds = (torch.randn((b, l, d), generator=gen).bfloat16() for _ in range(4))
    gamma = 1 + 0.1 * torch.randn(d, generator=gen)
    beta = 0.1 * torch.randn(d, generator=gen)
    qkv = torch.randn((b, l, 3 * d), generator=gen).bfloat16()
    go = torch.randn((b, l, d), generator=gen).bfloat16()

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (x, br, gamma, beta, qkv)]
        xt, brt, gt, bt, qt = leaves
        y = LN.LayerNormFn.apply(xt, gt, bt, 1e-6)
        s, y2 = LN.LayerNormResidualFn.apply(xt, brt, gt, bt, 1e-6)
        o = MHA.attention(qt, h)
        loss = sum((t.float() * w.to(device).float()).sum()
                   for t, w in ((y, dy), (s, ds), (y2, dy), (o, go)))
        loss.backward()
        return [t.grad for t in leaves]

    names = ("dx", "dbranch", "dgamma", "dbeta", "dqkv")
    tols = (3.2e-2, 3.2e-2, 1e-2, 1e-2, 1e-2)
    for name, tol, got, want in zip(names, tols, grads("cuda"), grads("cpu")):
        check(got.device.type == "cuda" and got.dtype == want.dtype, f"{name}: {got.dtype} on {got.device}")
        err = max_err(got.cpu(), want)
        print(f"  Functions, card vs CPU, {name} {tuple(got.shape)} {got.dtype}: "
              f"max_abs_err {err:.3g} (tolerance {tol:g})")
        check(math.isfinite(err) and err <= tol, f"{name}: card and CPU Functions disagree")

    # SRAttentionFn: K10 forward, torch-math backward; bf16 q/k/v of order
    # 1, outputs and gradients of order 1 (one or two bf16 ulps: 1.6e-2)
    q, k, v = (torch.randn(s, generator=gen).bfloat16() for s in ((2, 2, 1024, 32),) + ((2, 2, 64, 32),) * 2)
    g = torch.randn(q.shape, generator=gen).bfloat16()

    def sr_grads(device):
        leaves = [t.to(device).requires_grad_() for t in (q, k, v)]
        o = SR.sr_attention(*leaves, 32**-0.5)
        check(o.grad_fn.name().startswith("SRAttentionFn"), "SRAttentionFn not taken")
        o.backward(g.to(device))
        return [o.detach()] + [t.grad for t in leaves]

    for name, got, want in zip(("o", "dq", "dk", "dv"), sr_grads("cuda"), sr_grads("cpu")):
        err = max_err(got.cpu(), want)
        print(f"  SRAttentionFn, card vs CPU, {name} {tuple(got.shape)} {got.dtype}: "
              f"max_abs_err {err:.3g} (tolerance 1.6e-2)")
        check(got.dtype == want.dtype and math.isfinite(err) and err <= 1.6e-2,
              f"SRAttentionFn {name}: card and CPU disagree")


def bound(rec: dict) -> tuple[float, str]:
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = (rec["tensor_flops"] / BF16_TENSOR_FLOPS + rec["f32_flops"] / F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reference_check(torch, config: dict, size: int) -> None:
    """Two ``size``^2 crops of tst patches through the config's model at
    full width: on the card (bf16 autocast, kernels) against the same
    weights on the CPU (f32, plain versions). A small crop keeps the CPU
    side short."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step

    model_node = copy.deepcopy(config["model"])
    model_node["init_args"]["image_size"] = [size, size]
    spec = instantiate(model_node)
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    batch = _crops(torch, config, size)
    del batch["mask"]
    outs = {}
    for device, precision in (("cuda", "bf16-mixed"), ("cpu", "32-true")):
        spec.task.model = model.to(device)
        step = make_predict_step(spec.task, PrecisionPolicy.create(precision))
        outs[device] = step({k: v.to(device) for k, v in batch.items()})
    got, want = outs["cuda"]["probs"].float().cpu(), outs["cpu"]["probs"]
    err = float((got - want).abs().max())
    agree = float((outs["cuda"]["preds"].cpu() == outs["cpu"]["preds"]).float().mean())
    print(f"  card bf16 vs CPU f32, 2 x {size}^2: max |d prob| {err:.3g} (tolerance 0.05), "
          f"pixel agreement {agree:.5f} (at least 0.99)")
    check(torch.isfinite(got).all().item(), "non-finite probabilities on the card")
    check(err <= 0.05 and agree >= 0.99, "card output disagrees with the CPU reference")


def breakdown(torch, config: dict) -> None:
    """Where the ``test`` wall time goes: the host loader alone over the
    split, then the eval steps alone on batches already on the card."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.steps import make_eval_step, to_device

    t0 = time.perf_counter()
    batches = list(instantiate(config["data"]).test_dataloader())
    host_s = time.perf_counter() - t0
    spec = instantiate(config["model"])
    spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    step = make_eval_step(spec.task, PrecisionPolicy.create("bf16-mixed"))
    on_card = [to_device(b, torch.device("cuda")) for b in batches]
    step(on_card[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in on_card:
        step(b)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    print(f"  breakdown: host loader {host_s:.3f} s for {N_TST} patches "
          f"({1e3 * host_s / N_TST:.2f} ms/patch); eval steps on resident batches "
          f"{steps_s:.3f} s ({1e3 * steps_s / len(on_card):.2f} ms per bs-{BATCH} batch)")


def main_path_phase(torch, smi: str, path: ModelPath) -> None:
    """The reference check at the path's ``ref_size``^2, then ``test`` and
    ``predict`` through the CLI over the tst split with exact launch counts,
    then the host-loader / eval-step breakdown and the path's further
    serving checks."""
    from geo_deep_learning_tpu_torch.cli.main import run
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    n_batches = -(-N_TST // BATCH)
    with tempfile.TemporaryDirectory(prefix="gdl_chip_smoke_") as tmp:
        config = data_config(path)
        config["trainer"]["default_root_dir"] = tmp

        reference_check(torch, config, path.ref_size)

        for sub in ("test", "predict"):
            torch.cuda.synchronize()
            _lib.reset_launches()
            t0 = time.perf_counter()
            result = run(config, sub, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = dict(_lib.LAUNCHES)
            print(f"  {sub}: {result}")
            print(f"  {sub}: {N_TST} patches in {seconds:.2f} s = {N_TST / seconds:.2f} patches/s "
                  f"(bs {BATCH}, 512^2, {path.label}, bf16-mixed) on {smi}")
            print(f"  {sub}: launches {got}")
            want = {k: v * n_batches for k, v in path.per_batch.items()}
            check(got == want, f"{sub}: launches {got}, expected {want}")
            if sub == "test":
                check(all(math.isfinite(v) for v in result.values()), "non-finite test metric")
                check(0.0 <= result["test_miou"] <= 1.0, "test_miou out of [0, 1]")
            else:
                files = sorted(Path(result["output_dir"]).glob("*_pred.tif"))
                check(result["num_predictions"] == N_TST and len(files) == N_TST,
                      f"expected {N_TST} rasters, found {len(files)}")
                raster, _ = read_geotiff(files[0])
                check(raster.shape == (512, 512, 1) and raster.dtype.name == "uint8"
                      and set(raster.ravel().tolist()) <= {0, 1}, "bad prediction raster")
        breakdown(torch, config)
        for extra in path.serving_checks:
            extra(torch, config)


def dynamic_check(torch, config: dict) -> None:
    """One bs-8 512^2 forward of SegFormer with the channel-agnostic
    Dynamic MiT on a 4-band batch (tst patches with their first band
    repeated): finite logits of the input's size, K1 once and K10 six
    times."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step

    node = copy.deepcopy(config["model"])
    node["init_args"]["use_dynamic_encoder"] = True
    spec = instantiate(node)
    spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    data = instantiate(config["data"])
    data.setup("test")
    images = np.stack([data.datasets["tst"][i]["image"] for i in range(BATCH)])
    mean, std = config["data"]["init_args"]["mean"], config["data"]["init_args"]["std"]
    batch = {
        "image": torch.from_numpy(np.concatenate([images, images[..., :1]], axis=-1)).cuda(),
        "mean": torch.tensor(mean + mean[:1], device="cuda"),
        "std": torch.tensor(std + std[:1], device="cuda"),
    }
    step = make_predict_step(spec.task, PrecisionPolicy.create("bf16-mixed"))
    torch.cuda.synchronize()
    _lib.reset_launches()
    probs = step(batch)["probs"]
    torch.cuda.synchronize()
    got = dict(_lib.LAUNCHES)
    print(f"  Dynamic MiT, 4 bands, bs {BATCH} 512^2: probs {tuple(probs.shape)}, launches {got}")
    check(probs.shape == (BATCH, 1, 512, 512) and torch.isfinite(probs).all().item(),
          "Dynamic MiT: bad output")
    check(got == SEG_PER_BATCH, f"Dynamic MiT: launches {got}, expected {SEG_PER_BATCH}")


def _crops(torch, config: dict, size: int) -> dict:
    """Two ``size``^2 crops of tst patches 0 and 1 as a host batch."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate

    data = instantiate(config["data"])
    data.setup("test")
    samples = [data.datasets["tst"][i] for i in (0, 1)]
    return {
        "image": torch.from_numpy(np.stack([s["image"][:size, :size] for s in samples])),
        "mask": torch.from_numpy(np.stack([s["mask"][:size, :size] for s in samples])),
        "mean": torch.from_numpy(samples[0]["mean"]),
        "std": torch.from_numpy(samples[0]["std"]),
    }


def _train_once(torch, spec, model, batch: dict, precision: str, freeze=None):
    """One train step of ``model`` (no augmentation, no clipping) -> (loss,
    gradients by name, launches). The optimizer's LR is 0 (the weights do
    not move) unless the encoder is frozen, where Adam at 1e-3 shows what
    moves."""
    import dataclasses

    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.ops.cuda import _lib
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_train_step

    optim.freeze(model, freeze)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = optim.build_optimizer(params, "adam", 1e-3) if freeze else torch.optim.SGD(params, lr=0.0)
    grads = {}
    opt.register_step_pre_hook(lambda o, a, k: grads.update(
        {n: p.grad.detach().float().cpu() for n, p in model.named_parameters() if p.grad is not None}))
    task = dataclasses.replace(spec.task, model=model)
    step = make_train_step(task, PrecisionPolicy.create(precision), augment=None, grad_clip=None)
    device = next(model.parameters()).device
    _lib.reset_launches()
    out = step(TrainState.create(model, opt, 0), {k: v.to(device) for k, v in batch.items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    return float(out["loss"]), grads, dict(_lib.LAUNCHES)


def cosine(a, b) -> float:
    a, b = a.double(), b.double()  # an f32 sum over ~1e6 terms can exceed 1
    return float((a * b).sum() / (a.norm() * b.norm()))


def _three_steps(torch, config: dict, size: int, launches_want: dict):
    """The config's model at full width, DropPath and dropout off, one train
    step on two ``size``^2 crops: on the card (bf16, kernels; its launches
    must be ``launches_want``), and on CPU copies in f32 and in bf16-mixed
    (plain versions). Returns ``(spec, batch, (card loss, card grads), (f32
    loss, f32 grads), (plain bf16 loss, plain bf16 grads))``."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout

    node = copy.deepcopy(config["model"])
    node["init_args"]["image_size"] = [size, size]
    spec = instantiate(node)
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    cpu_models = [copy.deepcopy(model).to("cpu") for _ in range(2)]
    batch = _crops(torch, config, size)
    loss, grads, launches = _train_once(torch, spec, model, batch, "bf16-mixed")
    check(launches == launches_want, f"train step launches {launches}, expected {launches_want}")
    f32_loss, f32_grads, _ = _train_once(torch, spec, cpu_models[0], batch, "32-true")
    plain_loss, plain_grads, _ = _train_once(torch, spec, cpu_models[1], batch, "bf16-mixed")
    check(set(grads) == set(f32_grads) == set(plain_grads), "steps reached different parameters")
    return spec, batch, (loss, grads), (f32_loss, f32_grads), (plain_loss, plain_grads)


def train_reference_check(torch, config: dict) -> None:
    """One full-width train step on two 128^2 crops, on the card (bf16
    autocast, kernels K1-K7) and with the same weights on the CPU, in f32
    and in bf16-mixed (plain versions); DropPath and dropout off.

    The Dice loss must agree with f32 to 2e-2. Gradients are held against
    f32 for the weight and LayerScale tensors of the encoder's blocks, the
    tensors that K5-K7 reach (their biases are left out: ahead of the
    neck's BatchNorm their token sums cancel to ~1e-13, pure rounding
    noise in any precision). bf16 alone takes these gradients well away
    from f32 at random weights (per-tensor cosines of 0.92-0.98 on the
    CPU's plain path, measured at a narrow width), so the bound is
    relative: per tensor, the card's cosine to f32 must be at least 0.5
    (a wrong sign or scrambled heads gives about 0 or less) and at least
    the plain bf16 path's cosine minus 0.1; over all of them together,
    the card's cosine must be at least the plain path's minus 0.02 and the
    gradients' norm within 10 % of f32's. Then a frozen-encoder step on the
    card must launch no K5-K7 and leave the encoder as it was."""
    size = 128
    spec, batch, (loss, grads), (f32_loss, f32_grads), (_, plain_grads) = _three_steps(
        torch, config, size, PER_TRAIN_STEP)
    names = [n for n in f32_grads if n.startswith("encoder.blocks.") and not n.endswith(".bias")]
    card = {n: cosine(grads[n], f32_grads[n]) for n in names}
    plain = {n: cosine(plain_grads[n], f32_grads[n]) for n in names}
    flat = [torch.cat([g[n].flatten() for n in names]) for g in (grads, plain_grads, f32_grads)]
    all_card, all_plain = cosine(flat[0], flat[2]), cosine(flat[1], flat[2])
    ratio = float(flat[0].norm() / flat[2].norm())
    worst = min(names, key=lambda n: card[n] - plain[n])
    print(f"  train step, card bf16 vs CPU f32, 2 x {size}^2: loss {loss:.6f} vs {f32_loss:.6f} "
          f"(tolerance 2e-2)")
    print(f"  {len(names)} encoder-block gradients vs f32: cosine card {min(card.values()):.4f} "
          f"lowest, {all_card:.4f} all together (norm ratio {ratio:.4f}); plain bf16 "
          f"{min(plain.values()):.4f} lowest, {all_plain:.4f} together; largest shortfall "
          f"{plain[worst] - card[worst]:.4f} ({worst})")
    check(math.isfinite(loss) and abs(loss - f32_loss) <= 2e-2, "train loss disagrees with f32")
    check(all(card[n] >= max(0.5, plain[n] - 0.1) for n in names), "encoder gradients disagree")
    check(all_card >= all_plain - 0.02 and abs(ratio - 1.0) <= 0.1, "encoder gradients disagree")

    frozen = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    before = {n: p.detach().clone() for n, p in frozen.named_parameters()}
    _, fgrads, launches = _train_once(torch, spec, frozen, batch, "bf16-mixed", ["encoder"])
    moved = {n for n, p in frozen.named_parameters() if not torch.equal(p.detach(), before[n])}
    print(f"  frozen-encoder step: launches {launches}; {len(moved)} tensors moved, none in the encoder")
    check(not any(k in launches for k in BACKWARD), "a frozen encoder launched a backward kernel")
    check(all(launches.get(k) == v for k, v in PER_BATCH.items()), "frozen step: forward launches")
    check(moved and not any(n.startswith("encoder.") for n in moved | set(fgrads)),
          "a frozen encoder moved or got gradients")


def segformer_train_check(torch, config: dict) -> None:
    """One full-width SegFormer mit_b0 train step on two whole 512^2
    patches, on the card (bf16 autocast, K1 and K10 at all three of its
    path shapes) and with the same weights on the CPU in f32 and in
    bf16-mixed (plain versions); DropPath and dropout off. Gradients are
    compared per encoder stage (its patch embedding, blocks and norm, all
    weights but the biases, which ahead of a LayerNorm or the decoder's
    BatchNorm carry rounding noise) and over the whole encoder.

    Limits, from the readings on an H100 80GB HBM3 (the plain bf16 path is
    printed beside them as the yardstick): 1 - cosine to f32 at most
    SEG_COS_GAP per stage and over the encoder (card 9e-6 to 2.5e-5, plain
    bf16 3.1e-5 to 1.0e-4: ten times the card's worst, and 2.4 times the
    plain path's, while a scrambled head or tile is off by 1e-2 or more);
    the encoder gradients' norm within 1e-2 of f32's (card 1.1e-3); the
    Dice loss within 5e-4 of f32 (card 1.2e-5, plain bf16 8.2e-5)."""
    size = 512
    _, _, (loss, grads), (f32_loss, f32_grads), (plain_loss, plain_grads) = _three_steps(
        torch, config, size, SEG_PER_TRAIN_STEP)

    def flat(g, names):
        return torch.cat([g[n].flatten() for n in names])

    print(f"  SegFormer train step, 2 x {size}^2: loss card bf16 {loss:.7f}, CPU f32 "
          f"{f32_loss:.7f}, plain bf16 {plain_loss:.7f}; |card - f32| {abs(loss - f32_loss):.3e}, "
          f"|plain - f32| {abs(plain_loss - f32_loss):.3e} (tolerance 5e-4)")
    check(math.isfinite(loss) and abs(loss - f32_loss) <= 5e-4, "train loss disagrees with f32")
    every = []
    for stage in range(1, 5):
        names = [n for n in f32_grads if not n.endswith(".bias") and any(
            n.startswith(f"encoder.{part}{stage}") for part in ("patch_embed", "block", "norm"))]
        every += names
        card = cosine(flat(grads, names), flat(f32_grads, names))
        plain = cosine(flat(plain_grads, names), flat(f32_grads, names))
        print(f"  stage {stage}, {len(names)} weight gradients vs f32: 1 - cosine card "
              f"{1 - card:.3e}, plain bf16 {1 - plain:.3e} (tolerance {SEG_COS_GAP:g})")
        check(1 - card <= SEG_COS_GAP, f"stage {stage} gradients disagree")
    card = cosine(flat(grads, every), flat(f32_grads, every))
    plain = cosine(flat(plain_grads, every), flat(f32_grads, every))
    ratio = float(flat(grads, every).norm() / flat(f32_grads, every).norm())
    print(f"  encoder, {len(every)} gradients: 1 - cosine card {1 - card:.3e}, plain bf16 "
          f"{1 - plain:.3e} (tolerance {SEG_COS_GAP:g}), norm ratio {ratio:.6f} (within 1e-2 of 1)")
    check(1 - card <= SEG_COS_GAP and abs(ratio - 1.0) <= 1e-2, "encoder gradients disagree")


def train_timing(torch, config: dict, smi: str, tmp: Path, label: str) -> None:
    """Train steps on bs-8 512^2 batches already on the card (augmentation
    on, as in fit), and one checkpoint write of the whole train state."""
    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager
    from geo_deep_learning_tpu_torch.training.steps import make_train_step, to_device

    spec = instantiate(config["model"])
    model = spec.task.materialize(torch.device("cuda"), config["seed_everything"])
    state = TrainState.create(model, optim.build_optimizer(model.parameters(), "adam", 6e-5), 0)
    step = make_train_step(spec.task, PrecisionPolicy.create("bf16-mixed"))
    loader = instantiate(config["data"]).test_dataloader()
    batches = [to_device(b, torch.device("cuda")) for b, _ in zip(loader, range(3))]
    for b in batches[:2]:
        step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 6
    t0 = time.perf_counter()
    for i in range(n):
        step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    path = CheckpointManager(tmp / "timing").save_last(state)
    write_s = time.perf_counter() - t0
    print(f"  {label} train steps on resident batches: {ms:.2f} ms per bs-{BATCH} 512^2 step "
          f"= {1e3 * BATCH / ms:.2f} patches/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {smi}")
    print(f"  checkpoint write: {write_s:.3f} s for {path.stat().st_size / 2**30:.3f} GiB; on {smi}")
    path.unlink()
    profile_steps(torch, lambda i: step(state, batches[i % len(batches)]), ms, smi)


# kernel-name fragments -> family, tried in order (cuDNN's convolution
# kernels are xmma kernels too, so they are matched first)
FAMILIES = (
    ("K1-K10", ("preprocess_kernel", "layernorm_fwd_kernel", "layernorm_bwd_kernel",
                "attention_fwd_packed_kernel", "attention_bwd_", "sr_attention_fwd_kernel")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma")),
)


def profile_steps(torch, step, step_ms: float, smi: str, n: int = 2) -> None:
    """Device time of ``n`` train steps by kernel family and the largest
    kernels. The card's idle share is taken against ``step_ms``, the step
    time measured without the profiler, whose own host work slows the
    profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    check(bool(kernels), "the profiler recorded no kernel on the card")
    families = {name: 0.0 for name, _ in FAMILIES} | {"other": 0.0}
    for name, us in kernels.items():
        low = name.lower()
        fam = next((f for f, keys in FAMILIES if any(k.lower() in low for k in keys)), "other")
        families[fam] += us
    busy = sum(kernels.values())
    print(f"  profile of {n} train steps: {busy / n / 1e3:.2f} ms of kernels per step "
          f"({wall_us / n / 1e3:.2f} ms wall under the profiler); against the unprofiled "
          f"{step_ms:.2f} ms step the card is idle {100 * (1 - busy / n / 1e3 / step_ms):.1f} %; "
          f"on {smi}")
    print("  by family, ms per step: " + ", ".join(
        f"{f} {us / n / 1e3:.2f}" for f, us in sorted(families.items(), key=lambda kv: -kv[1])))
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / n / 1e3:8.3f} ms  {name[:110]}")


def fit_phase(torch, smi: str, tmp: Path, path: ModelPath) -> dict[str, int]:
    """``run(config, "fit")`` for 2 epochs over trn/val/tst CSVs cut from
    the tst split, then ``run(config, "test")`` from its best checkpoint.
    Returns the fit's launch counts."""
    from geo_deep_learning_tpu_torch.cli.main import run
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    rows = [r for r in (DATA / "tst.csv").read_text().splitlines() if r.strip()]
    check(len(rows) == N_TST, f"expected {N_TST} tst rows, found {len(rows)}")
    csv_dir = tmp / "csv"
    csv_dir.mkdir(exist_ok=True)
    for split, part in (("trn", rows[:N_TRN]), ("val", rows[N_TRN:N_TRN + N_VAL]), ("tst", rows)):
        (csv_dir / f"{split}.csv").write_text("\n".join(part) + "\n")
    config = copy.deepcopy(path.config)
    config["trainer"].update(default_root_dir=str(tmp / "fit"), max_epochs=FIT_EPOCHS)
    config["data"]["init_args"].update(csv_root_folder=str(csv_dir), patches_root_folder=str(DATA))

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    result = run(copy.deepcopy(config), "fit", device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_lib.LAUNCHES)
    n_train = FIT_EPOCHS * (N_TRN // BATCH)
    n_eval = FIT_EPOCHS * -(-N_VAL // BATCH) + -(-N_TST // BATCH)
    want = {k: v * n_train + path.per_batch.get(k, 0) * n_eval for k, v in path.per_step.items()}
    per_step = {k: (counts.get(k, 0) - path.per_batch.get(k, 0) * n_eval) / n_train for k in want}
    print(f"  fit: {FIT_EPOCHS} epochs x {N_TRN // BATCH} steps, {n_eval} evaluated batches, "
          f"{seconds:.2f} s in all; last epoch {result['patches_per_sec']:.2f} train patches/s "
          f"(loader included; bs {BATCH}, 512^2, {path.label}, bf16-mixed) on {smi}")
    print(f"  fit: {result}")
    print(f"  fit: launches {counts}; per train step {per_step}")
    check(counts == want, f"fit: launches {counts}, expected {want}")
    check(all(math.isfinite(v) for v in result.values()), "non-finite fit metric")
    index = json.loads((tmp / "fit" / "checkpoints" / "index.json").read_text())
    best = index["best_path"]
    check(best is not None and Path(best).exists(), "fit wrote no best checkpoint")

    tested = run(copy.deepcopy(config), "test", device="cuda", ckpt_path=best)
    auto = {k: v for k, v in result.items() if k.startswith("test_")}
    diff = max(abs(tested[k] - auto[k]) for k in auto)
    print(f"  test from {Path(best).name}: {tested}; largest difference from the auto-test "
          f"{diff:.3g} (tolerance 1e-4)")
    check(set(tested) == set(auto) and diff <= 1e-4, "restored test disagrees with the auto-test")
    return counts


DOFA = ModelPath("DOFA-base + UperNet", CONFIG, PER_BATCH, PER_TRAIN_STEP, 128,
                 train_reference_check)
SEGFORMER = ModelPath("SegFormer mit_b0", SEGFORMER_CONFIG, SEG_PER_BATCH, SEG_PER_TRAIN_STEP,
                      512, segformer_train_check, (dynamic_check,))
PATHS = (DOFA, SEGFORMER)


def data_config(path: ModelPath) -> dict:
    """The path's config reading data/waterloo of this checkout."""
    config = copy.deepcopy(path.config)
    config["data"]["init_args"].update(csv_root_folder=str(DATA), patches_root_folder=str(DATA))
    return config


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "geo_deep_learning_tpu_torch").is_dir() or not DATA.is_dir():
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    t_start = time.perf_counter()
    with Phase("device"):
        smi = device_phase(torch)
    with Phase("build"):
        _, seconds = _lib.build()
        _lib.library()
        print(f"  nvcc: {seconds:.1f} s (0.0 = up-to-date build reused)")
    with Phase("kernels"):
        records = kernels_phase(torch)
        for name, rec in records.items():
            bound_ms, bound_by = bound(rec)
            lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
            print(f"  {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                  f"library {lib} ms, bound {bound_ms:.4f} ms ({bound_by})")
        for path in PATHS:
            fwd = sum(path.per_batch[k] * records[k]["ms"] for k in path.per_batch)
            step = sum(path.per_step[k] * records[k]["ms"] for k in path.per_step)
            print(f"  {path.label}: kernels per bs-{BATCH} forward {fwd:.3f} ms of device time "
                  f"(K10 at its stage-1 time); per train step {step:.3f} ms")
        functions_phase(torch)
    launches: collections.Counter = collections.Counter()
    for path in PATHS:
        with Phase(f"{path.label} serving path"):
            main_path_phase(torch, smi, path)
        with Phase(f"{path.label} training path"), \
                tempfile.TemporaryDirectory(prefix="gdl_chip_fit_") as tmp:
            config = data_config(path)
            path.train_check(torch, config)
            launches.update(fit_phase(torch, smi, Path(tmp), path))
            train_timing(torch, config, smi, Path(tmp), path.label)

    kernels = []
    for name, rec in records.items():
        bound_ms, bound_by = bound(rec)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": launches.get(name, 0),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": rec["library_ms"],
        })
    check(sorted(k["name"] for k in kernels)
          == sorted(set().union(*(path.per_step for path in PATHS))),
          "missing kernel record")
    check(all(k["launches"] > 0 for k in kernels), "a kernel was not launched on the fit paths")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
