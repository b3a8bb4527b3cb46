#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``geo_deep_learning_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device  -- the card's name and power limit (``nvidia-smi``); the card
   must be Hopper (compute capability 9.0).
2. build   -- the port's CUDA kernels, one ``nvcc`` call into one library.
3. kernels -- each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at ragged ones, with its time, the plain
   version's time, one library call's time where PyTorch has one (a
   yardstick only; the port never calls it) and the least time the card
   could take for the same bytes or operations.
4. main path -- the CLI's ``run(config, "test")`` over the 100 patches of
   the ``tst`` split of ``data/waterloo``, then ``run(config, "predict")``
   into a temporary directory, at the full width of DOFA-base + UperNet
   with seeded random weights; launch counts must be 1/4/20/12 per batch.
   Before that, two 128^2 crops through the full-width model on the card
   (bf16, kernels) are held against the same weights on the CPU (f32,
   plain versions).

Prints one JSON line of kernel records, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero; without CUDA, or outside a checkout, it exits
non-zero before printing any result. A watchdog ends a hung run after 900 s.
"""

from __future__ import annotations

import faulthandler
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WATCHDOG_S = 900
ROOT = Path(__file__).resolve().parent
DATA = ROOT / "data" / "waterloo"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

BATCH = 8
N_TST = 100
# kernel launches per 512^2 DOFA-base forward: K1 once; K2 at blocks 0, 5,
# 7, 11 (each starts without a pending branch: taps 4, 6, 10, 11); K3 at
# norm1 of the other 8 blocks and norm2 of all 12; K4 once per block
PER_BATCH = {
    "preprocess": 1,
    "layernorm_fwd": 4,
    "layernorm_residual_fwd": 20,
    "attention_fwd_packed": 12,
}
SOURCES = {
    "preprocess": ("geo_deep_learning_tpu_torch/csrc/preprocess.cu",
                   "geo_deep_learning_tpu/ops/pallas/preprocess.py:33"),
    "layernorm_fwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                      "geo_deep_learning_tpu/ops/pallas/layernorm.py:50"),
    "layernorm_residual_fwd": ("geo_deep_learning_tpu_torch/csrc/layernorm.cu",
                               "geo_deep_learning_tpu/ops/pallas/layernorm.py:93"),
    "attention_fwd_packed": ("geo_deep_learning_tpu_torch/csrc/attention.cu",
                             "geo_deep_learning_tpu/ops/pallas/mha.py:255"),
}

# the port config (geo_deep_learning_tpu_torch/configs/dofa_upernet_waterloo.yaml)
# as a dict: the machine with the card has no YAML parser
CONFIG = {
    "seed_everything": 42,
    "trainer": {"precision": "bf16-mixed", "default_root_dir": "runs/torch_dofa_waterloo"},
    "model": {
        "class_path": "geo_deep_learning_tpu_torch.tasks.SegmentationDOFA",
        "init_args": {
            "encoder": "dofa_base",
            "pretrained": False,
            "image_size": [512, 512],
            "num_classes": 1,
            "wavelengths": [0.665, 0.549, 0.481],
            "loss": {
                "class_path": "geo_deep_learning_tpu_torch.ops.losses.DiceLoss",
                "init_args": {"mode": "binary"},
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
    return records


def bound(rec: dict) -> tuple[float, str]:
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = (rec["tensor_flops"] / BF16_TENSOR_FLOPS + rec["f32_flops"] / F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reference_check(torch, config: dict) -> None:
    """Two 128^2 crops of tst patches through DOFA-base + UperNet at full
    width: on the card (bf16 autocast, kernels) against the same weights
    on the CPU (f32, plain versions). The crop keeps the CPU side short."""
    import numpy as np

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step

    size = 128
    model_node = json.loads(json.dumps(config["model"]))
    model_node["init_args"]["image_size"] = [size, size]
    spec = instantiate(model_node)
    model = spec.materialize(torch.device("cuda"), config["seed_everything"])
    data = instantiate(config["data"])
    data.setup("test")
    samples = [data.datasets["tst"][i] for i in (0, 1)]
    batch = {
        "image": torch.from_numpy(np.stack([s["image"][:size, :size] for s in samples])),
        "mean": torch.from_numpy(samples[0]["mean"]),
        "std": torch.from_numpy(samples[0]["std"]),
    }
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
    from geo_deep_learning_tpu_torch.cli.main import to_device
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.steps import make_eval_step

    t0 = time.perf_counter()
    batches = list(instantiate(config["data"]).test_dataloader())
    host_s = time.perf_counter() - t0
    spec = instantiate(config["model"])
    spec.materialize(torch.device("cuda"), config["seed_everything"])
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


def main_path_phase(torch, smi: str) -> dict[str, int]:
    from geo_deep_learning_tpu_torch.cli.main import run
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    n_batches = -(-N_TST // BATCH)
    with tempfile.TemporaryDirectory(prefix="gdl_chip_smoke_") as tmp:
        config = json.loads(json.dumps(CONFIG))
        config["trainer"]["default_root_dir"] = tmp
        config["data"]["init_args"]["csv_root_folder"] = str(DATA)
        config["data"]["init_args"]["patches_root_folder"] = str(DATA)

        reference_check(torch, config)

        counts = {}
        for sub in ("test", "predict"):
            torch.cuda.synchronize()
            _lib.reset_launches()
            t0 = time.perf_counter()
            result = run(config, sub, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = dict(_lib.LAUNCHES)
            counts.setdefault("test", got)
            print(f"  {sub}: {result}")
            print(f"  {sub}: {N_TST} patches in {seconds:.2f} s = {N_TST / seconds:.2f} patches/s "
                  f"(bs {BATCH}, 512^2, DOFA-base + UperNet, bf16-mixed) on {smi}")
            print(f"  {sub}: launches {got}")
            want = {k: v * n_batches for k, v in PER_BATCH.items()}
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
    return counts["test"]


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
        per_batch = sum(PER_BATCH[k] * rec["ms"] for k, rec in records.items())
        print(f"  the four kernels per bs-{BATCH} forward: {per_batch:.3f} ms of device time")
    with Phase("main path"):
        launches = main_path_phase(torch, smi)

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
    check(sorted(k["name"] for k in kernels) == sorted(PER_BATCH), "missing kernel record")
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
