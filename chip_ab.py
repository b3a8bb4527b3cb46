#!/usr/bin/env python3
"""A/B of two checkouts of the port on one H100: host cost of the kernel
calls and the DOFA-base 512^2 train step.

Run from the root of a checkout (the change), with a second checkout (the
base, e.g. an unpacked ``git archive`` of the parent commit) in a directory
that ``.gitignore`` lists::

    python3 chip_ab.py --base build/ab_base [--rounds 1]

Each round runs four worker processes in turns, base, change, change, base;
each worker imports the port from its checkout and measures, with this
checkout's ``chip_smoke.py`` helpers:

- ``op_host_us``: the host time of one call of every kernel call on the
  DOFA-base 512^2 bf16 path (K1-K7 through their public wrappers, and the
  LayerNorm module and attention with inputs that require gradients), and
  of the library calls beside them;
- the bs-8 bf16 train step of DOFA-base + UperNet on tst batches already on
  the card (``resident_step_ms``, ``STEPS`` steps after two warm-up steps).

Before the workers, the driver times the two ways ``torch.library`` offers
to define an operator with a Python kernel, on a toy elementwise op of a
CUDA tensor: ``@torch.library.custom_op`` and a ``Library`` ``define`` /
``impl`` with ``register_fake`` / ``register_autograd``, each without and
with an input that requires gradients (host us a call, the least of 9
rounds of 2000 calls).

The kernels are built once, in this checkout, and the build is copied to
the base (its stamp, the hash of ``csrc/`` and the flags, decides whether
the base reuses it). Prints each worker's line, then the medians and
change/base ratios, the card's name and power limit; exits non-zero if a
worker fails or CUDA is not available.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 20
TIMEOUT_S = 600


def worker(tree: Path) -> None:
    sys.path.insert(0, str(tree))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import geo_deep_learning_tpu_torch as port
    from geo_deep_learning_tpu_torch.cli.config import instantiate

    if Path(port.__file__).resolve().parents[1] != tree.resolve():
        msg = f"imported the port from {port.__file__}, not from {tree}"
        raise RuntimeError(msg)
    host = cs.op_host_us(torch)
    config = cs.CONFIG
    loader = instantiate(config["data"]).test_dataloader()
    batches = [cs.to_card(torch, b) for b, _ in zip(loader, range(3))]
    step_ms, peak = cs.resident_step_ms(torch, instantiate(config["model"]), batches,
                                        "bf16-mixed", n=STEPS)
    print("AB " + json.dumps({"tree": str(tree), "step_ms": step_ms, "peak_gib": peak,
                              "host_us": host}), flush=True)


def registration_us(torch) -> dict[str, float]:
    """Host us a call of a toy op defined each way, and of a plain call."""
    from torch.library import Library

    def kernel(x, w):
        return x * w

    def backward(ctx, g):
        return g * ctx.w, None

    def setup(ctx, inputs, output):
        ctx.w = inputs[1]

    mul_custom = torch.library.custom_op("gdl_ab::mul_custom", kernel, mutates_args=(),
                                         schema="(Tensor x, Tensor w) -> Tensor")

    mul_custom.register_fake(lambda x, w: torch.empty_like(x))
    mul_custom.register_autograd(backward, setup_context=setup)
    lib = Library("gdl_ab", "FRAGMENT")
    lib.define("mul_lib(Tensor x, Tensor w) -> Tensor")
    lib.impl("mul_lib", kernel, "CUDA")
    torch.library.register_fake("gdl_ab::mul_lib", lambda x, w: torch.empty_like(x), lib=lib)
    torch.library.register_autograd("gdl_ab::mul_lib", backward, setup_context=setup, lib=lib)
    x, w = torch.ones(8, device="cuda"), torch.ones(8, device="cuda")
    xg = x.clone().requires_grad_()
    fns = {"plain": kernel, "custom_op": torch.ops.gdl_ab.mul_custom.default,
           "Library": torch.ops.gdl_ab.mul_lib.default}
    out = {}
    for grad in (False, True):
        for name, fn in fns.items():
            arg = xg if grad else x
            best = float("inf")
            for _ in range(9):
                t0 = time.perf_counter()
                for _ in range(2000):
                    fn(arg, w)
                best = min(best, (time.perf_counter() - t0) / 2000 * 1e6)
                torch.cuda.synchronize()
            out[f"{name}{' (grad)' if grad else ''}"] = best
    return out


def median(values: list[float]) -> float:
    values = sorted(values)
    mid = len(values) // 2
    return values[mid] if len(values) % 2 else 0.5 * (values[mid - 1] + values[mid])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", type=Path, required=True, help="the other checkout's root")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    base = args.base.resolve()
    _, seconds = _lib.build()
    print(f"nvcc: {seconds:.1f} s")
    target = base / _lib.BUILD_DIR.relative_to(ROOT)
    shutil.rmtree(target, ignore_errors=True)
    shutil.copytree(_lib.BUILD_DIR, target)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for name, us in registration_us(torch).items():
        print(f"registration {name}: {us:.2f} us a call; on {smi}")
    results: dict[str, list[dict]] = {"base": [], "change": []}
    for _ in range(args.rounds):
        for label in ("base", "change", "change", "base"):
            tree = base if label == "base" else ROOT
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ROOT / "chip_ab.py"), "--base", str(base),
                                   "--worker", str(tree)], capture_output=True, text=True,
                                  timeout=TIMEOUT_S, check=False)
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
                return 1
            line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("AB "))
            rec = json.loads(line[3:])
            results[label].append(rec)
            print(f"{label}: step {rec['step_ms']:.2f} ms, peak {rec['peak_gib']:.2f} GiB, host us "
                  + ", ".join(f"{k} {v[0]:.2f}" for k, v in rec["host_us"].items())
                  + f" ({time.perf_counter() - t0:.0f} s)", flush=True)
    step = {k: median([r["step_ms"] for r in v]) for k, v in results.items()}
    print(f"DOFA-base 512^2 bf16 train step on resident batches, median of "
          f"{len(results['base'])} turns of {STEPS} steps: base {step['base']:.2f} ms, change "
          f"{step['change']:.2f} ms, change/base {step['change'] / step['base']:.4f}; on {smi}")
    for name in results["change"][0]["host_us"]:
        b, c = (median([r["host_us"][name][0] for r in results[k]]) for k in ("base", "change"))
        lib = median([r["host_us"][name][1] for r in results["change"]
                      if r["host_us"][name][1] is not None] or [float("nan")])
        print(f"host_us {name}: base {b:.2f} us, change {c:.2f} us (+{c - b:.2f}), "
              f"library {lib:.2f} us; on {smi}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
