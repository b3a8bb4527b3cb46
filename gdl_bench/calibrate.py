"""Readings that the limits of ``workloads/<cell>.json`` are set from.

    python3 gdl_bench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control <k>] [--faults <fault> ...] [--seconds <s>]

For each seed, one run of the cell in this process with a short window
(the readings need none for training, and one long enough to serve the
sampled scenes for scenes): the program's numbers, and for the first
``k`` seeds the control's (the plain reference in fp8, put in the
program's place); then each named fault planted in the program on the
first three seeds (``unchanged`` and ``half_batch`` for training,
``half_batch`` and ``altered`` for scenes). One JSON line a run; with
``--detail``, the training numbers' three worst leaves beside them. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--detail", action="store_true")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)  # in place of this script's own folder
    from gdl_bench import checks, harness

    detail = []
    if args.detail:
        numbers = checks.train_numbers

        def spy(program, reference):
            detail.append(worst_leaves(checks, program, reference))
            return numbers(program, reference)

        checks.train_numbers = spy

    harness.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runs = [(s, None, i < args.control) for i, s in enumerate(args.seeds)]
    runs += [(s, f, False) for f in args.faults for s in args.seeds[:args.fault_seeds]]
    for seed, fault, control in runs:
        t = time.perf_counter()
        r = harness.run(args.workload, seed, args.seconds, False, device, t, ROOT,
                        all_numbers=True, fault=fault, control=control)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "numbers": r["numbers"],
                "control": r.get("control"), "attempted": r["attempted"],
                "run_s": time.perf_counter() - t, "worst": detail[:]}
        detail.clear()
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def worst_leaves(checks, program: dict, reference: dict, n: int = 3) -> dict:
    """The ``n`` leaves with the largest gaps of the first gradient's and
    the change's norms: ``[name, gap, program, reference]``."""
    import statistics

    out = {}
    ref_change = checks.change_norms(reference["delta"], reference["grad1"])
    pairs = {"grad": (program["grad"], reference["grad"]),
             "change": (checks.change_norms(program["delta"], reference["grad1"]), ref_change)}
    for key, (prog, ref) in pairs.items():
        med = statistics.median(ref.values())
        gaps = sorted(((abs(prog.get(k, 0.0) - v) / max(v, med, 1e-30), k, prog.get(k, 0.0), v)
                       for k, v in ref.items()), reverse=True)[:n]
        out[key] = [[k, g, p, v] for g, k, p, v in gaps]
    return out


if __name__ == "__main__":
    sys.exit(main())
