"""Run one cell of the port's benchmark on this machine's card.

    python3 gdl_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; the numbers
that decided ``correct`` come last, under ``compared``, and as the last
lines of standard error. Without a CUDA card, without the program beside
it, or once JAX or the JAX package has been loaded, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "geo_deep_learning_tpu_torch").is_dir():
        print(f"no geo_deep_learning_tpu_torch beside {ROOT / 'gdl_bench'}", file=sys.stderr)
        return 2
    sys.path[0] = str(ROOT)  # in place of this script's own folder
    from gdl_bench import harness

    harness.cache_env(ROOT)
    import torch

    phases = [("torch", time.perf_counter() - T0)]

    bench = harness.benchmark(ROOT)
    chips = harness.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)  # the card's context
    phases.append(("cuda", time.perf_counter() - T0))
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device, T0,
                         ROOT, phases=phases)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
