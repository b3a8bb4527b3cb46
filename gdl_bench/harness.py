"""The harness: finds a cell's files by name, runs its driver, reads the
per-layer metrics and prints the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the model's sizes, its ``family`` (which
  names ``reference/<family>.py`` and ``counts/<family>.py``) and the
  ``port`` node that builds it in the program;
- ``traffic/<traffic>.json``: the traffic's parameters; its ``kind`` names
  the general generator ``drivers/<kind>.py``;
- ``workloads/<cell>.json``: the cell's limits on the numbers that decide
  ``correct`` (and the readings each was set from);
- ``metrics/<metric>.py``: a per-layer metric's reader.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "geo_deep_learning_tpu")
BREAKDOWN_ENTRIES = 10


@dataclass
class Ctx:
    """What a driver needs for one run."""

    cfg: dict
    traffic: dict
    cell: dict
    device: Any
    seed: int
    seconds: float
    trace: bool
    t0: float
    reference: Any
    counts: Any
    fault: str | None = None
    control: bool = False
    tmpdir: Path = field(default_factory=lambda: Path(tempfile.gettempdir()))
    profile: Callable | None = None
    phases: list = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """The seconds since the process began at the end of a set-up phase."""
        self.phases.append((phase, time.perf_counter() - self.t0))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path):
    """A module from a file whose name may hold dots (``mfu.train.py``)."""
    name = "gdl_bench_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics this cell reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return e2e, layer


def make_ctx(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             root: Path = ROOT, **kw) -> tuple[Ctx, dict]:
    bench = benchmark(root)
    w = workload(bench, name)
    here = root / "gdl_bench"
    cfg = load_json(here / "configs" / f"{w['config']}.json")
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    cell = load_json(here / "workloads" / f"{name}.json")
    family = cfg["family"]
    ctx = Ctx(cfg=cfg, traffic=traffic, cell=cell, device=device, seed=seed, seconds=seconds,
              trace=trace, t0=t0,
              reference=importlib.import_module(f"gdl_bench.reference.{family}"),
              counts=importlib.import_module(f"gdl_bench.counts.{family}"), **kw)
    return ctx, bench


def run(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
        root: Path = ROOT, all_numbers: bool = False, **kw) -> dict:
    """One run of a cell; the result as the last line prints it (with the
    compared numbers and limits under ``compared``; with ``all_numbers``
    every number the check computes, compared or not, under ``numbers``)."""
    from gdl_bench import tracing

    ctx, bench = make_ctx(name, seed, seconds, trace, device, t0, root, **kw)
    ctx.profile = lambda fn: tracing.profiled(fn, device, ctx.tmpdir)
    ctx.mark("imported")
    driver = load_file_module(root / "gdl_bench" / "drivers" / f"{ctx.traffic['kind']}.py")
    out = driver.run(ctx)
    e2e, layer = cell_metrics(bench, name)
    metrics = {}
    if trace:
        for m in layer:
            reader = load_file_module(root / "gdl_bench" / "metrics" / f"{m['name']}.py")
            value = reader.read(out["record"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    limits = ctx.cell["limits"]
    numbers = out["numbers"]
    correct = _within(numbers, limits)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": device_info(device, out["memory_peak_bytes"], out.get("device_count", 1))}
    tr = out["record"].get("trace")
    if trace and tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.span_s
        result["breakdown"] = breakdown(tr)
    if out.get("control") is not None:
        result["control"] = out["control"]
    if all_numbers:
        result["numbers"] = numbers
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    print("set-up " + ", ".join(f"{p} {t:.2f} s" for p, t in ctx.phases), file=sys.stderr)
    return result


def _within(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def device_info(device, peak: int, count: int = 1) -> dict:
    """The card's name and the run's peak; ``count``, the cards the driver
    ran on (a driver over several gives ``device_count`` and the fullest
    card's peak)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": peak}


def breakdown(tr) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps named by what the host's main thread was doing as each began."""
    by_name: dict[str, float] = {}
    for a, b, name, _, _ in tr.clipped():
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    gaps = sorted(tr.gaps(), key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[tr.host_at(a)[:160], (b - a) * 1e-6] for a, b in gaps]}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def print_result(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output."""
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel library builds into ``build/torch_kernels``), and
    Python's bytecode of every module imported from here on under
    ``build/gdl_bench/pycache``: where the environment turns bytecode off
    (``PYTHONDONTWRITEBYTECODE``), each run would otherwise compile torch's
    2,000 sources anew, some 5 s of host time that swings with the host's
    load."""
    base = root / "build" / "gdl_bench"
    sys.pycache_prefix = str(base / "pycache")
    sys.dont_write_bytecode = False
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
