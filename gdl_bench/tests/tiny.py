"""A tiny copy of the benchmark for CPU tests.

Every cell of ``BENCHMARK.json`` has a CPU twin, ``twins/<cell>.json``
beside this file, found by its name:

- ``cell``, ``config``, ``traffic``: the twin's own names; its traffic is
  ``twins/traffic/<traffic>.json``;
- ``overrides``: the tiny configuration's keys over the real cell's
  configuration (whose ``name`` becomes ``config``), and ``init_args``,
  the same over its ``port.init_args``;
- ``faults``: the faults that the cell's driver can plant, each of which
  has to come out as not correct;
- ``register``: the narrow encoders to register in the port, each as its
  ``table`` and config ``class`` (module-qualified), ``name`` and ``args``
  (lists passed as tuples).

:func:`tiny_tree` copies ``gdl_bench/`` into a temporary checkout beside
its own ``BENCHMARK.json``, whose cells are the twins, so a whole run,
reference included, takes seconds. Twins may share a tiny configuration
only where they make it alike.
"""

from __future__ import annotations

import importlib
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def twin_dir(source: Path = ROOT) -> Path:
    return Path(source) / "gdl_bench" / "tests" / "twins"


def twins(source: Path = ROOT) -> dict[str, dict]:
    """Real cell -> its twin, for every ``twins/<cell>.json``."""
    return {p.stem: _load(p) for p in sorted(twin_dir(source).glob("*.json"))}


def tiny_cells(source: Path = ROOT) -> dict[str, tuple[dict, dict]]:
    """Real cell -> ``(twin, tiny configuration)`` for every workload of
    ``source``'s ``BENCHMARK.json``."""
    source = Path(source)
    found = twins(source)
    cells, configs = {}, {}
    for w in _load(source / "BENCHMARK.json")["workloads"]:
        if w["name"] not in found:
            raise LookupError(f"cell {w['name']!r} has no CPU twin "
                              f"{twin_dir(source) / w['name']}.json")
        twin = found[w["name"]]
        cfg = _load(source / "gdl_bench" / "configs" / f"{w['config']}.json")
        cfg.update(twin["overrides"])
        cfg["name"] = twin["config"]
        cfg["port"]["init_args"].update(twin["init_args"])
        if configs.setdefault(cfg["name"], cfg) != cfg:
            raise ValueError(f"twins make two configurations named {cfg['name']!r}")
        cells[w["name"]] = (twin, cfg)
    return cells


def register(source: Path = ROOT) -> None:
    """Register every twin's narrow encoders in the port."""
    for twin in twins(source).values():
        for spec in twin.get("register", []):
            table_module, table = spec["table"].rsplit(".", 1)
            class_module, cls = spec["class"].rsplit(".", 1)
            args = {k: tuple(v) if isinstance(v, list) else v for k, v in spec["args"].items()}
            getattr(importlib.import_module(table_module), table)[spec["name"]] = getattr(
                importlib.import_module(class_module), cls)(**args)


def source_copy(tmp: Path) -> Path:
    """A copy under ``tmp`` of this checkout's benchmark (``BENCHMARK.json``,
    ``gdl_bench/`` and the pytest settings) beside a link to the port, for
    a test to add files to; returns its root."""
    root = Path(tmp) / "source"
    root.mkdir(parents=True)
    for name in ("BENCHMARK.json", "pyproject.toml"):
        shutil.copy(ROOT / name, root)
    shutil.copytree(BENCH, root / "gdl_bench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "geo_deep_learning_tpu_torch").symlink_to(ROOT / "geo_deep_learning_tpu_torch",
                                                       target_is_directory=True)
    return root


def tiny_tree(tmp: Path, limits: dict | None = None, source: Path = ROOT) -> Path:
    """A checkout under ``tmp`` holding ``source``'s ``gdl_bench/`` and a
    ``BENCHMARK.json`` of its cells' twins; returns its root."""
    source = Path(source)
    root = Path(tmp) / "checkout"
    here = root / "gdl_bench"
    shutil.copytree(source / "gdl_bench", here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _load(source / "BENCHMARK.json")
    cells, names = tiny_cells(source), {}
    for w in bench["workloads"]:
        real = w["name"]
        twin, cfg = cells[real]
        names[real] = twin["cell"]
        (here / "configs" / f"{twin['config']}.json").write_text(json.dumps(cfg))
        shutil.copy(twin_dir(source) / "traffic" / f"{twin['traffic']}.json", here / "traffic")
        cell = _load(source / "gdl_bench" / "workloads" / f"{real}.json")
        if limits:
            cell["limits"] = {k: limits.get(k, v) for k, v in cell["limits"].items()}
        (here / "workloads" / f"{twin['cell']}.json").write_text(json.dumps(cell))
        w["name"], w["config"], w["traffic"] = twin["cell"], twin["config"], twin["traffic"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
