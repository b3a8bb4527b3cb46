"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program (top-level names compared whole:
the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "geo_deep_learning_tpu"}
PROGRAM = "geo_deep_learning_tpu_torch"


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder: Path):
    return [p for p in folder.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_file_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        assert not (_top_level_imports(path) & JAX), path


def test_the_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        names = _top_level_imports(path)
        assert not (names & (JAX | {PROGRAM})), path
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.startswith("gdl_bench")):
                assert node.module.startswith("gdl_bench.reference"), (path, node.module)


def test_the_name_check_compares_whole_names():
    from gdl_bench import harness

    before = set(sys.modules)
    sys.modules["geo_deep_learning_tpu_torch_probe"] = sys
    try:
        assert "geo_deep_learning_tpu_torch_probe" not in harness.forbidden_modules()
        sys.modules["jax_probe_whole"] = sys
        assert "jax_probe_whole" not in harness.forbidden_modules()
        sys.modules["flax.probe_whole"] = sys
        assert "flax.probe_whole" in harness.forbidden_modules()
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]


_RUN = """
import sys, time, torch
from pathlib import Path
sys.path.insert(0, {root!r})
from gdl_bench.tests import tiny
from gdl_bench import harness
tiny.register()
root = tiny.tiny_tree(Path({tmp!r}))
sys.path.insert(0, str(root))
harness.run("dofa_tiny-train", 11, 0.5, False, torch.device("cpu"), time.perf_counter(), root)
bad = [m for m in sys.modules if m.split(".")[0] in {jax!r}]
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""

_REF = """
import sys
sys.path.insert(0, {root!r})
import gdl_bench.reference.dofa_upernet, gdl_bench.reference.segformer
bad = [m for m in sys.modules if m.split(".")[0] in {names!r}]
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_a_run_loads_no_jax(tmp_path):
    code = _RUN.format(root=str(ROOT), tmp=str(tmp_path), jax=sorted(JAX))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_the_references_load_nothing_of_the_program():
    code = _REF.format(root=str(ROOT), names=sorted(JAX | {PROGRAM}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
