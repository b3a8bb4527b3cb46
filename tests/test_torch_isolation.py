"""The port stands alone: it imports nothing of JAX, of the JAX package, or
of packages the card's machine lacks, and it never runs on the CPU unless
asked to."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "geo_deep_learning_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "matplotlib", "mlflow",
           "pyproj", "colorlog", "geo_deep_learning_tpu")

_PROBE = """
import importlib, importlib.abc, importlib.util, json, pkgutil, sys
BLOCKED = set(json.loads(sys.argv[1]))
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import geo_deep_learning_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_and_chip_smoke_import_without_jax_or_yaml():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(BLOCKED), str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT, check=False,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("models.encoders.dofa", "cli.main", "training.loop", "training.optim",
                 "training.checkpoint", "training.steps", "core.train_state", "ops.augment",
                 "tools.tracking", "ops.cuda.layernorm", "ops.cuda.mha",
                 "ops.cuda.sr_attention", "models.encoders.mix_transformer",
                 "models.decoders.segformer_mlp", "models.segmentation.segformer",
                 "ops.cuda.packed_conv", "tools.bench_column", "models.encoders.resnet",
                 "models.decoders.unetpp", "models.segmentation.unetpp", "data.geotiff_stream",
                 "inference.sliding_window", "inference.streaming", "data.shard_dataset",
                 "data.samplers", "data.multisensor", "data.multisensor_csv",
                 "tools.make_shards", "data.grain_pipeline", "data._native",
                 "inference.export", "tools.script_model", "core.mesh",
                 "parallel.collectives", "parallel.placement", "utils.tensors", "utils.crs",
                 "utils.rasters", "utils.models", "config.logging_config", "tools.profiling",
                 "tools.visualization", "tools.callbacks.segmentation_visualization",
                 "tools.callbacks", "tools.schedulers", "models.utils"):
        assert f"geo_deep_learning_tpu_torch.{name}" in out["modules"], name


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_no_source_names_the_jax_package():
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("geo_deep_learning_tpu", "jax", "flax", "optax", "orbax"), (
                f"{path.relative_to(ROOT)} imports {name}"
            )


def test_entry_point_refuses_to_fall_back_to_the_cpu():
    import torch

    from geo_deep_learning_tpu_torch.cli.main import run

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run({"model": {}, "data": {}}, "test")
    from geo_deep_learning_tpu_torch.inference.export import export_model, load_exported

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model(torch.nn.Identity(), (2, 8, 8, 3), "unused.pt2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported("unused.pt2")


def test_kernel_build_directory_is_ignored_by_git():
    from geo_deep_learning_tpu_torch.ops.cuda import _lib

    target = (_lib.BUILD_DIR / _lib.LIB_NAME).relative_to(ROOT)
    proc = subprocess.run(
        ["git", "-C", str(ROOT), "check-ignore", "-q", str(target)],
        capture_output=True, timeout=60, check=False,
    )
    assert proc.returncode == 0, f"{target} is not covered by .gitignore"
