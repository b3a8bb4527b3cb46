"""A tiny copy of the benchmark for CPU tests.

:func:`tiny_tree` copies ``gdl_bench/`` into a temporary checkout beside
its own ``BENCHMARK.json``, whose cells run narrow DOFA and MiT encoders
(registered in the port under ``dofa_bench_tiny`` and ``mit_bench_tiny``)
on small traffic, so a whole run, reference included, takes seconds.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DOFA_TINY = {"embed_dim": 64, "depth": 4, "num_heads": 2, "out_indices": [0, 1, 2, 3],
             "image_size": 56, "decoder_channels": 16}
MIT_TINY = {"embed_dims": [16, 16, 32, 32], "depths": [1, 1, 1, 1], "num_heads": [1, 2, 2, 4],
            "image_size": 128}


def register_tiny() -> None:
    from geo_deep_learning_tpu_torch.models.encoders import dofa, mix_transformer

    dofa.dofa_configs["dofa_bench_tiny"] = dofa.DOFAConfig(
        embed_dim=DOFA_TINY["embed_dim"], depth=DOFA_TINY["depth"],
        num_heads=DOFA_TINY["num_heads"], out_indices=tuple(DOFA_TINY["out_indices"]))
    mix_transformer.mit_configs["mit_bench_tiny"] = mix_transformer.MiTConfig(
        embed_dims=tuple(MIT_TINY["embed_dims"]), num_heads=tuple(MIT_TINY["num_heads"]),
        depths=tuple(MIT_TINY["depths"]))


def tiny_configs() -> dict[str, dict]:
    dofa = json.loads((BENCH / "configs" / "dofa_base_upernet.json").read_text())
    dofa.update({k: v for k, v in DOFA_TINY.items()})
    dofa["name"] = "dofa_tiny"
    dofa["port"]["init_args"].update(encoder="dofa_bench_tiny",
                                     image_size=[dofa["image_size"]] * 2,
                                     decoder_channels=dofa["decoder_channels"])
    seg = json.loads((BENCH / "configs" / "segformer_mit_b2.json").read_text())
    seg.update({k: v for k, v in MIT_TINY.items()})
    seg["name"] = "mit_tiny"
    seg["port"]["init_args"].update(encoder="mit_bench_tiny", image_size=[seg["image_size"]] * 2)
    return {"dofa_tiny": dofa, "mit_tiny": seg}


TRAIN = {"kind": "train", "batch": 4, "pool_batches": 4, "mask_block": 4, "first_steps": 3,
         "log_every_n_steps": 2, "stretch_steps": 2}
SCENE = {"kind": "scene", "scene_px": 150, "pool_scenes": 2, "tile_size": 56, "overlap": 16,
         "tile_batch": 6, "blend": "hann", "threshold": 0.5, "check_scenes": 2, "check_from": 2,
         "reference_batch": 4, "stretch_scenes": 1}
# real cell -> (tiny cell, tiny config, tiny traffic)
CELLS = {"dofa_base-train-b32": ("dofa_tiny-train", "dofa_tiny", "train-tiny"),
         "segformer_mit_b2-train-b32": ("mit_tiny-train", "mit_tiny", "train-tiny"),
         "dofa_base-scene-3333": ("dofa_tiny-scene", "dofa_tiny", "scene-tiny")}


def tiny_tree(tmp: Path, limits: dict | None = None) -> Path:
    """A checkout under ``tmp`` holding ``gdl_bench/`` and a tiny
    ``BENCHMARK.json``; returns its root."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "gdl_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cfg in tiny_configs().items():
        (root / "gdl_bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (root / "gdl_bench" / "traffic" / "train-tiny.json").write_text(json.dumps(TRAIN))
    (root / "gdl_bench" / "traffic" / "scene-tiny.json").write_text(json.dumps(SCENE))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        real = w["name"]
        w["name"], w["config"], w["traffic"] = CELLS[real]
        cell = json.loads((BENCH / "workloads" / f"{real}.json").read_text())
        if limits:
            cell["limits"] = {k: limits.get(k, v) for k, v in cell["limits"].items()}
        (root / "gdl_bench" / "workloads" / f"{w['name']}.json").write_text(json.dumps(cell))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[w][0] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
