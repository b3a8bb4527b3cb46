"""The port's own spans (``tools/profiling.annotate``).

With no profiler session a span is one flag check and opens no
``record_function``. Inside a session (``tools/profiling.trace`` on the
CPU) a train step of a tiny DOFA and a tiny MiT shows ``gdl.train.step``
holding forward, backward, clip and optimizer once each, in that order; an
accumulation micro-step shows no clip and no optimizer; a scene shows
``gdl.scene.tiles`` holding one ``plan`` and a gather, forward and blend
a tile batch, on one rank and on each gloo rank of the sharded and halo
paths. The loss, the gradients (as Adam's first moments) and the blended
logits are bitwise the same with and without a session.
"""

from __future__ import annotations

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dp_scene as S
from _torch_tiny_port import TINY, TINY_MIT, WAVES
from geo_deep_learning_tpu_torch.core.mesh import create_mesh, launch
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.inference import sliding_window as tsw
from geo_deep_learning_tpu_torch.models.encoders import dofa as tdofa
from geo_deep_learning_tpu_torch.models.encoders import mix_transformer as tmit
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.tools import profiling
from geo_deep_learning_tpu_torch.training import optim
from geo_deep_learning_tpu_torch.training.steps import make_train_step
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

PHASES = ["gdl.train.forward", "gdl.train.backward", "gdl.train.clip", "gdl.train.optimizer"]
BATCH_PHASES = ["gdl.scene.gather", "gdl.scene.forward", "gdl.scene.blend"]
SIZE, K = 64, 3


def _spans(log_dir: Path, fn) -> tuple[list[tuple], object]:
    """``fn()`` inside a CPU profiler session: the ``gdl.`` spans of its
    trace, ``(start, end, name)`` sorted by start, and ``fn``'s result."""
    with profiling.trace(log_dir, device="cpu"):
        out = fn()
    (path,) = Path(log_dir).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("gdl."))
    return spans, out


def _inside(child: tuple, parent: tuple) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def _names(spans: list[tuple]) -> list[str]:
    return [s[2] for s in spans]


def _model(family: str, monkeypatch) -> torch.nn.Module:
    if family == "dofa":
        monkeypatch.setitem(tdofa.dofa_configs, "tiny", tdofa.DOFAConfig(**TINY))
        model = DOFASegmentation("tiny", num_classes=K, decoder_channels=32, img_size=SIZE)
    else:
        monkeypatch.setitem(tmit.mit_configs, "tiny_mit", tmit.MiTConfig(**TINY_MIT))
        model = SegFormer("tiny_mit", num_classes=K)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _trainer(model: torch.nn.Module, accumulate: int = 1):
    task = SegmentationTask(model, DiceLoss(mode="multiclass"), num_classes=K,
                            default_wavelengths=list(WAVES))
    state = TrainState.create(model, optim.build_optimizer(list(model.parameters()), "adam",
                                                           1e-3), seed=0)
    step = make_train_step(task, PrecisionPolicy.create("32-true"), augment=None,
                           grad_clip=1.0, accumulate=accumulate)
    return state, step


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "image": torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)),
        "mask": torch.from_numpy(rng.integers(0, K, (2, SIZE, SIZE))),
        "mean": torch.tensor([[0.405, 0.432, 0.397]] * 2),
        "std": torch.tensor([[0.165, 0.161, 0.174]] * 2),
    }


def _batches(n_tiles: int) -> int:
    return math.ceil(n_tiles / S.TILE_BATCH)


def _n_tiles() -> int:
    stride = S.TILE - S.OVERLAP
    return len(tsw._tile_origins(S.H, S.TILE, stride)) * len(tsw._tile_origins(S.W, S.TILE,
                                                                                   stride))


def _check_scene(spans: list[tuple], n_tiles: int, plans: int = 1) -> None:
    """One ``gdl.scene.tiles`` holding every other span, ``plans`` plans
    first, then gather, forward and blend a tile batch, in that order."""
    tiles = [s for s in spans if s[2] == "gdl.scene.tiles"]
    assert len(tiles) == 1
    inner = [s for s in spans if s is not tiles[0]]
    assert all(_inside(s, tiles[0]) for s in inner)
    assert _names(inner) == ["gdl.scene.plan"] * plans + BATCH_PHASES * _batches(n_tiles)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))  # one after another


def test_no_session_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    first, second = profiling.annotate("gdl.train.step"), profiling.annotate("gdl.scene.tiles")
    assert first is second
    with first:
        pass
    model = _model("dofa", monkeypatch)
    state, step = _trainer(model)
    step(state, _batch(0))
    tsw.sliding_window_logits(S.forward, torch.from_numpy(S.scene()), S.K, S.config("hann"))
    assert opened == []


@pytest.mark.parametrize("family", ["dofa", "mit"])
def test_train_step_spans_nest_in_order(family, monkeypatch, tmp_path):
    state, step = _trainer(_model(family, monkeypatch))
    spans, _ = _spans(tmp_path, lambda: step(state, _batch(0)))
    assert _names(spans) == ["gdl.train.step"] + PHASES
    outer, inner = spans[0], spans[1:]
    assert all(_inside(s, outer) for s in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


def test_accumulation_micro_step_has_no_update(monkeypatch, tmp_path):
    state, step = _trainer(_model("dofa", monkeypatch), accumulate=2)
    spans, _ = _spans(tmp_path, lambda: [step(state, _batch(i)) for i in range(2)])
    steps = [s for s in spans if s[2] == "gdl.train.step"]
    assert len(steps) == 2
    assert [_names([s for s in spans if s[2] != "gdl.train.step" and _inside(s, outer)])
            for outer in steps] == [PHASES[:2], PHASES]


@pytest.mark.parametrize("blend", ["hann", "uniform"])
def test_scene_spans_once_a_tile_batch(blend, tmp_path):
    scene = torch.from_numpy(S.scene())
    spans, _ = _spans(tmp_path, lambda: tsw.sliding_window_logits(S.forward, scene, S.K,
                                                                  S.config(blend)))
    _check_scene(spans, _n_tiles())


def rank_spans(out: str) -> None:
    """The sharded and halo paths' spans on this rank (the ``launch``
    target), written to ``<out>/spans_rank<r>.json``."""
    torch.set_num_threads(1)
    mesh = create_mesh(device="cpu")
    x = torch.from_numpy(S.scene())
    found = {}
    for name, fn in (("sharded", lambda: tsw.sliding_window_logits_sharded(
            S.forward, x, S.K, mesh, S.config("hann"))),
            ("halo", lambda: tsw.sliding_window_logits_halo(
                S.forward, x, S.K, mesh, S.config("crop")))):
        found[name], _ = _spans(Path(out) / f"{name}_{mesh.rank}", fn)
    (Path(out) / f"spans_rank{mesh.rank}.json").write_text(json.dumps(found))


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("spans_ranks")
    launch(rank_spans, (str(out),), size=2, backend="gloo", deadline_s=120)
    return [json.loads((out / f"spans_rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_scene_spans_on_a_gloo_rank(rank_results, rank):
    spans = [tuple(s) for s in rank_results[rank]["sharded"]]
    _check_scene(spans, len(range(rank, _n_tiles(), 2)))


@pytest.mark.parametrize("rank", [0, 1])
def test_halo_scene_spans_on_a_gloo_rank(rank_results, rank):
    """The halo path plans inside ``tiles``' own time: no ``plan`` span."""
    spans = [tuple(s) for s in rank_results[rank]["halo"]]
    n_cols = len(tsw._tile_origins(S.W, S.TILE, S.TILE - S.OVERLAP))
    plan = tsw.plan_bands(S.H, S.W, S.config("crop"), 2)
    _check_scene(spans, plan["counts"][rank] * n_cols, plans=0)


@pytest.mark.parametrize("family", ["dofa", "mit"])
def test_train_numbers_equal_with_and_without_a_session(family, monkeypatch, tmp_path):
    model = _model(family, monkeypatch)
    runs = []
    for traced in (False, True):
        state, step = _trainer(copy.deepcopy(model))
        batches = [_batch(i) for i in range(2)]
        go = lambda: [float(step(state, b)["loss"]) for b in batches]  # noqa: E731
        losses = _spans(tmp_path / "t", go)[1] if traced else go()
        moments = [state.optimizer.state[p]["exp_avg"] for p in state.model.parameters()
                   if "exp_avg" in state.optimizer.state.get(p, {})]
        runs.append((losses, moments, [p.detach() for p in state.model.parameters()]))
    (l0, m0, p0), (l1, m1, p1) = runs
    assert l0 == l1
    assert len(m0) == len(m1) > 0
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_scene_logits_equal_with_and_without_a_session(tmp_path):
    scene = torch.from_numpy(S.scene())
    run = lambda: tsw.sliding_window_logits(S.forward, scene, S.K, S.config("hann"))  # noqa: E731
    assert torch.equal(run(), _spans(tmp_path, run)[1])
