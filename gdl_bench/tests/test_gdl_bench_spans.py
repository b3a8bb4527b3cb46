"""The readers of the program's spans on hand-built traces: idle gaps put
down to the innermost open ``gdl.`` span, phase idle plus the rest equal
to ``idle_pct`` x the stretch, the lead of a host-paced and of a queued
timeline, no value without spans, and the older readers unmoved by them."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from gdl_bench import harness, readers, spans
from gdl_bench.tracing import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gdl_bench"
SPAN_NAMES = [f"gdl.train.{p}" for p in ("step", "forward", "backward", "clip", "optimizer")] + \
    [f"gdl.scene.{p}" for p in ("tiles", "plan", "gather", "forward", "blend")]
STRETCH = ("bench.stretch",)
FWD = STRETCH + ("bench.train_step", "gdl.train.step", "gdl.train.forward")
CLIP = STRETCH + ("bench.train_step", "gdl.train.step", "gdl.train.clip")
OPT = STRETCH + ("bench.train_step", "gdl.train.step", "gdl.train.optimizer")
BWD = ("autograd::engine::evaluate_function: MmBackward0",)  # the autograd thread's


def _metrics(source: str) -> dict[str, dict]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"]: m for m in bench["per_layer"] if (m["source"] == "program_span")
            == (source == "program_span")}


def _read(name: str, rec: dict, ctx=None):
    return harness.load_file_module(BENCH / "metrics" / f"{name}.py").read(rec, ctx)


def _step_host(t0: float, host_end: float) -> list[tuple]:
    """One train step's spans on the main thread, forward from ``t0``."""
    return [(t0, host_end, "gdl.train.step", "user_annotation"),
            (t0 + 2, t0 + 140, "gdl.train.forward", "user_annotation"),
            (t0 + 5, t0 + 20, "aten::conv2d", "cpu_op"),
            (t0 + 140, t0 + 290, "gdl.train.backward", "user_annotation"),
            (t0 + 290, t0 + 310, "gdl.train.clip", "user_annotation"),
            (t0 + 310, host_end - 5, "gdl.train.optimizer", "user_annotation")]


def _step_device(t0: float, lag: float) -> list[tuple]:
    """A step's kernels ``(start, end, name, cat, stack)``, ``lag`` µs
    after their launches."""
    k = [(10, 50, FWD), (60, 130, FWD), (150, 270, BWD), (295, 305, CLIP), (320, 380, OPT)]
    return [(t0 + a + lag, t0 + b + lag, "kernel_x", "kernel", s) for a, b, s in k]


def _train_trace(lag: float, steps: int = 3, with_spans: bool = True) -> Trace:
    end = 10 + 500 * steps + 90 + lag  # the stretch ends after the last kernel
    host = [(0.0, end, "bench.stretch", "user_annotation")]
    dev = []
    for i in range(steps):
        t0 = 10 + 500 * i
        host += _step_host(t0, t0 + 400)
        dev += _step_device(t0, lag)
    if not with_spans:
        host = [e for e in host if not e[2].startswith("gdl.")]
        dev = [(a, b, n, c, tuple(o for o in s if not o.startswith("gdl."))) for a, b, n, c, s
               in dev]
    return Trace(device=[d[:4] for d in dev], stacks=[d[4] for d in dev], span=(0.0, end),
                 host=sorted(host))


def _train_rec(tr: Trace, steps: int = 3) -> dict:
    return {"kind": "train", "batch": 32, "stretch_steps": steps, "trace": tr}


def test_gaps_land_on_the_innermost_open_span():
    tr = _train_trace(lag=0.0)
    by = spans.idle_by_span(tr)
    # each step from t0 (10, 510, 1010): forward gaps [t0+50, t0+60) and
    # [t0+130, t0+150) (forward open until t0+140), backward [t0+270,
    # t0+295), clip [t0+305, t0+320), then the optimizer's from t0+380 to
    # the next step's first kernel (130) or the stretch's end (210)
    assert by == pytest.approx({None: 20, "gdl.train.forward": 3 * 30,
                                "gdl.train.backward": 3 * 25, "gdl.train.clip": 3 * 15,
                                "gdl.train.optimizer": 2 * 130 + 210})
    rec = _train_rec(tr)
    assert _read("fwd_idle_ms.train", rec) == pytest.approx(30e-3)
    assert _read("bwd_idle_ms.train", rec) == pytest.approx(25e-3)
    assert _read("opt_idle_ms.train", rec) == pytest.approx((3 * 15 + 470) / 3e3)


def test_a_gap_in_a_span_s_own_time_is_the_span_s():
    """Between a parent's children the parent is the innermost open span."""
    spans_ = [(0, 100, "gdl.train.step"), (10, 40, "gdl.train.forward"),
              (60, 90, "gdl.train.backward")]
    assert [spans.innermost(spans_, t) for t in (5, 20, 50, 70, 95, 150)] == [
        "gdl.train.step", "gdl.train.forward", "gdl.train.step", "gdl.train.backward",
        "gdl.train.step", None]


@pytest.mark.parametrize("lag", [0.0, 35.0, 400.0])
def test_phase_idle_and_the_rest_sum_to_idle_pct(lag):
    tr = _train_trace(lag)
    rec = _train_rec(tr)
    total_ms = sum(spans.idle_by_span(tr).values()) / 1e3
    assert total_ms == pytest.approx(readers.idle_pct(rec) / 100 * tr.span_s * 1e3)
    names = ("fwd_idle_ms.train", "bwd_idle_ms.train", "opt_idle_ms.train")
    phases = sum(_read(n, rec) for n in names) * rec["stretch_steps"]
    rest = spans.idle_by_span(tr)
    assert phases + (rest.get(None, 0.0) + rest.get("gdl.train.step", 0.0)) / 1e3 == \
        pytest.approx(total_ms)


def test_lead_of_a_host_paced_and_a_queued_timeline():
    assert _read("lead_ms.train", _train_rec(_train_trace(lag=0.0))) == 0.0
    # the last kernel ends at t0 + 380 + lag against the host's t0 + 400
    assert _read("lead_ms.train", _train_rec(_train_trace(lag=35.0))) == pytest.approx(15e-3)
    assert _read("lead_ms.train", _train_rec(_train_trace(lag=400.0))) == pytest.approx(380e-3)
    assert len(spans.step_kernels(_train_trace(lag=400.0))) == 3
    # an accumulation micro-step launches no clip or optimizer kernel on the
    # main thread: its kernels merge with the next step's, and no reading
    tr = _train_trace(lag=0.0, steps=2)
    keep = [i for i, (a, _, _, _) in enumerate(tr.device) if not (a < 500 and a > 290)]
    tr.device, tr.stacks = [tr.device[i] for i in keep], [tr.stacks[i] for i in keep]
    assert len(spans.step_kernels(tr)) == 1
    assert _read("lead_ms.train", _train_rec(tr, steps=2)) is None


def test_host_and_device_ms_of_the_train_phases():
    rec = _train_rec(_train_trace(lag=0.0))
    assert _read("fwd_host_ms.train", rec) == pytest.approx(138e-3)
    assert _read("bwd_host_ms.train", rec) == pytest.approx(150e-3)
    assert _read("opt_host_ms.train", rec) == pytest.approx((20 + 85) / 1e3)
    assert _read("opt_device_ms.train", rec) == pytest.approx((10 + 60) / 1e3)


def _scene_trace(with_spans: bool = True) -> Trace:
    """One scene: plan, two tile batches, the division in ``tiles``' own
    time; a copy under plan, two kernels under each forward, one a blend."""
    a = "user_annotation"
    host = [(0.0, 600.0, "bench.stretch", a), (10, 500, "gdl.scene.tiles", a),
            (12, 40, "gdl.scene.plan", a), (40, 60, "gdl.scene.gather", a),
            (60, 200, "gdl.scene.forward", a), (200, 300, "gdl.scene.blend", a),
            (300, 310, "gdl.scene.gather", a), (310, 400, "gdl.scene.forward", a),
            (400, 480, "gdl.scene.blend", a)]
    t = STRETCH + ("bench.sliding_window_logits", "gdl.scene.tiles")
    dev = [(20, 30, "Memcpy HtoD", "gpu_memcpy", t + ("gdl.scene.plan",)),
           (70, 150, "k", "kernel", t + ("gdl.scene.forward",)),
           (160, 220, "k", "kernel", t + ("gdl.scene.forward",)),
           (230, 260, "add", "kernel", t + ("gdl.scene.blend",)),
           (320, 390, "k", "kernel", t + ("gdl.scene.forward",)),
           (405, 450, "add", "kernel", t + ("gdl.scene.blend",)),
           (485, 495, "div", "kernel", t)]
    if not with_spans:
        host = host[:1]
        dev = [(a, b, n, c, tuple(o for o in s if not o.startswith("gdl."))) for a, b, n, c, s
               in dev]
    return Trace(device=[d[:4] for d in dev], stacks=[d[4] for d in dev], span=(0.0, 600.0),
                 host=sorted(host))


def test_scene_readers():
    rec = {"kind": "scene", "stretch_scenes": 1, "trace": _scene_trace(), "tiles": 81,
           "tile_batch": 32}
    assert _read("blend_host_ms.scene", rec) == pytest.approx(180e-3)
    assert _read("blend_device_ms.scene", rec) == pytest.approx(75e-3)
    # gaps: [0,20) none; [30,70) plan; [150,160) forward; [220,230) blend;
    # [260,320) blend; [390,405) forward; [450,485) blend; [495,600): at
    # 495 tiles' own time
    assert _read("fwd_idle_ms.scene", rec) == pytest.approx(25e-3)
    assert _read("loop_idle_ms.scene", rec) == pytest.approx((40 + 10 + 60 + 35 + 105) / 1e3)


def test_no_spans_no_value():
    train = _train_rec(_train_trace(lag=35.0, with_spans=False))
    scene = {"kind": "scene", "stretch_scenes": 1, "trace": _scene_trace(with_spans=False),
             "tiles": 81, "tile_batch": 32}
    cpu = _train_rec(Trace(span=(0.0, 1600.0), host=_train_trace(lag=0.0).host))
    no_trace = {"kind": "train", "stretch_steps": 3, "trace": None}
    new = _metrics("program_span")
    assert len(new) == 12
    for name in new:
        for rec in (train, scene, no_trace):
            assert _read(name, rec) is None, name
        if "device" in name or "idle" in name or "lead" in name:
            assert _read(name, cpu) is None, name  # spans but no device records


def test_no_older_reader_matches_a_span_name():
    for name in _metrics("other"):
        reader = harness.load_file_module(BENCH / "metrics" / f"{name}.py")
        for pattern in reader.OPS:
            assert not any(re.search(pattern, s) for s in SPAN_NAMES), (name, pattern)


def _kernel_trace(with_spans: bool) -> Trace:
    """Attention, SR attention and other kernels under their operators,
    with or without the step's spans around them."""
    around = ("gdl.train.step", "gdl.train.forward") if with_spans else ()
    ops = [("attention_fwd_wgmma_kernel<64>", ("gdl::attention_fwd_packed",)),
           ("attention_bwd_dkdv_kernel", ("GeneratedBackwardFor_gdl_attention_fwd_packed"
                                          "_defaultBackward", "gdl::attention_bwd_packed")),
           ("sr_attention_fwd_kernel", ("gdl::sr_attention_fwd",)),
           ("sr_einsum", ("GeneratedBackwardFor_gdl_sr_attention_fwd_defaultBackward",)),
           ("elementwise_kernel", ("aten::add",)), ("nvjet_gemm", ("aten::mm",))]
    device, stacks = [], []
    for i, (kernel, stack) in enumerate(ops):
        device.append((100.0 * i, 100.0 * i + 60, kernel, "kernel"))
        stacks.append(STRETCH + around + stack)
    host = [(0.0, 1000.0, "bench.stretch", "user_annotation")]
    if with_spans:
        host += [(0.0, 900.0, "gdl.train.step", "user_annotation"),
                 (1.0, 800.0, "gdl.train.forward", "user_annotation")]
    return Trace(device=device, stacks=stacks, span=(0.0, 1000.0), host=host)


@pytest.mark.parametrize("name,family,kind", [
    ("attn_roofline.train", "dofa_upernet", "train"),
    ("attn_roofline.scene", "dofa_upernet", "scene"),
    ("sr_attn_roofline.train", "segformer", "train"),
    ("other_kernel_ms.train", "dofa_upernet", "train"),
    ("idle_pct.train", "dofa_upernet", "train"),
])
def test_older_readers_read_the_same_with_spans(name, family, kind):
    cfg = {"dofa_upernet": "dofa_base_upernet", "segformer": "segformer_mit_b2"}[family]
    ctx = SimpleNamespace(cfg=json.loads((BENCH / "configs" / f"{cfg}.json").read_text()),
                          counts=importlib.import_module(f"gdl_bench.counts.{family}"))
    values = []
    for with_spans in (False, True):
        rec = {"kind": kind, "batch": 32, "stretch_steps": 3, "stretch_scenes": 2,
               "tiles": 81, "tile_batch": 32, "trace": _kernel_trace(with_spans)}
        values.append(_read(name, rec, ctx))
    assert values[0] is not None and values[0] > 0
    assert values[0] == values[1]
