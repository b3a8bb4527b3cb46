"""Helpers the readers of the program's own spans share.

The port opens ``gdl.*`` spans inside its train step and scene loop
(``tools/profiling.py::annotate``): ``gdl.train.step`` holding
``gdl.train.{forward,backward,clip,optimizer}``, and ``gdl.scene.tiles``
holding ``gdl.scene.plan`` and ``gdl.scene.{gather,forward,blend}`` once
a tile batch. In a traced run they are ``user_annotation`` events of the
profiled stretch, on the clock of its device records: ``Trace.host`` holds
those of the main thread, ``Trace.stacks`` those open at each kernel's
launch. "A step" or "a scene" is the stretch's total over
``stretch_steps`` or ``stretch_scenes``. Every reader returns None where
the stretch holds no ``gdl.`` span (a program without them), so the
metric is left out, not read as 0; the device readers also where the
trace holds no device record (the CPU).
"""

from __future__ import annotations

import statistics

PREFIX = "gdl."
STEP, FORWARD = "gdl.train.step", "gdl.train.forward"


def program_spans(tr) -> list:
    """The main thread's ``gdl.`` spans that begin inside the stretch,
    ``(start_us, end_us, name, cat)`` sorted by start."""
    s0, s1 = tr.span
    return [e for e in tr.host
            if e[3] == "user_annotation" and e[2].startswith(PREFIX) and s0 <= e[0] <= s1]


def _per(rec: dict) -> int:
    return rec["stretch_steps"] if rec["kind"] == "train" else rec["stretch_scenes"]


def _traced(rec: dict, kind: str, device: bool):
    """The record's trace where it is of ``kind`` and holds ``gdl.``
    spans (and, with ``device``, device records), else None."""
    tr = rec.get("trace")
    if rec["kind"] != kind or tr is None or not program_spans(tr):
        return None
    if device and not tr.device:
        return None
    return tr


def host_ms(rec: dict, kind: str, names) -> float | None:
    """Host ms a step or scene inside the spans named ``names``."""
    tr = _traced(rec, kind, False)
    if tr is None:
        return None
    us = sum(b - a for a, b, name, _ in program_spans(tr) if name in names)
    return us / 1e3 / _per(rec)


def device_ms(rec: dict, kind: str, ops) -> float | None:
    """Device ms a step or scene of the kernels launched under a span that
    matches one of the patterns ``ops``."""
    tr = _traced(rec, kind, True)
    if tr is None:
        return None
    return tr.kernel_us(ops) / 1e3 / _per(rec)


def innermost(spans: list, t: float) -> str | None:
    """The innermost of ``spans`` (properly nested) open at ``t``."""
    open_at = [e for e in spans if e[0] <= t <= e[1]]
    return max(open_at, key=lambda e: e[0])[2] if open_at else None


def idle_by_span(tr) -> dict:
    """Device-idle µs of the stretch by the innermost ``gdl.`` span open on
    the main thread as each gap began (None: no such span open). The
    values sum to the stretch's idle time."""
    spans = program_spans(tr)
    out: dict = {}
    for a, b in tr.gaps():
        name = innermost(spans, a)
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def idle_ms(rec: dict, kind: str, names) -> float | None:
    """Device-idle ms a step or scene in the gaps that began while the
    innermost open ``gdl.`` span was one named in ``names``."""
    tr = _traced(rec, kind, True)
    if tr is None:
        return None
    by = idle_by_span(tr)
    return sum(by.get(n, 0.0) for n in names) / 1e3 / _per(rec)


def step_kernels(tr) -> list[list[tuple]]:
    """The kernels launched on the main thread inside ``gdl.train.step``,
    ``(start, end)`` in device order, one list a step: a step's begins at
    a kernel launched under ``gdl.train.forward`` that follows one that
    was not (a step that updates ends in clip and optimizer kernels; the
    backward's come from the autograd engine's thread)."""
    steps: list[list[tuple]] = []
    prev_fwd = False
    for a, b, _, cat, stack in sorted(tr.clipped()):
        if cat != "kernel" or STEP not in stack:
            continue
        fwd = FORWARD in stack
        if (fwd and not prev_fwd) or not steps:
            steps.append([])
        steps[-1].append((a, b))
        prev_fwd = fwd
    return steps


def lead_ms(rec: dict) -> float | None:
    """The median over the stretch's steps of the device ms from the host's
    return from ``gdl.train.step`` to the end of that step's last kernel,
    0 where the device finished first; None where the kernels do not fall
    into one group a step."""
    tr = _traced(rec, "train", True)
    if tr is None:
        return None
    ends = [b for _, b, name, _ in program_spans(tr) if name == STEP]
    groups = step_kernels(tr)
    if not ends or len(groups) != len(ends):
        return None
    leads = [max(0.0, max(b for _, b in g) - end) for g, end in zip(groups, ends)]
    return statistics.median(leads) / 1e3
