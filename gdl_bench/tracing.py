"""One profiled stretch and its reduction: device intervals, the operators
each kernel was launched under, and the host spans.

``profiled(fn, device, tmpdir)`` runs ``fn`` inside a ``torch.profiler``
session (host and, on CUDA, device activities) whose schedule first takes
one warm-up step of small kernels (records discarded) and then records
``fn`` inside a ``bench.stretch`` span; the Chrome trace it exports under
``tmpdir`` is read back and deleted. :class:`Trace` holds what the
metric readers need:

- ``device``: every kernel, copy and fill on the device, ``(start_us,
  end_us, name, cat)``;
- ``stacks``: for each kernel, the names of the host operators and spans
  open on the launching thread when it was launched (matched through the
  runtime call's correlation id);
- ``span``: the stretch's ``(start_us, end_us)``;
- ``host``: the main thread's operators and spans, for naming idle gaps.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WARMUP_KERNELS = 32
EDGE_S = 0.05


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (start, end, name, cat)
    stacks: list = field(default_factory=list)  # per device event: tuple of op names
    span: tuple = (0.0, 0.0)
    host: list = field(default_factory=list)  # main thread (start, end, name, cat)

    @property
    def span_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-6

    def clipped(self):
        """Device intervals clipped to the stretch, with their stacks."""
        s0, s1 = self.span
        for (a, b, name, cat), stack in zip(self.device, self.stacks):
            a, b = max(a, s0), min(b, s1)
            if b > a:
                yield a, b, name, cat, stack

    def busy_s(self) -> float:
        """Seconds of the stretch in which some kernel, copy or fill ran
        (the union of the intervals)."""
        total, end = 0.0, None
        for a, b, *_ in sorted(self.clipped()):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total * 1e-6

    def kernel_us(self, patterns=None) -> float:
        """Device µs of the kernels launched under an operator whose name
        matches one of ``patterns`` (every kernel when None)."""
        regs = [re.compile(p) for p in patterns or ()]
        total = 0.0
        for a, b, _, cat, stack in self.clipped():
            if cat != "kernel":
                continue
            if patterns is None or any(r.search(op) for r in regs for op in stack):
                total += b - a
        return total

    def gaps(self):
        """Idle intervals of the device inside the stretch, ``(start, end)``."""
        out, end = [], self.span[0]
        for a, b, *_ in sorted(self.clipped()):
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.span[1] > end:
            out.append((end, self.span[1]))
        return out

    def host_at(self, t: float) -> str:
        """What the main thread was doing at ``t``: its outermost bench span
        and its innermost operator, joined by ``/``."""
        spans = [e for e in self.host if e[0] <= t <= e[1] and e[2].startswith("bench.")
                 and e[2] != STRETCH]
        ops = [e for e in self.host if e[0] <= t <= e[1] and e[3] == "cpu_op"]
        parts = []
        if spans:
            parts.append(min(spans, key=lambda e: e[0])[2])
        if ops:
            parts.append(max(ops, key=lambda e: e[0])[2])
        return "/".join(parts) or "outside any span"


def parse(events: list[dict]) -> Trace:
    tr = Trace()
    spans = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"]
    if not spans:
        return tr
    stretch = spans[0]
    tr.span = (float(stretch["ts"]), float(stretch["ts"]) + float(stretch["dur"]))
    main_tid = stretch.get("tid")
    launches = {}
    ops_by_tid: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), a)
        elif cat in HOST_CATS:
            ops_by_tid.setdefault(e.get("tid"), []).append((a, b, e["name"], cat))
    for ops in ops_by_tid.values():
        ops.sort()
    tr.host = ops_by_tid.get(main_tid, [])
    queries: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        tr.device.append((a, a + float(e.get("dur", 0.0)), e["name"], e["cat"]))
        tid, t = launches.get((e.get("args") or {}).get("correlation"), (None, None))
        if t is not None:
            queries.setdefault(tid, []).append((t, len(tr.device) - 1))
    tr.stacks = [()] * len(tr.device)
    for tid, qs in queries.items():
        for i, stack in _open_at(ops_by_tid.get(tid, []), qs):
            tr.stacks[i] = stack
    return tr


def _open_at(ops: list, queries: list):
    """For each ``(t, key)`` query, the names of the operators of one
    thread (sorted by start, properly nested) open at ``t``: one sweep."""
    stack: list = []
    j = 0
    for t, key in sorted(queries):
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        yield key, tuple(op[2] for op in stack if op[1] >= t)


def profiled(fn, device: torch.device, tmpdir: Path) -> Trace:
    """``fn()`` in a profiler session; its :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = Path(tmpdir) / f"gdl_bench_trace_{os.getpid()}.json"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        warm = torch.zeros(1024, device=device)
        for _ in range(WARMUP_KERNELS):
            warm.add_(1.0)
        sync()
        time.sleep(EDGE_S)
        prof.step()
        with record_function(STRETCH):
            fn()
            sync()
        time.sleep(EDGE_S)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return parse(events)
