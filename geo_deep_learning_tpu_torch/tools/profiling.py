"""Profiling and step timing.

Port of ``geo_deep_learning_tpu/tools/profiling.py`` on ``torch.profiler``
and the CUDA caching allocator:

- :class:`StepTimer` -- per-step wall time with the first ``warmup`` steps
  left out. Given a CUDA ``device`` it synchronizes that device before it
  reads the clock, so a step is timed to its last kernel; without one it
  times the host's launches, not the steps.
- :func:`trace` -- a ``torch.profiler`` session (CPU activities, and CUDA
  ones on a CUDA device) whose trace is written under ``log_dir`` as a
  Chrome / TensorBoard trace (``*.pt.trace.json``) when the session ends.
- :func:`annotate` -- a named region of the trace
  (``torch.profiler.record_function``), on the host's timeline and, within
  a CUDA session, as a span over the device's timeline too; outside a
  session, one flag check. The program's spans: ``gdl.train.step`` around
  a train step, with ``gdl.train.{forward,backward,clip,optimizer}``
  inside it (``training/steps.py``); ``gdl.scene.tiles`` around a scene's
  sliding window, with ``gdl.scene.plan`` once and
  ``gdl.scene.{gather,forward,blend}`` once a tile batch inside it
  (``inference/sliding_window.py``).
- :func:`device_memory_stats` -- the allocator's bytes in use, their peak
  and the device's memory, one dict a device, with the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from geo_deep_learning_tpu_torch.core.device import resolve_device

# The profiler keeps a device record only if its timestamps, converted to
# the host clock, fall inside the session; a kernel at the session's very
# edge can land just outside it. A CUDA session opens this long before the
# block and closes this long after the block's last kernel.
EDGE_S = 0.05
# The first kernels after the device activities are enabled can go
# unrecorded (seen on an H100: up to the first 5 launches of a session, the
# first millisecond of device work). The session warms up on this many
# small kernels, whose records the profiler discards, before it records.
WARMUP_KERNELS = 32


@dataclass
class StepTimer:
    warmup: int = 2
    times: list[float] = field(default_factory=list)
    device: str | torch.device | None = None
    _t0: float | None = None
    _seen: int = 0

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self, items_per_step: int = 1) -> dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps_timed": len(arr),
            "mean_step_s": float(arr.mean()),
            "p50_step_s": float(np.percentile(arr, 50)),
            "p95_step_s": float(np.percentile(arr, 95)),
            "items_per_sec": float(items_per_step / arr.mean()),
        }


@contextlib.contextmanager
def trace(log_dir: str | Path, device: str | torch.device = "cuda"):
    """Profile the block on the host and, for a CUDA ``device``, on that
    device; yields the ``torch.profiler.profile`` and writes its trace as
    ``<log_dir>/<host>_<pid>.<time>.pt.trace.json`` when the block ends.
    The profiler's schedule takes one warmup step (activities on, records
    discarded: on CUDA, ``WARMUP_KERNELS`` small kernels and ``EDGE_S``),
    then records the block as step 1 (a ``ProfilerStep#1`` span); on CUDA
    the session also waits ``EDGE_S`` after the block's last kernel, so
    the block's first and last kernels are recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    device = resolve_device(device)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        if cuda:
            warm = torch.zeros(1024, device=device)
            for _ in range(WARMUP_KERNELS):
                warm.add_(1.0)
            torch.cuda.synchronize(device)
            time.sleep(EDGE_S)
        prof.step()  # the block is the recorded step
        yield prof
        if cuda:  # the block's kernels end inside the session
            torch.cuda.synchronize(device)
            time.sleep(EDGE_S)


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Named region visible in the trace viewer: a
    ``torch.profiler.record_function`` range inside a profiler session, so
    it lands in the session's trace on the clock of its device records;
    outside one, a shared no-op context after one flag check (an ungated
    range costs microseconds with no session). The program's own spans are
    named ``gdl.<path>.<phase>``, with dots: no operator name has them."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def device_memory_stats(device: str | torch.device = "cuda") -> list[dict]:
    """``device``, bytes in use, their peak since the last reset, and the
    device's memory, for every CUDA device when ``device`` is CUDA; one dict
    with ``None`` values for the CPU, whose memory the allocator does not
    track (as JAX reports CPU devices)."""
    if resolve_device(device).type != "cuda":
        return [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                 "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": str(torch.device("cuda", i)),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    return out
