"""Helpers the per-layer metric readers share.

A reader is a file ``metrics/<metric>.py`` with ``SOURCE``, ``LAYER``,
``MOVES``, ``OPS`` (the host operators whose kernels it attributes, as
regular expressions) and ``read(rec, ctx)``, which returns the metric's
value from the run's record, or None where the record holds nothing to
read (no trace, no such kernels): the harness then leaves the metric out.
"""

from __future__ import annotations

from gdl_bench import stats
from gdl_bench.counts import peaks


def tile_batches(rec: dict) -> list[int]:
    """The forward batch sizes of one scene."""
    n, b = rec["tiles"], rec["tile_batch"]
    return [min(b, n - i) for i in range(0, n, b)]


def mfu(rec: dict, ctx) -> float:
    """The window's model operations over its seconds and the bf16 peak, in %."""
    counts = ctx.counts
    if rec["kind"] == "train":
        ops = rec["steps"] * counts.train_flops(ctx.cfg, rec["batch"])
    else:
        ops = rec["scenes"] * sum(counts.forward_flops(ctx.cfg, b) for b in tile_batches(rec))
    return 100.0 * ops / rec["window_s"] / peaks.BF16_TENSOR_FLOPS


def idle_pct(rec: dict) -> float | None:
    tr = rec["trace"]
    if tr is None or not tr.device or tr.span_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.span_s)


def roofline(rec: dict, ctx, ops: tuple, train: bool) -> float | None:
    """The least time of the stretch's attention work (the counted kernel
    records at their bounds) over the device time of the kernels launched
    under ``ops``, in %."""
    tr = rec["trace"]
    if tr is None:
        return None
    us = tr.kernel_us(ops)
    if us <= 0:
        return None
    if train:
        recs = ctx.counts.attention(ctx.cfg, rec["batch"], True) * rec["stretch_steps"]
    else:
        recs = [r for b in tile_batches(rec) for r in ctx.counts.attention(ctx.cfg, b, False)]
        recs = recs * rec["stretch_scenes"]
    if not recs:
        return None
    bound_ms = sum(peaks.bound(r)[0] for r in recs)
    return 100.0 * bound_ms * 1e3 / us


def enqueue_ms(rec: dict) -> float | None:
    return 1e3 * stats.mean(rec["enqueue_s"]) if rec["enqueue_s"] else None
