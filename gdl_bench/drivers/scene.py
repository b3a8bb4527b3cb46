"""Scene traffic: a closed loop of whole-scene class maps, one client.

Set-up builds the model from the seed (eval mode) and a pool of
``pool_scenes`` seeded uint8 RGB scenes of ``scene_px`` square in pinned
host memory, and serves one scene as the warm-up. Each scene of the
window is submitted when the previous map has reached the host: the H2D
copy, ``normalize``, ``sliding_window_logits`` through the program's
``tile_forward`` (tiles of ``tile_size`` at ``overlap``, ``tile_batch`` a
forward, the last tile of a row or column clamped to the edge, the blend
window), ``logits_to_classes`` and the D2H copy of the uint8 map into
pinned memory; its latency runs from submission to the map on the host.
The maps and blended logits of ``check_scenes`` completions drawn from
the seed among the first ``check_from``, and of the last, are kept (the
logits copied to the host after the scene's latency is taken) and judged
against the plain reference's blended logits once the window has closed,
in f32 and, for the scale of the gaps, with bf16 operands.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch
from torch.profiler import record_function

from gdl_bench import checks, port, stats, weights
from gdl_bench import device as dev
from gdl_bench.reference.common import normalize_nhwc
from gdl_bench.reference.numerics import BF16, FP8, Plain, f32_scope


def make_pool(traffic: dict, cfg: dict, seed: int, device: torch.device) -> list[torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(weights.derive(seed, 3))
    s = traffic["scene_px"]
    scenes = torch.randint(0, 256, (traffic["pool_scenes"], s, s, cfg["in_channels"]),
                           generator=g, device=device, dtype=torch.uint8).cpu()
    if device.type == "cuda":
        scenes = scenes.pin_memory()
    return list(scenes.unbind(0))


def tile_origins(size: int, tile: int, overlap: int) -> list[int]:
    """Tile starts along one side at stride ``tile - overlap``, the last
    one moved back to end at the edge."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile + 1, tile - overlap))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def hann(tile: int) -> np.ndarray:
    """The blend window: a Hann taper floored at 1e-3."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
    return np.maximum(np.outer(w, w), 1e-3).astype(np.float32)


def run(ctx) -> dict:
    cfg, traffic, device, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    layout = port.state_layout(cfg)
    tables = ctx.reference.buffers(cfg)
    task = port.build_task(cfg, weights.make_state(layout, seed, device, tables), device, seed)
    forward, logits_fn, normalize, classes_fn, sw_config = port.scene_fns(cfg, task)
    win = sw_config(traffic["tile_size"], traffic["overlap"], traffic["tile_batch"],
                    traffic["blend"])
    k = cfg["num_classes"]
    if ctx.fault == "half_batch":
        whole = forward
        forward = lambda tiles: whole(tiles[: max(1, tiles.shape[0] // 2)])  # noqa: E731
    ctx.mark("model")
    pool = make_pool(traffic, cfg, seed, device)
    ctx.mark("pool")
    s = traffic["scene_px"]
    out = torch.empty((s, s), dtype=torch.uint8, pin_memory=device.type == "cuda")
    done = torch.cuda.Event() if device.type == "cuda" else None

    def serve(i: int) -> tuple[float, torch.Tensor]:
        """One scene, submission to map on the host; returns the seconds
        taken to issue it and the blended logits."""
        t0 = time.perf_counter()
        with record_function("bench.h2d"):
            x = pool[i % len(pool)].to(device, non_blocking=True)
        with record_function("bench.normalize"):
            x = normalize(x, cfg["mean"], cfg["std"])
        with record_function("bench.sliding_window_logits"):
            logits = logits_fn(forward, x, k, win)
            if ctx.fault == "altered":  # a block of answers altered where produced
                logits[: s // 8, : s // 8] = logits[: s // 8, : s // 8].roll(1, dims=-1)
        with record_function("bench.logits_to_classes"):
            cls = classes_fn(logits, k, traffic["threshold"])
        with record_function("bench.d2h"):
            out.copy_(cls, non_blocking=True)
            if done is not None:
                done.record()
        issued = time.perf_counter() - t0
        if done is not None:
            done.synchronize()
        return issued, logits

    serve(0)  # warm-up: every shape of the window
    ctx.mark("warm-up scene")
    rng = random.Random(weights.derive(seed, 4))
    keep = set(rng.sample(range(traffic["check_from"]), traffic["check_scenes"]))
    setup_peak = dev.peak(device)
    dev.reset_peak(device)
    setup_s = time.perf_counter() - ctx.t0
    latency, enqueue, kept, i = [], [], {}, 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        t_sub = time.perf_counter()
        issued, logits = serve(i)
        latency.append(time.perf_counter() - t_sub)
        enqueue.append(issued)
        if i in keep:
            kept[i] = (out.clone(), logits.cpu())
        i += 1
    window_s = time.perf_counter() - t_start
    kept[i - 1] = (out.clone(), logits.cpu())
    del logits
    window_peak = dev.peak(device)

    trace = None
    if ctx.trace:
        def stretch():
            for j in range(traffic["stretch_scenes"]):
                serve(i + j)
        trace = ctx.profile(stretch)

    del task, forward
    dev.release(device)

    order = sorted(kept)
    scenes = [pool[j % len(pool)] for j in order]
    maps = [kept[j][0] for j in order]
    logits = [kept[j][1] for j in order]
    reference = [reference_logits(ctx, Plain(), layout, tables, sc) for sc in scenes]
    rounded = [reference_logits(ctx, BF16(), layout, tables, sc) for sc in scenes]
    numbers = checks.scene_numbers(maps, logits, reference, rounded)
    control = None
    if ctx.control:
        ctl = [reference_logits(ctx, FP8(), layout, tables, sc) for sc in scenes]
        control = checks.scene_numbers([lg.argmax(dim=0) for lg in ctl],
                                       [lg.permute(1, 2, 0) for lg in ctl], reference, rounded)
    px = s * s
    return {
        "attempted": i, "failed": 0, "numbers": numbers, "control": control,
        "e2e": {"scene_mpx_per_s": stats.rate(i * px / 1e6, window_s),
                "scene_s_p95": stats.percentile(latency, 95.0),
                "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s},
        "memory_peak_bytes": max(setup_peak, window_peak),
        "record": {"kind": "scene", "scenes": i, "window_s": window_s,
                   "enqueue_s": enqueue, "latency_s": latency, "trace": trace,
                   "stretch_scenes": traffic["stretch_scenes"],
                   "tiles": len(tile_origins(s, traffic["tile_size"], traffic["overlap"])) ** 2,
                   "tile_batch": traffic["tile_batch"]},
    }


@torch.no_grad()
def reference_logits(ctx, M, layout: dict, tables: dict, scene: torch.Tensor) -> torch.Tensor:
    """The reference's blended logits ``[K, H, W]`` of one uint8 scene:
    the same tiles, each through the plain model in eval mode, weighted by
    the blend window into f32 canvases, divided by the weights."""
    cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
    P = {n: v.float() for n, v in weights.make_state(layout, ctx.seed, device, tables).items()}
    t = traffic["tile_size"]
    s = scene.shape[0]
    starts = tile_origins(s, t, traffic["overlap"])
    coords = [(r, c) for r in starts for c in starts]
    w = torch.from_numpy(hann(t)).to(device)
    k = cfg["num_classes"]
    acc = torch.zeros((k, s, s), device=device)
    wsum = torch.zeros((s, s), device=device)
    x = scene.to(device)
    with f32_scope():
        for j in range(0, len(coords), traffic["reference_batch"]):
            rcs = coords[j: j + traffic["reference_batch"]]
            tiles = torch.stack([x[r: r + t, c: c + t] for r, c in rcs])
            logits, _ = ctx.reference.forward(M, P, cfg, normalize_nhwc(tiles, cfg["mean"],
                                                                        cfg["std"]), train=False)
            for (r, c), lg in zip(rcs, logits):
                acc[:, r: r + t, c: c + t] += lg * w
                wsum[r: r + t, c: c + t] += w
    return acc / torch.clamp(wsum, min=1e-8)
