"""Train traffic: a closed loop of the program's train steps over a seeded
pool of batches in pinned host memory.

Set-up builds the model from the seed, the train state and the step, and
drives that same object through its first ``first_steps`` steps on pool
batches 0, 1, 2 (rows that all differ), through the window's own call and
feed: those steps are the warm-up and give the readings that decide
``correct`` (each step's loss, the first gradient as Adam holds it after
step 1, each leaf's change after the last). The window then cycles the
pool from the next batch: ``to_device`` of the pinned batch, the step,
and the loss read every ``log_every_n_steps`` steps, as ``Trainer.fit``
does; it ends with a synchronise, and counts every patch of every step
issued in it. A traced run adds a profiled stretch of ``stretch_steps``
steps after the window. Once the window has closed and the program's
state is freed, the plain reference trains three steps on the same
batches from the same weights (f32, TF32 off), with the loss that the
configuration's ``"loss"`` names, layer by layer under activation
checkpoints.
"""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from gdl_bench import checks, port, stats, weights
from gdl_bench import device as dev
from gdl_bench.reference.common import loss_of, normalize_nhwc
from gdl_bench.reference.numerics import FP8, Plain, f32_scope


def make_pool(traffic: dict, cfg: dict, seed: int, device: torch.device) -> list[dict]:
    """``pool_batches`` batches of uint8 NHWC patches and class masks made
    in ``mask_block``-pixel squares, drawn on the device, kept pinned on the
    host. A one-class (binary) head gets {0, 1} masks: background and its
    class."""
    g = torch.Generator(device=device).manual_seed(weights.derive(seed, 2))
    n, b, s = traffic["pool_batches"], traffic["batch"], cfg["image_size"]
    blk = traffic["mask_block"]
    img = torch.randint(0, 256, (n, b, s, s, cfg["in_channels"]), generator=g, device=device,
                        dtype=torch.uint8)
    cls = torch.randint(0, max(cfg["num_classes"], 2), (n, b, s // blk, s // blk), generator=g,
                        device=device, dtype=torch.uint8)
    mask = cls.repeat_interleave(blk, 2).repeat_interleave(blk, 3)
    img, mask = img.cpu(), mask.cpu()
    if device.type == "cuda":
        img, mask = img.pin_memory(), mask.pin_memory()
    mean = torch.tensor(cfg["mean"], dtype=torch.float32)
    std = torch.tensor(cfg["std"], dtype=torch.float32)
    return [{"image": img[i], "mask": mask[i], "mean": mean, "std": std} for i in range(n)]


def _leaf_norms(tensors: dict) -> dict[str, torch.Tensor]:
    return {k: torch.linalg.vector_norm(v.detach().float()) for k, v in tensors.items()}


def _half(batch: dict) -> dict:
    """The half-batch fault: the step sees the first half of the rows."""
    b = batch["image"].shape[0] // 2
    return {**batch, "image": batch["image"][:b], "mask": batch["mask"][:b]}


def run(ctx) -> dict:
    cfg, traffic, device, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    batch = traffic["batch"]
    loss_fn = loss_of(cfg)
    layout = port.state_layout(cfg)
    tables = ctx.reference.buffers(cfg)
    task = port.build_task(cfg, weights.make_state(layout, seed, device, tables), device, seed)
    state, step = port.train_step(cfg, task, seed)
    ctx.mark("model")
    pool = make_pool(traffic, cfg, seed, device)
    ctx.mark("pool")
    if ctx.fault == "unchanged":
        state.optimizer.step = lambda *a, **k: None
    feed = _half if ctx.fault == "half_batch" else (lambda b: b)
    beta1 = cfg["optimizer"]["betas"][0]
    named = dict(task.model.named_parameters())

    # the first steps: warm-up and the program's readings
    losses, grad1 = [], {}
    for t in range(traffic["first_steps"]):
        out = step(state, port.to_device(feed(pool[t]), device))
        losses.append(out["loss"])
        if t == 0:
            grad1 = {n: torch.linalg.vector_norm(state.optimizer.state[p]["exp_avg"]) / (1 - beta1)
                     for n, p in named.items() if p in state.optimizer.state}
    ctx.mark("first steps")
    start = weights.make_state(layout, seed, device, tables)
    delta = {n: (p.detach() - start[n]).cpu() for n, p in named.items()}
    del start
    ctx.mark("readings")
    program = {"loss": [float(x) for x in losses],
               "grad": {n: float(v) for n, v in grad1.items()}, "delta": delta}

    # the window
    setup_peak = dev.peak(device)
    dev.reset_peak(device)
    setup_s = time.perf_counter() - ctx.t0
    every = traffic["log_every_n_steps"]
    enqueue, i = [], traffic["first_steps"]
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        t0 = time.perf_counter()
        with record_function("bench.to_device"):
            dev_batch = port.to_device(feed(pool[i % len(pool)]), device)
        with record_function("bench.train_step"):
            out = step(state, dev_batch)
        enqueue.append(time.perf_counter() - t0)
        i += 1
        if state.step % every == 0:
            float(out["loss"])
    dev.sync(device)
    window_s = time.perf_counter() - t_start
    steps = i - traffic["first_steps"]
    window_peak = dev.peak(device)

    trace = None
    if ctx.trace:
        def stretch():
            nonlocal i
            for _ in range(traffic["stretch_steps"]):
                with record_function("bench.to_device"):
                    dev_batch = port.to_device(feed(pool[i % len(pool)]), device)
                with record_function("bench.train_step"):
                    step(state, dev_batch)
                i += 1
        trace = ctx.profile(stretch)

    del task, state, step, named, out, dev_batch
    dev.release(device)

    ref_batches = [pool[t] for t in range(traffic["first_steps"])]
    reference = reference_steps(ctx, Plain(), loss_fn, layout, tables, ref_batches)
    numbers = checks.train_numbers(program, reference)
    control = None
    if ctx.control:
        control = checks.train_numbers(
            reference_steps(ctx, FP8(), loss_fn, layout, tables, ref_batches), reference)
    return {
        "attempted": steps, "failed": 0, "numbers": numbers, "control": control,
        "e2e": {"train_patches_per_s": stats.rate(steps * batch, window_s),
                "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s},
        "memory_peak_bytes": max(setup_peak, window_peak),
        "record": {"kind": "train", "batch": batch, "steps": steps, "window_s": window_s,
                   "enqueue_s": enqueue, "trace": trace,
                   "stretch_steps": traffic["stretch_steps"]},
    }


def reference_steps(ctx, M, loss_fn, layout: dict, tables: dict, batches: list[dict]) -> dict:
    """The plain reference's three steps: the configuration's loss (+ aux),
    backward, global-norm clip, Adam; its readings as the program's."""
    cfg, device = ctx.cfg, ctx.device
    state = weights.make_state(layout, ctx.seed, device, tables)
    trainable = [n for n, (s, dt) in layout.items()
                 if dt.is_floating_point and n not in tables
                 and weights.kind(n, s) not in ("running_mean", "running_var")]
    P = {n: v.float() for n, v in state.items()}
    for n in trainable:
        P[n].requires_grad_(True)
    start = {n: P[n].detach().clone() for n in trainable}
    opt = cfg["optimizer"]
    b1, b2 = opt["betas"]
    m = {n: torch.zeros_like(P[n]) for n in trainable}
    v = {n: torch.zeros_like(P[n]) for n in trainable}
    losses, grad1 = [], {}
    with f32_scope():
        for t, batch in enumerate(batches, start=1):
            x = normalize_nhwc(batch["image"].to(device), cfg["mean"], cfg["std"])
            y = batch["mask"].to(device).long()
            out, aux = ctx.reference.forward(M, P, cfg, x, train=True, ckpt=True)
            loss = loss_fn(out, y, cfg["num_classes"])
            if aux is not None:
                loss = loss + cfg["aux_loss_weight"] * loss_fn(aux, y, cfg["num_classes"])
            grads = torch.autograd.grad(loss, [P[n] for n in trainable], allow_unused=True)
            grads = {n: (g if g is not None else torch.zeros_like(P[n]))
                     for n, g in zip(trainable, grads)}
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
            if norm >= cfg["grad_clip"]:
                grads = {n: g * (cfg["grad_clip"] / norm).float() for n, g in grads.items()}
            if t == 1:
                grad1 = {n: g.detach().clone() for n, g in grads.items()}
            with torch.no_grad():
                for n, g in grads.items():
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(opt["eps"])
                    P[n].addcdiv_(m[n], denom, value=-opt["lr"] / (1 - b1 ** t))
            losses.append(float(loss.detach()))
            del out, aux, loss, grads, x, y
    return {"loss": losses, "grad1": grad1,
            "grad": {n: float(x) for n, x in _leaf_norms(grad1).items()},
            "delta": {n: (P[n] - start[n]).detach() for n in trainable}}
