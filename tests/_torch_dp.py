"""Scenarios of the data-parallel tests, without JAX.

Each scenario runs on every rank of a gloo group (``core.mesh.launch``
calls :func:`run_scenarios` on two spawned processes) and, in the test
process, on one rank with no group, from the same inputs: weights that the
test wrote as port state dicts, and global batches drawn with numpy. A rank
writes its results to ``<out>/<scenario>_rank<r>.npz``; the tests compare
them with the one-rank run, with the JAX package's two-device mesh step and
across the ranks.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from _torch_tiny_port import TINY_DECODER, WAVES, register_port_tiny
from geo_deep_learning_tpu_torch.core.mesh import Mesh, create_mesh, shard_batch
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
from geo_deep_learning_tpu_torch.models.segmentation.unetpp import UnetPlusPlus
from geo_deep_learning_tpu_torch.ops import losses as L
from geo_deep_learning_tpu_torch.parallel.collectives import reduce_over
from geo_deep_learning_tpu_torch.training import optim as toptim
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.loop import Trainer, TrainerConfig
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

SIZE = 64
GLOBAL_BATCH = 4
N_STEPS = 3
LR = 1e-3
FAMILIES = ("dofa", "unetpp", "segformer")
# DOFA: the narrow ViT; UNet++: resnet18 (the registry's own) with the
# narrow decoder; SegFormer: the narrow MiT
ARCH = {
    "dofa": lambda: DOFASegmentation("tiny", num_classes=1, decoder_channels=32, img_size=SIZE),
    "unetpp": lambda: UnetPlusPlus("resnet18", num_classes=1, decoder_channels=TINY_DECODER),
    "segformer": lambda: SegFormer("tiny_mit", num_classes=1),
    "tiny_unetpp": lambda: UnetPlusPlus("tiny_resnet", num_classes=1,
                                        decoder_channels=TINY_DECODER),
}
# losses whose batch sums the ranks share, with sample weights that differ
# between the ranks' rows
LOSSES = {
    "dice": L.DiceLoss(mode="multiclass"),
    "jaccard": L.JaccardLoss(mode="multiclass"),
    "cross_entropy": L.CrossEntropyLoss(class_weights=[0.5, 1.0, 2.0], ignore_index=2),
    "focal": L.FocalLoss(mode="multiclass", alpha=0.25),
}
LOSS_WEIGHTS = np.asarray([1.0, 1.0, 1.0, 0.0])  # rank 0: both rows real, rank 1: one


def model(family: str, inputs: Path) -> torch.nn.Module:
    """The family's port model with the weights the test wrote, every
    random layer at rate 0 (random streams do not match across packages)."""
    m = ARCH[family]()
    m.load_state_dict(torch.load(inputs / f"{family}.pt", weights_only=True), strict=True)
    for sub in m.modules():
        if isinstance(sub, (DropPath, Dropout)):
            sub.rate = 0.0
    return m.eval()


def task_of(m: torch.nn.Module) -> SegmentationTask:
    return SegmentationTask(m, L.DiceLoss(mode="binary"), num_classes=1,
                            default_wavelengths=list(WAVES))


def global_batches(seed: int, n: int = N_STEPS, rows: int = GLOBAL_BATCH) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{
        "image": rng.integers(0, 256, (rows, SIZE, SIZE, 3), dtype=np.uint8),
        "mask": rng.integers(0, 2, (rows, SIZE, SIZE)).astype(np.int64),
        "mean": np.tile(np.asarray([0.405, 0.432, 0.397], np.float32), (rows, 1)),
        "std": np.tile(np.asarray([0.165, 0.161, 0.174], np.float32), (rows, 1)),
        "image_name": [f"s{seed}_{k}_{i}" for i in range(rows)],
    } for k in range(n)]


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def _flat_state(opt: torch.optim.Optimizer, m: torch.nn.Module) -> dict[str, np.ndarray]:
    out = {f"param/{n}": p.detach().numpy().copy() for n, p in m.named_parameters()}
    out.update({f"buffer/{n}": b.numpy().copy() for n, b in m.named_buffers()})
    names = {p: n for n, p in m.named_parameters()}
    for p, slots in opt.state.items():
        for k, v in slots.items():
            if torch.is_tensor(v):
                out[f"opt/{names[p]}/{k}"] = v.numpy().copy()
    return out


def train(mesh: Mesh, family: str, inputs: Path) -> dict[str, np.ndarray]:
    """Three Adam steps (no clip) of a f32 train step on the global
    batches: the losses, the first step's gradients (as the optimizer
    sees them, after DDP's mean) and BatchNorm statistics, and the whole
    state after the last step."""
    m = model(family, inputs)
    opt = toptim.build_optimizer(list(m.parameters()), "adam", LR)
    first: dict[str, np.ndarray] = {}

    def capture(optimizer, args, kwargs):
        if not first:
            first.update({f"grad/{n}": p.grad.numpy().copy()
                          for n, p in m.named_parameters() if p.grad is not None})
            first.update({f"stat/{n}": b.numpy().copy() for n, b in m.named_buffers()
                          if n.endswith(("running_mean", "running_var"))})

    opt.register_step_pre_hook(capture)
    state = TrainState.create(m, opt, seed=0)
    step = tsteps.make_train_step(task_of(m), PrecisionPolicy.create("32-true"), augment=None,
                                  grad_clip=None, mesh=mesh)
    losses = [float(step(state, shard_batch(_torch(b), mesh))["loss"])
              for b in global_batches(1)]
    return {"loss": np.asarray(losses), **first, **_flat_state(opt, m)}


def losses(mesh: Mesh) -> dict[str, np.ndarray]:
    """Each configured loss and its gradient by the logits on this rank's
    rows (f64), the gradient divided by the rank count: the identity
    ``d(global loss)/d(rows) = local gradient / W`` that DDP's mean rests on."""
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((GLOBAL_BATCH, 3, 16, 16))
    targets = rng.integers(0, 3, (GLOBAL_BATCH, 16, 16))
    batch = shard_batch({"mask": targets, "logits": logits, "w": LOSS_WEIGHTS}, mesh)
    out = {}
    for name, loss_fn in LOSSES.items():
        x = torch.tensor(batch["logits"], requires_grad=True)
        with reduce_over(mesh.group if mesh.size > 1 else None):
            value = loss_fn(x, torch.from_numpy(batch["mask"]),
                            sample_weights=torch.from_numpy(batch["w"]))
            value.backward()
        out[f"{name}/loss"] = np.asarray(value.item())
        out[f"{name}/grad"] = x.grad.numpy() / mesh.size
    return out


def accumulate(mesh: Mesh, inputs: Path, freeze: bool = False) -> dict[str, np.ndarray]:
    """SGD (momentum 0.9) with gradient clipping on two micro-batches accumulated into one
    update (``no_sync`` on the first), or one step with the encoder frozen;
    the DDP all-reduce calls of each micro-step are counted."""
    m = model("tiny_unetpp", inputs)
    frozen = toptim.freeze(m, ["encoder"] if freeze else None)
    opt = toptim.build_optimizer([p for p in m.parameters() if p.requires_grad], "sgd", 0.1,
                                 momentum=0.9)
    state = TrainState.create(m, opt, seed=0)
    step = tsteps.make_train_step(task_of(m), PrecisionPolicy.create("32-true"), augment=None,
                                  grad_clip=1.0, accumulate=1 if freeze else 2, mesh=mesh)
    calls = []
    if step.ddp is not None:
        from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import allreduce_hook

        def counting(process_group, bucket):
            calls[-1] += 1
            return allreduce_hook(process_group, bucket)

        step.ddp.register_comm_hook(mesh.group, counting)
    losses = []
    for b in global_batches(2, n=1 if freeze else 2):
        calls.append(0)
        losses.append(float(step(state, shard_batch(_torch(b), mesh))["loss"]))
    return {"loss": np.asarray(losses), "allreduce_calls": np.asarray(calls),
            "n_frozen": np.asarray(len(frozen)), **_flat_state(opt, m)}


def serve(mesh: Mesh, inputs: Path) -> dict[str, np.ndarray]:
    """``Trainer.evaluate`` over batches of 4, 4 and a short 3 (replicated
    over 2 ranks), and ``Trainer.predict``'s gathered predictions."""
    trainer = Trainer(TrainerConfig(precision="32-true"), device="cpu")
    task = task_of(model("tiny_unetpp", inputs))
    batches = global_batches(3, n=2) + global_batches(4, n=1, rows=3)
    out = {f"metric/{k}": np.asarray(v)
           for k, v in trainer.evaluate(task, [_torch(b) for b in batches], "test").items()}
    for k, pred in enumerate(trainer.predict(task, [_torch(b) for b in batches])):
        out[f"preds/{k}"] = pred["preds"]
        out[f"names/{k}"] = np.asarray(pred["batch"]["image_name"])
        out[f"valid/{k}"] = np.asarray(int(pred["batch"].get("valid_count", len(pred["preds"]))))
    return out


def streams(mesh: Mesh, inputs: Path) -> dict[str, np.ndarray]:
    """The data paths' batches at this rank: the shard stream's ``trn``
    (each rank its own shards, ``B / W`` rows a batch) and ``val`` (global
    batches cut by rows), and the worker-process CSV module's ``val`` (its
    short last batch replicated): names, rows and row keys by batch."""
    from geo_deep_learning_tpu_torch.data.grain_pipeline import GrainCSVDataModule
    from geo_deep_learning_tpu_torch.data.multisensor import MultiSensorDataModule

    out = {}
    shards = MultiSensorDataModule(str(inputs / "shards" / "sensors.json"), model_type="dofa",
                                   batch_size=GLOBAL_BATCH, epoch_size=8, shuffle_buffer=1,
                                   seed=3)
    shards.setup("fit")
    grain = GrainCSVDataModule(str(inputs / "csv"), str(inputs / "csv"),
                               batch_size=GLOBAL_BATCH, num_workers=1)
    grain.setup("fit")
    try:
        for name, loader in (("trn", shards.train_dataloader()), ("val", shards.val_dataloader()),
                             ("grain_val", grain.val_dataloader())):
            out[f"{name}/len"] = np.asarray(len(loader))
            for k, batch in enumerate(loader):
                batch = shard_batch(batch, mesh)
                out[f"{name}/{k}/names"] = np.asarray(batch["image_name"])
                out[f"{name}/{k}/keys"] = np.asarray(
                    [int(batch["valid_count"]), int(batch.get("row_offset", 0)),
                     int(batch.get("global_rows", len(batch["image_name"])))])
    finally:
        grain.close()
    return out


SCENARIOS = {
    **{f"train_{f}": (lambda mesh, inputs, f=f: train(mesh, f, inputs)) for f in FAMILIES},
    "losses": lambda mesh, inputs: losses(mesh),
    "accumulate": lambda mesh, inputs: accumulate(mesh, inputs),
    "freeze": lambda mesh, inputs: accumulate(mesh, inputs, freeze=True),
    "serve": serve,
    "streams": streams,
}


def run_scenarios(inputs: str, out: str) -> int:
    """Every scenario on this rank (the ``launch`` target)."""
    torch.set_num_threads(1)
    register_port_tiny()
    mesh = create_mesh(device="cpu")
    for name, fn in SCENARIOS.items():
        np.savez(Path(out) / f"{name}_rank{mesh.rank}.npz", **fn(mesh, Path(inputs)))
    return os.getpid()


def fail_on_rank_1(hold_s: float) -> None:
    """Rank 1 raises; rank 0 waits in a collective that rank 1 never joins."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(0.5)
        msg = "rank 1 fails on purpose"
        raise ValueError(msg)
    dist.all_reduce(torch.ones(1))
    time.sleep(hold_s)


def batchnorm_on_card(out: str, device: str = "cuda") -> None:
    """Two ranks on ``cuda:0`` over gloo: the port's train-mode BatchNorm on
    the rank's rows of a seeded ``[4, 8, 16, 16]`` batch (its statistics the
    global batch's) and a ``global_sum`` of its weighted output, backward
    through both; each rank writes its output, input gradient, running
    statistics and the BN parameters' gradients."""
    mesh = create_mesh(device=device)
    np.savez(Path(out) / f"bn_rank{mesh.rank}.npz",
             **batchnorm_step(mesh, shard_batch(bn_batch(), mesh)))


def bn_batch() -> dict:
    rng = np.random.default_rng(31)
    return {"mask": rng.standard_normal((4, 8, 16, 16)).astype(np.float32) * 3 + 1,
            "w": rng.standard_normal((4, 8, 16, 16)).astype(np.float32)}


def batchnorm_step(mesh: Mesh, batch: dict) -> dict[str, np.ndarray]:
    """One train-mode BatchNorm forward and backward on ``mesh.device``: the
    input's gradient divided by the rank count is the global gradient on
    the rank's rows; the weight's, averaged over the ranks (DDP's mean), is
    the global one."""
    from geo_deep_learning_tpu_torch.models.layers import BatchNorm2d
    from geo_deep_learning_tpu_torch.parallel.collectives import global_sum

    bn = BatchNorm2d(8).to(mesh.device).train()
    x = torch.from_numpy(batch["mask"]).to(mesh.device).requires_grad_()
    with reduce_over(mesh.group if mesh.size > 1 else None):
        y = bn(x)
        total = global_sum((y * torch.from_numpy(batch["w"]).to(mesh.device)).sum())
        total.backward()
    return {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy() / mesh.size,
            "mean": bn.running_mean.cpu().numpy(), "var": bn.running_var.cpu().numpy(),
            "dw": bn.weight.grad.cpu().numpy(), "total": np.asarray(total.item())}
