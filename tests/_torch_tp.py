"""Scenarios of the tensor-parallel tests, without JAX.

Each scenario runs on every rank of a 4-rank gloo group as a
``{data: 2, model: 2}`` mesh (``core.mesh.launch`` calls
:func:`run_scenarios`), and the train scenarios also on one rank with no
group in the test process, from the same inputs: weights that the test
wrote as port state dicts, global batches drawn with numpy, and a CSV
dataset and its shards. A rank writes its results to
``<out>/<scenario>_rank<global rank>.npz``; the tests compare them with the
one-rank run, with the JAX package's ``{data: 2, model: 2}`` mesh step and
across the ranks. Gradients and parameters are gathered whole over the
model group before they are written (``parallel.placement.gather_tensor``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from _torch_tiny_port import WAVES, register_port_tiny
from geo_deep_learning_tpu_torch.core.mesh import Mesh, MeshConfig, create_mesh, shard_batch
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
from geo_deep_learning_tpu_torch.ops import losses as L
from geo_deep_learning_tpu_torch.parallel.placement import (
    TENSOR_PARALLEL_RULES,
    count_model_sharded,
    gather_tensor,
    place_state,
    replicate_state,
)
from geo_deep_learning_tpu_torch.training import optim as toptim
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

SIZE = 64
GLOBAL_BATCH = 4
LR = 1e-3
CLIP = 0.05  # below every step's global norm here, so the clip engages
FAMILIES = ("dofa", "segformer")
MESH = MeshConfig(data=2, model=2)
ARCH = {
    "dofa": lambda: DOFASegmentation("tiny", num_classes=1, decoder_channels=32, img_size=SIZE),
    "segformer": lambda: SegFormer("tiny_mit", num_classes=1),
}


def model(family: str, inputs: Path, drop_path: float = 0.0) -> torch.nn.Module:
    """The family's port model with the weights the test wrote; every
    random layer at rate 0 except DropPath at ``drop_path``."""
    m = ARCH[family]()
    m.load_state_dict(torch.load(inputs / f"{family}.pt", weights_only=True), strict=True)
    for sub in m.modules():
        if isinstance(sub, (DropPath, Dropout)):
            sub.rate = drop_path if isinstance(sub, DropPath) else 0.0
    return m.eval()


def placed(m: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    replicate_state(m, mesh)
    return place_state(m, mesh, TENSOR_PARALLEL_RULES if mesh.model_size > 1 else None)


def task_of(m: torch.nn.Module) -> SegmentationTask:
    return SegmentationTask(m, L.DiceLoss(mode="binary"), num_classes=1,
                            default_wavelengths=list(WAVES))


def global_batches(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{
        "image": torch.from_numpy(rng.integers(0, 256, (GLOBAL_BATCH, SIZE, SIZE, 3),
                                               dtype=np.uint8)),
        "mask": torch.from_numpy(rng.integers(0, 2, (GLOBAL_BATCH, SIZE, SIZE)).astype(np.int64)),
        "mean": torch.tensor([0.405, 0.432, 0.397]).repeat(GLOBAL_BATCH, 1),
        "std": torch.tensor([0.165, 0.161, 0.174]).repeat(GLOBAL_BATCH, 1),
    } for _ in range(n)]


def _whole(p: torch.Tensor, t: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """``t`` (``p``'s value or gradient) whole over the model group."""
    split = getattr(p, "model_split", None)
    return (t if split is None else gather_tensor(t, split, mesh)).detach().numpy().copy()


def train(mesh: Mesh, family: str, inputs: Path, steps: int = 3, drop_path: float = 0.0,
          remat: bool = False) -> dict[str, np.ndarray]:
    """``steps`` f32 Adam steps with a global-norm clip that engages: the
    losses, each step's clip norm, the first step's whole gradients (before
    the clip, as the JAX package's step gives them), the whole parameters
    after the last step, and this rank's own parameters and optimizer
    state (``local/``) for the bit-equality checks."""
    m = placed(model(family, inputs, drop_path), mesh)
    if remat:
        m.encoder.remat_block = True
    names = {p: n for n, p in m.named_parameters()}
    opt = toptim.build_optimizer(list(m.parameters()), "adam", LR)
    state = TrainState.create(m, opt, seed=0)
    norms: list[float] = []
    first: dict[str, np.ndarray] = {}
    clip = tsteps.clip_by_global_norm_

    def recording(params, max_norm, model_group=None):
        params = list(params)
        if not first:
            first.update({f"grad/{names[p]}": _whole(p, p.grad, mesh) for p in params
                          if p.grad is not None})
        norm = clip(params, max_norm, model_group)
        norms.append(float(norm))
        return norm

    tsteps.clip_by_global_norm_ = recording
    try:
        step = tsteps.make_train_step(task_of(m), PrecisionPolicy.create("32-true"),
                                      augment=None, grad_clip=CLIP, mesh=mesh)
        losses = [float(step(state, shard_batch(b, mesh))["loss"])
                  for b in global_batches(1, steps)]
    finally:
        tsteps.clip_by_global_norm_ = clip
    out = {"loss": np.asarray(losses), "norm": np.asarray(norms),
           "n_sharded": np.asarray(count_model_sharded(m)), **first}
    out.update({f"param/{names[p]}": _whole(p, p, mesh) for p in m.parameters()})
    out.update({f"local/{n}": p.detach().numpy().copy() for n, p in m.named_parameters()})
    for p, slots in opt.state.items():
        out.update({f"local_opt/{names[p]}/{k}": v.numpy().copy() for k, v in slots.items()})
    return out


def streams(mesh: Mesh, inputs: Path) -> dict[str, np.ndarray]:
    """The names of each batch that this rank reads from the threaded CSV
    loader (``trn`` and ``val``), the round-robin distributed sampler and
    the shard stream's ``trn`` and ``val``."""
    from geo_deep_learning_tpu_torch.data.datamodule import CSVDataModule
    from geo_deep_learning_tpu_torch.data.multisensor import MultiSensorDataModule
    from geo_deep_learning_tpu_torch.data.samplers import RoundRobinDistributedSampler

    out = {}
    csv = CSVDataModule(str(inputs / "csv"), str(inputs / "csv"), batch_size=GLOBAL_BATCH,
                        num_workers=1)
    csv.setup("fit")
    shards = MultiSensorDataModule(str(inputs / "shards" / "sensors.json"), model_type="dofa",
                                   batch_size=GLOBAL_BATCH, epoch_size=8, shuffle_buffer=1,
                                   seed=3)
    shards.setup("fit")
    loaders = {"csv_trn": csv.train_dataloader(), "csv_val": csv.val_dataloader(),
               "shard_trn": shards.train_dataloader(), "shard_val": shards.val_dataloader()}
    for name, loader in loaders.items():
        for k, batch in enumerate(loader):
            out[f"{name}/{k}"] = np.asarray(shard_batch(batch, mesh)["image_name"])
    sampler = RoundRobinDistributedSampler({"a": 12, "b": 8}, batch_size=2, seed=5,
                                           balance=False)
    for k, (sensor, idx) in enumerate(sampler):
        out[f"round_robin/{k}"] = np.asarray([f"{sensor}{i}" for i in idx])
    return out


def fit(mesh: Mesh, inputs: Path) -> dict[str, np.ndarray]:
    """``run(config, "fit")`` with ``trainer.mesh: {data: 2, model: 2}`` on
    the narrow SegFormer (2 epochs, auto-test), then a second fit from its
    ``last.pt`` through the ``Trainer``: the metrics, the checkpoints'
    paths, and the second fit's restored and final steps and sharded count."""
    import copy

    from geo_deep_learning_tpu_torch.cli.config import instantiate
    from geo_deep_learning_tpu_torch.cli.main import build_trainer_config, run
    from geo_deep_learning_tpu_torch.training.loop import Trainer

    config = json.loads((inputs / "fit_config.json").read_text())
    result = run(copy.deepcopy(config), "fit", device="cpu")
    root = Path(config["trainer"]["default_root_dir"]) / "checkpoints"
    best = json.loads((root / "index.json").read_text())["best_path"]
    last = root / "last.pt"
    restored = int(torch.load(last, weights_only=True)["step"])

    resumed = copy.deepcopy(config)
    resumed["trainer"]["default_root_dir"] = config["trainer"]["default_root_dir"] + "_resumed"
    spec = instantiate(resumed["model"])
    datamodule = instantiate(resumed["data"])
    trainer = Trainer(build_trainer_config(resumed["trainer"], 42), device="cpu")
    history = trainer.fit(spec.task, datamodule, ckpt_path=str(last), **spec.fit_kwargs())
    return {**{f"metric/{k}": np.asarray(v) for k, v in result.items()},
            "best": np.asarray(str(best)), "restored_step": np.asarray(restored),
            "resumed_step": np.asarray(trainer.state.step),
            "resumed_loss": np.asarray(history["train_loss"]),
            "n_sharded": np.asarray(count_model_sharded(trainer.state.model))}


SCENARIOS = {
    **{f"train_{f}": (lambda mesh, inputs, f=f: train(mesh, f, inputs)) for f in FAMILIES},
    "droppath_dofa": lambda mesh, inputs: train(mesh, "dofa", inputs, steps=2, drop_path=0.1),
    "remat_dofa": lambda mesh, inputs: train(mesh, "dofa", inputs, steps=1, remat=True),
    "streams": streams,
    "fit": fit,
}
ONE_RANK = tuple(f"train_{f}" for f in FAMILIES)


def run_scenarios(inputs: str, out: str) -> int:
    """Every scenario on this rank of the ``{data: 2, model: 2}`` mesh (the
    ``launch`` target)."""
    torch.set_num_threads(1)
    register_port_tiny()
    mesh = create_mesh(MESH, device="cpu")
    for name, fn in SCENARIOS.items():
        np.savez(Path(out) / f"{name}_rank{mesh.global_rank}.npz", **fn(mesh, Path(inputs)))
    return os.getpid()
