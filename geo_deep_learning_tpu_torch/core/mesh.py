"""The 2-D ``(data, model)`` mesh: one process a rank, and a rank's rows of a batch.

Port of ``geo_deep_learning_tpu/core/mesh.py``. The JAX package runs one
process that holds every device, and GSPMD splits a host batch into
contiguous blocks along the mesh's ``data`` axis. Here each rank is its own
process in a ``torch.distributed`` group (NCCL for CUDA, gloo for the CPU,
or gloo on a shared card when asked), and the same split is explicit:

- ``data.batch_size`` is the global batch: rank r of W holds rows
  ``[r * B / W, (r + 1) * B / W)`` of it (:func:`rank_rows`), as
  ``P("data")`` places them; a batch whose length does not divide W is
  replicated on every rank (``core/mesh.py:149-151`` of the JAX package);
- a rank's batch carries ``valid_count`` (the real rows among its own),
  and, when W > 1, ``row_offset`` and ``global_rows`` (where its rows sit
  in the global batch); :func:`shard_batch` cuts a host batch so, and the
  rank-aware loaders produce the same batch directly;
- :func:`launch` spawns W processes (``spawn``), each joins the group and
  runs one function; a rank that fails ends the run: the launcher stops the
  other ranks and raises its traceback. Every group has a timeout, so a
  collective that one rank never joins raises instead of hanging.

The model axis (tensor parallelism): ``MeshConfig(data=D, model=M)`` runs
``D * M`` ranks. Global rank ``g = d * M + m`` has data index ``d`` and
model index ``m`` (the model axis moves fastest, as the JAX package's
``reshape(data, model)`` lays out its devices). The ``M`` ranks of one data
index form a model group: they read the same rows and hold the
tensor-parallel shards of one replica (``parallel.placement``). The ``D``
ranks of one model index form a data group, over which batches are split
and gradients averaged exactly as with ``model: 1``. :class:`Mesh`'s
``rank``, ``size`` and ``group`` stay the data axis's; ``model_rank``,
``model_size`` and ``model_group`` are the model axis's.
"""

from __future__ import annotations

import datetime
import functools
import os
import queue as queue_lib
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

GROUP_TIMEOUT_S = 300.0  # the longest a collective waits for the other ranks
POLL_S = 0.2  # how often the launcher looks at its ranks
STOP_S = 10.0  # how long a stopped rank may take to end before it is killed

# (data rank, data size) of this process, set by create_mesh; the loaders
# split rows by it (a model rank reads the same rows as its peers)
_DATA_COORDS: tuple[int, int] | None = None


@dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. ``data=-1`` means every visible device over
    the model axis (``device_count() // model`` data ranks on CUDA, one on
    the CPU)."""

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its data rank, the data axis size, its
    device and the data group (None when the data axis has one rank), and
    the same for the model axis."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    model_rank: int = 0
    model_size: int = 1
    model_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}

    @property
    def parallel(self) -> bool:
        """True when batches are split over more than one rank."""
        return self.group is not None and self.size > 1

    @property
    def tensor_parallel(self) -> bool:
        """True when parameters are sharded over more than one model rank."""
        return self.model_group is not None and self.model_size > 1

    @property
    def global_rank(self) -> int:
        return self.rank * self.model_size + self.model_rank

    @property
    def world_size(self) -> int:
        return self.size * self.model_size


def process_rank() -> tuple[int, int]:
    """``(rank, world size)`` of an initialised ``torch.distributed`` group,
    else ``(0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_rank() -> tuple[int, int]:
    """``(data rank, data size)`` of this process: the loaders' split. Under
    a 2-D mesh the model ranks of one data index share their rows; before
    :func:`create_mesh` has run, the group's rank and size."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return _DATA_COORDS if _DATA_COORDS is not None else process_rank()


def is_host0() -> bool:
    """True on rank 0, or without a group (reference: ``rank_zero_only``)."""
    return process_rank()[0] == 0


def host0_only(fn: Callable) -> Callable:
    """Decorator: run ``fn`` only on rank 0 (reference ``rank_zero_only``,
    datasets/csv_dataset.py:19-22); other ranks get None."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_host0():
            return fn(*args, **kwargs)
        return None

    return wrapper


def world_size(config: MeshConfig, device: torch.device) -> int:
    """The number of ranks ``config`` asks for on ``device``'s type:
    ``data x model``, ``data=-1`` being every visible CUDA device over the
    model axis (one data rank on the CPU)."""
    if config.model < 1:
        msg = f"mesh model must be a positive count, got {config.model}"
        raise ValueError(msg)
    if config.data > 0:
        return config.data * config.model
    if config.data != -1:
        msg = f"mesh data must be -1 or a positive count, got {config.data}"
        raise ValueError(msg)
    if device.type != "cuda":
        return config.model
    return max(1, torch.cuda.device_count() // config.model) * config.model


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def initialize_distributed(
    device: str | torch.device = "cuda",
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout_s: float = GROUP_TIMEOUT_S,
) -> bool:
    """Join a process group from the arguments or from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); True when a group is up. Without either (a plain
    single-process run) nothing happens. The backend is NCCL for a CUDA
    ``device`` and gloo for the CPU unless ``backend`` names one."""
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return False
    world_size = int(world_size if world_size is not None else os.environ["WORLD_SIZE"])
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _axis_groups(data: int, model: int) -> tuple[list, list]:
    """Every data group (one a model index) and every model group (one a
    data index). Each rank must create every group, in the same order,
    the groups it is not in too (``dist.new_group`` is collective)."""
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    return data_groups, model_groups


def create_mesh(config: MeshConfig | None = None, device: str | torch.device = "cuda") -> Mesh:
    """This rank's :class:`Mesh`. Under a process group the world is the
    ``data x model`` mesh (``config.data`` must be -1 or the group's size
    over ``config.model``; ``data=1, model=1`` runs this rank alone); a
    CUDA device without an index becomes the rank's local device. Without
    a group the mesh has one rank and no group."""
    global _DATA_COORDS
    config = config or MeshConfig()
    device = torch.device(device)
    if not dist.is_initialized() or (config.data, config.model) == (1, 1):
        if config.data not in (-1, 1) or config.model != 1:
            msg = (f"mesh {config.data} x {config.model} needs {max(config.data, 1) * config.model}"
                   " ranks: start them with core.mesh.launch, torchrun, or the CLI")
            raise ValueError(msg)
        _DATA_COORDS = (0, 1)
        return Mesh(device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    model = config.model
    if model < 1 or world % model or config.data not in (-1, world // model):
        msg = (f"mesh {config.data} x {model} does not match the group's {world} ranks")
        raise ValueError(msg)
    data = world // model
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    _DATA_COORDS = (rank // model, data)
    if model == 1:
        return Mesh(rank, world, device, dist.group.WORLD)
    data_groups, model_groups = _axis_groups(data, model)
    d, m = divmod(rank, model)
    return Mesh(d, data, device, data_groups[m] if data > 1 else None,
                m, model, model_groups[d])


def rank_rows(n: int, rank: int, size: int) -> tuple[int, int]:
    """Rows ``[start, stop)`` of a global batch of ``n`` rows that ``rank``
    of ``size`` holds: a contiguous block when ``size`` divides ``n``, the
    whole batch (replicated) otherwise."""
    if size == 1 or n % size:
        return 0, n
    per = n // size
    return rank * per, (rank + 1) * per


def rank_batch_keys(n: int, valid: int, rank: int, size: int) -> tuple[tuple[int, int], dict]:
    """The rows of a planned global batch of ``n`` rows (the first ``valid``
    real) that ``rank`` reads, and the keys its batch carries."""
    start, stop = rank_rows(n, rank, size)
    keys = {"valid_count": min(max(valid - start, 0), stop - start)}
    if size > 1:
        keys.update(row_offset=start, global_rows=n)
    return (start, stop), keys


def _rows_of(batch: dict) -> int:
    lead = batch["mask"] if "mask" in batch else batch["image"]
    return int(lead.shape[0])


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a host batch that holds the global rows (a batch
    that already carries ``global_rows`` is a rank's batch and passes
    through). Arrays, tensors and lists of the batch's length are cut;
    ``valid_count`` becomes the count of real rows among this rank's."""
    if mesh.size == 1 or "global_rows" in batch:
        return batch
    n = _rows_of(batch)
    (start, stop), keys = rank_batch_keys(n, int(batch.get("valid_count", n)), mesh.rank,
                                          mesh.size)
    out = {}
    for key, value in batch.items():
        if isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim and value.shape[0] == n:
            value = value[start:stop]
        elif isinstance(value, (list, tuple)) and len(value) == n:
            value = value[start:stop]
        out[key] = value
    out.update(keys)
    return out


def local_batch_to_global(batch: dict, mesh: Mesh) -> dict:
    """Mark a batch that holds this rank's own rows (a rank's shard stream)
    as its block of the global batch: rank r's ``b`` rows are rows
    ``[r * b, (r + 1) * b)`` of a global batch of ``W * b``."""
    if mesh.size == 1:
        return batch
    b = _rows_of(batch)
    return {**batch, "row_offset": mesh.rank * b, "global_rows": mesh.size * b}


def is_sharded(batch: dict, mesh: Mesh | None) -> bool:
    """True when ``batch`` is this rank's block of a global batch split over
    the mesh (False for a replicated batch, or without a group)."""
    return (mesh is not None and mesh.parallel
            and int(batch.get("global_rows", 0)) > _rows_of(batch))


# --- the launcher -------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, size: int, port: int, backend: str, timeout_s: float,
                fn: Callable, args: tuple, results) -> None:
    """One spawned rank: join the group, run ``fn``, report to the parent."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
    if backend == "gloo":  # ranks that share the CPU share its cores
        threads = int(os.environ.get("OMP_NUM_THREADS") or 0)
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // size))
    try:
        device = "cuda" if backend == "nccl" else "cpu"
        initialize_distributed(device, backend=backend, timeout_s=timeout_s)
        result = fn(*args)
        dist.destroy_process_group()
        results.put((rank, True, result if rank == 0 else None))
    except BaseException:  # reported to the parent, which stops the others
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)  # a failed group's shutdown may wait on the other ranks


def launch(fn: Callable, args: tuple = (), size: int = 2, backend: str = "gloo",
           timeout_s: float = GROUP_TIMEOUT_S, deadline_s: float | None = None) -> Any:
    """Run ``fn(*args)`` on ``size`` spawned processes, one a rank of a
    ``backend`` group on ``localhost``, and return rank 0's result.

    ``fn`` must be importable (a module-level function) and ``args``
    picklable. A gloo rank computes on ``OMP_NUM_THREADS`` threads where
    that is set, else on its share of the cores. When a rank raises or
    dies, or ``deadline_s`` passes, the
    other ranks are stopped (terminated, then killed after
    :data:`STOP_S`) and the launcher raises with the failed rank's
    traceback; no rank outlives the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, name=f"gdl-rank-{r}",
                         args=(r, size, port, backend, timeout_s, fn, args, results))
             for r in range(size)]
    for p in procs:
        p.start()
    done: dict[int, Any] = {}
    failure: str | None = None
    start = time.monotonic()
    try:
        while len(done) < size and failure is None:
            try:
                rank, ok, value = results.get(timeout=POLL_S)
            except queue_lib.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    failure = f"{dead[0].name} ended with exit code {dead[0].exitcode}"
                elif deadline_s is not None and time.monotonic() - start > deadline_s:
                    failure = f"the ranks did not finish within {deadline_s:.0f} s"
                continue
            if ok:
                done[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
        for p in procs:
            p.join(STOP_S if failure is None else 0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(STOP_S)
            if p.is_alive():
                p.kill()
                p.join(STOP_S)
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return done[0]
