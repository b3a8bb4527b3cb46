"""The data-parallel scene tests' model, scene and rank worker, without JAX."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from geo_deep_learning_tpu_torch.core.mesh import create_mesh
from geo_deep_learning_tpu_torch.inference import sliding_window as tsw
from geo_deep_learning_tpu_torch.inference import streaming as tstream

H, W, C, K = 200, 130, 3, 3
TILE, OVERLAP, TILE_BATCH = 64, 16, 3


def weights() -> tuple[np.ndarray, np.ndarray]:
    """Per-band coefficients ``[3, K]`` and a ``[TILE, TILE, K]`` pattern."""
    rng = np.random.default_rng(21)
    return (rng.standard_normal((C, K)).astype(np.float32),
            (0.5 * rng.standard_normal((TILE, TILE, K))).astype(np.float32))


def forward(tiles: torch.Tensor) -> torch.Tensor:
    """Elementwise logits ``[B, t, t, K]`` of normalized tiles."""
    coef, pattern = (torch.from_numpy(a) for a in weights())
    z = tiles[..., 0:1] * coef[0] + tiles[..., 1:2] * coef[1] + tiles[..., 2:3] * coef[2]
    return torch.sin(z) + pattern


def scene() -> np.ndarray:
    return np.random.default_rng(22).standard_normal((H, W, C)).astype(np.float32)


def config(blend: str) -> tsw.SlidingWindowConfig:
    return tsw.SlidingWindowConfig(TILE, OVERLAP, TILE_BATCH, blend)


class Reader:
    """``read_rows`` over the in-memory scene (the streamer's reader)."""

    height, width = H, W

    def read_rows(self, row0: int, nrows: int) -> np.ndarray:
        return scene()[row0:row0 + nrows]


def run(out: str) -> None:
    """The three scene paths on this rank (the ``launch`` target)."""
    torch.set_num_threads(1)
    mesh = create_mesh(device="cpu")
    x = torch.from_numpy(scene())
    rows: dict[int, np.ndarray] = {}
    tstream.streamed_scene_logits_writer(
        forward, Reader(), lambda r0, logits: rows.__setitem__(r0, logits.numpy()), K,
        config("hann"), band_tile_rows=2, mesh=mesh)
    np.savez(Path(out) / f"scene_rank{mesh.rank}.npz",
             sharded=tsw.sliding_window_logits_sharded(forward, x, K, mesh, config("hann")),
             halo=tsw.sliding_window_logits_halo(forward, x, K, mesh, config("crop")),
             streamed=np.concatenate([rows[k] for k in sorted(rows)]),
             streamed_starts=np.asarray(sorted(rows)))
