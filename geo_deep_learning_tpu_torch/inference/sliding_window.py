"""Sliding-window whole-scene inference with overlap blending.

Port of ``geo_deep_learning_tpu/inference/sliding_window.py`` (one device;
the sharded and halo variants need a data-parallel mesh and are not
ported). A scene is tiled with a fixed stride (the last tile of a row or
column is clamped to the edge), batches of tiles go through the model, and
the tiles' logits, weighted by a blend window, are added into an f32 canvas
beside the sum of the weights; the blended logits are their ratio.

The scene lives on the model's device once; tiles are gathered by slicing
it, and the loop over tile batches is a Python loop. Eager PyTorch has no
static shapes, so the last batch is simply shorter: the JAX package's
padding of the tile list to whole batches, and its validity mask, have no
counterpart. Blend windows: a floored Hann taper (default), uniform, or
receptive-field-aware core cropping (``crop``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from geo_deep_learning_tpu_torch.data.geotiff import GeoInfo, read_geotiff
from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffStripWriter

# ``forward`` maps normalized NHWC f32 tiles [B, t, t, C] to f32 logits
# [B, t, t, K] on the same device
Forward = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class SlidingWindowConfig:
    tile_size: int = 512
    overlap: int = 128
    batch_size: int = 8
    blend: str = "hann"  # "hann" | "uniform" | "crop"


def _tile_origins(size: int, tile: int, stride: int) -> np.ndarray:
    """1-D tile start offsets; the last tile is clamped to the edge."""
    if size <= tile:
        return np.array([0])
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return np.array(starts)


def _blend_window(tile: int, kind: str, overlap: int = 0) -> np.ndarray:
    """``[tile, tile]`` f32 weights of one tile's logits."""
    if kind == "uniform":
        return np.ones((tile, tile), dtype=np.float32)
    if kind == "crop":
        # the core [m, tile - m) at 1 and the margin, whose context the tile
        # edge cut off, at a 1e-3 floor: with m = overlap // 2 the cores tile
        # the scene's interior, while border pixels, which no core covers,
        # still get the margins' predictions
        m = overlap // 2
        w = np.full(tile, 1e-3, dtype=np.float32)
        w[m : tile - m] = 1.0
        return np.outer(w, w).astype(np.float32)
    # Hann taper, floored so that edge tiles still count at the scene's border
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
    return np.maximum(np.outer(w, w).astype(np.float32), 1e-3)


def _reflect_pad(scene: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """``np.pad(..., mode="reflect")`` of an HWC tensor at the bottom and
    right, any pad width."""
    h, w = scene.shape[:2]
    rows = torch.from_numpy(np.pad(np.arange(h), (0, pad_h), mode="reflect")).to(scene.device)
    cols = torch.from_numpy(np.pad(np.arange(w), (0, pad_w), mode="reflect")).to(scene.device)
    return scene.index_select(0, rows).index_select(1, cols)


def _plan_tiles(scene: torch.Tensor, cfg: SlidingWindowConfig):
    """Reflect-pad the scene to at least one tile; the tile origins
    ``[N, 2]`` (row, col) in row order and the blend window on the scene's
    device. Returns ``(scene, coords, window, h, w)``."""
    tile = cfg.tile_size
    h, w = scene.shape[0], scene.shape[1]
    pad_h, pad_w = max(tile - h, 0), max(tile - w, 0)
    if pad_h or pad_w:
        scene = _reflect_pad(scene, pad_h, pad_w)
    stride = tile - cfg.overlap
    rows = _tile_origins(scene.shape[0], tile, stride)
    cols = _tile_origins(scene.shape[1], tile, stride)
    coords = np.array([(r, c) for r in rows for c in cols], dtype=np.int64)
    window = torch.from_numpy(_blend_window(tile, cfg.blend, cfg.overlap)).to(scene.device)
    return scene, coords, window, h, w


def _accumulate_tiles(
    forward: Forward,
    scene: torch.Tensor,
    coords: np.ndarray,
    window: torch.Tensor,
    tile: int,
    batch_size: int,
    num_classes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted logits ``acc [H, W, K]`` and weights ``wsum [H, W, 1]``
    (f32, on the scene's device) over the tiles at ``coords``."""
    h, w = scene.shape[0], scene.shape[1]
    acc = torch.zeros((h, w, num_classes), dtype=torch.float32, device=scene.device)
    wsum = torch.zeros((h, w, 1), dtype=torch.float32, device=scene.device)
    wtile = window[..., None]
    for i in range(0, len(coords), batch_size):
        rcs = coords[i : i + batch_size].tolist()
        tiles = torch.stack([scene[r : r + tile, c : c + tile] for r, c in rcs])
        logits = forward(tiles).float()
        for (r, c), lg in zip(rcs, logits):
            acc[r : r + tile, c : c + tile] += lg * wtile
            wsum[r : r + tile, c : c + tile] += wtile
    return acc, wsum


def sliding_window_logits(
    forward: Forward,
    scene: torch.Tensor,
    num_classes: int,
    config: SlidingWindowConfig | None = None,
) -> torch.Tensor:
    """Blended logits ``[H, W, K]`` (f32) of an HWC scene (normalized, on
    the model's device)."""
    cfg = config or SlidingWindowConfig()
    scene, coords, window, h, w = _plan_tiles(scene, cfg)
    acc, wsum = _accumulate_tiles(forward, scene, coords, window, cfg.tile_size,
                                  cfg.batch_size, num_classes)
    return (acc / torch.clamp(wsum, min=1e-8))[:h, :w]


def normalize(image: torch.Tensor, mean: Sequence[float] | None, std: Sequence[float] | None):
    """uint8 pixels -> ``/255``, then ``(x - mean) / std`` when given, in f32
    on the image's device (the JAX package's ``predict_scene``, :632-634)."""
    x = image.to(torch.float32) / 255.0
    if mean is not None:
        x = (x - torch.as_tensor(mean, dtype=torch.float32, device=x.device)) / torch.as_tensor(
            std, dtype=torch.float32, device=x.device)
    return x


def logits_to_classes(logits: torch.Tensor, num_classes: int, threshold: float) -> torch.Tensor:
    """``[..., K]`` logits -> uint8 class map: sigmoid > threshold for one
    class, argmax otherwise."""
    if num_classes == 1:
        return (torch.sigmoid(logits[..., 0]) > threshold).to(torch.uint8)
    return torch.argmax(logits, dim=-1).to(torch.uint8)


def predict_scene(
    forward: Forward,
    scene_path: str,
    output_path: str,
    num_classes: int,
    config: SlidingWindowConfig | None = None,
    mean: Sequence[float] | None = None,
    std: Sequence[float] | None = None,
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
) -> str:
    """Read a georeferenced scene whole, run tiled inference on ``device``
    and write the uint8 class map with the scene's transform and EPSG code."""
    scene, geo = read_geotiff(scene_path)
    x = normalize(torch.from_numpy(scene).to(device), mean, std)
    preds = logits_to_classes(sliding_window_logits(forward, x, num_classes, config),
                              num_classes, threshold)
    with GeoTiffStripWriter(output_path, scene.shape[1], 1, np.uint8,
                            geo=GeoInfo(transform=geo.transform, epsg=geo.epsg)) as writer:
        writer.write_rows(preds.cpu().numpy())
    return output_path
