"""Sliding-window whole-scene inference with overlap blending.

Port of ``geo_deep_learning_tpu/inference/sliding_window.py``. A scene is tiled with a fixed stride (the last tile of a row or
column is clamped to the edge), batches of tiles go through the model, and
the tiles' logits, weighted by a blend window, are added into an f32 canvas
beside the sum of the weights; the blended logits are their ratio.

The scene lives on the model's device once; tiles are gathered by slicing
it, and the loop over tile batches is a Python loop. Eager PyTorch has no
static shapes, so the last batch is simply shorter: the JAX package's
padding of the tile list to whole batches, and its validity mask, have no
counterpart. Blend windows: a floored Hann taper (default), uniform, or
receptive-field-aware core cropping (``crop``).

Over a data-parallel mesh (``core.mesh.Mesh``, one process a rank):
:func:`sliding_window_logits_sharded` stripes the tiles over the ranks
(the scene replicated on each) and sums the local canvases with one
``all_reduce``; :func:`sliding_window_logits_halo` (``blend='crop'``) gives
each rank contiguous tile-row bands and exchanges only the boundary strips
of accumulated logits and weights, through one ``all_reduce`` of a
``[2, W - 1, strip, W, K + 1]`` buffer (gloo has no send/recv of CUDA
tensors). Both return the blended logits on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from geo_deep_learning_tpu_torch.core.mesh import Mesh
from geo_deep_learning_tpu_torch.data.geotiff import GeoInfo, read_geotiff
from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffStripWriter
from geo_deep_learning_tpu_torch.parallel.collectives import all_reduce_sum_

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


def _blend(aw: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Blended logits of a ``[..., K + 1]`` (weighted logits, weight) canvas."""
    return aw[..., :num_classes] / torch.clamp(aw[..., num_classes:], min=1e-8)


def sliding_window_logits_sharded(
    forward: Forward,
    scene: torch.Tensor,
    num_classes: int,
    mesh: Mesh,
    config: SlidingWindowConfig | None = None,
) -> torch.Tensor:
    """Data-parallel scene inference (JAX ``sliding_window.py:225``): rank
    r of W takes every W-th tile from the r-th, accumulates a canvas of the
    whole (replicated) scene, and one ``all_reduce`` sums the canvases
    before blending. Blended logits ``[H, W, K]`` on every rank."""
    cfg = config or SlidingWindowConfig()
    scene, coords, window, h, w = _plan_tiles(scene, cfg)
    acc, wsum = _accumulate_tiles(forward, scene, coords[mesh.rank::mesh.size], window,
                                  cfg.tile_size, cfg.batch_size, num_classes)
    aw = all_reduce_sum_(torch.cat([acc, wsum], dim=-1), mesh)
    return _blend(aw, num_classes)[:h, :w]


def plan_bands(hp: int, wp: int, cfg: SlidingWindowConfig, n_data: int) -> dict | None:
    """The halo path's plan for a padded ``hp x wp`` scene over ``n_data``
    ranks (JAX ``_plan_bands``): the crop-blend tile grid's rows in
    contiguous blocks, one a rank, balanced by row count, with the rows
    whose tiles overlap three deep kept in one block; each block's band
    ``[lo, lo + band_h)`` of the scene, the ownership boundaries
    ``bounds`` (rank d owns rows ``[bounds[d], bounds[d + 1])``) and the
    strip height. None where a block's tiles would reach past its
    neighbours' rows (the caller then takes the sharded path)."""
    tile = cfg.tile_size
    stride = tile - cfg.overlap
    m = cfg.overlap // 2
    rows = _tile_origins(hp, tile, stride)
    cols = _tile_origins(wp, tile, stride)
    nrows = len(rows)
    join = [False] * max(nrows - 1, 0)
    for i in range(nrows - 2):
        if rows[i + 2] - rows[i] < tile:
            join[i] = join[i + 1] = True
    units: list[int] = []
    run = 1
    for i in range(nrows - 1):
        if join[i]:
            run += 1
        else:
            units.append(run)
            run = 1
    if nrows:
        units.append(run)
    counts = [0] * n_data
    d, acc_rows, remaining = 0, 0, nrows
    for u in units:
        fair = -(-remaining // (n_data - d))
        if counts[d] and acc_rows + u > fair and d < n_data - 1:
            remaining -= acc_rows
            d, acc_rows = d + 1, 0
        counts[d] += u
        acc_rows += u
    starts = [int(x) for x in np.cumsum([0] + counts[:-1])]
    bounds = [0] + [int(rows[starts[d]]) + m if counts[d] else hp for d in range(1, n_data)]
    bounds.append(hp)
    lo = [int(rows[starts[d]]) if counts[d] else 0 for d in range(n_data)]
    hi = [int(rows[starts[d] + counts[d] - 1]) + tile if counts[d] else tile
          for d in range(n_data)]
    for d in range(n_data):
        if counts[d] and ((d + 2 < len(bounds) and hi[d] > bounds[d + 2])
                          or (d >= 1 and lo[d] < bounds[d - 1])):
            return None
    band_h = max(b - a for a, b in zip(lo, hi))
    lo = [min(a, hp - band_h) for a in lo]
    s_up = max((bounds[d] - lo[d]) if counts[d] else 0 for d in range(n_data))
    s_dn = max((hi[d] - bounds[d + 1]) if counts[d] else 0 for d in range(n_data))
    own_h = [bounds[d + 1] - bounds[d] for d in range(n_data)]
    return {
        "rows": rows, "cols": cols, "starts": starts, "counts": counts, "bounds": bounds,
        "lo": lo, "band_h": int(band_h), "strip": max(int(s_up), int(s_dn), 1),
        "own_h": own_h, "own_start": [bounds[d] - lo[d] if own_h[d] > 0 else 0
                                      for d in range(n_data)],
    }


def sliding_window_logits_halo(
    forward: Forward,
    scene: torch.Tensor,
    num_classes: int,
    mesh: Mesh,
    config: SlidingWindowConfig | None = None,
) -> torch.Tensor:
    """Banded scene inference with a halo exchange (JAX
    ``sliding_window.py:445``, ``blend='crop'``).

    Rank d accumulates the tiles of its block of tile rows over its band of
    the scene; rows of its canvas that belong to a neighbour (the strips
    next to an ownership boundary) go to that neighbour, which adds them to
    its own. Exactness, JAX's contract: every pixel sums the same f32
    terms as the one-rank ``blend='crop'`` path; pixels outside the
    exchanged strips are bit-identical to it (their additions are all
    local, in the same order), strip pixels add two partial sums
    (equal to f32 reassociation). Blended logits ``[H, W, K]`` on every
    rank: each rank's owned rows are broadcast from it."""
    cfg = config or SlidingWindowConfig()
    if cfg.blend != "crop":
        msg = "the halo-exchange path requires blend='crop'"
        raise ValueError(msg)
    tile, k = cfg.tile_size, num_classes
    h, w = scene.shape[0], scene.shape[1]
    pad_h, pad_w = max(tile - h, 0), max(tile - w, 0)
    if pad_h or pad_w:
        scene = _reflect_pad(scene, pad_h, pad_w)
    hp, wp = scene.shape[0], scene.shape[1]
    n, d = mesh.size, mesh.rank
    plan = plan_bands(hp, wp, cfg, n)
    if plan is None:
        return sliding_window_logits_sharded(forward, scene[:h, :w], num_classes, mesh, cfg)
    lo, band_h, strip = plan["lo"][d], plan["band_h"], plan["strip"]
    ostart, oh = plan["own_start"][d], plan["own_h"][d]
    own_h_max = max(plan["own_h"])
    rows = plan["rows"][plan["starts"][d]:plan["starts"][d] + plan["counts"][d]]
    coords = np.array([(int(r) - lo, int(c)) for r in rows for c in plan["cols"]],
                      dtype=np.int64).reshape(-1, 2)
    window = torch.from_numpy(_blend_window(tile, "crop", cfg.overlap)).to(scene.device)
    acc, wsum = _accumulate_tiles(forward, scene[lo:lo + band_h], coords, window, tile,
                                  cfg.batch_size, k)
    # padded-local row p is band-local row p - strip, so every strip slice
    # below is in bounds (as the JAX body pads its canvas)
    awp = torch.nn.functional.pad(torch.cat([acc, wsum], dim=-1),
                                  (0, 0, 0, 0, strip, strip + own_h_max))
    if n > 1:
        sent = torch.zeros((2, n - 1, strip, wp, k + 1), dtype=awp.dtype, device=awp.device)
        if d >= 1:  # rows above my own: my upper neighbour's
            sent[0, d - 1] = awp[ostart:ostart + strip]
        if d < n - 1:  # rows below my own: my lower neighbour's
            sent[1, d] = awp[ostart + oh + strip:ostart + oh + 2 * strip]
        dist.all_reduce(sent, group=mesh.group)
        if d >= 1:  # from above, onto my first strip rows
            awp[ostart + strip:ostart + 2 * strip] += sent[1, d - 1]
        if d < n - 1:  # from below, onto my last strip rows
            awp[ostart + oh:ostart + oh + strip] += sent[0, d]
    out = torch.empty((hp, wp, k), dtype=awp.dtype, device=awp.device)
    bounds = plan["bounds"]
    out[bounds[d]:bounds[d + 1]] = _blend(awp[ostart + strip:ostart + strip + oh], k)
    if n > 1:
        for src in range(n):
            if bounds[src + 1] > bounds[src]:
                dist.broadcast(out[bounds[src]:bounds[src + 1]], src=src, group=mesh.group)
    return out[:h, :w]


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
