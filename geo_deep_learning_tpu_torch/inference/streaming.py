"""Band-streamed whole-scene inference for scenes too large to decode whole.

Port of ``geo_deep_learning_tpu/inference/streaming.py`` (one device; the
data-parallel band accumulation ``_band_acc_sharded`` waits for the DDP
slice). The scene is read in horizontal bands of ``band_tile_rows`` tile
rows through :class:`GeoTiffWindowReader`, each band's tiles are blended on
the device as in ``sliding_window``, and finished rows go out through a
:class:`GeoTiffStripWriter` as soon as no later tile can touch them. The
weighted-logit and weight canvases of the rows that two bands share are
carried from one band to the next, so every pixel sums the same tile
contributions as the whole-scene path. Host memory holds one band.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from geo_deep_learning_tpu_torch.data.geotiff import GeoInfo
from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffStripWriter, GeoTiffWindowReader
from geo_deep_learning_tpu_torch.inference.sliding_window import (
    Forward,
    SlidingWindowConfig,
    _accumulate_tiles,
    _blend_window,
    _tile_origins,
    logits_to_classes,
    normalize,
)


def streamed_scene_logits_writer(
    forward: Forward,
    reader,
    writer_fn: Callable[[int, torch.Tensor], None],
    num_classes: int,
    config: SlidingWindowConfig | None = None,
    band_tile_rows: int = 4,
    preprocess: Callable[[np.ndarray], torch.Tensor] | None = None,
) -> None:
    """Blend a scene band by band.

    ``reader`` has ``height`` and ``width`` and ``read_rows(row0, nrows) ->
    [nrows, W, C]``; ``preprocess`` maps a band (numpy) to the tensor the
    model takes (by default: f32 on the CPU); ``writer_fn(row0, logits)`` is
    called with the finished blended f32 logit rows ``[n, W, K]``, in order.
    """
    cfg = config or SlidingWindowConfig()
    tile, bs = cfg.tile_size, cfg.batch_size
    stride = tile - cfg.overlap
    h, w = reader.height, reader.width
    pad_w = max(tile - w, 0)
    rows = _tile_origins(h, tile, stride)
    cols = _tile_origins(w + pad_w, tile, stride)
    band_h = tile + (band_tile_rows - 1) * stride
    window = None
    carry_acc = carry_w = None
    done = 0
    for g0 in range(0, len(rows), band_tile_rows):
        group = rows[g0 : g0 + band_tile_rows]
        r0 = int(group[0])
        nrows = min(band_h, h - r0)
        block = reader.read_rows(r0, nrows)
        if pad_w:  # reflect, as the whole-scene path pads a narrow scene
            block = np.pad(block, ((0, 0), (0, pad_w), (0, 0)), mode="reflect")
        if nrows < band_h:
            # a scene shorter than one tile: its single clamped tile covers
            # reflected rows, as in the whole-scene path; rows past the tile
            # are touched by no tile
            reflect_rows = min(max(tile - nrows, 0), band_h - nrows)
            if reflect_rows:
                block = np.pad(block, ((0, reflect_rows), (0, 0), (0, 0)), mode="reflect")
            rest = band_h - nrows - reflect_rows
            if rest:
                block = np.pad(block, ((0, rest), (0, 0), (0, 0)), mode="edge")
        band = preprocess(block) if preprocess is not None else torch.from_numpy(
            block.astype(np.float32))
        if window is None:
            window = torch.from_numpy(_blend_window(tile, cfg.blend, cfg.overlap)).to(band.device)
        coords = np.array([(int(r) - r0, int(c)) for r in group for c in cols], dtype=np.int64)
        acc, wsum = _accumulate_tiles(forward, band, coords, window, tile, bs, num_classes)
        if carry_acc is not None:  # the rows [r0, done + kept) that the last band shared
            k = carry_acc.shape[0]
            acc[:k] += carry_acc
            wsum[:k] += carry_w
        last_band = g0 + band_tile_rows >= len(rows)
        final_upto = h if last_band else int(rows[g0 + band_tile_rows])
        blended = acc[done - r0 : final_upto - r0] / torch.clamp(
            wsum[done - r0 : final_upto - r0], min=1e-8)
        writer_fn(done, blended[:, :w])
        if not last_band:
            keep0 = final_upto - r0
            kept = min(r0 + band_h, h) - final_upto
            carry_acc = acc[keep0 : keep0 + kept].clone()
            carry_w = wsum[keep0 : keep0 + kept].clone()
        done = final_upto
    if done != h:
        msg = f"streamed {done} of {h} rows"
        raise RuntimeError(msg)


def predict_scene_streamed(
    forward: Forward,
    scene_path: str,
    output_path: str,
    num_classes: int,
    config: SlidingWindowConfig | None = None,
    mean: Sequence[float] | None = None,
    std: Sequence[float] | None = None,
    threshold: float = 0.5,
    device: str | torch.device = "cuda",
    band_tile_rows: int = 4,
    compress: str | None = "deflate",
) -> str:
    """The streamed twin of ``sliding_window.predict_scene``: the same class
    map, with reads, inference and writes going band by band."""
    with GeoTiffWindowReader(scene_path) as reader:
        geo = reader.geo
        with GeoTiffStripWriter(output_path, reader.width, 1, np.uint8,
                                geo=GeoInfo(transform=geo.transform, epsg=geo.epsg),
                                compress=compress) as writer:
            streamed_scene_logits_writer(
                forward, reader,
                lambda row0, logits: writer.write_rows(
                    logits_to_classes(logits, num_classes, threshold).cpu().numpy()),
                num_classes, config, band_tile_rows=band_tile_rows,
                preprocess=lambda block: normalize(torch.from_numpy(block).to(device), mean, std),
            )
    return output_path
