"""Raster utilities: grid alignment and dataset statistics (host numpy).

Port of ``geo_deep_learning_tpu/utils/rasters.py`` (reference
``utils/rasters.py:14-145``, rasterio/GDAL-based), on the port's GeoTIFF
codec (``data/geotiff.py``) and its own CRS math (``utils/crs.py``):

- :func:`align_to_reference` resamples a raster onto a reference's
  transform and extent (nearest, bilinear or cubic), honouring nodata and
  reprojecting when the two CRSs differ; the result is an LZW-compressed
  GeoTIFF with the reference's transform and EPSG code and the nodata
  value, written by ``data/geotiff_stream.py``'s ``GeoTiffStripWriter``.
- :func:`compute_dataset_stats_from_list` gives per-band mean/std over a
  list of rasters, excluding nodata pixels.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from geo_deep_learning_tpu_torch.data.geotiff import GeoInfo, read_geotiff
from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffStripWriter
from geo_deep_learning_tpu_torch.utils import crs as crs_lib

logger = logging.getLogger(__name__)

_RESAMPLERS = ("nearest", "bilinear", "cubic")
# a classic TIFF addresses 4 GiB; LZW may grow its input by half
_CLASSIC_TIFF_BYTES = (2**32 - 1) // 2


def _cubic_kernel(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel (GDAL/torch bicubic, a=-0.5)."""
    at = np.abs(t)
    return np.where(
        at <= 1,
        (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0),
    )


def _sample(
    src: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    method: str,
    nodata: float | None,
) -> np.ndarray:
    """Sample src [H, W, C] at fractional (rows, cols) grids [h, w]."""
    h_src, w_src, c = src.shape
    fill = nodata if nodata is not None else 0.0

    def gather(r, col):
        valid = (r >= 0) & (r < h_src) & (col >= 0) & (col < w_src)
        rc = np.clip(r, 0, h_src - 1)
        cc = np.clip(col, 0, w_src - 1)
        vals = src[rc, cc].astype(np.float64)
        vals[~valid] = fill
        return vals, valid

    if method == "nearest":
        out, _ = gather(np.round(rows).astype(np.int64), np.round(cols).astype(np.int64))
        return out
    r0 = np.floor(rows).astype(np.int64)
    c0 = np.floor(cols).astype(np.int64)
    fr, fc = rows - r0, cols - c0
    if method == "bilinear":
        offsets = (0, 1)
        wr = [1 - fr, fr]
        wc = [1 - fc, fc]
    else:  # cubic
        offsets = (-1, 0, 1, 2)
        wr = [_cubic_kernel(fr - o) for o in offsets]
        wc = [_cubic_kernel(fc - o) for o in offsets]
    out = np.zeros((*rows.shape, c), dtype=np.float64)
    weight_sum = np.zeros(rows.shape, dtype=np.float64)
    for i, oi in enumerate(offsets):
        for j, oj in enumerate(offsets):
            vals, valid = gather(r0 + oi, c0 + oj)
            w = wr[i] * wc[j]
            if nodata is not None:
                w = w * (valid & ~np.isclose(vals[..., 0], nodata))
            out += vals * w[..., None]
            weight_sum += w
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(weight_sum[..., None] > 1e-9, out / weight_sum[..., None], fill)


def align_to_reference(
    input_path: str | Path,
    reference_path: str | Path,
    output_path: str | Path,
    resampling: str = "bilinear",
    nodata: float | None = None,
) -> Path:
    """Resample ``input`` onto ``reference``'s grid (transform + extent)."""
    if resampling not in _RESAMPLERS:
        msg = f"Invalid resampling method: {resampling}. Use one of {_RESAMPLERS}"
        raise ValueError(msg)
    src, src_geo = read_geotiff(input_path)
    ref, ref_geo = read_geotiff(reference_path)
    reproject = (
        src_geo.epsg is not None
        and ref_geo.epsg is not None
        and src_geo.epsg != ref_geo.epsg
    )
    if reproject and not crs_lib.can_transform(src_geo.epsg, ref_geo.epsg):
        msg = (
            f"CRS reprojection (EPSG:{src_geo.epsg} -> EPSG:{ref_geo.epsg}): "
            "the pair is outside the natively supported families "
            f"({crs_lib.SUPPORTED_FAMILIES}) and pyproj is not installed "
            "or does not recognize the pair. Install pyproj for "
            "arbitrary-CRS support, check the EPSG codes, or "
            "pre-reproject with GDAL (gdalwarp -t_srs) first."
        )
        raise NotImplementedError(msg)
    nodata = nodata if nodata is not None else src_geo.nodata

    h_ref, w_ref = ref.shape[:2]
    inv = src_geo.transform.invert()
    cols_ref, rows_ref = np.meshgrid(
        np.arange(w_ref, dtype=np.float64) + 0.5,
        np.arange(h_ref, dtype=np.float64) + 0.5,
    )
    # ref pixel centre -> ref world -> (src world through the CRS transform
    # when they differ) -> src pixel (centre-based, so -0.5 back)
    t = ref_geo.transform
    xs = t.a * cols_ref + t.b * rows_ref + t.c
    ys = t.d * cols_ref + t.e * rows_ref + t.f
    if reproject:
        xs, ys = crs_lib.transform_points(ref_geo.epsg, src_geo.epsg, xs, ys)
    src_cols = inv.a * xs + inv.b * ys + inv.c - 0.5
    src_rows = inv.d * xs + inv.e * ys + inv.f - 0.5

    out = _sample(src, src_rows, src_cols, resampling, nodata).astype(src.dtype)
    out_geo = GeoInfo(transform=ref_geo.transform, epsg=ref_geo.epsg, nodata=nodata)
    # LZW, BigTIFF only where a classic TIFF cannot hold the payload (the
    # reference writes LZW + BIGTIFF=YES, utils/rasters.py:63-66)
    with GeoTiffStripWriter(output_path, w_ref, out.shape[-1], out.dtype, out_geo, compress="lzw",
                            bigtiff=out.nbytes > _CLASSIC_TIFF_BYTES) as writer:
        writer.write_rows(out)
    return Path(output_path)


def compute_dataset_stats_from_list(
    raster_paths: list[str | Path],
    nodata: float | None = None,
) -> dict[str, list[float]]:
    """Per-band mean/std over rasters, excluding nodata pixels (reference
    ``utils/rasters.py:82-145``: sum / sum of squares / count per band)."""
    if not raster_paths:
        msg = "raster_paths list is empty"
        raise ValueError(msg)
    s = ss = count = None
    for p in raster_paths:
        img, geo = read_geotiff(p)
        arr = img.astype(np.float64)
        nd = nodata if nodata is not None else geo.nodata
        if s is None:
            c = arr.shape[-1]
            s, ss, count = np.zeros(c), np.zeros(c), np.zeros(c)
        mask = ~np.isclose(arr, nd) if nd is not None else np.ones_like(arr, dtype=bool)
        s += np.where(mask, arr, 0).sum(axis=(0, 1))
        ss += np.where(mask, arr**2, 0).sum(axis=(0, 1))
        count += mask.sum(axis=(0, 1))
    count = np.maximum(count, 1)
    mean = s / count
    var = np.maximum(ss / count - mean**2, 0)
    return {"mean": mean.tolist(), "std": np.sqrt(var).tolist()}
