"""Convert a CSV/GeoTIFF patch dataset into the sharded-tar streaming layout.

The port's counterpart of ``scripts/make_shards_from_csv.py``, on the
port's own GeoTIFF reader. It reads a CSV-dataset root (``{split}.csv``
files of ``image;mask`` paths under a patches root) and writes the layout
that ``data/multisensor.py`` streams::

    <out>/<sensor>/{trn,val,tst}/shard-NNNN.tar    (.image_patch.npy [C,H,W],
                                                    .label_patch.npy [H,W],
                                                    .metadata.json)
    <out>/<sensor>/manifest.json                   (shards + patch counts)
    <out>/<sensor>/stats.json                      (per-band mean/std, 0-255)
    <registry>                                     (the sensor registry)

Band statistics are taken over the training images; the metadata carries
per-band wavelengths (DOFA format) and datetime / lat-lon (CLAY format).
Beyond the JAX script it takes ``band_indices`` (a band may repeat, as a
synthetic band would) and writes the registry as JSON whatever its name,
merged with an existing registry of the same path, so a machine without
PyYAML reads it.

Usage::

    python -m geo_deep_learning_tpu_torch.tools.make_shards <csv_root> <out_root> \
        [--sensor geoeye] [--per-shard 64] [--wavelengths 0.665 0.549 0.481] \
        [--band-indices 0 1 2] [--patches-root <dir>] [--registry <out_root>/sensors.yaml]
"""

from __future__ import annotations

import argparse
import io
import json
import tarfile
from pathlib import Path
from typing import Sequence

import numpy as np

from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff
from geo_deep_learning_tpu_torch.data.shard_dataset import load_sensor_configs

WAVELENGTH_NAMES = ("red", "green", "blue", "nir", "swir1", "swir2")
SPLITS = ("trn", "val", "tst")


def _read_pairs(csv_root: Path, patches_root: Path, split: str) -> list[tuple[Path, Path]]:
    csv = csv_root / f"{split}.csv"
    if not csv.exists():
        return []
    pairs = []
    for line in csv.read_text().strip().splitlines():
        img, lbl = line.split(";")[:2]
        pairs.append((patches_root / img.strip(), patches_root / lbl.strip()))
    return pairs


def _add(tar: tarfile.TarFile, name: str, payload) -> None:
    if isinstance(payload, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, payload)
        raw = buf.getvalue()
    else:
        raw = json.dumps(payload).encode()
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    tar.addfile(info, io.BytesIO(raw))


def make_shards(
    csv_root: str | Path,
    out_root: str | Path,
    sensor: str = "geoeye",
    per_shard: int = 64,
    wavelengths: Sequence[float] = (0.665, 0.549, 0.481),
    band_indices: Sequence[int] | None = None,
    patches_root: str | Path | None = None,
    registry: str | Path | None = None,
    datetime: str = "2023-06-15T14:30:00Z",
    lat: float = 43.47,  # Waterloo, ON
    lon: float = -80.54,
) -> Path:
    """Write one sensor's shards, manifest and statistics and add it to the
    registry; returns the registry's path."""
    csv_root = Path(csv_root)
    patches = Path(patches_root) if patches_root is not None else csv_root
    sdir = Path(out_root) / sensor
    bands = list(band_indices) if band_indices is not None else None
    if bands is not None and len(wavelengths) != len(bands):
        msg = f"{len(bands)} band indices but {len(wavelengths)} wavelengths"
        raise ValueError(msg)
    keys = [f"{WAVELENGTH_NAMES[i]}_wavelength" for i in range(len(wavelengths))]
    meta = {"metadata": {"datetime": datetime, "coordinates_lat": lat, "coordinates_lon": lon,
                         **dict(zip(keys, map(float, wavelengths)))}}
    manifest: dict = {"shards": {}, "statistics": {"patch_counts": {}}}
    total = total_sq = None
    count_px = 0
    for split in SPLITS:
        pairs = _read_pairs(csv_root, patches, split)
        if not pairs:
            continue
        (sdir / split).mkdir(parents=True, exist_ok=True)
        entries = []
        for s in range(0, len(pairs), per_shard):
            name = f"shard-{s // per_shard:04d}.tar"
            with tarfile.open(sdir / split / name, "w") as tar:
                for img_path, lbl_path in pairs[s : s + per_shard]:
                    img, _ = read_geotiff(img_path)  # [H, W, C]
                    if bands is not None:
                        img = img[..., bands]
                    chw = np.ascontiguousarray(np.moveaxis(img, -1, 0))
                    lbl, _ = read_geotiff(lbl_path)
                    if split == "trn":
                        f = chw.reshape(chw.shape[0], -1).astype(np.float64)
                        total = f.sum(1) if total is None else total + f.sum(1)
                        total_sq = (f**2).sum(1) if total_sq is None else total_sq + (f**2).sum(1)
                        count_px += f.shape[1]
                    key = img_path.stem
                    _add(tar, f"{key}.image_patch.npy", chw)
                    _add(tar, f"{key}.label_patch.npy", np.ascontiguousarray(lbl.squeeze()))
                    _add(tar, f"{key}.metadata.json", meta)
            entries.append({"path": name})
        manifest["shards"][split] = entries
        manifest["statistics"]["patch_counts"][split] = len(pairs)
    if total is None:
        msg = f"no trn patches under {csv_root}: the statistics need them"
        raise ValueError(msg)
    mean = total / count_px
    std = np.sqrt(total_sq / count_px - mean**2)
    (sdir / "manifest.json").write_text(json.dumps(manifest, indent=1))
    stats = {"mean": mean.tolist(), "std": std.tolist(), "band_count": int(len(mean)),
             "patch_count": manifest["statistics"]["patch_counts"].get("trn", 0),
             "dtype": "uint8"}
    (sdir / "stats.json").write_text(json.dumps({"statistics": {sensor: stats}}, indent=1))
    path = Path(registry) if registry is not None else Path(out_root) / "sensors.yaml"
    sensors = (load_sensor_configs(str(path)) or {}) if path.exists() else {}
    sensors[sensor] = {
        "manifest_path": str(sdir / "manifest.json"),
        "parent_dir": str(sdir),
        "stats_path": str(sdir / "stats.json"),
        "wavelength_keys": keys,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(sensors, indent=1))
    return path


def main(argv: list[str] | None = None) -> Path:
    p = argparse.ArgumentParser(prog="make_shards")
    p.add_argument("csv_root")
    p.add_argument("out_root")
    p.add_argument("--sensor", default="geoeye")
    p.add_argument("--per-shard", type=int, default=64)
    p.add_argument("--wavelengths", type=float, nargs="+", default=[0.665, 0.549, 0.481])
    p.add_argument("--band-indices", type=int, nargs="+", default=None)
    p.add_argument("--patches-root", default=None)
    p.add_argument("--registry", default=None)
    p.add_argument("--datetime", default="2023-06-15T14:30:00Z")
    p.add_argument("--lat", type=float, default=43.47)
    p.add_argument("--lon", type=float, default=-80.54)
    a = p.parse_args(argv)
    path = make_shards(a.csv_root, a.out_root, a.sensor, a.per_shard, a.wavelengths,
                       a.band_indices, a.patches_root, a.registry, a.datetime, a.lat, a.lon)
    print(f"wrote {path} (sensor: {a.sensor})")
    return path


if __name__ == "__main__":
    main()
