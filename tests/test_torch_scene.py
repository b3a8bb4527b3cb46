"""Whole-scene inference of the port against the JAX package's, on the CPU.

- ``_tile_origins`` and ``_blend_window`` (hann, uniform, crop) equal the
  JAX package's.
- ``sliding_window_logits`` against the JAX one on ragged scenes smaller
  and larger than a tile, with a forward whose output depends on the whole
  tile (each pixel's logits add the tile's mean), so that the blend weights
  and the tile origins matter; f32 on both sides, 1e-5 absolute on logits
  of order 1 (the canvases add the same terms in the same order; the
  forwards' sums differ in order).
- ``GeoTiffWindowReader`` against the JAX reader on the same files
  (striped: none / Deflate / LZW; tiled with the horizontal predictor,
  chunky and planar); ``GeoTiffStripWriter`` writes the same bytes as the
  JAX writer.
- The band-streamed logits equal the whole-scene logits and the JAX
  streamer's (1e-5); ``predict_scene_streamed`` writes the same class map
  as ``predict_scene``.
- The port CLI's ``predict-scene`` on a tiny DOFA writes the scene's class
  map with its transform and EPSG code, equal to ``predict_scene`` run with
  the CLI's forward, streamed or not.
"""

import struct
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import register_tiny

from geo_deep_learning_tpu.data import geotiff as jgeotiff
from geo_deep_learning_tpu.data import geotiff_stream as jstream
from geo_deep_learning_tpu.inference import sliding_window as jsw
from geo_deep_learning_tpu.inference import streaming as jstreaming
from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import load_config
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.data.geotiff import Affine, GeoInfo, read_geotiff, write_geotiff
from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffStripWriter, GeoTiffWindowReader
from geo_deep_learning_tpu_torch.inference import sliding_window as tsw
from geo_deep_learning_tpu_torch.inference import streaming as tstreaming

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "dofa_upernet_waterloo.yaml"
GEO = (0.3, 0.0, 500000.0, 0.0, -0.3, 5000000.0)  # 0.3 m pixels
EPSG = 32617
K = 3
RNG = np.random.default_rng(0)
W_PIX = RNG.standard_normal((4, K)).astype(np.float32)
W_MEAN = RNG.standard_normal((4, K)).astype(np.float32)


def jax_forward(tiles):
    return tiles @ W_PIX + (tiles.mean(axis=(1, 2), keepdims=True) @ W_MEAN)


def port_forward(tiles):
    return tiles @ torch.from_numpy(W_PIX) + tiles.mean(dim=(1, 2), keepdim=True) @ torch.from_numpy(W_MEAN)


@pytest.mark.parametrize("size,tile,stride", [(300, 128, 96), (128, 128, 96), (90, 128, 96),
                                              (5120, 512, 384), (5120, 640, 512), (260, 64, 64)])
def test_tile_origins_match_jax(size, tile, stride):
    np.testing.assert_array_equal(tsw._tile_origins(size, tile, stride),
                                  jsw._tile_origins(size, tile, stride))


@pytest.mark.parametrize("kind", ["hann", "uniform", "crop"])
@pytest.mark.parametrize("tile,overlap", [(64, 16), (512, 128), (640, 128)])
def test_blend_window_matches_jax(kind, tile, overlap):
    got = tsw._blend_window(tile, kind, overlap)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jsw._blend_window(tile, kind, overlap))


@pytest.mark.parametrize("blend", ["hann", "uniform", "crop"])
@pytest.mark.parametrize("hw", [(300, 260), (100, 90), (64, 200)])
def test_sliding_window_logits_match_jax(blend, hw):
    scene = np.random.default_rng(1).standard_normal((*hw, 4)).astype(np.float32)
    cfg = tsw.SlidingWindowConfig(tile_size=128, overlap=32, batch_size=3, blend=blend)
    jcfg = jsw.SlidingWindowConfig(tile_size=128, overlap=32, batch_size=3, blend=blend)
    got = tsw.sliding_window_logits(port_forward, torch.from_numpy(scene), K, cfg)
    want = np.asarray(jsw.sliding_window_logits(jax_forward, scene, K, jcfg))
    assert got.shape == (*hw, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _write_tiled(path, img, tile, planar):
    """A little-endian classic TIFF of ``img`` (uint8 HWC) in Deflate tiles
    with the horizontal predictor, chunky or in separate planes."""
    h, w, c = img.shape
    blocks = []
    for p in ([img[..., i : i + 1] for i in range(c)] if planar else [img]):
        for y in range(0, h, tile):
            for x in range(0, w, tile):
                t = np.zeros((tile, tile, p.shape[2]), np.uint8)
                part = p[y : y + tile, x : x + tile]
                t[: part.shape[0], : part.shape[1]] = part
                t = np.diff(t, axis=1, prepend=np.zeros_like(t[:, :1]))  # wraps mod 256
                blocks.append(zlib.compress(t.tobytes()))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * c), 259: (3, [8]),
               262: (3, [2 if c == 3 else 1]), 277: (3, [c]), 284: (3, [2 if planar else 1]),
               317: (3, [2]), 322: (3, [tile]), 323: (3, [tile]),
               324: (4, [0] * len(blocks)), 325: (4, [len(b) for b in blocks]), 339: (3, [1] * c)}

    def raw(typ, vals):
        return struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)

    # header | IFD | values longer than 4 bytes | tiles
    ifd_size = 2 + 12 * len(entries) + 4
    pos = 8 + ifd_size + sum(len(raw(*e)) for e in entries.values() if len(raw(*e)) > 4)
    offsets = []
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    entries[324] = (4, offsets)
    ifd, extra = bytearray(struct.pack("<H", len(entries))), bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        r = raw(typ, vals)
        if len(r) <= 4:
            field = r.ljust(4, b"\0")
        else:
            field = struct.pack("<I", 8 + ifd_size + len(extra))
            extra += r
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + field
    ifd += b"\0" * 4
    Path(path).write_bytes(b"II*\0" + struct.pack("<I", 8) + ifd + extra + b"".join(blocks))


@pytest.mark.parametrize("layout", ["none", "deflate", "lzw", "tiled", "tiled-planar"])
def test_window_reader_matches_jax(tmp_path, layout):
    img = np.random.default_rng(2).integers(0, 256, (93, 70, 3), dtype=np.uint8)
    path = tmp_path / "scene.tif"
    if layout.startswith("tiled"):
        _write_tiled(path, img, 32, planar=layout.endswith("planar"))
    else:
        jgeotiff.write_geotiff(path, img, compress=None if layout == "none" else layout,
                               rows_per_strip=16)
    whole, _ = read_geotiff(path)
    np.testing.assert_array_equal(whole, img)
    with GeoTiffWindowReader(path) as ours, jstream.GeoTiffWindowReader(path) as theirs:
        assert (ours.height, ours.width, ours.channels, ours.dtype) == (
            theirs.height, theirs.width, theirs.channels, theirs.dtype)
        for row0, n in [(0, 93), (0, 1), (10, 30), (80, 13), (15, 17), (90, 40)]:
            got = ours.read_rows(row0, n)
            np.testing.assert_array_equal(got, theirs.read_rows(row0, n))
            np.testing.assert_array_equal(got, img[row0 : row0 + n])


@pytest.mark.parametrize("compress", [None, "deflate", "lzw"])
@pytest.mark.parametrize("bigtiff", [True, False])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_strip_writer_writes_the_jax_bytes(tmp_path, compress, bigtiff, dtype):
    img = (np.random.default_rng(3).random((70, 33, 2)) * 200).astype(dtype)
    ours, theirs = tmp_path / "ours.tif", tmp_path / "theirs.tif"
    for writer, info, path in (
        (GeoTiffStripWriter, GeoInfo(Affine(*GEO), EPSG, 0.0), ours),
        (jstream.GeoTiffStripWriter, jgeotiff.GeoInfo(jgeotiff.Affine(*GEO), EPSG, 0.0), theirs),
    ):
        with writer(path, 33, 2, dtype, geo=info, compress=compress, rows_per_strip=16,
                    bigtiff=bigtiff) as w:
            for y0, n in [(0, 5), (5, 20), (25, 16), (41, 29)]:
                w.write_rows(img[y0 : y0 + n])
    assert ours.read_bytes() == theirs.read_bytes()
    back, got_geo = read_geotiff(ours)
    np.testing.assert_array_equal(back, img)
    assert got_geo.epsg == EPSG and got_geo.transform == Affine(*GEO)


def _scene_file(path, hw=(300, 260)):
    img = np.random.default_rng(4).integers(0, 256, (*hw, 4), dtype=np.uint8)
    with jstream.GeoTiffStripWriter(path, hw[1], 4, np.uint8, rows_per_strip=32,
                                    geo=jgeotiff.GeoInfo(jgeotiff.Affine(*GEO), EPSG)) as w:
        w.write_rows(img)
    return img


@pytest.mark.parametrize("blend", ["hann", "crop"])
@pytest.mark.parametrize("hw", [(300, 260), (100, 90)])
def test_streamed_logits_match_whole_scene_and_jax(tmp_path, blend, hw):
    path = tmp_path / "scene.tif"
    img = _scene_file(path, hw)
    cfg = tsw.SlidingWindowConfig(tile_size=64, overlap=16, batch_size=5, blend=blend)
    jcfg = jsw.SlidingWindowConfig(tile_size=64, overlap=16, batch_size=5, blend=blend)
    got, want = [], []
    with GeoTiffWindowReader(path) as r:
        tstreaming.streamed_scene_logits_writer(
            port_forward, r, lambda row0, lg: got.append((row0, lg.numpy())), K, cfg,
            band_tile_rows=2, preprocess=lambda b: torch.from_numpy(b.astype(np.float32) / 255))
    with jstream.GeoTiffWindowReader(path) as r:
        jstreaming.streamed_scene_logits_writer(
            jax_forward, r, lambda row0, lg: want.append((row0, np.asarray(lg))), K, jcfg,
            band_tile_rows=2, preprocess=lambda b: b / 255)
    assert [r for r, _ in got] == [r for r, _ in want]
    streamed = np.concatenate([lg for _, lg in got])
    np.testing.assert_allclose(streamed, np.concatenate([lg for _, lg in want]), atol=1e-5, rtol=0)
    whole = tsw.sliding_window_logits(
        port_forward, torch.from_numpy(img.astype(np.float32) / 255), K, cfg)
    np.testing.assert_allclose(streamed, whole.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_classes", [1, K])
def test_predict_scene_streamed_matches_whole_and_jax(tmp_path, num_classes):
    """Class maps of both port paths and the JAX ``predict_scene`` (its
    forward in f32 numpy arithmetic) agree, with the scene's georeference;
    pixels whose logit sits within 1e-4 of the decision may differ."""
    path = tmp_path / "scene.tif"
    _scene_file(path)
    mean, std = [0.4, 0.45, 0.5, 0.42], [0.2, 0.18, 0.22, 0.25]
    cfg = tsw.SlidingWindowConfig(tile_size=64, overlap=16, batch_size=5)
    tfwd = lambda t: port_forward(t)[..., :num_classes]  # noqa: E731
    jfwd = lambda t: jax_forward(t)[..., :num_classes]  # noqa: E731
    tsw.predict_scene(tfwd, str(path), str(tmp_path / "whole.tif"), num_classes, cfg,
                      mean, std, device="cpu")
    tstreaming.predict_scene_streamed(tfwd, str(path), str(tmp_path / "band.tif"), num_classes,
                                      cfg, mean, std, device="cpu", band_tile_rows=2)
    jsw.predict_scene(jfwd, str(path), str(tmp_path / "jax.tif"), num_classes,
                      jsw.SlidingWindowConfig(tile_size=64, overlap=16, batch_size=5), mean, std)
    whole, geo = read_geotiff(tmp_path / "whole.tif")
    band, band_geo = read_geotiff(tmp_path / "band.tif")
    theirs, _ = jgeotiff.read_geotiff(tmp_path / "jax.tif")
    assert whole.shape == (300, 260, 1) and whole.dtype == np.uint8
    assert geo.epsg == band_geo.epsg == EPSG and geo.transform == band_geo.transform == Affine(*GEO)
    np.testing.assert_array_equal(whole, band)
    img, _ = read_geotiff(path)
    x = torch.from_numpy(((img / 255.0 - np.asarray(mean)) / np.asarray(std)).astype(np.float32))
    logits = tsw.sliding_window_logits(tfwd, x, num_classes, cfg).numpy()
    if num_classes == 1:
        margin = np.abs(logits[..., 0])
    else:
        top2 = np.sort(logits, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
    decided = margin > 1e-4
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(whole[decided], theirs[decided])


@pytest.fixture
def scene_config(tmp_path, monkeypatch):
    register_tiny(monkeypatch)
    cfg = load_config(PORT_CONFIG)
    cfg["trainer"]["default_root_dir"] = str(tmp_path / "run")
    cfg["trainer"]["precision"] = "32-true"
    cfg["model"]["init_args"].update(encoder="tiny", image_size=[64, 64], decoder_channels=32)
    cfg["data"]["init_args"].update(csv_root_folder=str(tmp_path), patches_root_folder=str(tmp_path))
    img = np.random.default_rng(5).integers(0, 256, (150, 130, 3), dtype=np.uint8)
    with GeoTiffStripWriter(tmp_path / "scene.tif", 130, 3, np.uint8,
                            geo=GeoInfo(Affine(*GEO), EPSG)) as w:
        w.write_rows(img)
    return cfg


@pytest.mark.parametrize("blend", ["hann", "uniform"])
def test_cli_predict_scene_writes_the_georeferenced_map(scene_config, tmp_path, blend):
    """``main(["predict-scene", ...])`` on the CPU: the map equals
    ``predict_scene`` with the CLI's forward (the seeded tiny DOFA +
    UperNet, f32) and the datamodule's mean/std, and the streamed run's
    map."""
    import yaml

    cfg_path = tmp_path / "port.yaml"
    cfg_path.write_text(yaml.safe_dump(scene_config))
    args = ["predict-scene", "--config", str(cfg_path), "--device", "cpu",
            "--scene", str(tmp_path / "scene.tif"), "--tile-size", "64", "--tile-overlap", "16",
            "--tile-batch", "3", "--blend", blend]
    result = cli.main(args)
    assert result == {"output": str(tmp_path / "scene_pred.tif"), "streamed": False}
    streamed = cli.main([*args, "--streamed", "--output", str(tmp_path / "band.tif")])
    assert streamed["streamed"]
    got, geo = read_geotiff(result["output"])
    assert got.shape == (150, 130, 1) and got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1}
    assert geo.epsg == EPSG and geo.transform == Affine(*GEO)
    np.testing.assert_array_equal(read_geotiff(streamed["output"])[0], got)

    spec = cli.instantiate(scene_config["model"])
    spec.task.materialize(torch.device("cpu"), scene_config["seed_everything"])
    data = scene_config["data"]["init_args"]
    cfg = tsw.SlidingWindowConfig(64, 16, 3, blend)
    tsw.predict_scene(cli.tile_forward(spec.task, PrecisionPolicy.create("32-true")),
                      str(tmp_path / "scene.tif"), str(tmp_path / "direct.tif"), 1, cfg,
                      data["mean"], data["std"], device="cpu")
    np.testing.assert_array_equal(read_geotiff(tmp_path / "direct.tif")[0], got)


def test_predict_scene_needs_a_scene(scene_config):
    with pytest.raises(ValueError, match="requires --scene"):
        cli.run(scene_config, "predict-scene", device="cpu")


def test_cli_streams_scenes_above_the_decoded_size_limit(scene_config, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "STREAM_ABOVE_BYTES", 150 * 130 * 3 - 1)
    opts = cli.SceneOptions(str(tmp_path / "scene.tif"), str(tmp_path / "out.tif"), 64, 16, 3)
    assert cli.run(scene_config, "predict-scene", device="cpu", scene=opts)["streamed"]
    monkeypatch.setattr(cli, "STREAM_ABOVE_BYTES", 150 * 130 * 3)
    assert not cli.run(scene_config, "predict-scene", device="cpu", scene=opts)["streamed"]
