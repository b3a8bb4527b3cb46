"""The port's host utilities against the JAX package's on the same seeded
numpy inputs: ``utils.tensors`` (torch), ``utils.crs`` (the port's copy),
``utils.rasters`` (on the port's GeoTIFF codec), ``adaptive_avg_pool``
(NCHW against JAX's NHWC), and the re-export shims."""

import importlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geo_deep_learning_tpu.data.geotiff import Affine as JAffine
from geo_deep_learning_tpu.data.geotiff import GeoInfo as JGeoInfo
from geo_deep_learning_tpu.data.geotiff import read_geotiff as jread
from geo_deep_learning_tpu.data.geotiff import write_geotiff as jwrite
from geo_deep_learning_tpu.models.layers import adaptive_avg_pool as jpool
from geo_deep_learning_tpu.utils import crs as jcrs
from geo_deep_learning_tpu.utils import rasters as jrasters
from geo_deep_learning_tpu.utils import tensors as jtensors
from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff as tread
from geo_deep_learning_tpu_torch.models.layers import adaptive_avg_pool as tpool
from geo_deep_learning_tpu_torch.utils import crs as tcrs
from geo_deep_learning_tpu_torch.utils import rasters as trasters
from geo_deep_learning_tpu_torch.utils import tensors as ttensors

F32_TOL = 1e-6

# -- utils.tensors -----------------------------------------------------------


def _image(seed: int, shape=(2, 8, 8, 4)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-20.0, 280.0, shape).astype(np.float32)


def test_normalization_matches_jax():
    x = _image(0)
    for kw in ({}, {"image_min": 10.0, "image_max": 200.0, "norm_min": -1.0, "norm_max": 1.0}):
        got = ttensors.normalization(torch.from_numpy(x), **kw)
        want = np.asarray(jtensors.normalization(jnp.asarray(x), **kw))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("channel_axis", [-1, 1])
def test_standardization_and_denormalization_match_jax(channel_axis):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 1.0, (2, 4, 8, 8) if channel_axis == 1 else (2, 8, 8, 4))
    x = x.astype(np.float32)
    mean = rng.uniform(0.3, 0.6, 4).astype(np.float32)
    std = rng.uniform(0.1, 0.3, 4).astype(np.float32)
    got = ttensors.standardization(torch.from_numpy(x), mean, std, channel_axis)
    want = np.asarray(jtensors.standardization(jnp.asarray(x), mean, std, channel_axis))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    for m, s in ((mean, std), (None, None), (0.5, 0.25)):
        back = ttensors.denormalization(got, m, s, channel_axis=channel_axis)
        jback = np.asarray(jtensors.denormalization(jnp.asarray(want), m, s,
                                                    channel_axis=channel_axis))
        assert back.dtype == torch.uint8
        np.testing.assert_array_equal(back.numpy(), jback)


def test_manage_bands_matches_jax():
    x = _image(2, (5, 6, 5))
    for bands in (None, [4, 0], [1, 1, 3]):
        got = ttensors.manage_bands(torch.from_numpy(x), bands)
        want = np.asarray(jtensors.manage_bands(jnp.asarray(x), bands))
        np.testing.assert_array_equal(got.numpy(), want)
    got = ttensors.manage_bands(torch.from_numpy(x), [2, 0], channel_axis=0)
    np.testing.assert_array_equal(got.numpy(), x[[2, 0]])


@pytest.mark.parametrize("case", ["stats_2d", "bands_out_of_range"])
def test_bad_inputs_raise_the_jax_errors(case):
    x = _image(3, (4, 4, 3))
    calls = {
        "stats_2d": (lambda m, t: m.standardization(t, np.ones((3, 1)), np.ones((3, 1)))),
        "bands_out_of_range": (lambda m, t: m.manage_bands(t, [0, 3])),
    }[case]
    with pytest.raises(ValueError) as jax_err:
        calls(jtensors, jnp.asarray(x))
    with pytest.raises(ValueError) as port_err:
        calls(ttensors, torch.from_numpy(x))
    assert str(port_err.value).split(",")[0] == str(jax_err.value).split(",")[0]


# -- utils.crs ---------------------------------------------------------------

# (EPSG, lon range, lat range) of each family's domain
CRS_CASES = {
    "utm_north": (32617, (-84.0, -78.0), (0.0, 80.0)),
    "utm_south": (32717, (-84.0, -78.0), (-80.0, 0.0)),
    "lambert_canada": (3978, (-140.0, -52.0), (41.0, 80.0)),
    "lambert_france": (2154, (-5.0, 9.0), (41.0, 51.0)),
    "albers_conus": (5070, (-125.0, -66.0), (24.0, 50.0)),
    "albers_australia": (3577, (112.0, 154.0), (-44.0, -10.0)),
    "polar_north": (3413, (-180.0, 180.0), (60.0, 89.5)),
    "polar_south": (3031, (-180.0, 180.0), (-89.5, -60.0)),
    "web_mercator": (3857, (-180.0, 180.0), (-85.0, 85.0)),
    "geographic": (4326, (-180.0, 180.0), (-90.0, 90.0)),
}


def _lonlat(lons, lats, n: int = 1000, seed: int = 4):
    rng = np.random.default_rng(seed)
    return rng.uniform(*lons, n), rng.uniform(*lats, n)


@pytest.mark.parametrize("case", list(CRS_CASES))
def test_transform_points_matches_jax_and_round_trips(case):
    epsg, lons, lats = CRS_CASES[case]
    lon, lat = _lonlat(lons, lats)
    x, y = tcrs.transform_points(4326, epsg, lon, lat)
    jx, jy = jcrs.transform_points(4326, epsg, lon, lat)
    tol = 1e-9 if epsg == 4326 else 1e-6  # degrees, else metres
    np.testing.assert_allclose(x, jx, atol=tol, rtol=0)
    np.testing.assert_allclose(y, jy, atol=tol, rtol=0)
    lon2, lat2 = tcrs.transform_points(epsg, 4326, x, y)
    jlon2, jlat2 = jcrs.transform_points(epsg, 4326, jx, jy)
    for got, want, orig in ((lon2, jlon2, lon), (lat2, jlat2, lat)):
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
        np.testing.assert_allclose(got, orig, atol=1e-9, rtol=0)


def test_projected_to_projected_matches_jax():
    lon, lat = _lonlat((-84.0, -78.0), (30.0, 60.0), seed=5)
    for src, dst in ((32617, 3857), (32617, 3978), (5070, 32617), (3857, 32717)):
        x, y = jcrs.from_geographic(src, lon, lat if dst != 32717 else -lat)
        got = tcrs.transform_points(src, dst, x, y)
        want = jcrs.transform_points(src, dst, x, y)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_utm_zone_params_and_supported_envelope_match_jax():
    for epsg in (32601, 32617, 32660, 32701, 32760):
        assert tcrs.utm_zone_params(epsg) == jcrs.utm_zone_params(epsg)
    with pytest.raises(ValueError):
        tcrs.utm_zone_params(2193)
    for epsg in (None, 4326, 3857, 3978, 3031, 32617, 32761, 2193, 2960):
        assert tcrs.is_supported(epsg) == jcrs.is_supported(epsg)
        assert tcrs.can_transform(epsg, 4326) == jcrs.can_transform(epsg, 4326)
    assert tcrs.SUPPORTED_FAMILIES == jcrs.SUPPORTED_FAMILIES


def _stub_pyproj(monkeypatch, crs_module):
    """An API-faithful pyproj whose transformer runs ``crs_module``'s own
    projection math, as ``tests/test_utils_rasters.py`` stubs it."""

    class _Transformer:
        def __init__(self, src: int, dst: int):
            self.src, self.dst = src, dst

        @classmethod
        def from_crs(cls, src: str, dst: str, always_xy: bool = False):
            assert always_xy, "the caller must ask for always_xy axis order"
            return cls(int(src.split(":")[1]), int(dst.split(":")[1]))

        def transform(self, x, y):
            lon, lat = crs_module.to_geographic(self.src, x, y)
            return crs_module.from_geographic(self.dst, lon, lat)

    stub = types.ModuleType("pyproj")
    stub.Transformer = _Transformer
    monkeypatch.setitem(sys.modules, "pyproj", stub)


def test_pyproj_delegation_with_a_stub(monkeypatch):
    """A pair outside the native families goes to pyproj where it imports:
    with 4326/32617 made to look unsupported, the stub's answer is JAX's
    native one bit for bit."""
    lon, lat = _lonlat((-80.9, -78.1), (42.0, 45.0), n=50, seed=6)
    want = jcrs.transform_points(4326, 32617, lon, lat)
    _stub_pyproj(monkeypatch, tcrs)
    monkeypatch.setattr(tcrs, "is_supported", lambda epsg: False)
    assert tcrs.can_transform(4326, 32617)
    got = tcrs.transform_points(4326, 32617, lon, lat)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -- utils.rasters -----------------------------------------------------------


def _same_crs_pair(tmp_path):
    """uint8 source at 1 m; a 2 m reference grid over the same extent,
    offset by a third of a pixel so every resampler interpolates."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 255, size=(32, 32, 3)).astype(np.uint8)
    jwrite(tmp_path / "src.tif", src, JGeoInfo(JAffine(1.0, 0, 1000.0, 0, -1.0, 2000.0),
                                               epsg=32617))
    jwrite(tmp_path / "ref.tif", np.zeros((15, 15, 1), np.uint8),
           JGeoInfo(JAffine(2.0, 0, 1000.7, 0, -2.0, 1999.3), epsg=32617))
    return tmp_path / "src.tif", tmp_path / "ref.tif"


def _geographic_to_utm_pair(tmp_path):
    """The 4326 -> 32617 case of ``tests/test_utils_rasters.py``: an f32
    field of (lon, lat) on 0.001-degree pixels, a corner of nodata, and a
    30 m UTM 17N reference over its middle."""
    lon0, lat0, res = -79.45, 43.70, 0.001
    lon = lon0 + (np.arange(120) + 0.5) * res
    lat = lat0 - (np.arange(120) + 0.5) * res
    lon_g, lat_g = np.meshgrid(lon, lat)
    src = (1000.0 * (lon_g - lon0) + 2000.0 * (lat0 - lat_g)).astype(np.float32)
    src += np.random.default_rng(8).normal(0.0, 0.5, src.shape).astype(np.float32)
    src[:30, :30] = -9999.0
    jwrite(tmp_path / "src.tif", src[..., None],
           JGeoInfo(JAffine(res, 0, lon0, 0, -res, lat0), epsg=4326, nodata=-9999.0))
    e0, n0 = jcrs.from_geographic(32617, lon0 + 0.02, lat0 - 0.02)
    jwrite(tmp_path / "ref.tif", np.zeros((64, 64), np.uint8),
           JGeoInfo(JAffine(30.0, 0, float(e0), 0, -30.0, float(n0)), epsg=32617))
    return tmp_path / "src.tif", tmp_path / "ref.tif"


@pytest.mark.parametrize("pair", ["same_crs", "4326_to_32617"])
@pytest.mark.parametrize("resampling", ["nearest", "bilinear", "cubic"])
def test_align_to_reference_matches_jax(tmp_path, pair, resampling):
    make = {"same_crs": _same_crs_pair, "4326_to_32617": _geographic_to_utm_pair}[pair]
    src, ref = make(tmp_path)
    jout = jrasters.align_to_reference(src, ref, tmp_path / "jax.tif", resampling=resampling)
    tout = trasters.align_to_reference(src, ref, tmp_path / "port.tif", resampling=resampling)
    want, wgeo = jread(jout)
    got, geo = tread(tout)
    assert got.dtype == want.dtype and got.shape == want.shape
    if resampling == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    assert (geo.transform.a, geo.transform.b, geo.transform.c, geo.transform.d,
            geo.transform.e, geo.transform.f) == wgeo.transform.to_tuple()
    assert (geo.epsg, geo.nodata) == (wgeo.epsg, wgeo.nodata)
    # and the JAX package reads the port's file as the port does
    np.testing.assert_array_equal(jread(tout)[0], got)


def test_align_rejects_bad_resampling_and_unsupported_crs(tmp_path):
    src, ref = _same_crs_pair(tmp_path)
    for mod in (jrasters, trasters):
        with pytest.raises(ValueError, match="Invalid resampling"):
            mod.align_to_reference(src, ref, tmp_path / "x.tif", resampling="lanczos")
    a, b = tmp_path / "a.tif", tmp_path / "b.tif"
    jwrite(a, np.zeros((4, 4), np.uint8), JGeoInfo(epsg=2193))  # NZTM, outside the families
    jwrite(b, np.zeros((4, 4), np.uint8), JGeoInfo(epsg=4326))
    errors = []
    for mod in (jrasters, trasters):
        with pytest.raises(NotImplementedError, match="pyproj") as err:
            mod.align_to_reference(a, b, tmp_path / "c.tif")
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_align_delegates_to_pyproj_with_a_stub(tmp_path, monkeypatch):
    """``align_to_reference`` through the pyproj route (stubbed with the
    port's own math) gives JAX's native answer."""
    src, ref = _geographic_to_utm_pair(tmp_path)
    want, _ = jread(jrasters.align_to_reference(src, ref, tmp_path / "jax.tif"))
    _stub_pyproj(monkeypatch, tcrs)
    monkeypatch.setattr(tcrs, "is_supported", lambda epsg: False)
    got, _ = tread(trasters.align_to_reference(src, ref, tmp_path / "port.tif"))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("nodata", [None, -9999.0])
def test_dataset_stats_match_jax(tmp_path, nodata):
    rng = np.random.default_rng(9)
    paths = []
    for i in range(3):
        arr = rng.uniform(0, 100, size=(9, 7, 2)).astype(np.float32)
        if nodata is not None:
            arr[rng.random(arr.shape[:2]) < 0.3] = nodata
        paths.append(tmp_path / f"{i}.tif")
        jwrite(paths[-1], arr, JGeoInfo(nodata=nodata))
    got = trasters.compute_dataset_stats_from_list(paths)
    want = jrasters.compute_dataset_stats_from_list(paths)
    np.testing.assert_allclose(got["mean"], want["mean"], atol=1e-9, rtol=0)
    np.testing.assert_allclose(got["std"], want["std"], atol=1e-9, rtol=0)
    if nodata is not None:  # the nodata pixels are left out
        vals = np.concatenate([jread(p)[0].reshape(-1, 2) for p in paths])
        kept = [vals[vals[:, c] != nodata, c].astype(np.float64) for c in range(2)]
        np.testing.assert_allclose(got["mean"], [k.mean() for k in kept], rtol=1e-9)
    with pytest.raises(ValueError, match="empty"):
        trasters.compute_dataset_stats_from_list([])


# -- adaptive_avg_pool -------------------------------------------------------


@pytest.mark.parametrize(("size", "out"), [((7, 9), (3, 4)), ((6, 6), (3, 3))])
def test_adaptive_avg_pool_matches_jax(size, out):
    x = np.random.default_rng(10).normal(size=(2, *size, 5)).astype(np.float32)  # NHWC
    want = np.asarray(jpool(jnp.asarray(x), out))
    got = tpool(torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


# -- the re-export shims -----------------------------------------------------

SHIMS = {
    "models.utils": {
        "PPM": "models.layers", "ConvModule": "models.layers",
        "adaptive_avg_pool": "models.layers", "patch_first_conv": "models.convert",
        "resize": "ops.resize"},
    "utils.models": {"load_weights_from_checkpoint": "training.checkpoint"},
    "tools.schedulers": {
        "LinearWarmupCosineAnnealingLR": ("training.optim", "linear_warmup_cosine_annealing"),
        "linear_warmup_decay": "training.optim", "one_cycle": "training.optim"},
    "tools.callbacks": {
        "VisualizationCallback": "tools.callbacks.segmentation_visualization"},
}


@pytest.mark.parametrize("shim", list(SHIMS))
def test_shims_export_the_jax_names_from_the_ports_homes(shim):
    port = importlib.import_module(f"geo_deep_learning_tpu_torch.{shim}")
    jax_shim = importlib.import_module(f"geo_deep_learning_tpu.{shim}")
    assert sorted(port.__all__) == sorted(jax_shim.__all__) == sorted(SHIMS[shim])
    for name, home in SHIMS[shim].items():
        home, attr = home if isinstance(home, tuple) else (home, name)
        module = importlib.import_module(f"geo_deep_learning_tpu_torch.{home}")
        assert getattr(port, name) is getattr(module, attr), name
