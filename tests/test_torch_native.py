"""The port's C++ host readers (``data/_native.py``) on the CPU.

The tar reader builds here (``g++`` is present) and yields exactly
``tarfile``'s file members, and the JAX package's ``_iter_members``, on
shards written by the port's ``tools/make_shards.py``; a member name past
its 4 KiB buffer resumes with ``tarfile``, every member once, with a
warning. The libtiff reader decodes exactly what the numpy codec decodes,
for uint8/uint16/int16/float32 and 1-6 bands; those tests skip where
``tiffio.h`` is absent. The decoder in use is logged once, and a build that
fails where the compiler is present raises.
"""

import io
import logging
import tarfile

import numpy as np
import pytest

from geo_deep_learning_tpu.data import geotiff as jgeotiff
from geo_deep_learning_tpu.data.shard_dataset import _iter_members as jax_iter_members
from geo_deep_learning_tpu_torch.data import _native
from geo_deep_learning_tpu_torch.data import geotiff
from geo_deep_learning_tpu_torch.data.shard_dataset import _iter_members, iter_tar_samples
from geo_deep_learning_tpu_torch.tools.make_shards import make_shards


def _tarfile_members(path) -> list[tuple[str, bytes]]:
    with tarfile.open(path) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar if m.isfile()]


@pytest.fixture(scope="module")
def shards(tmp_path_factory) -> list:
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(3)
    for split, n in (("trn", 5), ("val", 2), ("tst", 2)):
        (root / "csv" / split).mkdir(parents=True)
        rows = []
        for i in range(n):
            geotiff.write_geotiff(root / "csv" / split / f"{i}.tif",
                                  rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
            geotiff.write_geotiff(root / "csv" / split / f"{i}_lbl.tif",
                                  rng.integers(0, 2, (16, 16), dtype=np.uint8))
            rows.append(f"{split}/{i}.tif;{split}/{i}_lbl.tif")
        (root / "csv" / f"{split}.csv").write_text("\n".join(rows) + "\n")
    make_shards(root / "csv", root / "shards", "rgb", per_shard=2,
                wavelengths=[0.665, 0.549, 0.481])
    return sorted((root / "shards").rglob("*.tar"))


def test_tar_reader_yields_tarfiles_members(shards):
    assert _native.get_tar_lib() is not None, _native.DECODERS
    assert _native.DECODERS["tar"] == "native (build/host_readers/libgdltar.so)"
    assert len(shards) == 5
    for path in shards:
        want = _tarfile_members(path)
        assert len(want) == 6 or len(want) == 3
        assert list(_native.iter_tar_members_native(path)) == want
        assert list(_iter_members(str(path))) == want
        assert list(jax_iter_members(str(path))) == want


def test_tar_samples_group_as_before(shards):
    for path in shards:
        samples = list(iter_tar_samples(str(path)))
        keys = [s["__key__"] for s in samples]
        assert keys == sorted(set(keys), key=keys.index)
        for s in samples:
            assert s["image_patch.npy"].shape == (3, 16, 16)
            assert s["label_patch.npy"].dtype.kind in "iu"
            assert set(s["metadata.json"]) == {"metadata"}


def _add(tar: tarfile.TarFile, name: str, payload: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tar.addfile(info, io.BytesIO(payload))


@pytest.mark.parametrize("fmt", [tarfile.PAX_FORMAT, tarfile.GNU_FORMAT], ids=["pax", "gnu"])
def test_long_name_resumes_with_tarfile(tmp_path, caplog, fmt):
    """A 5000-character name overflows the native reader's 4 KiB buffer
    after two members: ``tarfile`` yields the rest, each member once."""
    path = tmp_path / "long.tar"
    long_name = "k" * 5000 + ".label_patch.npy"
    with tarfile.open(path, "w", format=fmt) as tar:
        _add(tar, "a.image_patch.npy", b"first")
        _add(tar, "a.label_patch.npy", b"second")
        _add(tar, long_name, b"third")
        _add(tar, "b.image_patch.npy", b"fourth" * 300)
    want = _tarfile_members(path)
    assert [n for n, _ in want][2] == long_name
    native = _native.iter_tar_members_native(path)
    assert next(native) == want[0]
    with caplog.at_level(logging.WARNING):
        got = list(_iter_members(str(path)))
    assert got == want
    msgs = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(msgs) == 1 and "after 2 members" in msgs[0] and "resuming with Python tarfile" in msgs[0]


def _fresh(monkeypatch, tmp_path=None) -> None:
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(_native, "DECODERS", {})
    if tmp_path is not None:
        monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build" / "host_readers")


def test_decoder_is_logged_once_at_first_use(monkeypatch, caplog):
    _fresh(monkeypatch)
    with caplog.at_level(logging.INFO, logger=_native.__name__):
        first = _native.get_tar_lib()
        again = _native.get_tar_lib()
    assert first is again is not None
    lines = [r.getMessage() for r in caplog.records if r.name == _native.__name__]
    assert lines == ["tar: native (build/host_readers/libgdltar.so)"]


def test_no_native_switch_keeps_the_python_readers(monkeypatch, caplog, shards):
    _fresh(monkeypatch)
    monkeypatch.setenv("GDL_TPU_NO_NATIVE", "1")
    with caplog.at_level(logging.INFO, logger=_native.__name__):
        assert _native.iter_tar_members_native(shards[0]) is None
        assert _native.read_pixels_native("any.tif") is None
    assert _native.DECODERS == {"tar": "tarfile (GDL_TPU_NO_NATIVE=1)",
                                "tiff": "numpy codec (GDL_TPU_NO_NATIVE=1)"}
    assert list(_iter_members(str(shards[0]))) == _tarfile_members(shards[0])


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    """With ``g++`` present, a reader that does not compile is an error, not
    a fallback; the build directory holds no partial library afterwards."""
    _fresh(monkeypatch, tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    (src / "tar_reader.cc").write_text("int gdl_tar_open( {\n")
    monkeypatch.setattr(_native, "SRC_DIR", src)
    with pytest.raises(RuntimeError, match=r"building the tar reader failed(.|\n)*error"):
        _native.get_tar_lib()
    assert not list(_native.BUILD_DIR.glob("*.so*tmp")) and not (
        _native.BUILD_DIR / "libgdltar.so").exists()


def test_a_stale_build_is_rebuilt(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    source = (_native.SRC_DIR / "tar_reader.cc").read_text()
    (src / "tar_reader.cc").write_text(source)
    monkeypatch.setattr(_native, "SRC_DIR", src)
    lib = _native._build(_native._TAR, "g++")
    stamp = (lib.parent / "libgdltar.so.stamp").read_text()
    mtime = lib.stat().st_mtime_ns
    assert _native._build(_native._TAR, "g++") == lib and lib.stat().st_mtime_ns == mtime
    (src / "tar_reader.cc").write_text(source + "\n// changed\n")
    _native._build(_native._TAR, "g++")
    assert (lib.parent / "libgdltar.so.stamp").read_text() != stamp


@pytest.fixture
def tiff_reader():
    if _native.get_lib() is None:
        pytest.skip(f"the libtiff reader is absent here: {_native.DECODERS['tiff']}")
    return _native


def _raster(dtype, bands: int, rng) -> np.ndarray:
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=(37, 29, bands)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), (37, 29, bands)).astype(dtype)


@pytest.mark.parametrize("bands", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_tiff_reader_equals_the_numpy_codec(tiff_reader, tmp_path, dtype, bands):
    arr = _raster(dtype, bands, np.random.default_rng(bands))
    for compress, rows in (("deflate", 8), (None, 64)):
        path = tmp_path / f"x_{compress}.tif"
        geotiff.write_geotiff(path, arr, compress=compress, rows_per_strip=rows)
        native = tiff_reader.read_pixels_native(path)
        plain, _ = geotiff.read_geotiff_numpy(path)
        assert native.dtype == plain.dtype == arr.dtype
        np.testing.assert_array_equal(native, plain)
        np.testing.assert_array_equal(native, arr)


def test_native_read_keeps_the_geo_tags(tiff_reader, tmp_path):
    arr = np.random.default_rng(2).integers(0, 255, (16, 16, 3)).astype(np.uint8)
    geo = jgeotiff.GeoInfo(jgeotiff.Affine(0.5, 0, 100.0, 0, -0.5, 200.0), epsg=32617, nodata=7)
    path = tmp_path / "g.tif"
    jgeotiff.write_geotiff(path, arr, geo)
    img, got = geotiff.read_geotiff(path)
    _, plain = geotiff.read_geotiff_numpy(path)
    np.testing.assert_array_equal(img, arr)
    assert got == plain == geotiff.read_geo_only(path)
    assert (got.epsg, got.nodata) == (32617, 7.0)
    assert (got.transform.a, got.transform.c, got.transform.f) == (0.5, 100.0, 200.0)
