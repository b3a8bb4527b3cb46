"""The port's ``test`` / ``predict`` subcommands end to end on the CPU, on a
tiny synthetic CSV dataset, plus its GeoTIFF codec against the JAX
package's."""

import copy
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_tiny import register_tiny

from geo_deep_learning_tpu.data.geotiff import read_geotiff as jax_read
from geo_deep_learning_tpu.data.geotiff import write_geotiff as jax_write
from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import load_config
from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff, write_geotiff

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "dofa_upernet_waterloo.yaml"
N = 5  # samples: with batch 2 the last batch is padded


def _dataset(root: Path) -> None:
    rng = np.random.default_rng(0)
    rows = []
    for split in ("image", "label"):
        (root / "tst" / split).mkdir(parents=True, exist_ok=True)
    for i in range(N):
        write_geotiff(root / "tst" / "image" / f"{i}.tif",
                      rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        write_geotiff(root / "tst" / "label" / f"{i}_lbl.tif",
                      rng.integers(0, 2, (64, 64), dtype=np.uint8))
        rows.append(f"tst/image/{i}.tif;tst/label/{i}_lbl.tif")
    (root / "tst.csv").write_text("\n".join(rows) + "\n")


@pytest.fixture
def config(tmp_path, monkeypatch):
    register_tiny(monkeypatch)
    _dataset(tmp_path / "data")
    cfg = load_config(PORT_CONFIG)
    cfg["trainer"]["default_root_dir"] = str(tmp_path / "run")
    args = cfg["model"]["init_args"]
    args.update(encoder="tiny", image_size=[64, 64], decoder_channels=32)
    data = cfg["data"]["init_args"]
    data.update(csv_root_folder=str(tmp_path / "data"),
                patches_root_folder=str(tmp_path / "data"), batch_size=2, patch_size=[64, 64])
    return cfg


@pytest.mark.parametrize("precision", ["32-true", "bf16-mixed"])
def test_test_subcommand(config, precision):
    config["trainer"]["precision"] = precision
    result = cli.run(config, "test", device="cpu")
    for key in ("test_loss", "test_miou", "test_accuracy", "test_mf1",
                "test_iou_background", "test_iou_building"):
        assert np.isfinite(result[key]), key
    assert 0.0 <= result["test_miou"] <= 1.0
    assert result == cli.run(copy.deepcopy(config), "test", device="cpu")  # seeded


def test_main_parses_yaml_and_overrides(config, tmp_path):
    import yaml

    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump(config))
    result = cli.main(["test", "--config", str(path), "--device", "cpu",
                       "trainer.precision=32-true"])
    config["trainer"]["precision"] = "32-true"
    assert result == cli.run(config, "test", device="cpu")


def test_run_archives_the_merged_config(config, tmp_path):
    import yaml

    want = yaml.safe_dump(config)
    cli.run(config, "test", device="cpu")
    runs = tmp_path / "run" / "checkpoints"
    archived = list(runs.glob("run-*/artifacts/config/run_config.yaml"))
    assert len(archived) == 1
    assert archived[0].read_text() == want


@pytest.mark.parametrize("with_yaml", [True, False])
def test_dump_config_loads_back_equal(config, monkeypatch, with_yaml):
    import yaml

    if not with_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    # floats PyYAML reads back only with a point, a non-finite one, other scalars
    config["trainer"]["limits"] = [1e-05, 0.5, -2.5e-12, 1e300, float("inf"), 3, None, "6e-05",
                                   {}, []]
    text = cli.dump_config(config)
    if with_yaml:
        assert text == yaml.safe_dump(config)
    else:
        assert json.loads(text.replace(".inf", "Infinity")) == config
    assert yaml.safe_load(text) == config


def test_predict_writes_rasters_the_jax_package_reads(config, tmp_path):
    result = cli.run(config, "predict", device="cpu")
    files = sorted(Path(result["output_dir"]).glob("*_pred.tif"))
    assert result["num_predictions"] == N and result["num_batches"] == 3
    assert [f.name for f in files] == [f"{i}_pred.tif" for i in range(N)]
    for f in files:
        ours, _ = read_geotiff(f)
        theirs, _ = jax_read(f)
        assert theirs.shape == (64, 64, 1) and theirs.dtype == np.uint8
        assert np.array_equal(ours, theirs)
        assert set(np.unique(theirs)) <= {0, 1}


def test_init_weights_writes_every_tensor(monkeypatch):
    """The model is built on the meta device and allocated uninitialised;
    ``init_weights`` must write every parameter and buffer."""
    from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation

    register_tiny(monkeypatch)
    model = DOFASegmentation("tiny", num_classes=2, decoder_channels=32, img_size=64)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.fill_(float("nan") if t.is_floating_point() else -1)
    model.init_weights(torch.Generator().manual_seed(0))
    for name, t in model.state_dict().items():
        ok = torch.isfinite(t).all() if t.is_floating_point() else (t >= 0).all()
        assert ok, name


def test_unported_paths_raise(config):
    with pytest.raises(ValueError, match="not ported"):
        cli.run(config, "export", device="cpu")
    config["model"]["init_args"]["weights_from_checkpoint_path"] = "some.ckpt"
    with pytest.raises(FileNotFoundError):  # a missing warm-start file, as in JAX
        cli.run(config, "test", device="cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_chip_smoke_config_is_the_port_config():
    assert _chip_smoke().CONFIG == load_config(PORT_CONFIG)


def test_chip_smoke_segformer_config_is_the_port_config():
    path = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "segformer_waterloo.yaml"
    assert _chip_smoke().SEGFORMER_CONFIG == load_config(path)


def test_chip_smoke_unetplus_config_is_the_port_config():
    path = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "unetplus_waterloo.yaml"
    assert _chip_smoke().UNETPLUS_CONFIG == load_config(path)


def test_unetplus_task_aliases():
    """The reference's and the JAX package's class paths name the port's
    UNet++ task."""
    from geo_deep_learning_tpu_torch.cli.config import import_class
    from geo_deep_learning_tpu_torch.tasks import SegmentationUnetPlus

    for path in ("tasks_with_models.segmentation_unetplus.SegmentationUnetPlus",
                 "geo_deep_learning_tpu.tasks.SegmentationUnetPlus",
                 "geo_deep_learning_tpu.tasks.segmentation.SegmentationUnetPlus"):
        assert import_class(path) is SegmentationUnetPlus


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("compress", [None, "deflate"])
def test_geotiff_round_trips_with_the_jax_codec(tmp_path, dtype, compress):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((70, 33, 2)) * 50).astype(dtype)
    write_geotiff(tmp_path / "a.tif", arr, compress=compress, rows_per_strip=16)
    assert np.array_equal(jax_read(tmp_path / "a.tif")[0], arr)
    jax_write(tmp_path / "b.tif", arr, compress="lzw")
    assert np.array_equal(read_geotiff(tmp_path / "b.tif")[0], arr)


def test_geotiff_reads_geo_tags_the_jax_codec_writes(tmp_path):
    from geo_deep_learning_tpu.data.geotiff import Affine, GeoInfo

    geo = GeoInfo(Affine(0.5, 0.0, 500000.0, 0.0, -0.5, 5000000.0), epsg=32617, nodata=255.0)
    jax_write(tmp_path / "g.tif", np.zeros((8, 8), np.uint8), geo=geo)
    _, got = read_geotiff(tmp_path / "g.tif")
    t = got.transform
    assert (t.a, t.b, t.c, t.d, t.e, t.f) == (0.5, 0.0, 500000.0, 0.0, -0.5, 5000000.0)
    assert (got.epsg, got.nodata) == (32617, 255.0)


def test_geotiff_reads_the_waterloo_patches():
    image, _ = read_geotiff(ROOT / "data/waterloo/tst/image/0.tif")
    mask, _ = read_geotiff(ROOT / "data/waterloo/tst/label/0_lbl.tif")
    assert image.shape == (512, 512, 3) and image.dtype == np.uint8
    assert np.array_equal(image, jax_read(ROOT / "data/waterloo/tst/image/0.tif")[0])
    assert mask.shape == (512, 512, 1) and set(np.unique(mask)) <= {0, 1}
