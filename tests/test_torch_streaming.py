"""The port's streaming / multi-sensor data stack against the JAX package's.

The same tar shards and CSV datasets (written from a fixed numpy seed) go
through both packages' ``shard_dataset``, ``samplers``, ``multisensor`` and
``multisensor_csv``; samples and batches must be equal, element for
element, in the same order (both are numpy on the host). Then the port's
own additions: reader errors raised in the consumer, no ``gdl-loader``
thread left after an early exit, the registry read as JSON without PyYAML,
the in-repo DOFA recipes and the converter end to end, a tiny DOFA trained
over a two-sensor stream against the JAX train step, and ``predict-scene``
with a multi-sensor config.
"""

import builtins
import functools
import importlib.util
import io
import json
import tarfile
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import jax_variables, register_tiny, tiny_model

import geo_deep_learning_tpu.models.segmentation.dofa as jsegdofa
from geo_deep_learning_tpu.core.precision import PrecisionPolicy as JaxPrecision
from geo_deep_learning_tpu.core.train_state import TrainState as JaxState
from geo_deep_learning_tpu.data import multisensor as jms
from geo_deep_learning_tpu.data import multisensor_csv as jmcsv
from geo_deep_learning_tpu.data import samplers as jsamplers
from geo_deep_learning_tpu.data import shard_dataset as jshard
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.heads.fcn import FCNHead as JaxFCNHead
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training import optim as joptim
from geo_deep_learning_tpu.training import steps as jsteps
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import import_class, instantiate, load_config
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.data import loader as tloader
from geo_deep_learning_tpu_torch.data import multisensor as tms
from geo_deep_learning_tpu_torch.data import multisensor_csv as tmcsv
from geo_deep_learning_tpu_torch.data import samplers as tsamplers
from geo_deep_learning_tpu_torch.data import shard_dataset as tshard
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.tools.make_shards import make_shards
from geo_deep_learning_tpu_torch.training import optim as toptim
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

ROOT = Path(__file__).resolve().parents[1]
RECIPES = ("dofa_config_RGB.yaml", "dofa_config_RGB_onecycle.yaml")
WAVES = {"rgb": [0.665, 0.549, 0.481], "rgbn": [0.665, 0.549, 0.481, 0.842]}
SIZE = 16
# (sensor, bands, shards per split, patches per shard)
SENSORS = (("rgb", 3, 2, 5), ("rgbn", 4, 1, 7))


def _meta(wavelengths) -> dict:
    names = ("red", "green", "blue", "nir")
    return {"metadata": {"datetime": "2023-06-15T14:30:00Z", "coordinates_lat": 45.4,
                         "coordinates_lon": -75.7,
                         **{f"{n}_wavelength": w for n, w in zip(names, wavelengths)}}}


def _write_shard(path: Path, keys, bands: int, rng, wavelengths) -> None:
    with tarfile.open(path, "w") as tar:
        for key in keys:
            img = rng.integers(0, 256, (bands, SIZE, SIZE)).astype(np.uint8)
            lbl = rng.integers(0, 3, (1, SIZE, SIZE)).astype(np.uint8)
            for field, payload in (("image_patch.npy", img), ("label_patch.npy", lbl),
                                   ("metadata.json", _meta(wavelengths))):
                if field.endswith("npy"):
                    buf = io.BytesIO()
                    np.save(buf, payload)
                    raw = buf.getvalue()
                else:
                    raw = json.dumps(payload).encode()
                info = tarfile.TarInfo(f"{key}.{field}")
                info.size = len(raw)
                tar.addfile(info, io.BytesIO(raw))


@pytest.fixture(scope="module")
def registry(tmp_path_factory) -> Path:
    """A 3-band and a 4-band sensor in the reference layout, from one seeded
    numpy generator, and a JSON registry."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(7)
    sensors = {}
    for sensor, bands, n_shards, per_shard in SENSORS:
        sdir = root / sensor
        manifest = {"shards": {}, "statistics": {"patch_counts": {}}}
        for split in ("trn", "val", "tst"):
            (sdir / split).mkdir(parents=True)
            entries = []
            for s in range(n_shards):
                name = f"shard-{s:04d}.tar"
                keys = [f"{sensor}_{split}_{s}_{i}" for i in range(per_shard)]
                _write_shard(sdir / split / name, keys, bands, rng, WAVES[sensor])
                entries.append({"path": name})
            manifest["shards"][split] = entries
            manifest["statistics"]["patch_counts"][split] = n_shards * per_shard
        (sdir / "manifest.json").write_text(json.dumps(manifest))
        stats = {"mean": [120.0, 110.0, 100.0, 90.0][:bands],
                 "std": [50.0, 45.0, 55.0, 60.0][:bands], "band_count": bands, "patch_count": n_shards * per_shard, "dtype": "uint8"}
        (sdir / "stats.json").write_text(json.dumps({"statistics": {sensor: stats}}))
        sensors[sensor] = {"manifest_path": str(sdir / "manifest.json"), "parent_dir": str(sdir),
                           "stats_path": str(sdir / "stats.json")}
    path = root / "sensors.json"
    path.write_text(json.dumps(sensors))
    return path


def assert_same(got, want, where="") -> None:
    """Equal samples or batches: the same keys, arrays equal in value,
    dtype and shape, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], (dict, np.ndarray)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _datasets(registry: Path, split: str, sensor: str, **kw):
    config = json.loads(registry.read_text())[sensor]
    paths, count = tshard.create_shard_split_paths(config["manifest_path"], split,
                                                   config["parent_dir"])
    assert (paths, count) == jshard.create_shard_split_paths(config["manifest_path"], split,
                                                             config["parent_dir"])
    args = dict(sensor_name=sensor, shard_paths=paths, patch_count=count,
                normalization_stats_path=config["stats_path"], split=split, **kw)
    return tshard.ShardedDataset(**args), jshard.ShardedDataset(**args)


@pytest.mark.parametrize("model_type", ["dofa", "clay", "unified"])
def test_tar_samples_and_process_sample_match_jax(registry, model_type):
    """``iter_tar_samples`` groups the same members into the same samples,
    and ``process_sample`` (stats / 255, CHW -> HWC, the label squeeze, the
    format's extra fields) gives equal samples."""
    for sensor in WAVES:
        port, ref = _datasets(registry, "tst", sensor, model_type=model_type)
        for shard in port.shard_paths:
            got, want = list(tshard.iter_tar_samples(shard)), list(jshard.iter_tar_samples(shard))
            assert len(got) == len(want) > 0
            assert_same(got, want, shard)
            for raw in got:
                sample = port.process_sample(raw)
                assert_same(sample, ref.process_sample(raw), sample["image_name"])
                assert sample["image"].shape == (SIZE, SIZE, len(WAVES[sensor]))
                assert sample["mask"].shape == (SIZE, SIZE) and sample["mask"].dtype == np.int32
                if model_type == "dofa":
                    np.testing.assert_allclose(sample["wavelengths"], WAVES[sensor], rtol=1e-6)


def test_process_sample_fallbacks_match_jax(registry):
    """A sample without wavelengths (zeros and a warning), CLAY fields from
    bad metadata (zeros), and the HWC label squeeze."""
    port, ref = _datasets(registry, "tst", "rgb", model_type="dofa")
    raw = next(tshard.iter_tar_samples(port.shard_paths[0]))
    bare = dict(raw, **{"metadata.json": {"metadata": {}}})
    bare["label_patch.npy"] = np.zeros((SIZE, SIZE, 1), np.uint8)
    assert_same(port.process_sample(bare), ref.process_sample(bare))
    assert not port.process_sample(bare)["wavelengths"].any()
    for fn in ("encode_temporal",):
        for text in ("2023-06-15T14:30:00Z", "not a date", "2024-01-01T00:00:00+00:00"):
            assert_same(getattr(tshard, fn)(text), getattr(jshard, fn)(text))
    for lat, lon in ((45.4, -75.7), (None, 3.0), ("x", 1.0)):
        assert_same(tshard.encode_spatial(lat, lon), jshard.encode_spatial(lat, lon))


@pytest.mark.parametrize("split,epoch,worker,workers,buffer,shardshuffle", [
    ("trn", 0, 0, 1, 4, 100), ("trn", 3, 0, 1, 4, 100), ("trn", 1, 1, 2, 3, 100),
    ("trn", 2, 0, 1, 1, None), ("val", 1, 0, 2, 4, 100), ("tst", 0, 0, 1, 4, 100)])
def test_iter_samples_order_matches_jax(registry, split, epoch, worker, workers, buffer,
                                        shardshuffle):
    """The shard shuffle (``seed + epoch``), the worker's shard stride and
    the shuffle buffer (``seed + 7919 (epoch + 1) + worker``) give the same
    samples in the same order."""
    for sensor in WAVES:
        port, ref = _datasets(registry, split, sensor, model_type="dofa", shuffle_buffer=buffer,
                              shardshuffle=shardshuffle, seed=5)
        got = list(port.iter_samples(epoch, worker, workers))
        want = list(ref.iter_samples(epoch, worker, workers))
        assert [s["image_name"] for s in got] == [s["image_name"] for s in want]
        assert_same(got, want)


@pytest.mark.parametrize("seed,probs,lengths", [(0, None, (3, 5)), (11, [0.2, 0.8], (4, 4)),
                                                (3, None, (1, 6, 2))])
def test_random_mix_matches_jax(seed, probs, lengths):
    if probs is not None and len(probs) != len(lengths):
        probs = None

    def streams():
        return [iter([(i, j) for j in range(n)]) for i, n in enumerate(lengths)]

    got = list(tms.random_mix(streams(), seed, probs))
    assert got == list(jms.random_mix(streams(), seed, probs))
    assert sorted(got) == sorted((i, j) for i, n in enumerate(lengths) for j in range(n))


def _toy_stream(n: int, tag: int = 0):
    def make(epoch):
        rng = np.random.default_rng(1000 * tag + epoch)
        return iter([{"image": rng.random((2, 2), dtype=np.float32), "mask": np.int32(i),
                      "platform": f"s{tag}"} for i in range(n)])
    return make


@pytest.mark.parametrize("n,bs,drop,epoch_size,cycle,multi", [
    (7, 3, False, None, False, False),  # padded tail, valid_count 1
    (7, 3, True, None, False, False),
    (7, 3, True, 12, True, False),      # cycling past the data
    (10, 4, False, 6, False, False),    # capped, padded
    (5, 2, True, 8, True, True),        # two streams, mixed whole batches, cycled
    (5, 2, False, 10, False, True),
])
def test_stream_batcher_matches_jax(n, bs, drop, epoch_size, cycle, multi):
    """Batches, padding, ``valid_count``, ``len``, cycling and mixing over
    three epochs."""
    def make(epoch):
        if multi:
            return [_toy_stream(n, 1)(epoch), _toy_stream(n + 2, 2)(epoch)]
        return _toy_stream(n)(epoch)

    kw = dict(batch_size=bs, drop_partial=drop, epoch_size=epoch_size, mix_seed=3, cycle=cycle)
    port, ref = tms.StreamBatcher(make, **kw), jms.StreamBatcher(make, **kw)
    if epoch_size is not None:
        assert len(port) == len(ref)
    for _ in range(3):
        got, want = list(port), list(ref)
        assert got and len(got) == len(want)
        assert_same(got, want)
        if epoch_size is not None and (drop or cycle):
            assert len(got) == len(port)
    assert port.epoch == ref.epoch == 3


def _module_kw(registry):
    return dict(sensor_configs_path=str(registry), model_type="dofa", batch_size=3,
                epoch_size=12, shuffle_buffer=4, seed=9)


@pytest.mark.parametrize("split", ["trn", "val", "tst"])
def test_multisensor_datamodule_batches_match_jax(registry, split):
    """A 3-band and a 4-band sensor: the same single-sensor batches in the
    same order for two epochs (train: ``epoch_size`` 12 from 10 + 7
    patches, cycled; val/test: padded per sensor, with ``valid_count``)."""
    port, ref = tms.MultiSensorDataModule(**_module_kw(registry)), jms.MultiSensorDataModule(
        **_module_kw(registry))
    port.setup("fit")
    ref.setup("fit")
    loaders = [getattr(m, {"trn": "train", "val": "val", "tst": "test"}[split] + "_dataloader")()
               for m in (port, ref)]
    assert len(loaders[0]) == len(loaders[1])
    channels = set()
    for _ in range(2):
        got, want = list(loaders[0]), list(loaders[1])
        assert_same(got, want, split)
        for batch in got:
            assert len(set(batch["platform"])) == 1  # single-sensor batches
            channels.add(batch["image"].shape[-1])
            assert batch["wavelengths"].shape == batch["image"].shape[::3]
        if split != "trn":
            assert sum(int(b["valid_count"]) for b in got) == 10 + 7
    assert channels == {3, 4}


def test_fit_epoch_numbers_align_with_jax(registry):
    """The port's fit advances the train loader's epoch by one in place of
    the JAX fit's peek at a batch: the epochs that follow see the same
    batches."""
    port, ref = tms.MultiSensorDataModule(**_module_kw(registry)), jms.MultiSensorDataModule(
        **_module_kw(registry))
    port.setup("fit")
    ref.setup("fit")
    tl, jl = port.train_dataloader(), ref.train_dataloader()
    tl.epoch += 1
    next(iter(jl))
    for _ in range(2):
        assert_same(list(tl), list(jl))


SIZES = {"a": 10, "b": 23, "c": 4}


@pytest.mark.parametrize("weights", ["equal", "proportional", {"a": 2, "b": 1, "c": 3}])
@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_round_robin_sampler_matches_jax(weights, balance, drop_last):
    kw = dict(batch_size=3, weights=weights, balance=balance, drop_last=drop_last, seed=4)
    port, ref = tsamplers.RoundRobinSampler(SIZES, **kw), jsamplers.RoundRobinSampler(SIZES, **kw)
    assert port.weights == ref.weights and len(port) == len(ref)
    for epoch in (0, 1, 5):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(port) == list(ref)


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (3, 2)])
def test_distributed_sampler_matches_jax(world, rank):
    kw = dict(num_replicas=world, rank=rank, batch_size=2, seed=1)
    port = tsamplers.create_round_robin_sampler(SIZES, distributed=True, **kw)
    ref = jsamplers.create_round_robin_sampler(SIZES, distributed=True, **kw)
    assert isinstance(port, tsamplers.RoundRobinDistributedSampler)
    for epoch in (0, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(port) == list(ref)
    with pytest.raises(ValueError, match="rank"):
        tsamplers.RoundRobinDistributedSampler(SIZES, num_replicas=2, rank=2)
    # without a process group: one replica, rank 0
    alone = tsamplers.RoundRobinDistributedSampler(SIZES)
    assert (alone.num_replicas, alone.rank) == (1, 0)


@pytest.fixture(scope="module")
def csv_sensors(tmp_path_factory) -> dict:
    """Two CSV sensors from one 4-band dataset: RGB bands and a band-reversed
    pair, each with its own statistics and wavelengths."""
    root = tmp_path_factory.mktemp("ms_csv")
    rng = np.random.default_rng(3)
    for split, n in (("trn", 7), ("val", 5), ("tst", 3)):
        (root / split / "image").mkdir(parents=True)
        (root / split / "label").mkdir(parents=True)
        rows = []
        for i in range(n):
            write_geotiff(root / split / "image" / f"{i}.tif",
                          rng.integers(0, 256, (SIZE, SIZE, 4), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{i}_lbl.tif",
                          rng.integers(0, 2, (SIZE, SIZE), dtype=np.uint8))
            rows.append(f"{split}/image/{i}.tif;{split}/label/{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return {
        "rgb": {"csv_root_folder": str(root), "band_indices": [0, 1, 2],
                "mean": [0.4, 0.41, 0.42], "std": [0.2, 0.21, 0.22],
                "wavelengths": WAVES["rgb"]},
        "nir": {"csv_root_folder": str(root), "band_indices": [3, 0],
                "mean": [0.5, 0.4], "std": [0.25, 0.2], "wavelengths": [0.842, 0.665]},
    }


def _int64_masks(batch: dict) -> dict:
    """The port's ``CSVDataset`` gives int64 masks (torch's index type),
    the JAX package's int32: equal values."""
    return dict(batch, mask=batch["mask"].astype(np.int64))


@pytest.mark.parametrize("device_preprocess", [True, False], ids=["uint8", "float"])
def test_multisensor_csv_batches_match_jax(csv_sensors, device_preprocess):
    """Round-robin training batches (two epochs, balanced) and the padded
    per-sensor evaluation batches equal the JAX package's; uint8 batches
    carry ``[B, C]`` statistics for the card's normalize."""
    kw = dict(batch_size=3, num_workers=2, device_preprocess=device_preprocess, seed=6)
    port = tmcsv.MultiSensorCSVDataModule(csv_sensors, **kw)
    ref = jmcsv.MultiSensorCSVDataModule(csv_sensors, **kw)
    port.setup("fit")
    ref.setup("fit")
    train, jtrain = port.train_dataloader(), ref.train_dataloader()
    assert len(train) == len(jtrain) == 4
    for _ in range(2):
        got, want = list(train), [_int64_masks(b) for b in jtrain]
        assert_same(got, want)
    for batch in got:
        sensor = batch["platform"][0]
        c = len(csv_sensors[sensor]["band_indices"])
        assert batch["image"].shape == (3, SIZE, SIZE, c)
        assert batch["image"].dtype == (np.uint8 if device_preprocess else np.float32)
        assert batch["mean"].shape == batch["std"].shape == batch["wavelengths"].shape == (3, c)
    for split in ("val", "test"):
        got = list(getattr(port, f"{split}_dataloader")())
        want = list(getattr(ref, f"{split}_dataloader")())
        for batch in want:  # the JAX loader's counts are numpy scalars
            batch["valid_count"] = int(batch["valid_count"])
        assert_same(got, [_int64_masks(b) for b in want], split)


class _Broken:
    def __init__(self, n: int, bad: int) -> None:
        self.n, self.bad = n, bad

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            msg = f"unreadable sample {i}"
            raise OSError(msg)
        return {"image": np.zeros((2, 2, 3), np.float32), "mask": np.zeros((2, 2), np.int64)}


def _loader_threads() -> list[str]:
    deadline = time.monotonic() + 5.0
    while True:
        alive = [t.name for t in threading.enumerate() if t.name.startswith(tloader.THREAD_PREFIX)]
        if not alive or time.monotonic() > deadline:
            return alive
        time.sleep(0.02)


def test_reader_errors_are_raised_in_the_consumer():
    """A producer's exception ends the epoch with that exception, for the
    stream (the JAX producer ends it silently) and for the round-robin
    loader; no thread is left."""
    def make(epoch):
        def gen():
            yield {"image": np.zeros((2, 2), np.float32)}
            msg = "shard decode failed"
            raise ValueError(msg)
        return gen()

    with pytest.raises(ValueError, match="shard decode failed"):
        list(tms.StreamBatcher(make, batch_size=1, drop_partial=False))
    sampler = tsamplers.RoundRobinSampler({"a": 6}, batch_size=2, shuffle=False)
    loader = tmcsv.RoundRobinLoader({"a": _Broken(6, 3)}, sampler, num_workers=2)
    with pytest.raises(OSError, match="unreadable sample 3"):
        list(loader)
    assert _loader_threads() == []


def test_no_loader_thread_left_after_an_early_break(registry, csv_sensors):
    """Leaving a loader after one batch (break, or a dropped generator)
    stops and joins its threads; a stalled consumer does not block the
    producer's exit."""
    dm = tms.MultiSensorDataModule(**_module_kw(registry))
    dm.setup("fit")
    for batch in dm.train_dataloader():
        time.sleep(0.3)  # the producer fills its queue meanwhile
        break
    it = iter(dm.val_dataloader())
    next(it)
    del it
    cm = tmcsv.MultiSensorCSVDataModule(csv_sensors, batch_size=2, num_workers=3)
    cm.setup("fit")
    for loader in (cm.train_dataloader(), cm.val_dataloader()):
        for batch in loader:
            break
    assert batch["image"].shape[0] == 2
    assert _loader_threads() == []


def test_load_sensor_configs_reads_json_without_yaml(registry, monkeypatch):
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            msg = "No module named 'yaml'"
            raise ImportError(msg)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    got = tshard.load_sensor_configs(str(registry))
    assert got == json.loads(registry.read_text()) and set(got) == set(WAVES)
    bad = registry.with_name("bad.yaml")
    bad.write_text("rgb:\n  manifest_path: x\n")
    with pytest.raises(json.JSONDecodeError):
        tshard.load_sensor_configs(str(bad))


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_yamls_instantiate_the_ports_classes(registry, recipe):
    cfg = load_config(ROOT / "configs" / recipe,
                      [f"data.init_args.sensor_configs_path={registry}"])
    dm = instantiate(cfg["data"])
    assert type(dm) is tms.MultiSensorDataModule
    assert (dm.model_type, dm.batch_size, dm.epoch_size) == ("dofa", 8, 4096)
    dm.setup("fit")
    assert set(dm.datasets) == set(WAVES)
    for path, want in (
        ("datamodules.wds_datamodule.MultiSensorDataModule", tms.MultiSensorDataModule),
        ("geo_deep_learning_tpu.data.multisensor_csv.MultiSensorCSVDataModule",
         tmcsv.MultiSensorCSVDataModule),
        ("datamodules.imagery_NonGeoDataModule.BlueSkyNonGeoDataModule",
         import_class("geo_deep_learning_tpu_torch.data.datamodule.CSVDataModule")),
    ):
        assert import_class(path) is want


@pytest.mark.parametrize("onecycle", [False, True], ids=["RGB", "onecycle"])
def test_chip_smoke_recipe_dicts_equal_the_yamls(tmp_path, onecycle):
    """``chip_smoke.py`` mirrors both recipes as dicts (the card's machine
    has no YAML parser): with its overrides they equal the port's
    ``load_config`` of the YAML files with the same overrides."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    registry, root = tmp_path / "sensors.json", tmp_path / "run"
    want = load_config(ROOT / "configs" / RECIPES[onecycle], [
        f"data.init_args.sensor_configs_path={registry}",
        f"data.init_args.epoch_size={smoke.MS_EPOCH_SIZE}",
        f"trainer.max_epochs={smoke.FIT_EPOCHS}", f"trainer.default_root_dir={root}",
        "model.init_args.freeze_layers=[]"])
    assert smoke.recipe_config(onecycle, registry, root) == want


def _waterloo_like(root: Path, n: dict, size: int = 64, classes: int = 5) -> Path:
    rng = np.random.default_rng(2)
    for split, count in n.items():
        (root / split / "image").mkdir(parents=True)
        (root / split / "label").mkdir(parents=True)
        rows = []
        for i in range(count):
            write_geotiff(root / split / "image" / f"{split}{i}.tif",
                          rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{split}{i}_lbl.tif",
                          rng.integers(0, classes, (size, size), dtype=np.uint8))
            rows.append(f"{split}/image/{split}{i}.tif;{split}/label/{split}{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def converted(tmp_path_factory) -> Path:
    """The port's converter over a small CSV dataset: an RGB sensor and an
    RGB + synthetic NIR (band 0 again) sensor in one JSON registry."""
    root = tmp_path_factory.mktemp("convert")
    data = _waterloo_like(root / "csv", {"trn": 6, "val": 3, "tst": 3})
    make_shards(data, root / "shards", "rgb", per_shard=4, wavelengths=WAVES["rgb"])
    return make_shards(data, root / "shards", "rgbn", per_shard=4, wavelengths=WAVES["rgbn"],
                       band_indices=[0, 1, 2, 0])


def test_make_shards_layout_streams_equal_in_both_packages(converted):
    """The converter's shards, manifests, statistics and JSON registry
    stream the same batches through the port and the JAX package; the
    synthetic band repeats band 0, and the statistics are the training
    images'."""
    registry = json.loads(converted.read_text())
    assert set(registry) == {"rgb", "rgbn"}
    assert registry["rgbn"]["wavelength_keys"][-1] == "nir_wavelength"
    stats = json.loads(Path(registry["rgbn"]["stats_path"]).read_text())["statistics"]["rgbn"]
    assert stats["band_count"] == 4 and stats["mean"][3] == stats["mean"][0]
    sample = next(tshard.iter_tar_samples(Path(registry["rgbn"]["parent_dir"]) / "trn" /
                                          "shard-0000.tar"))
    img = sample["image_patch.npy"]
    assert img.shape == (4, 64, 64) and np.array_equal(img[3], img[0])
    kw = dict(sensor_configs_path=str(converted), model_type="dofa", batch_size=2, epoch_size=8)
    port, ref = tms.MultiSensorDataModule(**kw), jms.MultiSensorDataModule(**kw)
    port.setup("fit")
    ref.setup("fit")
    for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
        assert_same(list(getattr(port, name)()), list(getattr(ref, name)()), name)


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_fits_through_the_cli(converted, tmp_path, monkeypatch, recipe):
    """``python -m ...cli.main fit --config configs/<recipe>`` with the
    registry overridden, at a test's size (tiny DOFA at 64^2, f32, CPU),
    instantiates the port's ``MultiSensorDataModule`` and trains; the
    OneCycle recipe takes its step count from ``epoch_size``."""
    register_tiny(monkeypatch)
    root = tmp_path / "run"
    result = cli.main(["fit", "--config", str(ROOT / "configs" / recipe), "--device", "cpu",
                       f"data.init_args.sensor_configs_path={converted}",
                       "data.init_args.epoch_size=8", "data.init_args.batch_size=2",
                       "model.init_args.encoder=tiny", "model.init_args.image_size=[64,64]",
                       "model.init_args.decoder_channels=32", "trainer.max_epochs=2",
                       "trainer.precision=32-true", f"trainer.default_root_dir={root}"])
    for key in ("train_loss", "val_loss", "test_loss", "test_miou"):
        assert np.isfinite(result[key]), key
    last = torch.load(root / "checkpoints" / "last.pt", weights_only=True)
    assert last["step"] == 2 * 4  # epoch_size 8 / batch 2, two epochs
    if "onecycle" in recipe:  # 8 steps: the schedule ends at max_lr / 25 / 1e4
        assert result["lr"] == pytest.approx(6e-4 / 25 / 1e4, rel=1e-6)
    assert _loader_threads() == []


def test_predict_scene_with_a_multisensor_config(converted, tmp_path, monkeypatch):
    """A data module without ``norm_stats`` serves a scene with ``/255``
    alone, as the JAX CLI does."""
    register_tiny(monkeypatch)
    scene = tmp_path / "scene.tif"
    write_geotiff(scene, np.random.default_rng(5).integers(0, 256, (150, 130, 3), dtype=np.uint8))
    cfg = load_config(ROOT / "configs" / "dofa_config_RGB.yaml", [
        f"data.init_args.sensor_configs_path={converted}", "model.init_args.encoder=tiny",
        "model.init_args.image_size=[64,64]", "model.init_args.decoder_channels=32",
        f"trainer.default_root_dir={tmp_path / 'run'}"])
    out = tmp_path / "map.tif"
    result = cli.run(cfg, "predict-scene", device="cpu",
                     scene=cli.SceneOptions(str(scene), str(out), 64, 16, 4))
    assert result["output"] == str(out) and out.exists()
    from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff

    classes, _ = read_geotiff(out)
    assert classes.shape[:2] == (150, 130) and classes.max() < 5


# -- a tiny DOFA trained over a two-sensor stream, port against JAX ---------

def _jax_setup(monkeypatch, model):
    monkeypatch.setattr(jsegdofa, "DOFAv2", functools.partial(JaxDOFAv2, drop_path_rate=0.0))
    monkeypatch.setattr(jsegdofa, "FCNHead", functools.partial(JaxFCNHead, dropout_ratio=0.0))
    table = model.encoder.pos_embed.numpy()
    jmodel = jsegdofa.DOFASegmentation(encoder_name="tiny", num_classes=5, decoder_channels=32,
                                       pos_embed_table=table)
    return JaxTask(jmodel, JaxDice(mode="multiclass"), num_classes=5), jax_variables(model)


def test_tiny_dofa_fit_over_a_two_sensor_stream_matches_jax(converted, monkeypatch):
    """Two epochs of the train loop (the port's fit advances the loader's
    epoch in place of the JAX peek) over the converter's 3- and 4-band
    sensors, f32 on both sides, SGD: the batches are equal and the per-step
    losses agree within 1e-5 (f32 through five blocks and the decoder,
    summed in other orders; observed about 1e-6)."""
    register_tiny(monkeypatch)
    model = tiny_model(5)
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    jtask, variables = _jax_setup(monkeypatch, model)
    task = SegmentationTask(model, DiceLoss(mode="multiclass"), num_classes=5)
    kw = dict(sensor_configs_path=str(converted), model_type="dofa", batch_size=2, epoch_size=6)
    port, ref = tms.MultiSensorDataModule(**kw), jms.MultiSensorDataModule(**kw)
    port.setup("fit")
    ref.setup("fit")
    tl, jl = port.train_dataloader(), ref.train_dataloader()
    tl.epoch += 1
    next(iter(jl))
    tx = joptim.build_optimizer(variables["params"], "sgd", lr=1e-2, grad_clip=1.0)
    jstate = JaxState.create(apply_fn=jtask.model.apply, params=variables["params"], tx=tx,
                             batch_stats=variables["batch_stats"])
    jstep = jsteps.make_train_step(jtask, JaxPrecision.create("32-true"), augment=None)
    opt = toptim.build_optimizer(list(model.parameters()), "sgd", 1e-2)
    state = TrainState.create(model, opt, seed=0)
    step = tsteps.make_train_step(task, PrecisionPolicy.create("32-true"), augment=None,
                                  grad_clip=1.0)
    channels, losses = set(), []
    for _ in range(2):
        for batch, jbatch in zip(tl, jl, strict=True):
            assert_same(batch, jbatch)
            channels.add(batch["image"].shape[-1])
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jbatch.items()
                                        if k in ("image", "mask", "wavelengths", "mean", "std")})
            got = float(step(state, tsteps.to_device(batch, torch.device("cpu")))["loss"])
            losses.append((got, float(jm["loss"])))
    assert channels == {3, 4} and len(losses) == 6
    for got, want in losses:
        assert abs(got - want) <= 1e-5, losses
