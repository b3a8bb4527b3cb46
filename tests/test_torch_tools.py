"""The port's run record and host tools against the JAX package's: the
tracker factory and its MLflow branch (a stub module: mlflow is not
installed), the file tracker's figures and artifacts, the prediction
figure, ``StepTimer`` / ``trace`` / ``device_memory_stats``,
``setup_logging``, and ``fit``'s logger node and figures on a new best."""

import copy
import json
import logging
import sys
import types
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch
from _torch_tiny import register_tiny

from geo_deep_learning_tpu.config import logging_config as jlogging
from geo_deep_learning_tpu.tools import profiling as jprofiling
from geo_deep_learning_tpu.tools.visualization import visualize_prediction as jvisualize
from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import load_config
from geo_deep_learning_tpu_torch.config import logging_config as tlogging
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.tools import profiling as tprofiling
from geo_deep_learning_tpu_torch.tools import tracking
from geo_deep_learning_tpu_torch.tools.visualization import visualize_prediction as tvisualize
from geo_deep_learning_tpu_torch.training import loop

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "dofa_upernet_waterloo.yaml"
RECIPE = ROOT / "configs" / "dofa_config_RGB.yaml"
JAX_TRACKER = "geo_deep_learning_tpu.tools.tracking"

# -- the tracker factory and its backends -------------------------------------


def _mlflow_stub():
    """An in-memory mlflow with the client calls ``MLflowTracker`` makes
    (the stub of ``tests/test_tools.py``), recording them."""
    stub = types.ModuleType("mlflow")
    stub.calls = {"tracking_uri": None, "experiment": None, "runs": [], "params": {},
                  "metrics": [], "figures": [], "artifacts": [], "texts": [], "ended": 0}
    stub.set_tracking_uri = lambda uri: stub.calls.__setitem__("tracking_uri", uri)
    stub.set_experiment = lambda name: stub.calls.__setitem__("experiment", name)
    stub.start_run = lambda run_name=None: stub.calls["runs"].append(run_name)
    stub.log_params = lambda p: stub.calls["params"].update(p)
    stub.log_metrics = lambda m, step=None: stub.calls["metrics"].append((dict(m), step))
    stub.log_figure = lambda fig, path: stub.calls["figures"].append(path)
    stub.log_artifact = lambda p, artifact_path=None: stub.calls["artifacts"].append(
        (p, artifact_path))
    stub.log_text = lambda text, name: stub.calls["texts"].append((text, name))
    stub.end_run = lambda: stub.calls.__setitem__("ended", stub.calls["ended"] + 1)
    return stub


def test_mlflow_tracker_branch(tmp_path, monkeypatch):
    stub = _mlflow_stub()
    monkeypatch.setitem(sys.modules, "mlflow", stub)
    t = tracking.create_tracker("mlflow", run_name="r5", experiment_name="exp",
                                tracking_uri=f"file:{tmp_path}")
    assert isinstance(t, tracking.MLflowTracker)
    assert (stub.calls["tracking_uri"], stub.calls["experiment"], stub.calls["runs"]) == (
        f"file:{tmp_path}", "exp", ["r5"])
    # nested params flattened to dotted keys, cut to mlflow's 500 characters
    t.log_params({"model": {"encoder": "mit_b0"}, "note": "x" * 600})
    assert stub.calls["params"]["model.encoder"] == "mit_b0"
    assert len(stub.calls["params"]["note"]) == 500
    t.log_metrics({"train_loss": np.float32(0.5)}, step=7)
    assert stub.calls["metrics"] == [({"train_loss": 0.5}, 7)]
    assert type(stub.calls["metrics"][0][0]["train_loss"]) is float
    fig = plt.figure()
    t.log_figure(fig, "epoch000_sample0.png")
    plt.close(fig)
    assert stub.calls["figures"] == ["figures/epoch000_sample0.png"]
    art = tmp_path / "a.txt"
    art.write_text("hi")
    t.log_artifact(art, "config")
    t.log_artifact(art)
    assert stub.calls["artifacts"] == [(str(art), "config"), (str(art), None)]
    t.log_text("a: 1\n", "config/run_config.yaml")
    assert stub.calls["texts"] == [("a: 1\n", "config/run_config.yaml")]
    t.finish()
    assert stub.calls["ended"] == 1


def test_create_tracker_backends(tmp_path, monkeypatch):
    """``auto`` prefers mlflow where it imports and falls back to the file
    tracker at ``<directory>/<run_name>-<t>``; ``mlflow`` raises without
    it; ``none`` and every rank but 0 get the no-op tracker."""
    monkeypatch.setitem(sys.modules, "mlflow", _mlflow_stub())
    assert isinstance(tracking.create_tracker("auto", tmp_path, "auto-run"),
                      tracking.MLflowTracker)
    assert sys.modules["mlflow"].calls["runs"] == ["auto-run"]
    monkeypatch.setitem(sys.modules, "mlflow", None)  # import mlflow raises ImportError
    t = tracking.create_tracker("auto", tmp_path / "save", "fallback")
    assert type(t) is tracking.FileTracker
    assert t.directory.parent == tmp_path / "save" and t.directory.name.startswith("fallback-")
    t.finish()
    with pytest.raises(ImportError):
        tracking.create_tracker("mlflow", tmp_path, "strict")
    assert type(tracking.create_tracker("none", tmp_path)) is tracking.NullTracker
    monkeypatch.setattr(tracking, "is_host0", lambda: False)
    for backend in ("auto", "file", "none"):
        assert type(tracking.create_tracker(backend, tmp_path / "rank1")) is tracking.NullTracker
    assert not (tmp_path / "rank1").exists()
    quiet = tracking.NullTracker()  # accepts every call and writes nothing
    quiet.log_params({})
    quiet.log_metrics({"a": 1.0}, 0)
    quiet.log_figure(None, "x.png")
    quiet.log_artifact("x")
    quiet.log_text("t", "x")
    quiet.finish()


def test_file_tracker_figures_and_artifacts(tmp_path):
    t = tracking.create_tracker("file", tmp_path, "run")
    fig = plt.figure()
    t.log_figure(fig, "epoch000_sample0.png")
    plt.close(fig)
    art = tmp_path / "notes.txt"
    art.write_text("hello")
    t.log_artifact(art, "extra")
    t.log_artifact(art)
    t.finish()
    png = t.directory / "figures" / "epoch000_sample0.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (t.directory / "artifacts" / "extra" / "notes.txt").read_text() == "hello"
    assert (t.directory / "artifacts" / "notes.txt").read_text() == "hello"


# -- the prediction figure ----------------------------------------------------


def _canvas(fig) -> bytes:
    fig.canvas.draw()
    out = bytes(fig.canvas.buffer_rgba())
    plt.close(fig)
    return out


@pytest.mark.parametrize("colors", [["#000000", "#008000", "#0000FF"], None],
                         ids=["class_colors", "tab10"])
@pytest.mark.parametrize("kind", ["uint8", "standardized"])
def test_visualize_prediction_renders_the_jax_figure(kind, colors):
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, (24, 20, 4), dtype=np.uint8)
    mean = rng.uniform(0.3, 0.6, 4).astype(np.float32)
    std = rng.uniform(0.1, 0.3, 4).astype(np.float32)
    image = raw if kind == "uint8" else ((raw / np.float32(255) - mean) / std).astype(np.float32)
    mask = rng.integers(0, 3, (24, 20))
    pred = rng.integers(0, 3, (24, 20))
    kw = {"mean": mean, "std": std, "class_colors": colors, "num_classes": 3,
          "sample_name": "tile_7"}
    assert _canvas(tvisualize(image, mask, pred, **kw)) == _canvas(jvisualize(image, mask, pred,
                                                                               **kw))


# -- profiling ----------------------------------------------------------------


def test_step_timer_and_memory_stats_keys_match_jax():
    timers = (jprofiling.StepTimer(warmup=2), tprofiling.StepTimer(warmup=2))
    for t in timers:
        for _ in range(5):
            with t.step():
                torch.ones(8).sum()
    summaries = [t.summary(items_per_step=8) for t in timers]
    assert summaries[0].keys() == summaries[1].keys()
    assert summaries[1]["steps_timed"] == 3 and len(timers[1].times) == 3
    assert summaries[1]["items_per_sec"] > 0
    assert tprofiling.StepTimer().summary() == {}
    jstats, tstats = jprofiling.device_memory_stats(), tprofiling.device_memory_stats("cpu")
    assert [s.keys() for s in tstats] == [jstats[0].keys()]
    assert tstats[0]["bytes_in_use"] is None is jstats[0]["bytes_in_use"]  # CPU: untracked


def test_trace_on_the_cpu_writes_an_annotated_trace(tmp_path):
    with tprofiling.trace(tmp_path / "trace", device="cpu") as prof:
        with tprofiling.annotate("train_step"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert any(e.name == "train_step" for e in prof.events())
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "train_step" for e in events)


def test_trace_and_memory_stats_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: tprofiling.device_memory_stats(),
                 lambda: tprofiling.trace("unused").__enter__()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# -- logging ------------------------------------------------------------------


@pytest.fixture
def root_logging():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


def test_setup_logging_installs_the_jax_format_on_stdout(root_logging):
    formats = []
    for module in (jlogging, tlogging):
        module.setup_logging()
        (handler,) = root_logging.handlers
        assert isinstance(handler, logging.StreamHandler) and handler.stream is sys.stdout
        formats.append((handler.formatter._fmt, root_logging.level))
    assert formats[0] == formats[1] == (jlogging._FORMAT, logging.INFO)


def test_main_calls_setup_logging(monkeypatch, tmp_path):
    """Repair: ``main`` set up logging with ``logging.basicConfig`` (another
    format, on stderr) instead of the JAX CLI's ``setup_logging``."""
    calls = []
    monkeypatch.setattr(cli, "setup_logging", lambda: calls.append("setup_logging"))
    monkeypatch.setattr(cli, "load_config", lambda path, overrides: {"path": path})
    monkeypatch.setattr(cli, "run", lambda config, *a: calls.append(config) or {})
    cli.main(["test", "--config", str(tmp_path / "c.yaml"), "--device", "cpu"])
    assert calls == ["setup_logging", {"path": str(tmp_path / "c.yaml")}]


# -- the trainer's visualization node and the CLI's logger node ----------------


def test_build_trainer_config_maps_the_visualization_callback():
    """Repair: the ``VisualizationCallback``'s ``max_samples`` was dropped."""
    recipe = load_config(RECIPE)["trainer"]
    assert cli.build_trainer_config(recipe, 0).visualize_max_samples == 3
    node = copy.deepcopy(recipe)
    node["callbacks"][-1]["init_args"] = {"max_samples": 2}
    assert cli.build_trainer_config(node, 0).visualize_max_samples == 2
    node["callbacks"][-1]["init_args"] = None
    assert cli.build_trainer_config(node, 0).visualize_max_samples == 3
    assert cli.build_trainer_config({}, 0).visualize_max_samples == 3  # JAX's default


class _Recorder(tracking.Tracker):
    def __init__(self):
        self.figures = []

    def log_figure(self, figure, name):
        self.figures.append(name)


def test_figures_only_on_a_new_best(tmp_path, monkeypatch):
    """Epochs whose val_loss goes 3, 4, 2, 2 save a new best at epochs 0
    and 2 only; each gets ``visualize_max_samples`` figures of the first
    val batch, and the other epochs none."""
    from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
    from geo_deep_learning_tpu_torch.training.task import SegmentationTask

    losses = iter([3.0, 3.0, 4.0, 4.0, 2.0, 2.0, 2.0, 2.0])  # two val batches an epoch

    def train_step(state, batch):
        state.step += 1
        return {"loss": torch.zeros(())}

    def eval_step(batch):
        return {"loss": torch.tensor(next(losses)), "confusion": torch.eye(2),
                "preds": torch.zeros((3, 2, 2), dtype=torch.long)}

    class Data:
        def setup(self, stage):
            pass

        def train_dataloader(self):
            from geo_deep_learning_tpu_torch.data.loader import DataLoader

            return DataLoader([{"mask": np.zeros((2, 2), np.int64)}] * 2, batch_size=2)

        def val_dataloader(self):
            batch = {"image": np.zeros((3, 2, 2, 3), np.uint8),
                     "mask": np.zeros((3, 2, 2), np.int64), "valid_count": 3}
            return [batch, dict(batch)]

    class Weight(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def init_weights(self, generator):
            with torch.no_grad():
                self.w.zero_()

    monkeypatch.setattr(loop, "make_train_step", lambda *a, **k: train_step)
    monkeypatch.setattr(loop, "make_eval_step", lambda *a, **k: eval_step)
    rendered = []
    monkeypatch.setattr("geo_deep_learning_tpu_torch.tools.visualization.visualize_prediction",
                        lambda *a, **k: rendered.append(k["sample_name"]) or plt.figure())
    recorder = _Recorder()
    cfg = loop.TrainerConfig(max_epochs=4, checkpoint_dir=str(tmp_path / "ckpt"),
                             auto_test_after_fit=False, visualize_max_samples=2)
    task = SegmentationTask(Weight(), DiceLoss(mode="binary"), uses_wavelengths=False)
    loop.Trainer(cfg, recorder, device="cpu").fit(task, Data())
    assert recorder.figures == [f"epoch{e:03d}_sample{i}.png" for e in (0, 2) for i in (0, 1)]
    assert rendered == ["0", "1", "0", "1"]


def _dataset(root: Path, size: int = 64) -> None:
    rng = np.random.default_rng(12)
    for split, n in {"trn": 6, "val": 3, "tst": 3}.items():
        rows = []
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            write_geotiff(root / split / "image" / f"{split}{i}.tif",
                          rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{split}{i}_lbl.tif",
                          rng.integers(0, 2, (size, size), dtype=np.uint8))
            rows.append(f"{split}/image/{split}{i}.tif;{split}/label/{split}{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def logged_fit(tmp_path_factory):
    """A 2-epoch CPU ``fit`` of a tiny DOFA whose config carries the
    recipes' ``trainer.logger`` node (``save_dir`` in a temporary
    directory) and ``VisualizationCallback`` with ``max_samples: 2``; the
    samples handed to visualization and each epoch's checkpoint outcome are
    recorded."""
    tmp = tmp_path_factory.mktemp("logged_fit")
    _dataset(tmp / "data")
    recipe = load_config(RECIPE)["trainer"]
    cfg = load_config(PORT_CONFIG)
    cfg["trainer"].update(default_root_dir=str(tmp / "run"), max_epochs=2, precision="32-true",
                          logger=copy.deepcopy(recipe["logger"]))
    cfg["trainer"]["logger"]["init_args"]["save_dir"] = str(tmp / "runs")
    viz = [cb for cb in recipe["callbacks"] if cb["class_path"].endswith("VisualizationCallback")]
    cfg["trainer"]["callbacks"] += copy.deepcopy(viz)
    cfg["trainer"]["callbacks"][-1]["init_args"]["max_samples"] = 2
    cfg["model"]["init_args"].update(encoder="tiny", image_size=[64, 64], decoder_channels=32)
    cfg["data"]["init_args"].update(csv_root_folder=str(tmp / "data"),
                                    patches_root_folder=str(tmp / "data"), batch_size=2,
                                    patch_size=[64, 64])
    samples, improved = [], []
    with pytest.MonkeyPatch.context() as mp:
        register_tiny(mp)
        mp.delitem(sys.modules, JAX_TRACKER, raising=False)
        real_viz, real_save = loop.Trainer._log_visualizations, loop.CheckpointManager.save

        def record_viz(self, task, sample, epoch):
            samples.append((epoch, copy.deepcopy(sample)))
            return real_viz(self, task, sample, epoch)

        def record_save(self, *args):
            out = real_save(self, *args)
            improved.append(out[0])
            return out

        mp.setattr(loop.Trainer, "_log_visualizations", record_viz)
        mp.setattr(loop.CheckpointManager, "save", record_save)
        result = cli.run(copy.deepcopy(cfg), "fit", device="cpu")
        jax_tracker_imported = JAX_TRACKER in sys.modules
        yield {"tmp": tmp, "config": cfg, "result": result, "samples": samples,
               "improved": improved, "jax_tracker_imported": jax_tracker_imported}


def test_fit_writes_its_run_under_the_logger_node(logged_fit):
    """Repair: ``run`` put its run directory under ``checkpoints/run-<t>``
    whatever ``trainer.logger`` said; JAX ``build_tracker`` puts it at
    ``<save_dir>/<run_name>-<t>``, reading the node's ``init_args`` and
    never importing its ``class_path``."""
    tmp, cfg = logged_fit["tmp"], logged_fit["config"]
    args = cfg["trainer"]["logger"]["init_args"]
    (run_dir,) = Path(args["save_dir"]).glob(f"{args['run_name']}-*")
    assert not list((tmp / "run" / "checkpoints").glob("run-*"))
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "val_loss" in r] == [0, 1]
    assert records[-1]["test_loss"] == pytest.approx(logged_fit["result"]["test_loss"])
    assert json.loads((run_dir / "params.json").read_text())["trainer"]["logger"] == (
        cfg["trainer"]["logger"])
    assert (run_dir / "artifacts" / "config" / "run_config.yaml").is_file()
    assert not logged_fit["jax_tracker_imported"]


def test_fit_renders_figures_of_the_first_val_batch_on_each_new_best(logged_fit):
    """Two figures on every epoch whose checkpoint improved and none on the
    others, of the predictions that evaluating the best checkpoint gives
    for the first val batch."""
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager
    from geo_deep_learning_tpu_torch.training.steps import make_eval_step, to_device

    tmp, cfg = logged_fit["tmp"], logged_fit["config"]
    improved, samples = logged_fit["improved"], logged_fit["samples"]
    best_epochs = [e for e, better in enumerate(improved) if better]
    assert len(improved) == 2 and best_epochs and [e for e, _ in samples] == best_epochs
    args = cfg["trainer"]["logger"]["init_args"]
    (run_dir,) = Path(args["save_dir"]).glob(f"{args['run_name']}-*")
    assert sorted(p.name for p in (run_dir / "figures").iterdir()) == [
        f"epoch{e:03d}_sample{i}.png" for e in best_epochs for i in (0, 1)]

    epoch, sample = samples[-1]  # the last new best is the best checkpoint
    assert list(sample["batch"]["image_name"]) == ["val0.tif", "val1.tif"]
    best = json.loads((tmp / "run" / "checkpoints" / "index.json").read_text())["best_path"]
    with pytest.MonkeyPatch.context() as mp:
        register_tiny(mp)
        spec = cli.instantiate(cfg["model"])
        model = spec.task.materialize(torch.device("cpu"), cfg["seed_everything"])
        CheckpointManager.load_model(best, model)
        step = make_eval_step(spec.task, PrecisionPolicy.create("32-true"))
        want = step(to_device(sample["batch"], torch.device("cpu")))["preds"].numpy()
    np.testing.assert_array_equal(sample["preds"], want)
