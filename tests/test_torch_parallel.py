"""The port's data axis against the JAX package's ``("data", .)`` mesh, on the CPU.

Two ranks of a gloo group (``core.mesh.launch``) run every scenario of
``_torch_dp`` once for the module; the same scenarios run on one rank with no
group in this process; the JAX package's two-device mesh step (conftest's 8
CPU devices, ``make_train_step(..., mesh=...)`` as ``tests/test_parallel.py``
runs it) runs here too. The workers import no JAX. Weights come from the
JAX package's init (UNet++ resnet18 at 64^2, the narrow SegFormer) or the
port's seeded narrow DOFA, carried across by the converters; batches are
numpy draws; global batch 4, 2 rows a rank; f32, no augmentation, every
random layer at rate 0.

Tolerances:
- losses: 1e-5 absolute (the JAX test's; Adam's later steps against one
  rank 1e-3, as their test says); BatchNorm running statistics:
  1e-5 absolute + 1e-4 relative (``test_unetpp_sync_bn_multi_device_matches_single``);
- gradients against the JAX mesh step, per tensor: the L2 norm of the
  difference within 2e-2 of the tensor's norm (floored at 1e-4 of the
  global gradient norm, for gradients that are rounding noise, such as
  conv biases in front of BatchNorm); read 7.2e-3 (DOFA, the neck's first
  ConvModule), 4.8e-3 (UNet++, layer2's BatchNorms: both sides take the
  variance as E[x^2] - E[x]^2 in f32, ROADMAP's rounding note) and 4e-5
  (SegFormer). Against the port's one-rank step, whose BatchNorm takes the
  variance from the deviations: the largest difference of any tensor
  within 2e-4 of the global gradient norm (read 1e-6 at most);
- the loss sums' gradient identity: f64, 1e-12;
- parameters, optimizer state and buffers across the two ranks: bit-equal.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import multiprocessing
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_tiny import (
    TINY_DECODER,
    jax_variables,
    register_tiny,
    register_tiny_mit,
    register_tiny_resnets,
    tiny_model,
)

import _torch_dp as D
import geo_deep_learning_tpu.models.segmentation.dofa as jsegdofa
from geo_deep_learning_tpu.core.mesh import MeshConfig as JaxMeshConfig
from geo_deep_learning_tpu.core.mesh import create_mesh as jax_create_mesh
from geo_deep_learning_tpu.core.mesh import shard_batch as jax_shard_batch
from geo_deep_learning_tpu.core.precision import PrecisionPolicy as JaxPrecision
from geo_deep_learning_tpu.core.train_state import TrainState as JaxState
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.heads.fcn import FCNHead as JaxFCNHead
from geo_deep_learning_tpu.models.segmentation.segformer import SegFormer as JaxSegFormer
from geo_deep_learning_tpu.models.segmentation.unetpp import UnetPlusPlus as JaxUnetPlusPlus
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.parallel import shard_params
from geo_deep_learning_tpu.training import optim as joptim
from geo_deep_learning_tpu.training import steps as jsteps
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import load_config
from geo_deep_learning_tpu_torch.core.mesh import (
    Mesh,
    MeshConfig,
    create_mesh,
    launch,
    local_batch_to_global,
    shard_batch,
)
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.tools.make_shards import make_shards
from geo_deep_learning_tpu_torch.models.convert import (
    from_jax_params,
    from_jax_segformer_params,
    from_jax_unetpp_params,
)

ROOT = Path(__file__).resolve().parents[1]
GRAD_L2 = 2e-2  # per tensor, of its norm (floored at 1e-4 of the global norm)
ONE_RANK_GRAD = 2e-4  # of the gradient's global norm


def _capture():
    """Pass-through transform that keeps the last gradients in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}),
    )


def _jax_models(inputs: Path) -> dict:
    """Each family's JAX model and variables, and a converter of JAX trees
    to port names; the port state dicts are written to ``inputs``."""
    x = jnp.zeros((1, D.SIZE, D.SIZE, 3), jnp.float32)
    dofa = tiny_model(1)
    table = dofa.encoder.pos_embed.numpy()
    torch.save(dofa.state_dict(), inputs / "dofa.pt")
    out = {"dofa": (jsegdofa.DOFASegmentation(encoder_name="tiny", num_classes=1,
                                              decoder_channels=32, pos_embed_table=table),
                    jax_variables(dofa), functools.partial(from_jax_params, pos_embed=table))}
    for family, jmodel, convert in (
        ("unetpp", JaxUnetPlusPlus(encoder_name="resnet18", num_classes=1,
                                   decoder_channels=TINY_DECODER), from_jax_unetpp_params),
        ("segformer", JaxSegFormer(encoder_name="tiny_mit", num_classes=1, dropout_ratio=0.0),
         from_jax_segformer_params),
    ):
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(4), x)
        variables = jax.tree.map(np.asarray, variables)
        torch.save(convert(variables["params"], variables["batch_stats"]),
                   inputs / f"{family}.pt")
        out[family] = (jmodel, variables, convert)
    return out


def _stream_data(inputs: Path) -> None:
    """A CSV dataset of 32^2 patches (trn 8, val 5, tst 2) and its shards,
    two samples a shard, in a JSON registry (the port's ``make_shards``)."""
    rng = np.random.default_rng(5)
    root = inputs / "csv"
    for split, n in {"trn": 8, "val": 5, "tst": 2}.items():
        rows = []
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True)
        for i in range(n):
            write_geotiff(root / split / "image" / f"{split}{i}.tif",
                          rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{split}{i}_lbl.tif",
                          rng.integers(0, 2, (32, 32), dtype=np.uint8))
            rows.append(f"{split}/image/{split}{i}.tif;{split}/label/{split}{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    make_shards(root, inputs / "shards", "rgb", per_shard=2,
                registry=inputs / "shards" / "sensors.json")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scenarios on two ranks (once for the module) and on one."""
    with pytest.MonkeyPatch.context() as mp:
        register_tiny(mp)
        register_tiny_mit(mp)
        register_tiny_resnets(mp)
        mp.setattr(jsegdofa, "DOFAv2", functools.partial(JaxDOFAv2, drop_path_rate=0.0))
        mp.setattr(jsegdofa, "FCNHead", functools.partial(JaxFCNHead, dropout_ratio=0.0))
        inputs = tmp_path_factory.mktemp("dp_inputs")
        out = tmp_path_factory.mktemp("dp_out")
        models = _jax_models(inputs)
        _stream_data(inputs)
        # the scenarios without a JAX reference take the port's seeded weights
        tiny = D.ARCH["tiny_unetpp"]()
        tiny.init_weights(torch.Generator().manual_seed(4))
        torch.save(tiny.state_dict(), inputs / "tiny_unetpp.pt")
        # the two ranks run while this process runs the one-rank scenarios,
        # each process on one thread (the test lane's workers share the cores)
        failed = []
        ranks_run = threading.Thread(target=_launch_scenarios, args=(inputs, out, failed))
        ranks_run.start()
        with _one_thread():
            one = {name: fn(Mesh(), inputs) for name, fn in D.SCENARIOS.items()}
        ranks_run.join(300)
        assert not ranks_run.is_alive() and not failed, failed
        ranks = {name: [dict(np.load(out / f"{name}_rank{r}.npz")) for r in range(2)]
                 for name in D.SCENARIOS}
        yield {"ranks": ranks, "one": one, "models": models, "inputs": inputs}


def _launch_scenarios(inputs: Path, out: Path, failed: list) -> None:
    try:
        launch(D.run_scenarios, (str(inputs), str(out)), size=2, backend="gloo",
               deadline_s=280)
    except Exception as err:  # reported by the fixture
        failed.append(err)


@contextlib.contextmanager
def _one_thread():
    """This process and the ranks it spawns on one thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def _jax_step(family: str, models: dict) -> dict:
    """One f32 Adam step of the JAX package on a two-device data mesh over
    the first global batch: loss, gradients and BN statistics by port name."""
    jmodel, variables, convert = models[family]
    mesh = jax_create_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
    params = shard_params(jax.tree.map(np.asarray, variables["params"]), mesh, rules=None)
    tx = optax.chain(_capture(), joptim.build_optimizer(params, "adam", lr=D.LR))
    state = JaxState.create(apply_fn=jmodel.apply, params=params, tx=tx,
                            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    task = JaxTask(jmodel, JaxDice(mode="binary"), num_classes=1,
                   default_wavelengths=[0.665, 0.549, 0.481] if family == "dofa" else None,
                   uses_wavelengths=family == "dofa")
    step = jsteps.make_train_step(task, JaxPrecision.create("32-true"), augment=None, mesh=mesh)
    batch = {k: v for k, v in D.global_batches(1)[0].items() if k != "image_name"}
    batch["mask"] = batch["mask"].astype(np.int32)
    state, metrics = step(state, jax_shard_batch(batch, mesh))
    grads = convert(jax.tree.map(np.asarray, state.opt_state[0]["g"]),
                    jax.tree.map(np.asarray, state.batch_stats))
    return {"loss": float(metrics["loss"]), "grads": grads}


def _stats(res: dict) -> dict[str, np.ndarray]:
    return {k[len("stat/"):]: v for k, v in res.items() if k.startswith("stat/")}


@pytest.mark.parametrize("family", D.FAMILIES)
def test_train_step_matches_the_jax_mesh_step(runs, family):
    """Loss, every gradient and every BN statistic of the first step at 2
    ranks against the JAX package's 2-device mesh step on the same batch."""
    want = _jax_step(family, runs["models"])
    got = runs["ranks"][f"train_{family}"][0]
    assert abs(float(got["loss"][0]) - want["loss"]) <= 1e-5
    grads = {k[len("grad/"):]: v for k, v in got.items() if k.startswith("grad/")}
    assert grads
    total = np.sqrt(sum(float((want["grads"][n].numpy().astype(np.float64) ** 2).sum())
                        for n in grads))
    worst = 0.0
    for name, g in grads.items():
        w = want["grads"][name].numpy().astype(np.float64)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-4 * total)
        assert rel <= GRAD_L2, (name, rel)
        worst = max(worst, rel)
    print(f"{family}: largest gradient difference to JAX, relative to its norm: {worst:.3g}")
    stats = _stats(got)
    assert stats or family == "dofa" and not any("running" in k for k in want["grads"])
    for name, s in stats.items():
        np.testing.assert_allclose(s, want["grads"][name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("family", D.FAMILIES)
def test_train_steps_match_one_rank(runs, family):
    """The first step's loss, gradients and BN statistics at 2 ranks against
    the port's own step on one rank and the global batch; the later steps'
    losses within 1e-3 (Adam's first updates move an element whose
    gradient is rounding noise by about +-lr, 1e-3, whichever way the noise
    points, so the two runs' weights part by up to that)."""
    got, want = runs["ranks"][f"train_{family}"][0], runs["one"][f"train_{family}"]
    assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5
    np.testing.assert_allclose(got["loss"][1:], want["loss"][1:], atol=1e-3, rtol=0)
    keys = [k for k in want if k.startswith("grad/")]
    assert keys and set(keys) == {k for k in got if k.startswith("grad/")}
    norm = np.sqrt(sum(float((want[k].astype(np.float64) ** 2).sum()) for k in keys))
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
    print(f"{family}: largest gradient difference to one rank / global norm {worst / norm:.3g}")
    assert worst <= ONE_RANK_GRAD * norm
    for name, s in _stats(want).items():
        np.testing.assert_allclose(got[f"stat/{name}"], s, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("scenario", [*(f"train_{f}" for f in D.FAMILIES), "accumulate",
                                      "freeze"])
def test_ranks_stay_identical(runs, scenario):
    """Parameters, optimizer state and buffers are bit-equal on both ranks
    after the scenario's steps (3 Adam steps for the train scenarios)."""
    r0, r1 = runs["ranks"][scenario]
    state = [k for k in r0 if k.startswith(("param/", "opt/", "buffer/"))]
    assert any(k.startswith("opt/") for k in state)
    assert state and set(state) == {k for k in r1 if k.startswith(("param/", "opt/", "buffer/"))}
    for k in state:
        assert np.array_equal(r0[k], r1[k]), k


@pytest.mark.parametrize("loss", list(D.LOSSES))
def test_global_sum_gradient_identity(runs, loss):
    """With sample weights that differ between the ranks' rows, each loss
    at 2 ranks equals the 1-rank f64 loss of the global batch, and each
    rank's gradient divided by 2 is the global gradient on its rows; the
    mean of the ranks' own losses is not the global loss."""
    r0, r1 = runs["ranks"]["losses"]
    want = runs["one"]["losses"]
    for r in (r0, r1):
        np.testing.assert_allclose(r[f"{loss}/loss"], want[f"{loss}/loss"], atol=1e-12, rtol=0)
    got = np.concatenate([r0[f"{loss}/grad"], r1[f"{loss}/grad"]])
    np.testing.assert_allclose(got, want[f"{loss}/grad"], atol=1e-12, rtol=0)
    fn = D.LOSSES[loss]
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(rng.standard_normal((D.GLOBAL_BATCH, 3, 16, 16)))
    targets = torch.from_numpy(rng.integers(0, 3, (D.GLOBAL_BATCH, 16, 16)))
    w = torch.from_numpy(D.LOSS_WEIGHTS)
    per_rank = np.mean([fn(logits[s], targets[s], sample_weights=w[s]).item()
                        for s in (slice(0, 2), slice(2, 4))])
    assert abs(per_rank - float(want[f"{loss}/loss"])) > 1e-6


def test_accumulation_syncs_on_the_last_micro_step_only(runs):
    """``accumulate=2``: no all-reduce on the first micro-step (``no_sync``),
    the buckets' on the second; the update equals one rank's."""
    r0, _ = runs["ranks"]["accumulate"]
    want = runs["one"]["accumulate"]
    assert r0["allreduce_calls"][0] == 0 and r0["allreduce_calls"][1] > 0
    np.testing.assert_allclose(r0["loss"], want["loss"], atol=1e-5, rtol=0)
    for k in (k for k in want if k.startswith("param/")):
        np.testing.assert_allclose(r0[k], want[k], atol=1e-4, rtol=0, err_msg=k)


def test_frozen_encoder_stays_out_of_the_buckets(runs):
    """``freeze_layers: ["encoder"]``: the encoder does not move on either
    rank; the rest updates as on one rank."""
    r0, _ = runs["ranks"]["freeze"]
    want = runs["one"]["freeze"]
    assert int(r0["n_frozen"]) > 0 and r0["allreduce_calls"][0] > 0
    initial = torch.load(runs["inputs"] / "tiny_unetpp.pt", weights_only=True)
    for k in (k for k in want if k.startswith("param/")):
        name = k[len("param/"):]
        if name.startswith("encoder."):
            assert np.array_equal(r0[k], initial[name].numpy()), name
        np.testing.assert_allclose(r0[k], want[k], atol=1e-4, rtol=0, err_msg=k)


def test_eval_and_predict_over_two_ranks(runs):
    """``Trainer.evaluate`` over 4-, 4- and 3-row batches (the short one
    replicated) and ``Trainer.predict``'s gathered predictions, names and
    counts equal one rank's."""
    r0, r1 = runs["ranks"]["serve"]
    want = runs["one"]["serve"]
    for r in (r0, r1):
        assert set(r) == set(want)
        for k, v in want.items():
            if k.startswith("metric/"):
                np.testing.assert_allclose(r[k], v, atol=1e-6, rtol=0, err_msg=k)
            else:
                assert np.array_equal(r[k], v), k


def _batches(res: dict, name: str) -> list[tuple[list[str], list[int]]]:
    n = int(res[f"{name}/len"])
    assert f"{name}/{n}/names" not in res
    return [(res[f"{name}/{k}/names"].tolist(), res[f"{name}/{k}/keys"].tolist())
            for k in range(n) if f"{name}/{k}/names" in res]


def test_data_paths_give_each_rank_its_rows(runs):
    """The shard stream's ``trn``: each rank streams its own shards (a
    disjoint cover) at 2 rows a batch, the rank's block of a global batch
    of 4, as many batches on both ranks; ``val`` of the shard stream and of
    the worker-process CSV module: the ranks' rows together are the
    one-rank batch, a short batch of 1 replicated on both."""
    r0, r1 = (_batches(r, "trn") for r in runs["ranks"]["streams"])
    assert len(r0) == len(r1) == 2
    for rank, batches in enumerate((r0, r1)):
        for names, (valid, offset, rows) in batches:
            assert len(names) == valid == 2 and (offset, rows) == (2 * rank, 4)
    seen = [{n for names, _ in b for n in names} for b in (r0, r1)]
    assert not seen[0] & seen[1] and len(seen[0] | seen[1]) == 8
    for name in ("val", "grain_val"):
        one = _batches(runs["one"]["streams"], name)
        two = [_batches(r, name) for r in runs["ranks"]["streams"]]
        assert len(one) == len(two[0]) == len(two[1]) == 2
        for k, (names, (valid, _, _)) in enumerate(one):
            (n0, k0), (n1, k1) = two[0][k], two[1][k]
            if len(names) % 2:  # replicated: both ranks hold the whole batch
                assert n0 == n1 == names and k0 == k1 == [valid, 0, len(names)]
            else:
                assert n0 + n1 == names and k0[0] + k1[0] == valid


def test_shard_batch_takes_the_rank_rows():
    """Rows ``[r*B/W, (r+1)*B/W)``, lists cut alike, ``valid_count`` the
    real rows among them; a length that W does not divide is replicated."""
    batch = {"mask": np.arange(8).reshape(4, 2), "image_name": list("abcd"), "valid_count": 3,
             "wavelengths": np.ones(3)}
    one = shard_batch(batch, Mesh(1, 2))
    assert one["mask"].tolist() == [[4, 5], [6, 7]] and one["image_name"] == ["c", "d"]
    assert (one["valid_count"], one["row_offset"], one["global_rows"]) == (1, 2, 4)
    assert one["wavelengths"].shape == (3,)
    assert shard_batch(one, Mesh(1, 2)) is one  # a rank's batch passes through
    odd = shard_batch({"mask": np.zeros((3, 2))}, Mesh(1, 2))
    assert odd["mask"].shape == (3, 2) and odd["row_offset"] == 0 and odd["global_rows"] == 3
    assert shard_batch(batch, Mesh()) is batch
    local = local_batch_to_global({"mask": np.zeros((2, 2))}, Mesh(1, 2))
    assert (local["row_offset"], local["global_rows"]) == (2, 4)


def test_a_failing_rank_ends_the_run():
    """A rank that raises while the other waits in a collective: the
    launcher stops the waiting rank and raises the failure's traceback
    well within the group timeout, and leaves no process behind."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(D.fail_on_rank_1, (60.0,), size=2, backend="gloo", timeout_s=60.0)
    assert time.monotonic() - t0 < 45.0
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("gdl-rank")]


def _dataset(root: Path) -> None:
    rng = np.random.default_rng(0)
    for split, n in {"trn": 8, "val": 5, "tst": 3}.items():
        rows = []
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            write_geotiff(root / split / "image" / f"{i}.tif",
                          rng.integers(0, 256, (D.SIZE, D.SIZE, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{i}_lbl.tif",
                          rng.integers(0, 2, (D.SIZE, D.SIZE), dtype=np.uint8))
            rows.append(f"{split}/image/{i}.tif;{split}/label/{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")


def test_cli_fit_on_two_ranks_matches_one_rank(tmp_path):
    """``fit`` of UNet++ resnet18 at 64^2, global batch 4, one epoch (2
    train steps, augmentation on: its draws are the global batch's), val
    of 5 (the second batch padded, its real row on rank 0 alone) and tst of
    3, with ``trainer.mesh: {data: 2}`` against the same fit on one rank:
    train loss and every val/test metric within 1e-4; rank 0 alone wrote
    one best checkpoint, ``last.pt``, the index and one archived config;
    the 2-rank best checkpoint restored into a 1-rank ``test`` gives the
    2-rank auto-test's metrics; no rank process is left."""
    _dataset(tmp_path / "data")
    base = load_config(ROOT / "geo_deep_learning_tpu_torch" / "configs" / "unetplus_waterloo.yaml")
    base["model"]["init_args"].update(encoder="resnet18", image_size=[D.SIZE, D.SIZE],
                                      decoder_channels=list(TINY_DECODER))
    base["data"]["init_args"].update(csv_root_folder=str(tmp_path / "data"),
                                     patches_root_folder=str(tmp_path / "data"), batch_size=4,
                                     num_workers=2, patch_size=[D.SIZE, D.SIZE])
    results = {}
    for data in (1, 2):
        config = copy.deepcopy(base)
        config["trainer"].update(default_root_dir=str(tmp_path / f"run{data}"), max_epochs=1,
                                 precision="32-true", mesh={"data": data})
        with _one_thread():
            results[data] = cli.run(config, "fit", device="cpu")
    one, two = results[1], results[2]
    assert set(one) == set(two)
    for key in one:
        if key.startswith(("val_", "test_", "train_loss")):
            assert abs(one[key] - two[key]) <= 1e-4, (key, one[key], two[key])
    ckpts = tmp_path / "run2" / "checkpoints"
    assert len(list(ckpts.glob("model-epoch=*.pt"))) == 1 and (ckpts / "last.pt").exists()
    assert not list(ckpts.glob("*.tmp"))
    configs = list(ckpts.glob("*/artifacts/config/run_config.yaml"))
    assert len(configs) == 1
    best = json.loads((ckpts / "index.json").read_text())["best_path"]
    assert torch.load(best, weights_only=True)["step"] == 2
    config = copy.deepcopy(base)
    config["trainer"].update(default_root_dir=str(tmp_path / "restored"), precision="32-true")
    with _one_thread():
        tested = cli.run(config, "test", device="cpu", ckpt_path=best)
    for key, value in tested.items():
        assert abs(value - two[key]) <= 1e-6, (key, value, two[key])
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("gdl-rank")]
