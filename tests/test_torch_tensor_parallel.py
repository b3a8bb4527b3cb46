"""The port's model axis against the JAX package's ``("data", "model")`` mesh, on the CPU.

One launch of four gloo ranks (``core.mesh.launch``), a ``{data: 2, model:
2}`` mesh, one thread each, runs every scenario of ``_torch_tp`` once for
the module; the train scenarios also run on one rank with no group in this
process, and the JAX package's ``{data: 2, model: 2}`` tensor-parallel step
(``TENSOR_PARALLEL_RULES`` over 4 of conftest's 8 CPU devices, as
``tests/test_parallel.py`` runs it) runs here too. The workers import no
JAX. Models: the narrow DOFA (2 heads) with the port's seeded weights and
the narrow SegFormer (MiT heads 1/2/3/4: its 1- and 3-head attentions stay
replicated, every Mix-FFN is sharded) with the JAX package's init, both at
64^2, f32, global batch 4, no augmentation, every random rate at 0 (but
DropPath 0.1 where named).

Tolerances:
- against the JAX mesh step, the first step: the loss within 1e-5
  absolute; each whole gradient's L2 difference within 2e-2 of its norm,
  floored at 1e-4 of the global norm (``GRAD_L2``, the data-parallel
  test's);
- against the port's one-rank steps (3 Adam steps with a clip that
  engages): the first step's largest gradient difference within 2e-4 of the
  global gradient norm, every whole parameter after the last step within
  2e-4 of the global parameter norm (``ONE_RANK``), the first step's clip
  norm within 1e-6 relative (``CLIP_NORM``) and the later steps' within
  1e-4 (``LATER_NORM``: read 5.7e-6), the losses within 1e-5 (first) and
  1e-3 (later): Adam moves an element whose gradient is rounding noise by
  about +-lr either way, so after the first update the two runs' weights
  part by up to that;
- across ranks: replicated parameters bit-equal over the model ranks,
  every local parameter and optimizer slot bit-equal over the data ranks;
- the fit: a one-process ``test`` of the tensor-parallel best checkpoint
  within 1e-5 of the fit's auto-test; ``remat="block"`` against no remat:
  loss and gradients within 1e-6 (``REMAT``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_tiny import jax_variables, register_tiny, register_tiny_mit, tiny_model

import _torch_tp as T
import geo_deep_learning_tpu.models.segmentation.dofa as jsegdofa
from geo_deep_learning_tpu.core.mesh import MeshConfig as JaxMeshConfig
from geo_deep_learning_tpu.core.mesh import create_mesh as jax_create_mesh
from geo_deep_learning_tpu.core.mesh import shard_batch as jax_shard_batch
from geo_deep_learning_tpu.core.precision import PrecisionPolicy as JaxPrecision
from geo_deep_learning_tpu.core.train_state import TrainState as JaxState
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.heads.fcn import FCNHead as JaxFCNHead
from geo_deep_learning_tpu.models.segmentation.segformer import SegFormer as JaxSegFormer
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.parallel import TENSOR_PARALLEL_RULES as JAX_RULES
from geo_deep_learning_tpu.parallel import count_model_sharded as jax_count_model_sharded
from geo_deep_learning_tpu.parallel import shard_params as jax_shard_params
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
    world_size,
)
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.models.convert import from_jax_params, from_jax_segformer_params
from geo_deep_learning_tpu_torch.models.encoders.dofa import DOFAv2
from geo_deep_learning_tpu_torch.models.segmentation.unetpp import UnetPlusPlus
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.parallel import placement as P
from geo_deep_learning_tpu_torch.tools.make_shards import make_shards

ROOT = Path(__file__).resolve().parents[1]
GRAD_L2 = 2e-2
ONE_RANK = 2e-4
CLIP_NORM = 1e-6
LATER_NORM = 1e-4  # after the first update the parameters differ by Adam's noise
REMAT = 1e-6
RANKS = 4  # global rank g = data index * 2 + model index


def _capture():
    """Pass-through transform that keeps the last gradients in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}),
    )


def _jax_models(inputs: Path) -> dict:
    """Each family's JAX model and variables and a converter of JAX trees
    to port names; the port state dicts are written to ``inputs``."""
    dofa = tiny_model(1)
    table = dofa.encoder.pos_embed.numpy()
    torch.save(dofa.state_dict(), inputs / "dofa.pt")
    out = {"dofa": (jsegdofa.DOFASegmentation(encoder_name="tiny", num_classes=1,
                                              decoder_channels=32, pos_embed_table=table),
                    jax_variables(dofa), functools.partial(from_jax_params, pos_embed=table))}
    jmodel = JaxSegFormer(encoder_name="tiny_mit", num_classes=1, dropout_ratio=0.0)
    x = jnp.zeros((1, T.SIZE, T.SIZE, 3), jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(4), x))
    torch.save(from_jax_segformer_params(variables["params"], variables["batch_stats"]),
               inputs / "segformer.pt")
    out["segformer"] = (jmodel, variables, from_jax_segformer_params)
    return out


def _dataset(inputs: Path) -> None:
    """A CSV dataset of 64^2 patches (trn 8, val 4, tst 4) and its shards
    (two samples a shard, in a JSON registry)."""
    rng = np.random.default_rng(5)
    root = inputs / "csv"
    for split, n in {"trn": 8, "val": 4, "tst": 4}.items():
        rows = []
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True)
        for i in range(n):
            write_geotiff(root / split / "image" / f"{split}{i}.tif",
                          rng.integers(0, 256, (T.SIZE, T.SIZE, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{split}{i}_lbl.tif",
                          rng.integers(0, 2, (T.SIZE, T.SIZE), dtype=np.uint8))
            rows.append(f"{split}/image/{split}{i}.tif;{split}/label/{split}{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    make_shards(root, inputs / "shards", "rgb", per_shard=2,
                registry=inputs / "shards" / "sensors.json")


def _fit_config(inputs: Path, run_dir: Path, mesh: dict | None) -> dict:
    config = load_config(ROOT / "geo_deep_learning_tpu_torch" / "configs"
                         / "segformer_waterloo.yaml")
    config["model"]["init_args"].update(encoder="tiny_mit", image_size=[T.SIZE, T.SIZE])
    config["data"]["init_args"].update(csv_root_folder=str(inputs / "csv"),
                                       patches_root_folder=str(inputs / "csv"),
                                       batch_size=T.GLOBAL_BATCH, num_workers=1,
                                       patch_size=[T.SIZE, T.SIZE])
    config["trainer"].update(default_root_dir=str(run_dir), max_epochs=2, precision="32-true")
    config["trainer"].pop("callbacks")
    if mesh:
        config["trainer"]["mesh"] = mesh
    return config


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scenarios on the 2 x 2 mesh (once for the module) and on one rank."""
    with pytest.MonkeyPatch.context() as mp:
        register_tiny(mp)
        register_tiny_mit(mp)
        mp.setattr(jsegdofa, "DOFAv2", functools.partial(JaxDOFAv2, drop_path_rate=0.0))
        mp.setattr(jsegdofa, "FCNHead", functools.partial(JaxFCNHead, dropout_ratio=0.0))
        inputs = tmp_path_factory.mktemp("tp_inputs")
        out = tmp_path_factory.mktemp("tp_out")
        models = _jax_models(inputs)
        _dataset(inputs)
        (inputs / "fit_config.json").write_text(json.dumps(
            _fit_config(inputs, inputs / "fit", {"data": 2, "model": 2})))
        failed = []
        ranks_run = threading.Thread(target=_launch_scenarios, args=(inputs, out, failed))
        with _one_thread():
            ranks_run.start()
            one = {name: T.SCENARIOS[name](Mesh(), inputs) for name in T.ONE_RANK}
            ranks_run.join(300)
        assert not ranks_run.is_alive() and not failed, failed
        ranks = {name: [dict(np.load(out / f"{name}_rank{r}.npz")) for r in range(RANKS)]
                 for name in T.SCENARIOS}
        yield {"ranks": ranks, "one": one, "models": models, "inputs": inputs}


def _launch_scenarios(inputs: Path, out: Path, failed: list) -> None:
    try:
        launch(T.run_scenarios, (str(inputs), str(out)), size=RANKS, backend="gloo",
               deadline_s=280)
    except Exception as err:  # reported by the fixture
        failed.append(err)


def _jax_tp_step(family: str, models: dict) -> dict:
    """One f32 Adam step of the JAX package on a ``{data: 2, model: 2}``
    mesh with its tensor-parallel rules over the first global batch: the
    loss and the gradients (before the clip) by port name."""
    jmodel, variables, convert = models[family]
    mesh = jax_create_mesh(JaxMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    params = jax_shard_params(jax.tree.map(np.asarray, variables["params"]), mesh,
                              rules=JAX_RULES)
    assert jax_count_model_sharded(params) > 0
    tx = optax.chain(_capture(), joptim.build_optimizer(params, "adam", lr=T.LR,
                                                        grad_clip=T.CLIP))
    state = JaxState.create(apply_fn=jmodel.apply, params=params, tx=tx,
                            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    task = JaxTask(jmodel, JaxDice(mode="binary"), num_classes=1,
                   default_wavelengths=list(T.WAVES) if family == "dofa" else None,
                   uses_wavelengths=family == "dofa")
    step = jsteps.make_train_step(task, JaxPrecision.create("32-true"), augment=None, mesh=mesh)
    batch = {k: v.numpy() for k, v in T.global_batches(1, 1)[0].items()}
    batch["mask"] = batch["mask"].astype(np.int32)
    state, metrics = step(state, jax_shard_batch(batch, mesh))
    grads = convert(jax.tree.map(np.asarray, state.opt_state[0]["g"]),
                    jax.tree.map(np.asarray, state.batch_stats))
    return {"loss": float(metrics["loss"]), "grads": grads}


def _prefixed(res: dict, prefix: str) -> dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("family", T.FAMILIES)
def test_first_step_matches_the_jax_tensor_parallel_step(runs, family):
    """Loss and every whole gradient of the first step on the 2 x 2 mesh
    against the JAX package's 2 x 2 tensor-parallel step."""
    want = _jax_tp_step(family, runs["models"])
    for got in runs["ranks"][f"train_{family}"]:
        assert abs(float(got["loss"][0]) - want["loss"]) <= 1e-5
    grads = _prefixed(runs["ranks"][f"train_{family}"][0], "grad/")
    assert grads and int(runs["ranks"][f"train_{family}"][0]["n_sharded"]) > 0
    total = np.sqrt(sum(float((want["grads"][n].numpy().astype(np.float64) ** 2).sum())
                        for n in grads))
    worst = 0.0
    for name, g in grads.items():
        w = want["grads"][name].numpy().astype(np.float64)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-4 * total)
        assert rel <= GRAD_L2, (name, rel)
        worst = max(worst, rel)
    print(f"{family}: largest gradient difference to JAX, relative to its norm: {worst:.3g}")


@pytest.mark.parametrize("family", T.FAMILIES)
def test_clipped_adam_steps_match_one_rank(runs, family):
    """Three Adam steps with a clip that engages, on the 2 x 2 mesh (every
    rank) against the port's one-rank steps on the global batches: losses,
    clip norms, the first step's gradients and the parameters after."""
    want = runs["one"][f"train_{family}"]
    assert np.all(want["norm"] > T.CLIP)
    grads = _prefixed(want, "grad/")
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    params = _prefixed(want, "param/")
    pnorm = np.sqrt(sum(float((p.astype(np.float64) ** 2).sum()) for p in params.values()))
    for got in runs["ranks"][f"train_{family}"]:
        assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5
        np.testing.assert_allclose(got["loss"][1:], want["loss"][1:], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got["norm"][0], want["norm"][0], rtol=CLIP_NORM, atol=0)
        np.testing.assert_allclose(got["norm"][1:], want["norm"][1:], rtol=LATER_NORM, atol=0)
        got_grads = _prefixed(got, "grad/")
        assert set(got_grads) == set(grads)
        worst = max(float(np.abs(got_grads[n] - g).max()) for n, g in grads.items())
        assert worst <= ONE_RANK * gnorm, worst / gnorm
        got_params = _prefixed(got, "param/")
        assert set(got_params) == set(params)
        worst_p = max(float(np.abs(got_params[n] - p).max()) for n, p in params.items())
        assert worst_p <= ONE_RANK * pnorm, worst_p / pnorm
    print(f"{family}: gradients {worst / gnorm:.3g} of their norm, parameters "
          f"{worst_p / pnorm:.3g} of theirs")


@pytest.mark.parametrize("scenario", ["train_dofa", "train_segformer", "droppath_dofa"])
def test_ranks_stay_bit_equal_where_they_are_replicated(runs, scenario):
    """After the scenario's steps (DropPath 0.1 in ``droppath_dofa``):
    every parameter that is not sharded is bit-equal on the two model ranks
    of a data index; every local parameter and optimizer slot is bit-equal
    on the two data ranks of a model index."""
    ranks = runs["ranks"][scenario]
    sharded = {n for n in _prefixed(ranks[0], "local/")
               if ranks[0][f"local/{n}"].shape != ranks[0][f"param/{n}"].shape}
    assert sharded
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        for name, v in _prefixed(a, "local/").items():
            if name not in sharded:
                assert np.array_equal(v, b[f"local/{name}"]), (d, name)
    for m in range(2):
        a, b = ranks[m], ranks[2 + m]
        keys = [k for k in a if k.startswith(("local/", "local_opt/"))]
        assert keys and set(keys) == {k for k in b if k.startswith(("local/", "local_opt/"))}
        for k in keys:
            assert np.array_equal(a[k], b[k]), (m, k)


def test_model_ranks_read_the_same_rows(runs):
    """Each data path (threaded CSV loader, round-robin distributed sampler,
    shard stream): the two model ranks of a data index read the same rows,
    and the two data indices read different ones."""
    ranks = runs["ranks"]["streams"]
    keys = [k for k in ranks[0] if not k.startswith("_")]
    assert {k.split("/")[0] for k in keys} == {"csv_trn", "csv_val", "shard_trn", "shard_val",
                                             "round_robin"}
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        assert set(a) == set(b)
        for k in keys:
            assert a[k].tolist() == b[k].tolist(), (d, k)
    for path in ("csv_trn", "csv_val", "shard_trn", "round_robin"):
        rows = [{n for k in keys if k.startswith(path + "/") for n in ranks[r][k].tolist()}
                for r in (0, 2)]
        assert rows[0] and rows[1] and not rows[0] & rows[1], path


def test_a_tensor_parallel_checkpoint_tests_in_one_process(runs, tmp_path):
    """``run(config, "fit")`` on the 2 x 2 mesh (narrow SegFormer, 2 epochs,
    auto-test): its best checkpoint, whole, in a fresh one-process ``test``
    gives the auto-test's metrics."""
    fit = runs["ranks"]["fit"][0]
    auto = {k: float(v) for k, v in _prefixed(fit, "metric/").items() if k.startswith("test_")}
    assert auto
    config = _fit_config(runs["inputs"], tmp_path / "restored", None)
    with pytest.MonkeyPatch.context() as mp, _one_thread():
        register_tiny_mit(mp)
        tested = cli.run(config, "test", device="cpu", ckpt_path=str(fit["best"]))
    assert set(tested) == set(auto)
    for key, value in tested.items():
        assert abs(value - auto[key]) <= 1e-5, (key, value, auto[key])


def test_a_second_fit_resumes_from_last_in_the_same_layout(runs):
    """A second 2 x 2 fit from the first one's ``last.pt`` continues past the
    restored step with the same number of sharded tensors (JAX
    ``tests/test_training_loop.py::test_fit_tensor_parallel_full_loop``)."""
    fits = runs["ranks"]["fit"]
    restored = int(fits[0]["restored_step"])
    assert restored == 4  # 2 epochs of 2 global batches
    for f in fits:
        assert int(f["resumed_step"]) > restored and np.isfinite(float(f["resumed_loss"]))
        assert int(f["n_sharded"]) == int(runs["ranks"]["train_segformer"][0]["n_sharded"]) > 0


def test_remat_block_recomputes_the_same_step(runs):
    """``remat="block"`` on the narrow DOFA (the recomputed blocks run their
    collectives again in the backward): the same loss and gradients as
    without remat."""
    for got, want in zip(runs["ranks"]["remat_dofa"], runs["ranks"]["train_dofa"]):
        assert abs(float(got["loss"][0]) - float(want["loss"][0])) <= REMAT
        grads = _prefixed(want, "grad/")
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
        for name, g in _prefixed(got, "grad/").items():
            assert float(np.abs(g - grads[name]).max()) <= REMAT * norm, name


# --- without a launch -------------------------------------------------------------


def _tiny(family: str) -> torch.nn.Module:
    with pytest.MonkeyPatch.context() as mp:
        register_tiny(mp)
        register_tiny_mit(mp)
        return T.ARCH[family]()


def test_which_names_shard():
    """The narrow DOFA (2 heads, hidden 256) shards every block's qkv, proj,
    fc1 and fc2 weights and the column biases; the narrow MiT shards the
    2- and 4-head attentions and every Mix-FFN, and keeps its 1- and 3-head
    attentions, every norm, ``sr`` and the row-parallel biases replicated."""
    dofa = P.shard_params_spec(_tiny("dofa"), 2, P.TENSOR_PARALLEL_RULES)
    sharded = {n for n, s in dofa.items() if s is not None}
    assert sharded == {f"encoder.blocks.{i}.{leaf}" for i in range(5)
                       for leaf in ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                                    "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")}
    assert dofa["encoder.blocks.0.attn.qkv.weight"] == P.Split(0, 3)
    assert dofa["encoder.blocks.0.attn.proj.weight"] == P.Split(1)
    mit = P.shard_params_spec(_tiny("segformer"), 2, P.TENSOR_PARALLEL_RULES)
    attn = {n.split(".")[1] for n, s in mit.items() if s is not None and ".attn." in n}
    assert attn == {"block2", "block4"}  # heads 2 and 4; block1 (1) and block3 (3) replicated
    for stage in (1, 2, 3, 4):
        assert mit[f"encoder.block{stage}.0.mlp.dwconv.dwconv.weight"] == P.Split(0)
        assert mit[f"encoder.block{stage}.0.mlp.fc2.weight"] == P.Split(1)
        assert mit[f"encoder.block{stage}.0.mlp.fc2.bias"] is None
        assert mit[f"encoder.block{stage}.0.norm1.weight"] is None
    assert mit["encoder.block2.0.attn.kv.weight"] == P.Split(0, 2)
    assert mit["encoder.block1.0.attn.sr.weight"] is None
    assert mit["encoder.block2.0.attn.proj.bias"] is None
    # 3 divides neither the 2 heads nor the hidden 256: all replicated
    assert all(s is None for s in P.shard_params_spec(_tiny("dofa"), 3,
                                                      P.TENSOR_PARALLEL_RULES).values())
    assert all(s is None for s in P.shard_params_spec(_tiny("dofa"), 2, None).values())


def test_dofa_base_shards_72_tensors():
    """DOFA-base under a model axis of 2: 12 blocks x (qkv weight and bias,
    proj weight, fc1 weight and bias, fc2 weight), the packed qkv one leaf
    each (the JAX package's separate q, k, v count 120)."""
    with torch.device("meta"):
        encoder = DOFAv2("dofa_base", img_size=512)
    spec = P.shard_params_spec(encoder, 2, P.TENSOR_PARALLEL_RULES)
    assert sum(s is not None for s in spec.values()) == 72


@pytest.mark.parametrize("parts", [3, 2])
def test_packed_projection_is_cut_head_aligned(parts):
    """The packed ``qkv [3D, D]`` (``kv [2D, D]``), 4 heads of 2 over 2
    model ranks: rank r holds heads ``2r, 2r + 1`` of each of q, k(, v), as
    a hand-built slice of the rows; the gather puts the whole back."""
    heads, hd, dim = 4, 2, 8
    w = torch.arange(parts * heads * hd * dim, dtype=torch.float32).reshape(-1, dim)
    split = P.Split(0, parts)
    for r in range(2):
        rows = [p * heads * hd + h * hd + i for p in range(parts)
                for h in (2 * r, 2 * r + 1) for i in range(hd)]
        assert torch.equal(P.local_slice(w, split, r, 2), w[rows])
    whole = torch.zeros_like(w)
    for r in range(2):
        P._shard_view(whole, split, r, 2).copy_(P.local_slice(w, split, r, 2).unflatten(
            0, (parts, -1)))
    assert torch.equal(whole, w)
    got = P.shard_params({"w": w, "b": w[:, 0]}, {"w": split, "b": None}, 1, 2)
    assert got["b"] is not None and torch.equal(got["w"], P.local_slice(w, split, 1, 2))


def test_unetpp_runs_fully_replicated_with_the_jax_warning(caplog):
    """No UNet++ parameter matches the rules: ``place_state`` changes
    nothing and logs the JAX package's warning."""
    model = UnetPlusPlus("resnet18", num_classes=1, decoder_channels=(16, 8, 8, 8, 8))
    before = {n: p.shape for n, p in model.named_parameters()}
    with caplog.at_level(logging.WARNING):
        P.place_state(model, Mesh(model_size=2), P.TENSOR_PARALLEL_RULES)
    assert "no parameter matched the tensor-parallel rules; running fully replicated" \
        in caplog.text
    assert {n: p.shape for n, p in model.named_parameters()} == before
    assert P.count_model_sharded(model) == 0


@pytest.mark.parametrize("l", [197, 1297])
def test_route_takes_the_head_major_pair_under_a_model_axis(l):
    """A shape the packed pair takes without a mesh goes to the head-major
    pair under a model axis of 2 (JAX ``mha.py:482-488``)."""
    assert tmha.route(12, l, 64) == "packed"
    assert tmha.route(6, l, 64, model_axis=2) == "head_major"
    assert tmha.route(12, l, 64, model_axis=1) == "packed"


def test_mesh_sizes_and_coordinates():
    """``data x model`` ranks; ``data: -1`` is one data rank on the CPU; a
    2-D mesh without its ranks raises (never a quiet one-rank run); the
    model axis moves fastest."""
    assert world_size(MeshConfig(data=2, model=2), torch.device("cpu")) == 4
    assert world_size(MeshConfig(data=-1, model=2), torch.device("cpu")) == 2
    with pytest.raises(ValueError, match="needs 4 ranks"):
        create_mesh(MeshConfig(data=2, model=2), device="cpu")
    mesh = Mesh(1, 2, model_rank=1, model_size=2)
    assert (mesh.global_rank, mesh.world_size) == (3, 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert not mesh.tensor_parallel  # no group


def test_copy_and_reduce_are_each_others_transpose():
    """Without a second rank (a group of one): ``copy_to_model`` and
    ``reduce_from_model`` are the identity both ways (bf16 comes back
    bf16), a row-parallel linear equals ``F.linear`` with its bias and
    scale, and the mean over the model group of equal gradients is
    exact."""
    import torch.distributed as dist

    from geo_deep_learning_tpu_torch.core.mesh import free_port
    from geo_deep_learning_tpu_torch.parallel import collectives as C

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((3, 5, 8))).float().requires_grad_()
        w = torch.from_numpy(rng.standard_normal((6, 8))).float().requires_grad_()
        b = torch.from_numpy(rng.standard_normal(6)).float().requires_grad_()
        s = torch.from_numpy(rng.standard_normal(6)).float().requires_grad_()
        y = C.row_parallel_linear(C.copy_to_model(x, group), w, b, group, s)
        ref = torch.nn.functional.linear(x, w * s[:, None], b * s)
        torch.testing.assert_close(y, ref)
        grads = torch.autograd.grad(y.square().sum(), (x, w, b, s))
        want = torch.autograd.grad(ref.square().sum(), (x, w, b, s))
        for g, h in zip(grads, want):
            torch.testing.assert_close(g, h)
        half = C.reduce_from_model(torch.ones(4, dtype=torch.bfloat16), group)
        assert half.dtype == torch.bfloat16 and torch.equal(half, torch.ones(4, dtype=half.dtype))
        grads = [g.clone() for g in want]
        C.average_over_model_(grads, group, 1)
        assert all(torch.equal(g, h) for g, h in zip(grads, want))
    finally:
        dist.destroy_process_group()
