"""The port's data-parallel scene paths against the JAX package's and one rank.

``sliding_window_logits_sharded`` (JAX ``sliding_window.py:225``),
``sliding_window_logits_halo`` (``:445``) and ``streamed_scene_logits_writer``
with a mesh (``streaming.py:51 _band_acc_sharded``) on two ranks of a gloo
group, launched once for the module (the workers import no JAX), against the
same functions of the JAX package on a two-device mesh of conftest's CPU
devices and against the port's one-rank ``sliding_window_logits``.

The model is a seeded function of each pixel's bands plus a fixed pattern
over the tile's own rows and columns (so the blend weights and the tile
placement matter), made of elementwise operations only: each tile's logits
do not depend on which tiles share its batch, as a real model's need not.
Scene 200 x 130 x 3, tiles 64 with overlap 16 (4 x 3 tiles, two tile rows
a rank on the halo path), tile batch 3.

Tolerances: against the JAX package 1e-5 absolute (the two packages' sin
and sums round apart); sharded and streamed against one rank 1e-5 (each
pixel's sum regroups by rank); halo against one rank's ``blend='crop'`` map
bit-identical outside the exchanged strips and within 1e-5 inside them
(JAX's contract).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geo_deep_learning_tpu.inference.sliding_window as jsw
import geo_deep_learning_tpu.inference.streaming as jstream
from geo_deep_learning_tpu.core.mesh import MeshConfig as JaxMeshConfig
from geo_deep_learning_tpu.core.mesh import create_mesh as jax_create_mesh
from geo_deep_learning_tpu_torch.core.mesh import Mesh, launch
from geo_deep_learning_tpu_torch.inference import sliding_window as tsw
from geo_deep_learning_tpu_torch.inference import streaming as tstream

import _torch_dp_scene as S


def _jax_forward(tiles):
    """The JAX twin of ``_torch_dp_scene.forward``."""
    coef, pattern = (jnp.asarray(a) for a in S.weights())
    z = tiles[..., 0:1] * coef[0] + tiles[..., 1:2] * coef[1] + tiles[..., 2:3] * coef[2]
    return jnp.sin(z) + pattern


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_scene")
    launch(S.run, (str(out),), size=2, backend="gloo", deadline_s=120)
    return [dict(np.load(out / f"scene_rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def one_rank():
    scene = torch.from_numpy(S.scene())
    return {blend: tsw.sliding_window_logits(S.forward, scene, S.K, S.config(blend)).numpy()
            for blend in ("hann", "crop")}


def _jax_mesh():
    import jax

    return jax_create_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])


def test_sharded_matches_jax_and_one_rank(ranks, one_rank):
    want = np.asarray(jsw.sliding_window_logits_sharded(
        _jax_forward, S.scene(), S.K, _jax_mesh(), S.config("hann")))
    for r in ranks:
        assert r["sharded"].shape == (S.H, S.W, S.K)
        np.testing.assert_allclose(r["sharded"], want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["sharded"], one_rank["hann"], atol=1e-5, rtol=0)
    assert np.array_equal(ranks[0]["sharded"], ranks[1]["sharded"])


def test_halo_is_bit_identical_outside_its_strips(ranks, one_rank):
    want = np.asarray(jsw.sliding_window_logits_halo(
        _jax_forward, S.scene(), S.K, _jax_mesh(), S.config("crop")))
    plan = tsw.plan_bands(S.H, S.W, S.config("crop"), 2)
    assert plan is not None and plan["counts"] == [2, 2]
    boundary, strip = plan["bounds"][1], plan["strip"]
    in_strip = np.zeros(S.H, bool)
    in_strip[boundary - strip:boundary + strip] = True
    ref = one_rank["crop"]
    for r in ranks:
        got = r["halo"]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert np.array_equal(got[~in_strip], ref[~in_strip])
        np.testing.assert_allclose(got[in_strip], ref[in_strip], atol=1e-5, rtol=0)
    assert np.array_equal(ranks[0]["halo"], ranks[1]["halo"])


def test_halo_rejects_other_blends():
    with pytest.raises(ValueError, match="crop"):
        tsw.sliding_window_logits_halo(S.forward, torch.zeros(8, 8, 3), S.K,
                                       Mesh(), S.config("hann"))


def test_streamed_writer_over_two_ranks(ranks):
    """Each band's tiles striped over the ranks: every rank writes the same
    rows, equal to the JAX streamer on a mesh and to one rank's."""
    got = {}
    jstream.streamed_scene_logits_writer(
        _jax_forward, S.Reader(), lambda r0, rows: got.__setitem__(r0, np.asarray(rows)), S.K,
        S.config("hann"), band_tile_rows=2, mesh=_jax_mesh())
    want = np.concatenate([got[k] for k in sorted(got)])
    one = {}
    tstream.streamed_scene_logits_writer(
        S.forward, S.Reader(), lambda r0, rows: one.__setitem__(r0, rows.numpy()), S.K,
        S.config("hann"), band_tile_rows=2)
    one = np.concatenate([one[k] for k in sorted(one)])
    for r in ranks:
        np.testing.assert_allclose(r["streamed"], want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["streamed"], one, atol=1e-5, rtol=0)
        assert r["streamed_starts"].tolist() == sorted(got)
