"""The port's DOFA + UperNet against the JAX package's, on the CPU.

A narrow 5-block DOFA (registered in both packages' ``dofa_configs``) at
64^2 inputs. Seeded port weights, perturbed away from their identity-like
inits (norm scales and biases, LayerScale gammas, BatchNorm statistics) so
that every branch moves the output, go to the JAX package through its own
``convert_dofa_model`` and come back through ``from_jax_params``; both
forwards run in f32. Block 0 is not a tap,
so block 1 starts from a pending branch and runs the residual LayerNorm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import WAVES, jax_variables, numpy_state, register_tiny, tiny_model

from geo_deep_learning_tpu.models.segmentation.dofa import DOFASegmentation as JaxDOFASeg
from geo_deep_learning_tpu_torch.models.convert import from_jax_params
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation


@pytest.fixture
def models(monkeypatch):
    """Port weights -> the JAX package's converter -> JAX variables ->
    ``from_jax_params`` -> a second port model."""
    register_tiny(monkeypatch)
    source = tiny_model(num_classes=3)
    table = source.encoder.pos_embed.numpy()
    variables = jax_variables(source)
    port = DOFASegmentation("tiny", num_classes=3, decoder_channels=32, img_size=64)
    port.load_state_dict(
        from_jax_params(variables["params"], variables["batch_stats"], pos_embed=table),
        strict=True,
    )
    port.eval()
    jax_model = JaxDOFASeg(
        encoder_name="tiny", num_classes=3, decoder_channels=32, pos_embed_table=table
    )
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.float32) / 255.0
    return source, port, jax_model, variables, x


def test_from_jax_params_inverts_convert(models):
    source, port, _, _, _ = models
    want, got = numpy_state(source), numpy_state(port)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_forward_matches_jax(models):
    _, port, jax_model, variables, x = models
    apply = jax.jit(lambda v, x, w: jax_model.apply(v, x, w, train=False))
    want = apply(variables, jnp.asarray(x), jnp.asarray(WAVES))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(WAVES))
    for g, w in ((got.out, want.out), (got.aux, want.aux)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        assert np.abs(np.asarray(w)).max() > 1e-2  # the comparison is not of zeros
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
