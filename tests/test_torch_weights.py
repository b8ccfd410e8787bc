"""``weights.from_jax_params`` against ``models/port.py::port_multihead_gamil``,
composed both ways, and the two packages computing one function."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.models.port import port_multihead_gamil
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.experiment import build_model
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params


@functools.cache
def _jax_params(shared):
    model = JaxMIL(shared_attention=shared)
    x = jnp.zeros((2, 32, 32, 3))
    variables = jax.jit(model.init)(jax.random.key(0), x, jnp.ones(2, bool))
    return model, jax.tree.map(np.asarray, variables["params"])


def _sd_np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.mark.parametrize("shared", [True, False])
def test_jax_to_port_to_jax_is_identity(shared):
    _, params = _jax_params(shared)
    sd = from_jax_params({"params": params})
    back = port_multihead_gamil(_sd_np(sd), shared_attention=shared)["params"]
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # the port's model takes the state_dict with every key accounted for
    model = build_model(Config(shared_att=shared))
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("shared", [True, False])
def test_port_to_jax_to_port_is_identity(shared):
    sd0 = build_model(Config(shared_att=shared), seed=3).state_dict()
    sd1 = from_jax_params(port_multihead_gamil(_sd_np(sd0), shared_attention=shared))
    assert set(sd1) == set(sd0)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


@pytest.mark.parametrize("shared", [True, False])
def test_head_params_from_jax_tree_equal_from_port_module(shared):
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams

    _, params = _jax_params(shared)
    model = build_model(Config(shared_att=shared))
    model.load_state_dict(from_jax_params(params))
    a = GatedAttentionParams.from_model_params(params)
    b = GatedAttentionParams.from_module(model)
    assert a.separate == b.separate == (not shared)
    for f in ("w_V", "b_V", "w_U", "b_U", "w_att", "b_att", "w_cls"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_seeded_init_is_reproducible():
    a = build_model(Config(), seed=1).state_dict()
    b = build_model(Config(), seed=1).state_dict()
    c = build_model(Config(), seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["attention_V.0.0.weight"], c["attention_V.0.0.weight"])


@pytest.mark.parametrize("shared", [True, False])
def test_same_weights_same_function(shared):
    """Deterministic forward of one bag: the JAX model and the port's model
    loaded through from_jax_params agree (f32, 96x96 patches)."""
    jmodel, params = _jax_params(shared)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 96, 96, 3)).astype(np.float32)
    mask = np.array([True, True, True, False, True, True])
    y_j, a_j, _ = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tmodel = build_model(Config(shared_att=shared))
    tmodel.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        y_t, a_t = tmodel(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-4)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5)
    assert np.all(a_t.numpy()[:, 3] == 0)
