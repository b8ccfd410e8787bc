"""Port's masked reductions vs the JAX package's, all-masked rows included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarlo_gated_mil_tpu.ops import masked as jm
from montecarlo_gated_mil_tpu_torch.ops import masked as tm


def _inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 7)) * 3).astype(np.float32)
    mask = rng.random((5, 7)) > 0.4
    mask[2] = False  # all-masked row
    mask[3] = True
    return x, mask


def test_masked_softmax_matches_jax_and_zeroes_masked_rows():
    x, mask = _inputs()
    got = tm.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(jm.masked_softmax(jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert np.all(got[~mask] == 0) and np.all(got[2] == 0)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[3].sum(), 1.0, atol=1e-6)


@pytest.mark.parametrize("fn", ["masked_mean", "masked_var"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_masked_mean_and_var_match_jax(fn, axis):
    x, mask = _inputs()
    got = getattr(tm, fn)(torch.from_numpy(x), torch.from_numpy(mask), dim=axis).numpy()
    want = np.asarray(getattr(jm, fn)(jnp.asarray(x), jnp.asarray(mask), axis=axis))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if axis == 1:
        assert got[2] == 0.0  # all-masked row: zero, not NaN


def test_masked_keepdims_shape():
    x, mask = _inputs()
    got = tm.masked_var(torch.from_numpy(x), torch.from_numpy(mask), dim=1, keepdim=True)
    assert got.shape == (5, 1)
