"""Port's image -> Bag pipeline vs the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.data import pipeline as jpl
from montecarlo_gated_mil_tpu.data.synthetic import synthetic_image as jax_synthetic_image
from montecarlo_gated_mil_tpu_torch.data import pipeline as tpl
from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image

CFG = dict(height=128, width=128, patch_size=64, overlap=0.5, empty_threshold=0.5, bucket=16)


def _bags(img, flip, **over):
    jcfg = jpl.PipelineConfig(**{**CFG, **over})
    tcfg = tpl.PipelineConfig(**{**CFG, **over})
    starts = jcfg.grid().tiles_array()[:, :2]
    jbag = jpl.image_to_bag(
        jnp.asarray(img), jnp.asarray(flip), jnp.asarray(1), jax.random.key(0),
        jnp.asarray(starts), jcfg,
    )
    tbag = tpl.image_to_bag(img, flip, 1, torch.from_numpy(starts), tcfg, device="cpu")
    return jbag, tbag


def test_synthetic_image_is_the_same_generator():
    np.testing.assert_array_equal(
        synthetic_image(64, 48, positive=True, seed=3),
        jax_synthetic_image(64, 48, positive=True, seed=3),
    )


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_image_to_bag_matches_jax(flip, seed):
    img = synthetic_image(128, 128, positive=bool(seed), seed=seed)
    jbag, tbag = _bags(img, flip)
    np.testing.assert_array_equal(tbag.mask.numpy(), np.asarray(jbag.mask))
    np.testing.assert_array_equal(tbag.tile_indices.numpy(), np.asarray(jbag.tile_indices))
    assert tbag.patches.dtype == torch.float32 and tbag.patches.shape == (16, 64, 64, 3)
    np.testing.assert_allclose(tbag.patches.numpy(), np.asarray(jbag.patches), atol=1e-6, rtol=0)
    assert int(tbag.num_instances) == int(jbag.num_instances) > 0
    assert torch.all(tbag.patches[~tbag.mask] == 0)


@pytest.mark.parametrize("flip", [False, True])
def test_estimate_and_count_equal_jax(flip):
    cfg = tpl.PipelineConfig(**CFG)
    jcfg = jpl.PipelineConfig(**CFG)
    starts = cfg.grid().tiles_array()[:, :2]
    for seed in range(3):
        img = synthetic_image(128, 128, positive=True, seed=seed)
        assert tpl.estimate_valid_tiles(
            img, flip, starts, cfg, margin_hi=tpl.ESTIMATE_MARGIN_HI
        ) == jpl.estimate_valid_tiles(img, flip, starts, jcfg, margin_hi=jpl.ESTIMATE_MARGIN_HI)
        assert tpl.count_valid_tiles(img, flip, starts, cfg, device="cpu") == int(
            jpl.count_valid_tiles(jnp.asarray(img), jnp.asarray(flip), jnp.asarray(starts), jcfg)
        )
    assert tpl.estimate_valid_tiles(np.zeros((100, 128)), flip, starts, cfg) is None


def test_mirror_and_translate_are_exact():
    img = synthetic_image(96, 80, positive=True, seed=5)
    for flip in (False, True):
        got = tpl.canonicalize_image(torch.from_numpy(img), flip, (96, 80)).numpy()
        want = np.asarray(jpl.canonicalize_image(jnp.asarray(img), jnp.asarray(flip), (96, 80)))
        np.testing.assert_array_equal(got, want)


def test_offsize_resize_deviation_is_bounded():
    """Antialiased bilinear resize: ``F.interpolate`` and
    ``jax.image.resize`` are different code (ROADMAP.md, faults found in the
    port); here they agree to rounding.  This pins it so a change shows."""
    rng = np.random.default_rng(0)
    img = rng.random((150, 110)).astype(np.float32)
    got = tpl.canonicalize_image(torch.from_numpy(img), False, (96, 80)).numpy()
    want = np.asarray(jpl.canonicalize_image(jnp.asarray(img), jnp.asarray(False), (96, 80)))
    assert got.shape == want.shape == (96, 80)
    assert np.abs(got - want).max() < 1e-6
