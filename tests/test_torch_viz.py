"""The port's attention-map reconstruction against the JAX package's and
against the numpy transcription of the reference formula in test_viz.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarlo_gated_mil_tpu.ops.patching import compute_tile_grid as jax_grid
from montecarlo_gated_mil_tpu.viz import attention as jviz
from montecarlo_gated_mil_tpu_torch.ops.patching import compute_tile_grid
from montecarlo_gated_mil_tpu_torch.viz import attention as tviz
from test_viz import _numpy_reference


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (H, W, patch, overlap, bag slots, valid slots, T): test_viz's geometry;
# padding (padded slots point at tile 0 and hold nonzero attention); a
# border-snapped last tile with overlap 0.5; T = 1 (std is zero).
CASES = {
    "overlap": (96, 128, 32, 0.5, 8, 8, 3),
    "padding": (64, 64, 32, 0.0, 4, 2, 2),
    "snapped": (100, 90, 32, 0.5, 12, 9, 4),
    "one_sample": (128, 128, 64, 0.5, 8, 6, 1),
}


def _inputs(case, seed=0):
    h, w, p, overlap, n, n_valid, t = CASES[case]
    rng = np.random.default_rng(seed)
    grid = compute_tile_grid(h, w, p, overlap)
    ids = np.zeros(n, np.int64)
    ids[:n_valid] = rng.choice(grid.num_tiles, size=n_valid, replace=False)
    att = rng.random((t, 2, n)).astype(np.float32)
    att /= att.sum(-1, keepdims=True)
    mask = np.arange(n) < n_valid
    return grid, jax_grid(h, w, p, overlap), att, ids, mask


def _np_box_mean(x, k):
    h, w = x.shape[-2:]
    sums = np.add.reduceat(np.add.reduceat(x, np.arange(0, h, k), axis=-2),
                           np.arange(0, w, k), axis=-1)
    ch = np.minimum(np.arange(0, h, k) + k, h) - np.arange(0, h, k)
    cw = np.minimum(np.arange(0, w, k) + k, w) - np.arange(0, w, k)
    return sums / (ch[:, None] * cw[None, :])


@pytest.mark.parametrize("downsample", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_map_stats_matches_jax_and_formula(case, downsample):
    grid, jgrid, att, ids, mask = _inputs(case)
    mean, std = tviz.attention_map_stats(
        torch.from_numpy(att), torch.from_numpy(ids), torch.from_numpy(mask), grid,
        downsample=downsample,
    )
    jmean, jstd = jviz.attention_map_stats(
        jnp.asarray(att), jnp.asarray(ids, jnp.int32), jnp.asarray(mask), jgrid,
        downsample=downsample,
    )
    h, w = grid.height, grid.width
    assert mean.shape == std.shape == (2, -(-h // downsample), -(-w // downsample))
    assert mean.dtype == std.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6, rtol=0)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), atol=1e-6, rtol=0)
    ref = _numpy_reference(att[:, :, mask], ids[mask], grid.tiles_array(), h, w)
    ref_std = ref.std(0, ddof=1) if ref.shape[0] > 1 else np.zeros_like(ref[0])
    np.testing.assert_allclose(mean.numpy(), _np_box_mean(ref.mean(0), downsample), atol=1e-6)
    np.testing.assert_allclose(std.numpy(), _np_box_mean(ref_std, downsample), atol=1e-6)
    if att.shape[0] == 1:
        assert torch.all(std == 0)
    assert float(mean.max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("case", sorted(CASES))
def test_reconstruct_attention_maps_matches_jax(case):
    grid, jgrid, att, ids, mask = _inputs(case, seed=1)
    got = tviz.reconstruct_attention_maps(
        torch.from_numpy(att), torch.from_numpy(ids), torch.from_numpy(mask), grid
    )
    want = jviz.reconstruct_attention_maps(
        jnp.asarray(att), jnp.asarray(ids, jnp.int32), jnp.asarray(mask), jgrid
    )
    assert got.shape == (att.shape[0], 2, grid.height, grid.width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_membership_and_box_mean_match_jax():
    grid = compute_tile_grid(100, 90, 32, 0.5)
    for got, want in zip(tviz.membership_matrices(grid),
                         jviz.membership_matrices(jax_grid(100, 90, 32, 0.5))):
        np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(3).random((2, 37, 29)).astype(np.float32)
    for k in (1, 3, 8):
        np.testing.assert_allclose(tviz._box_mean(torch.from_numpy(x), k).numpy(),
                                   np.asarray(jviz._box_mean(jnp.asarray(x), k)), atol=1e-6)
    with pytest.raises(ValueError, match="downsample"):
        tviz.attention_map_stats(torch.zeros(1, 2, 1), torch.zeros(1, dtype=torch.int64),
                                 torch.ones(1, dtype=torch.bool), grid, downsample=0)


def test_reconstruct_image_from_patches_matches_jax():
    rng = np.random.default_rng(4)
    grid = compute_tile_grid(40, 56, 16, 0.5)
    n = grid.num_tiles + 3
    ids = np.concatenate([rng.permutation(grid.num_tiles), np.zeros(3, np.int64)])
    mask = np.arange(n) < grid.num_tiles - 2  # two tiles unselected, three padded slots
    patches = rng.random((n, 16, 16, 3)).astype(np.float32)
    got = tviz.reconstruct_image_from_patches(
        torch.from_numpy(patches), torch.from_numpy(ids), torch.from_numpy(mask), grid
    )
    want = jviz.reconstruct_image_from_patches(
        jnp.asarray(patches), jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jax_grid(40, 56, 16, 0.5),
    )
    assert got.shape == (40, 56, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
