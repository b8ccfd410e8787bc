"""Port's tiling, fill scoring, selection and tile gather vs the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarlo_gated_mil_tpu.ops import patching as jp
from montecarlo_gated_mil_tpu_torch.ops import patching as tp

GEOMETRIES = [
    (703, 280, 224, 0.75),  # production-like: border remainders
    (150, 150, 48, 0.5),  # multiple x phases
    (128, 128, 64, 0.0),  # exact grid, no remainders
]


@pytest.mark.parametrize(
    "h,w,p,overlap",
    GEOMETRIES + [(7036, 2800, 224, 0.75), (7036, 2800, 224, 0.5), (224, 224, 224, 0.5)],
)
def test_grid_and_block_size_equal_jax(h, w, p, overlap):
    tg, jg = tp.compute_tile_grid(h, w, p, overlap), jp.compute_tile_grid(h, w, p, overlap)
    assert tg.tiles == jg.tiles
    np.testing.assert_array_equal(tg.tiles_array(), jg.tiles_array())
    assert tp.sat_block_size(tg) == jp.sat_block_size(jg)


def test_production_grid_has_5781_candidates():
    assert tp.compute_tile_grid(7036, 2800, 224, 0.75).num_tiles == 5781


@pytest.mark.parametrize("h,w,p,overlap", GEOMETRIES)
@pytest.mark.parametrize("blocked", [False, True])
def test_sat_scores_exactly_equal_jax(h, w, p, overlap, blocked):
    grid = tp.compute_tile_grid(h, w, p, overlap)
    block = tp.sat_block_size(grid) if blocked else 1
    rng = np.random.default_rng(0)
    img = rng.random((h, w)).astype(np.float32)
    img[: h // 3] = 0.0
    img[:, w // 2 :] *= rng.random((h, w - w // 2)) > 0.5
    starts = grid.tiles_array()[:, :2]
    got = tp.tile_fill_scores_sat(torch.from_numpy(img), torch.from_numpy(starts).long(), p, block)
    want = jp.tile_fill_scores_sat(jnp.asarray(img), jnp.asarray(starts), p, block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bucket,threshold,bag_size", [(8, 0.6, -1), (16, 0.0, -1), (4, 0.5, 3)])
def test_select_tiles_same_order_with_ties(bucket, threshold, bag_size):
    """Full tiles all tie at 100 %: the stable sort keeps the lower index
    first, as lax.top_k does."""
    scores = np.array(
        [100.0, 50.0, 100.0, 10.0, 100.0, 80.0, 80.0, 0.0, 100.0, 65.0, 100.0, 20.0],
        np.float32,
    )
    got_idx, got_mask = tp.select_tiles(torch.from_numpy(scores), bucket, threshold, bag_size)
    want_idx, want_mask = jp.select_tiles(jnp.asarray(scores), bucket, threshold, bag_size)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("h,w,p,overlap", GEOMETRIES)
def test_plain_gather_bit_exact_vs_interpreted_dma_kernel(h, w, p, overlap):
    grid = tp.compute_tile_grid(h, w, p, overlap)
    rng = np.random.default_rng(0)
    img = rng.random((h, w), np.float32)
    starts = grid.tiles_array()[:, :2]
    y_rems, x_rems = jp.gather_remainders(jp.compute_tile_grid(h, w, p, overlap))
    want = jp.gather_tiles_dma(
        jp.pad_for_dma_gather(jnp.asarray(img), p), jnp.asarray(starts), p, y_rems, x_rems,
        interpret=True,
    )
    got = tp.gather_selected(torch.from_numpy(img), torch.from_numpy(starts).long(), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_out_of_range_start_is_zero_filled():
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.random((40, 50), np.float32) + 0.5)
    starts = torch.tensor([[0, 0], [24, 34], [25, 0], [0, 35], [-1, 3]])
    got = tp.gather_selected(img, starts, 16)
    torch.testing.assert_close(got[0], img[:16, :16], atol=0, rtol=0)
    torch.testing.assert_close(got[1], img[24:40, 34:50], atol=0, rtol=0)
    assert torch.all(got[2:] == 0)


def test_multichannel_gather_clamps_like_dynamic_slice():
    rng = np.random.default_rng(2)
    img = rng.random((40, 50, 3), np.float32)
    starts = np.array([[0, 0], [30, 45], [5, 7]])
    got = tp.gather_tiles(torch.from_numpy(img), torch.from_numpy(starts), 16)
    want = jp.gather_tiles(jnp.asarray(img), jnp.asarray(starts), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
