"""Mammogram tiling into padded fixed-bucket bags.

Counterpart of ``montecarlo_gated_mil_tpu/ops/patching.py``.  Tile-grid
geometry is the reference's (``image_patcher.py:16-41``): stride
``int(patch_size * (1 - overlap))``, final tile snapped to the image border,
row-major (y outer, x inner), each tile recorded as ``(y, x, h, w, i, j)``.
Candidate tiles are fill-scored through a summed-area table, ranked by a
stable sort, and only the selected bucket is gathered, by the
``csrc/gather.cu`` kernel on the card (:func:`extract_bag_on_device`; the
loader's path, with canonicalization, flips and normalization, is
``data/pipeline.py::image_to_bag``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.ops import cuda_build


@dataclass(frozen=True)
class TileGrid:
    """Static tile geometry for one image size (host-side, hashable)."""

    patch_size: int
    overlap: float
    height: int
    width: int
    tiles: tuple[tuple[int, int, int, int, int, int], ...]

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    def tiles_array(self) -> np.ndarray:
        return np.asarray(self.tiles, dtype=np.int32)


def _start_points(size: int, split_size: int, overlap: float) -> list[int]:
    """Reference grid recurrence: stride steps, last tile snapped to
    ``size - split_size``; the snap is skipped when it repeats the previous
    start, so an exactly one-patch image is one tile."""
    points = [0]
    stride = int(split_size * (1 - overlap))
    if stride <= 0:
        raise ValueError(f"overlap {overlap} leaves a non-positive stride")
    counter = 1
    while True:
        pt = stride * counter
        if pt + split_size >= size:
            if size - split_size != points[-1]:
                points.append(size - split_size)
            break
        points.append(pt)
        counter += 1
    return points


def compute_tile_grid(height: int, width: int, patch_size: int, overlap: float) -> TileGrid:
    """Build the static tile grid for an image size."""
    if height < patch_size or width < patch_size:
        raise ValueError(f"image {height}x{width} smaller than patch_size {patch_size}")
    ys = _start_points(height, patch_size, overlap)
    xs = _start_points(width, patch_size, overlap)
    tiles = tuple(
        (y, x, patch_size, patch_size, i, j)
        for i, y in enumerate(ys)
        for j, x in enumerate(xs)
    )
    return TileGrid(patch_size, overlap, height, width, tiles)


def _windows(starts: torch.Tensor, patch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    ar = torch.arange(patch_size, device=starts.device)
    rows = starts[:, 0, None] + ar  # (K, p)
    cols = starts[:, 1, None] + ar
    return rows[:, :, None], cols[:, None, :]


def gather_tiles(image: torch.Tensor, starts: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Crop tiles from ``image (H, W, C)``: ``(K, p, p, C)``.  A start whose
    window leaves the image is clamped inside it, as ``lax.dynamic_slice``
    does in the JAX version."""
    h, w = image.shape[:2]
    lo = torch.zeros(2, dtype=starts.dtype, device=starts.device)
    hi = torch.tensor([h - patch_size, w - patch_size], dtype=starts.dtype, device=starts.device)
    rows, cols = _windows(torch.clamp(starts, lo, hi), patch_size)
    return image[rows, cols]


def gather_tiles_reference(
    image: torch.Tensor, starts: torch.Tensor, patch_size: int
) -> torch.Tensor:
    """Plain version of the gather kernel: ``(H, W) + (K, 2) -> (K, p, p)``,
    bit-exact crops for in-range starts, a zero tile for a start whose
    window leaves the image."""
    h, w = image.shape
    inside = (
        (starts[:, 0] >= 0) & (starts[:, 1] >= 0)
        & (starts[:, 0] + patch_size <= h) & (starts[:, 1] + patch_size <= w)
    )
    safe = torch.where(inside[:, None], starts, torch.zeros_like(starts))
    rows, cols = _windows(safe, patch_size)
    tiles = image[rows, cols]
    return torch.where(inside[:, None, None], tiles, torch.zeros_like(tiles))


def _gather_cuda(image: torch.Tensor, starts: torch.Tensor, patch_size: int) -> torch.Tensor:
    kernel = cuda_build.KERNELS["gather_tiles"]
    img = image.contiguous()
    cuda_build.require_cuda_f32(kernel.name, img)
    st = starts.to(device=img.device, dtype=torch.int64).contiguous()
    k = st.shape[0]
    out = torch.empty((k, patch_size, patch_size), dtype=torch.float32, device=img.device)
    fn = cuda_build.load(kernel.source).gather_tiles
    fn.restype = ctypes.c_int
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32, i32, ptr, i32, i32, ptr, ptr]
    err = fn(
        img.data_ptr(), img.shape[0], img.shape[1], st.data_ptr(), k, patch_size,
        out.data_ptr(), cuda_build.stream_handle(img.device),
    )
    cuda_build.check(err, kernel.name)
    kernel.launches += 1
    return out


def gather_selected(image: torch.Tensor, starts: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Single-channel tile gather ``(H, W) + (K, 2) -> (K, p, p)``.

    Counterpart of ``gather_selected``/``gather_tiles_dma``.  A CUDA image
    launches ``csrc/gather.cu``; a CPU image runs the plain version.
    """
    if image.is_cuda:
        return _gather_cuda(image, starts, patch_size)
    return gather_tiles_reference(image, starts, patch_size)


def sat_block_size(grid: TileGrid) -> int:
    """Largest block that tiles every candidate start and the patch: the gcd
    of all start coordinates and ``patch_size`` (4 at the production grid)."""
    g = grid.patch_size
    for y, x, *_ in grid.tiles:
        g = math.gcd(g, math.gcd(int(y), int(x)))
        if g == 1:
            break
    return g


def tile_fill_scores(patches: torch.Tensor) -> torch.Tensor:
    """Percent of nonzero pixels in channel 0 per tile (the reference's fill
    metric, ``image_patcher.py:53``): ``(K, h, w, C) -> (K,)``."""
    nonzero = (patches[..., 0] > 0).to(torch.float32)
    return nonzero.mean(dim=(-2, -1)) * 100.0


def tile_fill_scores_sat(
    image: torch.Tensor, starts: torch.Tensor, patch_size: int, block: int = 1
) -> torch.Tensor:
    """Percent of nonzero pixels per tile via a summed-area table, with no
    tile materialized.  Counts are exact integers; ``block`` (from
    :func:`sat_block_size`) pre-reduces nonzero counts to ``block x block``
    sums, exact whenever it divides every start and the patch."""
    p = patch_size
    nz = (image > 0).to(torch.int32)
    if block > 1:
        if p % block:
            raise ValueError(f"block {block} must divide patch_size {p}")
        hb, wb = nz.shape[0] // block, nz.shape[1] // block
        nz = nz[: hb * block, : wb * block].reshape(hb, block, wb, block).sum(dim=(1, 3))
    s = torch.zeros((nz.shape[0] + 1, nz.shape[1] + 1), dtype=torch.int64, device=nz.device)
    s[1:, 1:] = nz.cumsum(0).cumsum(1)
    y, x = starts[:, 0] // block, starts[:, 1] // block
    pb = p // block
    count = s[y + pb, x + pb] - s[y, x + pb] - s[y + pb, x] + s[y, x]
    return count.to(torch.float32) / (p * p) * 100.0


def select_tiles(
    fill_scores: torch.Tensor,
    bucket: int,
    empty_threshold: float,
    bag_size: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank tiles by fill, descending, keep those above ``empty_threshold``
    (optionally capped at ``bag_size``), always capped at ``bucket``.

    The sort is stable, so ties keep the lower index first as ``lax.top_k``
    does; every full tile ties at 100 % fill, and ``torch.topk`` promises
    no order among them.  Returns ``(indices (bucket,), mask (bucket,))``.
    """
    k = fill_scores.shape[0]
    take = min(bucket, k)
    order = torch.sort(fill_scores, descending=True, stable=True).indices[:take]
    if take < bucket:
        order = torch.cat([order, order.new_zeros(bucket - take)])
    thr = torch.tensor(empty_threshold * 100.0, dtype=torch.float32, device=fill_scores.device)
    cap = min(bucket, bag_size) if bag_size > 0 else bucket
    limit = torch.clamp((fill_scores > thr).sum(), max=cap)
    mask = torch.arange(bucket, device=fill_scores.device) < limit
    return order, mask


def extract_bag_on_device(
    image,
    grid: TileGrid,
    bucket: int,
    empty_threshold: float,
    bag_size: int = -1,
    label: int = 0,
    *,
    device: str | torch.device = "cuda",
) -> Bag:
    """Image ``(H, W, C)`` -> padded :class:`Bag` on ``device``: every tile of
    ``grid`` fill-scored on channel 0 through the summed-area table, the
    bucket selected (:func:`select_tiles`), and only the selected tiles
    gathered (a single channel by the gather kernel on the card), zero in
    padded slots.  The reference's unseeded bag shuffle is dropped, as in
    the JAX package: the model is invariant to the order of instances."""
    img = torch.as_tensor(image, device=device)
    starts = torch.as_tensor(grid.tiles_array()[:, :2], device=img.device).to(torch.int64)
    scores = tile_fill_scores_sat(img[..., 0], starts, grid.patch_size,
                                  block=sat_block_size(grid))
    idx, mask = select_tiles(scores, bucket, empty_threshold, bag_size)
    if img.shape[-1] == 1:
        patches = gather_selected(img[..., 0], starts[idx], grid.patch_size)[..., None]
    else:
        patches = gather_tiles(img, starts[idx], grid.patch_size)
    patches = torch.where(mask[:, None, None, None], patches, torch.zeros((), dtype=patches.dtype,
                                                                         device=img.device))
    return Bag(
        patches=patches,
        mask=mask,
        label=torch.tensor(label, dtype=torch.int64, device=img.device),
        tile_indices=torch.where(mask, idx, torch.zeros_like(idx)),
    )
