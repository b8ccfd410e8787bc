"""Attention-map reconstruction: bag attention -> full-resolution maps.

Counterpart of ``montecarlo_gated_mil_tpu/viz/attention.py`` (reference
``image_patcher.py:83-110``): paint each instance's attention back over its
tile rectangle, average overlaps, then normalize by the per-(pass, class)
maximum.

Tiles form a regular grid of equal rectangles, so a map is constant on each
cell between consecutive tile boundaries: 127 x 50 cells for the 123 x 47
tile grid of the shipped 7036 x 2800 geometry.  Everything up to the last
step runs on that cell grid: scatter attention onto the ``(R, S)`` tile
grid, sum the tiles covering each cell (two small 0/1 products), divide by
the overlap count, normalize by each ``(t, c)`` peak, and, for the serving
statistics, reduce over T.  Only the ``(C, cells)`` mean and std are then
expanded to pixels, or straight to their k-fold box mean, so the serving
path never allocates the ``(T, C, H, W)`` stack (7.9 GB at the shipped
geometry with T=50).  The cell arithmetic runs in float64, which keeps it
exact to f32 whatever the caller's TF32 settings.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.ops.patching import TileGrid

_F64 = torch.float64


def _membership(points: np.ndarray, size: int, patch: int) -> np.ndarray:
    """0/1 matrix M[pixel, tile_row]: pixel covered by that row's rectangle."""
    m = np.zeros((size, len(points)), np.float32)
    for j, p in enumerate(points):
        m[p : p + patch, j] = 1.0
    return m


def membership_matrices(grid: TileGrid) -> tuple[np.ndarray, np.ndarray]:
    """(RowMask (H, R), ColMask (W, S)) for a tile grid."""
    tiles = grid.tiles_array()
    ys = np.unique(tiles[:, 0])
    xs = np.unique(tiles[:, 1])
    return (
        _membership(ys, grid.height, grid.patch_size),
        _membership(xs, grid.width, grid.patch_size),
    )


@dataclass(frozen=True)
class _Axis:
    """One axis of the cell grid.  ``edges``: the cell boundaries (every
    tile start and end, and 0 and the size); ``cover (cells, tiles)``: 0/1,
    cell inside that tile row (or column); ``cell_of (size,)``: the cell of
    each pixel."""

    edges: np.ndarray
    cover: np.ndarray
    cell_of: np.ndarray

    def box_weights(self, factor: int) -> np.ndarray:
        """``(ceil(size / factor), cells)``: the share of each output
        window's pixels that lie in each cell.  A partial edge window is
        weighted by the pixels it covers, as an exact box mean."""
        size = int(self.edges[-1])
        lo = np.arange(0, size, factor)
        hi = np.minimum(lo + factor, size)
        inside = np.minimum(hi[:, None], self.edges[None, 1:]) - np.maximum(
            lo[:, None], self.edges[None, :-1]
        )
        return np.clip(inside, 0, None) / (hi - lo)[:, None]


def _axis(points: np.ndarray, size: int, patch: int) -> _Axis:
    edges = np.unique(np.concatenate([[0, size], points, np.minimum(points + patch, size)]))
    cover = _membership(points, size, patch)[edges[:-1]].astype(np.float64)
    cell_of = np.searchsorted(edges, np.arange(size), side="right") - 1
    return _Axis(edges, cover, cell_of)


@lru_cache(maxsize=8)
def _cells(grid: TileGrid) -> tuple[_Axis, _Axis]:
    """The (row, column) cell axes of a grid; a predictor asks for the same
    grid on every maps request."""
    tiles = grid.tiles_array()
    return (
        _axis(np.unique(tiles[:, 0]), grid.height, grid.patch_size),
        _axis(np.unique(tiles[:, 1]), grid.width, grid.patch_size),
    )


def _cell_maps(
    attention: torch.Tensor,  # (T, C, N)
    tile_indices: torch.Tensor,  # (N,)
    mask: torch.Tensor,  # (N,) bool
    rows: _Axis,
    cols: _Axis,
) -> torch.Tensor:
    """``(T, C, I, J)`` float64 maps on the cell grid: overlap-averaged,
    per-(pass, class) max-normalized; padded slots contribute nothing."""
    t, c, _ = attention.shape
    dev = attention.device
    n_rows, n_cols = rows.cover.shape[1], cols.cover.shape[1]
    idx = tile_indices.to(torch.int64)  # row-major: tile (i, j) is i * n_cols + j
    att = torch.where(mask, attention, torch.zeros((), dtype=attention.dtype, device=dev))
    a_grid = torch.zeros((t, c, n_rows * n_cols), dtype=_F64, device=dev)
    a_grid.index_add_(2, idx, att.to(_F64))
    ones = torch.zeros(n_rows * n_cols, dtype=_F64, device=dev).index_add_(0, idx, mask.to(_F64))
    row_m, col_m = torch.as_tensor(rows.cover, device=dev), torch.as_tensor(cols.cover, device=dev)
    maps = row_m @ a_grid.view(t, c, n_rows, n_cols) @ col_m.T
    counts = row_m @ ones.view(n_rows, n_cols) @ col_m.T
    maps = maps / counts.clamp(min=1.0)
    peak = maps.amax(dim=(-2, -1), keepdim=True)
    return maps / torch.where(peak > 0, peak, torch.ones((), dtype=_F64, device=dev))


def _expand(x: torch.Tensor, rows: _Axis, cols: _Axis) -> torch.Tensor:
    """``(..., I, J)`` cell values -> ``(..., H, W)`` float32 pixels (each
    pixel copies its cell)."""
    dev = x.device
    x = x.to(torch.float32).index_select(-2, torch.as_tensor(rows.cell_of, device=dev))
    return x.index_select(-1, torch.as_tensor(cols.cell_of, device=dev))


def _box_mean_cells(x: torch.Tensor, rows: _Axis, cols: _Axis, factor: int) -> torch.Tensor:
    """The exact ``factor``-fold box mean of the pixel map that ``x``
    ``(C, I, J)`` expands to, without expanding it."""
    if factor == 1:
        return _expand(x, rows, cols)
    wr = torch.as_tensor(rows.box_weights(factor), device=x.device)
    wc = torch.as_tensor(cols.box_weights(factor), device=x.device)
    return (wr @ x @ wc.T).to(torch.float32)


def _box_mean(maps: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact box-average downsample of ``(..., H, W)`` by ``factor``: zero
    padding with per-axis true-pixel counts keeps partial edge windows an
    exact mean over the pixels they actually cover."""
    if factor == 1:
        return maps
    h, w = maps.shape[-2:]
    ph, pw = -h % factor, -w % factor
    x = torch.nn.functional.pad(maps, (0, pw, 0, ph))
    x = x.reshape(*x.shape[:-2], (h + ph) // factor, factor, (w + pw) // factor, factor)
    sums = x.sum(dim=(-3, -1))
    ch = torch.full(((h + ph) // factor,), float(factor), dtype=maps.dtype, device=maps.device)
    cw = torch.full(((w + pw) // factor,), float(factor), dtype=maps.dtype, device=maps.device)
    if ph:
        ch[-1] = factor - ph
    if pw:
        cw[-1] = factor - pw
    return sums / (ch[:, None] * cw[None, :])


def attention_map_stats(
    attention: torch.Tensor,
    tile_indices: torch.Tensor,
    mask: torch.Tensor,
    grid: TileGrid,
    *,
    downsample: int = 1,
    ddof: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class (mean, std-over-T) attention maps ``(C, H', W')`` float32,
    optionally box-averaged down by ``downsample`` (``H' = ceil(H / k)``).

    The downsampled map is the exact box mean of the full-resolution one;
    ``std`` uses ddof=1, the torch convention the reference's figure path
    follows (the reference's ``infer.py:212-219``), and is zero when
    ``T <= ddof``.  Computed on the cell grid (module docstring): no
    ``(T, C, H, W)`` tensor is allocated.
    """
    if downsample < 1:
        raise ValueError(f"downsample must be >= 1, got {downsample}")
    rows, cols = _cells(grid)
    maps = _cell_maps(attention, tile_indices, mask, rows, cols)
    mean = maps.mean(0)
    std = maps.std(0, correction=ddof) if maps.shape[0] > ddof else torch.zeros_like(mean)
    return (
        _box_mean_cells(mean, rows, cols, downsample),
        _box_mean_cells(std, rows, cols, downsample),
    )


def reconstruct_attention_maps(
    attention: torch.Tensor, tile_indices: torch.Tensor, mask: torch.Tensor, grid: TileGrid
) -> torch.Tensor:
    """``(T, C, N)`` attention -> ``(T, C, H, W)`` float32 maps (per-pass/
    class max-normalized, overlap-averaged; padded slots contribute
    nothing).  Allocates the whole stack: for figures, not for serving."""
    rows, cols = _cells(grid)
    return _expand(_cell_maps(attention, tile_indices, mask, rows, cols), rows, cols)


def reconstruct_image_from_patches(
    patches: torch.Tensor, tile_indices: torch.Tensor, mask: torch.Tensor, grid: TileGrid
) -> torch.Tensor:
    """Overlap-averaged image reconstruction (spec:
    ``image_patcher.py:62-80``): ``(N, p, p, C)`` patches -> ``(H, W, C)``;
    padded slots contribute nothing."""
    dev = patches.device
    n, p, _, c = patches.shape
    tiles = torch.as_tensor(grid.tiles_array()[:, :2].astype(np.int64), device=dev)
    starts = tiles[tile_indices.to(torch.int64)]
    ar = torch.arange(p, device=dev)
    ys = starts[:, 0, None, None] + ar[None, :, None]
    xs = starts[:, 1, None, None] + ar[None, None, :]
    flat = (ys * grid.width + xs).reshape(-1)  # (N * p * p,) pixel of each patch element
    v = mask.to(patches.dtype)
    canvas = torch.zeros((grid.height * grid.width, c), dtype=patches.dtype, device=dev)
    canvas.index_add_(0, flat, (patches * v[:, None, None, None]).reshape(-1, c))
    counts = torch.zeros(grid.height * grid.width, dtype=patches.dtype, device=dev)
    counts.index_add_(0, flat, v.repeat_interleave(p * p))
    return (canvas / counts.clamp(min=1.0)[:, None]).view(grid.height, grid.width, c)
