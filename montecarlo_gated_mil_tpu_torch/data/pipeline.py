"""Image -> Bag preprocessing, on the device.

Counterpart of ``montecarlo_gated_mil_tpu/data/pipeline.py``: mirror
right-laterality images to left, translate by -20 px in x, resize to the
configured H x W, score every candidate tile through a summed-area table,
select the filled tiles into a bucket, gather only those, and normalize with
the ImageNet statistics.  Everything after the raw pixel upload runs on the
device the image lives on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.ops.patching import (
    TileGrid,
    compute_tile_grid,
    gather_selected,
    sat_block_size,
    select_tiles,
    tile_fill_scores_sat,
)

# ImageNet statistics (reference transforms, utils.py:48).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BORDER_TRANSLATE_PX = 20  # reference dataset.py:66

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class PipelineConfig:
    """Static preprocessing parameters."""

    height: int
    width: int
    patch_size: int = 224
    overlap: float = 0.5
    empty_threshold: float = 0.75
    bag_size: int = -1
    bucket: int = 256
    augment: bool = False  # train-time per-patch flips; not ported yet
    dtype: str = "float32"  # dtype of the emitted patches

    def grid(self) -> TileGrid:
        return compute_tile_grid(self.height, self.width, self.patch_size, self.overlap)


def canonicalize_image(
    image: torch.Tensor, flip_horizontal: bool, out_hw: tuple[int, int]
) -> torch.Tensor:
    """Laterality mirror + border translate + resize.

    ``image``: ``(H, W)`` grayscale in [0, 1].  The -20 px x-translate moves
    content left and zero-fills the right edge.  Resizing to the same size
    is the identity, which is the main path; an off-size image goes through
    ``F.interpolate(bilinear, antialias=True)``, whose weights differ from
    ``jax.image.resize`` (see ROADMAP.md, faults found in the port).
    """
    img = torch.flip(image, dims=(1,)) if flip_horizontal else image
    img = F.pad(img[:, BORDER_TRANSLATE_PX:], (0, BORDER_TRANSLATE_PX))
    if tuple(img.shape) != tuple(out_hw):
        img = F.interpolate(
            img[None, None], size=tuple(out_hw), mode="bilinear",
            align_corners=False, antialias=True,
        )[0, 0]
    return img


def image_to_bag(
    image,
    flip_horizontal: bool,
    label: int,
    starts: torch.Tensor,
    cfg: PipelineConfig,
    *,
    device: str | torch.device = "cuda",
) -> Bag:
    """Grayscale image -> normalized, padded :class:`Bag` on ``device``.

    Fill scores are computed on raw pixels, before normalization, as in the
    reference.
    """
    if cfg.augment:
        raise NotImplementedError(
            "train-time augmentation comes with the training slice (ROADMAP.md queue 1, item 11)"
        )
    device = torch.device(device)
    img = torch.as_tensor(image, device=device).to(torch.float32)
    starts = torch.as_tensor(starts, device=device).to(torch.int64)
    img = canonicalize_image(img, flip_horizontal, (cfg.height, cfg.width))
    grid = cfg.grid()
    scores = tile_fill_scores_sat(img, starts, cfg.patch_size, block=sat_block_size(grid))
    idx, mask = select_tiles(scores, cfg.bucket, cfg.empty_threshold, cfg.bag_size)
    patches = gather_selected(img, starts[idx], cfg.patch_size)[..., None]
    mean = torch.tensor(IMAGENET_MEAN, dtype=patches.dtype, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=patches.dtype, device=device)
    patches = (patches - mean) / std  # (bucket, p, p, 1) -> (bucket, p, p, 3)
    patches = torch.where(mask[:, None, None, None], patches, torch.zeros((), device=device))
    patches = patches.to(torch_dtype(cfg.dtype))
    return Bag(
        patches=patches,
        mask=mask,
        label=torch.tensor(label, dtype=torch.int64, device=device),
        tile_indices=torch.where(mask, idx, torch.zeros_like(idx)),
    )


def count_valid_tiles(
    image, flip_horizontal: bool, starts: torch.Tensor, cfg: PipelineConfig,
    *, device: str | torch.device = "cuda",
) -> int:
    """Number of tiles a bag would keep (fill > threshold, capped at
    ``bag_size``)."""
    img = torch.as_tensor(image, device=device).to(torch.float32)
    img = canonicalize_image(img, flip_horizontal, (cfg.height, cfg.width))
    starts = torch.as_tensor(starts, device=img.device).to(torch.int64)
    scores = tile_fill_scores_sat(img, starts, cfg.patch_size, block=sat_block_size(cfg.grid()))
    n = int((scores > torch.tensor(cfg.empty_threshold * 100.0, device=img.device)).sum())
    return min(n, cfg.bag_size) if cfg.bag_size > 0 else n


# Generous second margin for the estimator's uncertainty band: a bucket
# decision that flips between ``margin`` and ``margin_hi`` is borderline, and
# serving then takes the larger bucket (padding-only cost).
ESTIMATE_MARGIN_HI = 0.10


def estimate_valid_tiles(
    image: np.ndarray,
    flip: bool,
    starts: np.ndarray,
    cfg: PipelineConfig,
    *,
    subsample: int = 4,
    margin: float = 0.03,
    margin_hi: float | None = None,
) -> int | tuple[int, int] | None:
    """Host-side conservative estimate of :func:`count_valid_tiles` from a
    stride-``subsample`` pixel subsample, so the request path picks its
    bucket without a device readback.  Counts tiles whose estimated fill
    exceeds ``empty_threshold - margin``; with ``margin_hi`` also returns the
    generous-margin count as ``(n, n_hi)``.  Returns None when the image is
    off-size (the resize path, where the subsampled geometry does not map).
    Same numpy arithmetic as the JAX package's estimator, so both pick
    identical buckets.
    """
    arr = np.asarray(image)
    if arr.shape != (cfg.height, cfg.width):
        return None
    d = subsample
    while cfg.patch_size % d:
        d -= 1
    # canonical pixel (y, x) is view[y, x] with the right edge zero-filled
    view = arr[:, ::-1] if flip else arr
    view = view[:, BORDER_TRANSLATE_PX:]
    nz = view[::d, ::d] != 0
    sat = np.zeros((nz.shape[0] + 1, nz.shape[1] + 1), np.int32)
    sat[1:, 1:] = nz.cumsum(0, dtype=np.int32).cumsum(1)
    pb = cfg.patch_size // d
    starts = np.asarray(starts)
    y0 = np.minimum(np.round(starts[:, 0] / d).astype(np.int64), nz.shape[0])
    x0 = np.minimum(np.round(starts[:, 1] / d).astype(np.int64), nz.shape[1])
    y1 = np.minimum(y0 + pb, nz.shape[0])
    x1 = np.minimum(x0 + pb, nz.shape[1])
    counts = sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]
    fill = counts / float(pb * pb)
    n = int(np.sum(fill > max(cfg.empty_threshold - margin, 0.0)))
    if cfg.bag_size > 0:
        n = min(n, cfg.bag_size)
    if margin_hi is None:
        return n
    n_hi = int(np.sum(fill > max(cfg.empty_threshold - margin_hi, 0.0)))
    if cfg.bag_size > 0:
        n_hi = min(n_hi, cfg.bag_size)
    return n, n_hi
