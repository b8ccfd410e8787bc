"""Raw mammogram -> the valid tiles of its bag, written out for the reference.

The semantics the system states (reference ``image_patcher.py`` and
``dataset.py``): a right image is mirrored to the left, moved 20 px left
with the right edge zero-filled, resized to H x W (antialiased bilinear,
only where the size differs: the CC+MLO composite of training), tiled on
the reference's grid (stride ``int(p * (1 - overlap))``, the last tile
snapped to the border, row-major), each tile scored by its share of
nonzero pixels; the tiles whose share exceeds ``empty_threshold`` are kept,
fullest first (ties by grid order), and each is normalized with the
ImageNet statistics into three channels.  Padding to a bucket is no part
of the semantics: the reference keeps the valid tiles alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BORDER_TRANSLATE_PX = 20


def start_points(size: int, patch: int, overlap: float) -> list[int]:
    points = [0]
    stride = int(patch * (1 - overlap))
    k = 1
    while True:
        pt = stride * k
        if pt + patch >= size:
            if size - patch != points[-1]:
                points.append(size - patch)
            return points
        points.append(pt)
        k += 1


def grid_starts(height: int, width: int, patch: int, overlap: float) -> np.ndarray:
    """``(K, 2)`` tile starts ``(y, x)``, row-major."""
    ys, xs = start_points(height, patch, overlap), start_points(width, patch, overlap)
    return np.array([(y, x) for y in ys for x in xs], dtype=np.int64)


def _resize_axis(img: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """One axis of an antialiased bilinear resize (a triangle kernel widened
    by 1 / scale when shrinking, weights normalized per output sample, the
    sample at ``(j + 0.5) / scale - 0.5``), in float32."""
    n_in = img.shape[axis]
    f32, dev = torch.float32, img.device
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=f32, device=dev)
    width = torch.clamp(inv_scale, min=1.0)
    centers = torch.arange(n_out, dtype=f32, device=dev) + 0.5
    sample = (centers.double() * inv_scale.double() - 0.5).to(f32)
    k = math.ceil(2 * float(width)) + 2
    first = torch.floor(sample - width).to(torch.int64) + 1
    taps = first[:, None] + torch.arange(k, device=dev)
    inside = (taps >= 0) & (taps < n_in)
    w = torch.clamp(1.0 - (sample[:, None] - taps.to(f32)).abs() * (1.0 / width), min=0.0)
    w = torch.where(inside, w, torch.zeros((), dtype=f32, device=dev))
    total = w.sum(1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    w = torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[:, None], w, 0.0)
    taps = taps.clamp(0, n_in - 1)
    out = None
    for j in range(k):
        term = img[taps[:, j]] * w[:, j, None] if axis == 0 else img[:, taps[:, j]] * w[None, :, j]
        out = term if out is None else out + term
    return out


def canonical(image: torch.Tensor, flip: bool, height: int, width: int) -> torch.Tensor:
    """``(h, w)`` float32 in [0, 1] -> the canonical ``(height, width)`` image."""
    img = torch.flip(image, dims=(1,)) if flip else image
    img = torch.nn.functional.pad(img[:, BORDER_TRANSLATE_PX:], (0, BORDER_TRANSLATE_PX))
    for axis, n in enumerate((height, width)):
        if img.shape[axis] != n:
            img = _resize_axis(img, axis, n)
    return img


def valid_tiles(img: torch.Tensor, starts: np.ndarray, patch: int,
                threshold: float) -> torch.Tensor:
    """Grid indices of the kept tiles, fullest first: the nonzero count of
    each window by a summed-area table of exact integers."""
    nz = (img > 0).to(torch.int64)
    sat = torch.zeros((nz.shape[0] + 1, nz.shape[1] + 1), dtype=torch.int64, device=img.device)
    sat[1:, 1:] = nz.cumsum(0).cumsum(1)
    st = torch.as_tensor(starts, device=img.device)
    y, x = st[:, 0], st[:, 1]
    count = sat[y + patch, x + patch] - sat[y, x + patch] - sat[y + patch, x] + sat[y, x]
    share = count.to(torch.float32) / (patch * patch) * 100.0
    order = torch.sort(share, descending=True, stable=True).indices
    n = int((share > torch.tensor(threshold * 100.0, dtype=torch.float32)).sum())
    return order[:n]


def tiles(img: torch.Tensor, starts: np.ndarray, idx: torch.Tensor, patch: int,
          flips: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """``(n, p, p, 3)`` float32 normalized tiles of grid rows ``idx``;
    ``flips`` (per kept tile: mirror in x, in y) for training's augment."""
    st = torch.as_tensor(starts, device=img.device)[idx]
    ar = torch.arange(patch, device=img.device)
    t = img[(st[:, 0, None] + ar)[:, :, None], (st[:, 1, None] + ar)[:, None, :]][..., None]
    if flips is not None:
        fh = flips[0].to(img.device)[:, None, None, None]
        fv = flips[1].to(img.device)[:, None, None, None]
        t = torch.where(fh, t.flip(2), t)
        t = torch.where(fv, t.flip(1), t)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (t - mean) / std
