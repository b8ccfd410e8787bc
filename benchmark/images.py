"""Synthetic full-size mammograms, made on the card from the seed.

The breast-like image of the repository's synthetic generator
(``data/synthetic.py``), written in torch: an elliptical lobe anchored at
the chest wall (the left edge; a right breast is mirrored), tissue of a
base level plus a radial falloff plus pixel noise clipped to [0.05, 1], a
black background, and for a positive case a bright Gaussian mass inside
the lobe.  Pixels are quantized to ``pixel_bits`` (12, as raw DICOM
mammograms store them) in uint16.

A pool fixes the set of lobe sizes, lateralities and masses, so every seed
asks the system for the same work: the sizes are the generator's ranges at
stratified quantiles, and the seed draws the details that leave the work
alone (tissue level, noise, the mass's place and radius).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mammogram:
    pixels: np.ndarray  # (H, W) uint16
    laterality: str  # "L" or "R"
    positive: bool


def _quantile(k: int, n: int, step: int, offset: int) -> float:
    return ((k * step + offset) % n + 0.5) / n


def geometry(n: int) -> list[tuple[float, float, float]]:
    """``(cy, ry, rx)`` as shares of (H, H, W) for a pool of ``n``: the
    generator's ranges U(0.4, 0.6), U(0.35, 0.45), U(0.55, 0.8) at
    stratified quantiles, decorrelated by fixed strides."""
    return [(0.4 + 0.2 * _quantile(k, n, 11, 7), 0.35 + 0.1 * _quantile(k, n, 1, 0),
             0.55 + 0.25 * _quantile(k, n, 5, 3)) for k in range(n)]


def mammogram(height: int, width: int, cy: float, ry: float, rx: float, positive: bool,
              g: torch.Generator, device, pixel_bits: int = 12) -> torch.Tensor:
    """One ``(height, width)`` image in [0, 1] (float32), lobe at the left."""
    f32 = torch.float32
    u = torch.rand(5, generator=g, device=device, dtype=f32)
    y = torch.arange(height, device=device, dtype=f32)[:, None]
    x = torch.arange(width, device=device, dtype=f32)[None, :]
    cy, ry, rx = cy * height, ry * height, rx * width
    r2 = ((y - cy) / ry) ** 2 + (x / rx) ** 2
    lobe = r2 < 1.0
    noise = torch.randn(height, width, generator=g, device=device, dtype=f32) * 0.03
    tissue = torch.clamp((0.25 + 0.2 * u[0]) + 0.25 * torch.exp(-r2) + noise, 0.05, 1.0)
    img = torch.where(lobe, tissue, torch.zeros((), device=device))
    if positive:
        my = cy + ry * (u[1] - 0.5)
        mx = rx * (0.2 + 0.4 * u[2])
        mr = min(height, width) * (0.02 + 0.03 * u[3])
        mass = torch.exp(-(((y - my) ** 2 + (x - mx) ** 2) / (2 * mr**2)))
        img = torch.clamp(img + 0.5 * mass * lobe, 0.0, 1.0)
    return img


def to_pixels(img: torch.Tensor, pixel_bits: int) -> np.ndarray:
    """[0, 1] float -> uint16 codes of ``pixel_bits`` on the host."""
    top = (1 << pixel_bits) - 1
    codes = torch.round(img * top).to(torch.int32).to(torch.int16)  # < 2^15: same bits
    return codes.cpu().numpy().view(np.uint16)


def pool(height: int, width: int, traffic: dict, seed: int, device) -> list[Mammogram]:
    """The traffic's pool of images for ``seed``, in the order of
    :func:`geometry` (the traffic decides which request takes which)."""
    n = int(traffic["pool"])
    bits = int(traffic["pixel_bits"])
    n_pos = round(n * float(traffic["positive_share"]))
    n_right = round(n * float(traffic["right_share"]))
    g = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    out = []
    for k, (cy, ry, rx) in enumerate(geometry(n)):
        right = (k * 7 + 1) % n < n_right
        positive = (k * 5 + 2) % n < n_pos
        img = mammogram(height, width, cy, ry, rx, positive, g, device, bits)
        if right:
            img = torch.flip(img, dims=(1,))
        out.append(Mammogram(to_pixels(img, bits), "R" if right else "L", positive))
    return out
