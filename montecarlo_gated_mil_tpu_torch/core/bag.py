"""Bag abstraction: padded fixed-size instance buckets with validity masks.

Counterpart of ``montecarlo_gated_mil_tpu/core/bag.py``.  A bag is a set of
tensors padded to a bucket size from a small registry, plus a boolean mask
that every downstream op (BatchNorm statistics, attention softmax, pooling,
MC variance) respects, so padded instances contribute exactly nothing.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class Bag:
    """One bag of image patches.

    patches: ``(Nmax, ph, pw, C)`` NHWC per instance (the JAX package's
      layout); padded slots hold zeros.
    mask: ``(Nmax,)`` bool; True for real instances.
    label: ``()`` int64.
    tile_indices: ``(Nmax,)`` int64 row index into the tile grid; padded
      slots hold 0 and must be read through ``mask``.
    """

    patches: torch.Tensor
    mask: torch.Tensor
    label: torch.Tensor
    tile_indices: torch.Tensor

    @property
    def num_instances(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)

    @property
    def bucket(self) -> int:
        """The padded size Nmax."""
        return self.patches.shape[-4]


@dataclass(frozen=True)
class BucketSpec:
    """Registry of allowed padded bag sizes: every bag is padded to the
    smallest bucket >= its instance count."""

    sizes: tuple[int, ...] = (64, 128, 256, 512, 1024)

    def __post_init__(self):
        if not self.sizes:
            raise ValueError("BucketSpec needs at least one size")
        if list(self.sizes) != sorted(set(self.sizes)):
            raise ValueError(f"bucket sizes must be strictly increasing: {self.sizes}")

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n; the largest bucket caps oversized bags."""
        if n <= 0:
            return self.sizes[0]
        i = bisect.bisect_left(self.sizes, n)
        return self.sizes[min(i, len(self.sizes) - 1)]

    def extended_bucket(self, n: int, multiple_of: int = 1) -> int:
        """Padded size for an OVERSIZED bag (``n > max_size``) that must not
        be truncated: the smallest multiple of ``lcm(max_size, multiple_of)``
        >= n, which bounds the number of distinct bag shapes."""
        q = math.lcm(self.max_size, max(1, multiple_of))
        return -(-max(n, 1) // q) * q

    @property
    def max_size(self) -> int:
        return self.sizes[-1]


def pad_to_bucket(
    patches: np.ndarray,
    tile_indices: np.ndarray,
    label: int,
    bucket: int,
) -> Bag:
    """Pad host-side ragged instances ``(n, ph, pw, C)`` into a :class:`Bag`
    on the CPU.  With ``n > bucket`` the first ``bucket`` instances are kept
    (callers rank instances by fill first, so truncation drops the
    emptiest)."""
    n = patches.shape[0]
    keep = min(n, bucket)
    out = np.zeros((bucket,) + tuple(patches.shape[1:]), dtype=patches.dtype)
    out[:keep] = patches[:keep]
    idx = np.zeros((bucket,), dtype=np.int64)
    idx[:keep] = tile_indices[:keep]
    mask = np.zeros((bucket,), dtype=bool)
    mask[:keep] = True
    return Bag(
        patches=torch.from_numpy(out),
        mask=torch.from_numpy(mask),
        label=torch.tensor(label, dtype=torch.int64),
        tile_indices=torch.from_numpy(idx),
    )


def stack_bags(bags: Sequence[Bag]) -> Bag:
    """Stack same-bucket bags along a new leading batch axis."""
    buckets = {b.bucket for b in bags}
    if len(buckets) != 1:
        raise ValueError(f"cannot stack bags from different buckets: {buckets}")
    return Bag(*(torch.stack([getattr(b, f) for b in bags])
                 for f in ("patches", "mask", "label", "tile_indices")))
