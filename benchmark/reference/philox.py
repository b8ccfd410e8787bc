"""Philox4x32-10 dropout uniforms, written out for the reference.

The MC head draws its dropout masks from a counter-based stream: sample t
of a request seeded ``s`` uses key ``(s + t) mod 2^32`` and draw index 0
for the feature dropout of the ``(N, L)`` features, 1 for the attention
dropout of the ``(N, C)`` logits.  Element ``e`` of a draw is the top 24
bits of word ``e % 4`` of Philox4x32-10 at counter ``(e // 4, 0, 0, 0)`` and
key ``(key, draw)``, as a float32 in [0, 1); it is kept where ``u >= p``
and scaled by ``1 / (1 - p)``.  This is the published Philox4x32-10
(Salmon et al., SC'11) with its Weyl constants; nothing here is taken from
the program under test.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
FEATURE_DRAW, ATTENTION_DRAW = 0, 1


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` (``a`` uint32 held in int64),
    in 16-bit limbs so that no partial product overflows int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid = a_hi * m_lo + a_lo * m_hi
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    hi = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return hi, low & MASK32


def philox(c0: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor):
    """Philox4x32-10 of counters ``(c0, 0, 0, 0)`` under keys ``(k0, k1)``
    (int64 tensors of uint32 words that broadcast); the four output words."""
    c1 = c2 = c3 = torch.zeros_like(c0)
    k0, k1 = k0 & MASK32, k1 & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(keys: torch.Tensor, draw: int, n: int) -> torch.Tensor:
    """``(len(keys), n)`` float32 uniforms: elements ``0..n-1`` of draw
    ``draw`` under each key."""
    groups = (n + 3) // 4
    dev = keys.device
    counter = torch.arange(groups, dtype=torch.int64, device=dev)[None, :]
    key = keys.to(torch.int64)[:, None]
    words = torch.stack(philox(counter.expand(len(keys), groups), key,
                               torch.full_like(key, draw)), -1)
    flat = words.reshape(len(keys), -1)[:, :n]
    return (flat >> 8).to(torch.float32) * float(2.0**-24)


def keep_masks(seed: int, samples: int, draw: int, shape, p: float) -> torch.Tensor:
    """``(samples, *shape)`` float32 masks ``keep / (1 - p)`` of one draw for
    the keys ``seed + t``."""
    keys = torch.tensor([(seed + t) & MASK32 for t in range(samples)], dtype=torch.int64)
    n = 1
    for s in shape:
        n *= s
    u = uniforms(keys, draw, n).view(samples, *shape)
    return (u >= torch.tensor(p, dtype=torch.float32)).to(torch.float32) * (1.0 / (1.0 - p))
