"""Seed plumbing: every random stream of a run derived from one integer.

Counterpart of ``montecarlo_gated_mil_tpu/core/rng.py``.  The JAX package
folds names and counters into PRNG keys; the port folds them into 32-bit
seeds with the same structure, so a stream is named by
``(cfg.seed, name, *counters)`` in both packages (the bits differ: a JAX key
and a Philox or ``torch.Generator`` seed are different generators).

Derivation, all arithmetic modulo 2^32:

- ``name_to_int(name)``: FNV-1a 32-bit of the UTF-8 name (the JAX
  package's ``_name_to_int``);
- ``fold_in(seed, data)``: the splitmix64 finalizer of
  ``(seed << 32) | data``, low 32 bits;
- ``named_seed(seed, name) = fold_in(seed, name_to_int(name))``;
- ``derive_seed(seed, name, *counters)``: ``named_seed`` then ``fold_in``
  of each counter in turn.  The training step of epoch ``e`` and batch
  ``i`` draws its dropout masks from
  ``derive_seed(cfg.seed, "train-dropout", e, i)``, mirroring the JAX key
  ``fold_in(fold_in(named_key(root_key(seed), "train-dropout"), e), i)``
  (``train/loops.py``); that uint32 is the MC head's Philox key.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def name_to_int(name: str) -> int:
    """FNV-1a 32-bit: stable across runs (Python's ``hash`` is salted)."""
    h = 0x811C9DC5
    for byte in name.encode():
        h = ((h ^ byte) * 0x01000193) & _MASK32
    return h


def fold_in(seed: int, data: int) -> int:
    """A new 32-bit seed from ``seed`` and ``data`` (splitmix64 finalizer)."""
    z = (((seed & _MASK32) << 32) | (data & _MASK32)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK32


def named_seed(seed: int, name: str) -> int:
    """The seed of stream ``name`` of a run seeded with ``seed``."""
    return fold_in(seed, name_to_int(name))


def derive_seed(seed: int, name: str, *counters: int) -> int:
    """``named_seed(seed, name)`` with each counter folded in, in order."""
    s = named_seed(seed, name)
    for c in counters:
        s = fold_in(s, c)
    return s


def generator(seed: int, name: str, *counters: int) -> torch.Generator:
    """A CPU ``torch.Generator`` for stream ``(seed, name, *counters)``."""
    return torch.Generator().manual_seed(derive_seed(seed, name, *counters))
