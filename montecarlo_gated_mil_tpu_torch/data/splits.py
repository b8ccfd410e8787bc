"""Dataset splitting: fractional train/val/test, stratified test split,
shuffled k-fold, weighted epoch order.

Counterpart of ``montecarlo_gated_mil_tpu/data/splits.py``, in numpy only
(the port has no scikit-learn).  ``stratified_test_split`` and
``kfold_split`` replay scikit-learn's ``train_test_split(stratify=...)``
(``StratifiedShuffleSplit``) and ``KFold(shuffle=True)`` draw for draw on
``np.random.RandomState(seed)``, so both packages split the same records.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class Split:
    train: np.ndarray
    val: np.ndarray
    test: np.ndarray


def random_split(n: int, train_frac: float, val_test_frac: float, seed: int) -> Split:
    """train = train_frac of all; val = val_test_frac of the rest; test =
    remainder (reference ``random_split_df``, ``utils.py:26-33``)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = round(n * train_frac)
    rest = perm[n_train:]
    n_val = round(len(rest) * val_test_frac)
    return Split(
        train=np.sort(perm[:n_train]),
        val=np.sort(rest[:n_val]),
        test=np.sort(rest[n_val:]),
    )


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """Most likely per-class counts of ``n_draws`` draws without replacement,
    ties broken by ``rng`` (scikit-learn's ``_approximate_mode``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_test_split(
    labels: Sequence[int], test_frac: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Held-out test set stratified by label: ``(train_val, test)``, each
    sorted (reference ``train_test_split(stratify=...)``, ``utils.py:141``)."""
    y = np.asarray(labels)
    n = len(y)
    if not 0.0 < test_frac < 1.0:
        raise ValueError(f"test_frac must be in (0, 1), got {test_frac}")
    n_test = math.ceil(test_frac * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("the least populated class has only 1 member; need at least 2")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must each cover the "
            f"{len(classes)} classes"
        )
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return np.sort(np.asarray(train, dtype=np.int64)), np.sort(np.asarray(test, dtype=np.int64))


def kfold_split(n: int, k: int, fold: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Fold ``fold`` of shuffled k-fold over ``n`` items: ``(train, val)``,
    each ascending (reference ``KFold(k, shuffle=True, random_state=seed)``,
    ``utils.py:144-151``)."""
    if not 0 <= fold < k:
        raise ValueError(f"fold index {fold} must be in [0, {k})")
    if k > n:
        raise ValueError(f"cannot have k={k} folds over {n} items")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(k, n // k, dtype=int)
    sizes[: n % k] += 1
    start = int(sizes[:fold].sum())
    val = np.zeros(n, bool)
    val[order[start: start + sizes[fold]]] = True
    idx = np.arange(n)
    return idx[~val], idx[val]


def weighted_sample_order(
    sample_weights: Sequence[float], num_samples: int, seed: int
) -> np.ndarray:
    """Epoch ordering drawn with replacement proportional to weights
    (reference ``WeightedRandomSampler``, ``utils.py:217``)."""
    w = np.asarray(sample_weights, dtype=np.float64)
    p = w / w.sum()
    rng = np.random.default_rng(seed)
    return rng.choice(len(w), size=num_samples, replace=True, p=p)
