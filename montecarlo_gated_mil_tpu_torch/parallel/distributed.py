"""Fold fan-out over processes and the merge of their fold accuracies.

Counterpart of ``montecarlo_gated_mil_tpu/parallel/distributed.py``'s
``fold_assignment`` and ``allgather_fold_accuracies``.  The process index and
count come from ``torch.distributed`` when a process group is initialized,
and are 0 and 1 otherwise, so a single process runs every fold and the merge
is a passthrough.  The multi-process gather is not ported yet (ROADMAP.md
queue 1, item 2); the CLI refuses ``tpu.coordinator_address`` before a run
could need it.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def fold_assignment(num_folds: int, process_index: int, process_count: int) -> list[int]:
    """Round-robin fold -> process assignment (folds are independent:
    fresh model, loaders and optimizer per fold, ``cross_validation.py:57-95``)."""
    if process_count <= 0:
        raise ValueError(f"process_count must be positive, got {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range [0, {process_count})")
    return [f for f in range(num_folds) if f % process_count == process_index]


def allgather_fold_accuracies(
    fold_ids: list[int], accuracies: list[float], num_folds: int
) -> dict[int, float]:
    """Fold -> accuracy for every fold run, in float64 (2/3 stays
    0.6666666666666666).  One process: a passthrough."""
    local = np.full((num_folds,), np.nan, np.float64)
    for f, a in zip(fold_ids, accuracies):
        local[f] = a
    if process_count() > 1:
        raise NotImplementedError(
            "merging fold accuracies across processes is not ported yet "
            "(ROADMAP.md queue 1, item 2: parallel/distributed.py)"
        )
    return {int(f): float(a) for f, a in enumerate(local) if not np.isnan(a)}
