"""Multi-process runs: bring-up, fold fan-out, the merge of fold accuracies.

Counterpart of ``montecarlo_gated_mil_tpu/parallel/distributed.py``.
Within one process the device mesh (``parallel/mesh.py``) spreads work over
the cards; across processes cross-validation fans its folds out, each
process training its share, and the fold accuracies are merged with one
all-gather.  The process group is ``torch.distributed`` on ``gloo`` over
TCP: the gathered vector is a few float64 numbers on the CPU, and NCCL
refuses two ranks on one card.  The process index and count come from the
group when one is initialized, and are 0 and 1 otherwise, so a single
process runs every fold and the merge is a passthrough.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _from_env(value: int, name: str, what: str) -> int:
    if value >= 0:
        return value
    if name not in os.environ:
        raise ValueError(
            f"initialize: {what} not given (tpu.{what} is -1) and {name} is not set; set "
            f"tpu.{what} in the config or run under a launcher that sets {name}"
        )
    return int(os.environ[name])


def initialize(coordinator_address: str = "", num_processes: int = -1,
               process_id: int = -1) -> bool:
    """Join the process group of a multi-process run; True when more than
    one process takes part.

    With no ``coordinator_address`` nothing is started and the answer is
    whether a launcher already initialized a group.  Otherwise a ``gloo``
    group is initialized at ``tcp://{coordinator_address}`` (``host:port``
    of process 0) with ``num_processes`` processes, this one being
    ``process_id``; -1 takes ``WORLD_SIZE`` or ``RANK`` from the
    environment, as a launcher sets them, and raises saying what is missing
    when it is not there.  A group that is already initialized counts as
    success.  Call it before anything that asks for the process index.
    """
    if coordinator_address and not dist.is_initialized():
        world = _from_env(num_processes if num_processes > 0 else -1, "WORLD_SIZE",
                          "num_processes")
        rank = _from_env(process_id, "RANK", "process_id")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)
    return process_count() > 1


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
    """Fold -> accuracy for every fold any process ran, in float64 (2/3
    stays 0.6666666666666666).  Each process contributes a ``(num_folds,)``
    vector, NaN where it ran no fold, and one all-gather of the float64
    tensors merges them.  One process: a passthrough, no collective."""
    local = np.full((num_folds,), np.nan, np.float64)
    for f, a in zip(fold_ids, accuracies):
        local[f] = a
    merged = local
    if process_count() > 1:
        rows = [torch.empty(num_folds, dtype=torch.float64) for _ in range(process_count())]
        dist.all_gather(rows, torch.from_numpy(local))
        merged = np.full((num_folds,), np.nan, np.float64)
        for row in rows:
            row = row.numpy()
            have = ~np.isnan(row)
            merged[have] = row[have]
    return {int(f): float(a) for f, a in enumerate(merged) if not np.isnan(a)}
