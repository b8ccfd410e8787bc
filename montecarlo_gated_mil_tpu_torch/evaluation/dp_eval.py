"""Data-parallel MC test: bags spread over the ``data`` axis of a mesh.

Counterpart of ``montecarlo_gated_mil_tpu/evaluation/dp_eval.py``.  Bags
from the loader group per bucket size into mesh-sized batches
(``parallel/dp.py::BucketBatcher``), each group is padded by repeating its
first bag, split over ``data`` and evaluated one bag per data device.  Bag
``i`` of the stream samples with seed ``fold_in(seed, i)``, as the
sequential ``train/loops.py::mc_test`` does, so the labels equal the
sequential path's bag for bag whatever the grouping; padding results are
dropped and labels return to stream order.
"""

from __future__ import annotations

from typing import Iterable

import torch

from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import kernel_on
from montecarlo_gated_mil_tpu_torch.parallel.dp import (
    BucketBatcher,
    make_dp_mc_eval,
    pad_group_to_batch,
)
from montecarlo_gated_mil_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_mesh_for
from montecarlo_gated_mil_tpu_torch.utils.metrics import Metrics


def mc_test_dp(
    model,
    loader: Iterable,
    *,
    num_samples: int = 50,
    seed: int,
    mesh: Mesh | None = None,
    metrics: Metrics | None = None,
    fold: int | None = None,
    quantized: bool = False,
    pending_budget_bytes: int = 1 << 31,
    shard_over: int | None = None,
    use_pallas: bool | None = None,
):
    """Data-parallel ``mc_test``: ``(accuracy, Report)`` from the argmax of
    the MC-mean softmax.  ``mesh`` defaults to every visible CUDA device on
    ``data``; ``quantized`` embeds through the int8 path and
    ``use_pallas=False`` runs the plain head on the card, as the sequential
    loop's flags do.  ``pending_budget_bytes`` bounds the pending partial
    groups (default 2 GiB; always at least one mesh batch of the largest
    bag seen).  ``shard_over``: an OVERSIZED bag (bucket above it) leaves the
    grouping and evaluates alone with its instances sharded over all of the
    mesh's devices (``parallel/instance.py``, float path)."""
    from montecarlo_gated_mil_tpu_torch.train.loops import _finish_test

    targets, preds, _ = _mc_test_dp_outputs(
        model, loader, num_samples=num_samples, seed=seed, mesh=mesh, quantized=quantized,
        pending_budget_bytes=pending_budget_bytes, shard_over=shard_over, use_pallas=use_pallas,
    )
    return _finish_test(targets, preds, metrics, fold)


def _mc_test_dp_outputs(model, loader, *, num_samples, seed, mesh=None, quantized=False,
                        pending_budget_bytes=1 << 31, shard_over=None, use_pallas=None):
    """:func:`mc_test_dp`'s pass: per bag its target, predicted label and MC
    logits ``Y (T, C)`` on the CPU, in stream order."""
    from montecarlo_gated_mil_tpu_torch.train.loops import (
        _items,
        _mc_labels,
        _mc_test_step_sharded,
        warn_float_shard,
    )

    mesh = mesh or make_mesh()
    eval_step = make_dp_mc_eval(model, mesh, num_samples, quantized,
                                kernel=kernel_on(use_pallas))
    results: dict[int, tuple[int, torch.Tensor]] = {}
    targets: list[int] = []

    def flush(group):
        shards, seeds, n_real = pad_group_to_batch(
            mesh, [b for b, _ in group], [rng.fold_in(seed, i) for _, i in group])
        ys, _ = eval_step(shards, seeds)
        # Per bag, as the sequential loop reduces it: the same reduction on
        # the same (T, C) gives the same label.
        labels = torch.stack([_mc_labels(y) for y in ys[:n_real]]).tolist()
        for (_, i), label, y in zip(group, labels, ys[:n_real].cpu()):
            results[i] = (int(label), y)

    batcher = BucketBatcher(mesh.shape["data"], pending_budget_bytes)
    sharded = None
    with torch.inference_mode():
        for i, (bag, _rec) in enumerate(_items(loader, 0)):
            targets.append(int(bag.label))
            shard_mesh = shard_mesh_for(bag.bucket, shard_over, mesh)
            if shard_mesh is not None:
                if sharded is None and quantized:
                    warn_float_shard(quantized=True)
                sharded = sharded or _mc_test_step_sharded(model, num_samples, shard_mesh)
                y = sharded(bag.patches, bag.mask, rng.fold_in(seed, i))
                results[i] = (int(_mc_labels(y)), y.cpu())
                continue
            for group in batcher.add(bag, i):
                flush(group)
        for group in batcher.drain():
            flush(group)
    order = range(len(targets))
    return targets, [results[i][0] for i in order], [results[i][1] for i in order]
