"""Data-parallel MC evaluation over the ``data`` axis of a device mesh.

Counterpart of ``montecarlo_gated_mil_tpu/parallel/dp.py``'s evaluation
half.  A group of same-bucket bags is stacked, padded to the mesh's batch
and split over ``data`` (:func:`pad_group_to_batch`); bag ``b`` embeds and
runs its T head samples on data device ``b`` with that device's replica of
the model.  On the card that is the MC-head kernel (K1, or K2 for a shared
gate) per bag, and with ``quantized`` the int8 embed's K6-K8.  Per-bag
semantics (BN statistics, masking) are those of the sequential path, so a
bag's result does not depend on its group.

The device loop makes no host sync: launches are queued device after
device, so on a host with several cards their work overlaps, and results are
read once per group.  ``make_dp_train_step`` is training's and not ported
yet (ROADMAP.md queue 1, item 1).
"""

from __future__ import annotations

from typing import Sequence

import torch

from montecarlo_gated_mil_tpu_torch.core.bag import Bag, stack_bags
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn, mc_head
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams
from montecarlo_gated_mil_tpu_torch.parallel.mesh import Mesh, replicated, shard_batch


def make_dp_mc_eval(model, mesh: Mesh, num_samples: int, quantized: bool = False, *,
                    replicas: Sequence | None = None):
    """MC inference over a stacked batch of bags split over ``data``.

    Returns ``eval_step(shards, seeds) -> (Y (B, T, C), A (B, T, C, N))``
    on the first data device, where ``shards`` is :func:`pad_group_to_batch`'s
    (or ``shard_batch``'s) list and bag ``b`` of the batch samples with
    ``seeds[b]`` (sample t keyed ``seeds[b] + t``).  Features are computed once
    per bag, by the float backbone or with ``quantized`` the int8 embed,
    whose plan is built here once per device.  ``replicas``: the model on
    each data device, as ``replicated(mesh, model)`` gives it (made here if
    not given).
    """
    devices = mesh.axis_devices("data")
    per_device = {}
    for dev, replica in zip(devices, replicas or replicated(mesh, model)):
        if dev not in per_device:
            per_device[dev] = (
                replica,
                make_embed_fn(replica, quantized),
                GatedAttentionParams.from_module(replica).to(dev),
            )

    def eval_step(shards: Sequence[Bag], seeds: Sequence[int]):
        ys, attns = [], []
        with torch.inference_mode():
            for dev, shard in zip(devices, shards):
                replica, embed, params = per_device[dev]
                for b in range(shard.patches.shape[0]):
                    mask = shard.mask[b]
                    H = embed(shard.patches[b], mask)
                    out = mc_head(replica, H, mask, num_samples, seeds[len(ys)], params)
                    ys.append(out.predictions)
                    attns.append(out.attention)
            dev0 = devices[0]
            return (torch.stack([y.to(dev0) for y in ys]),
                    torch.stack([a.to(dev0) for a in attns]))

    return eval_step


class BucketBatcher:
    """Group a bag stream per bucket size into mesh-batch-sized groups.

    The grouping policy of the data-parallel evaluation
    (``evaluation/dp_eval.py``) and batched serving (``serve.predict_many``):
    bags group by their bucket, a group flushes when it reaches ``batch``
    bags, and the pending bags' bytes stay bounded: when their total exceeds
    ``max(budget_bytes, batch * largest-bag-bytes)`` the byte-heaviest
    partial group flushes early (some padded compute, bounded memory
    whatever the bucket count and bag size).
    """

    def __init__(self, batch: int, budget_bytes: int = 1 << 31):
        self.batch = batch
        self.budget_bytes = budget_bytes
        self._groups: dict[int, list] = {}
        self._max_bag_bytes = 1

    @staticmethod
    def _bytes(group) -> int:
        return sum(b.patches.nbytes for b, _ in group)

    def add(self, bag: Bag, index: int) -> list[list]:
        """Add ``(bag, index)``; returns the groups that must flush now."""
        self._max_bag_bytes = max(self._max_bag_bytes, bag.patches.nbytes)
        group = self._groups.setdefault(bag.bucket, [])
        group.append((bag, index))
        if len(group) == self.batch:
            self._groups[bag.bucket] = []
            return [group]
        if sum(map(self._bytes, self._groups.values())) > max(
            self.budget_bytes, self.batch * self._max_bag_bytes
        ):
            heaviest = max(self._groups, key=lambda k: self._bytes(self._groups[k]))
            group = self._groups[heaviest]
            self._groups[heaviest] = []
            return [group]
        return []

    def drain(self) -> list[list]:
        """The remaining partial groups, in first-seen bucket order."""
        out = [g for g in self._groups.values() if g]
        self._groups = {}
        return out


def pad_group_to_batch(mesh: Mesh, bags: Sequence[Bag], seeds: Sequence[int]):
    """Pad a partial group to the mesh's batch by repeating its first bag and
    seed, stack it and split it over ``data``.  The one owner of the padding
    protocol, for the data-parallel evaluation and batched serving.
    Returns ``(shards, seeds, n_real)``."""
    batch = mesh.shape["data"]
    n_real = len(bags)
    if not 0 < n_real <= batch:
        raise ValueError(f"group size {n_real} not in (0, {batch}]")
    bags = list(bags) + [bags[0]] * (batch - n_real)
    seeds = list(seeds) + [seeds[0]] * (batch - n_real)
    return shard_batch(mesh, stack_bags(bags)), seeds, n_real
