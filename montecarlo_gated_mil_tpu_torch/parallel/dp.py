"""Data-parallel training and MC evaluation over the ``data`` axis of a
device mesh.

Counterpart of ``montecarlo_gated_mil_tpu/parallel/dp.py``.  A group of
same-bucket bags is stacked, padded to the mesh's batch and split over
``data`` (:func:`pad_group_to_batch`); bag ``b`` runs on data device ``b``
with that device's replica of the model.  On the card that is the MC-head
kernel (K1, or K2 for a shared gate) per bag, in training its backward (K5,
or K4) too, and in evaluation with ``quantized`` the int8 embed's K6-K8.
Per-bag semantics (BN statistics, masking, dropout seeds) are those of the
sequential path, so a bag's result does not depend on its group.

Training (:func:`make_dp_train_step`) takes each bag's gradient alone, one
bag's graph at a time, and sums them on the first device in bag order,
where the optimizer and the model live; JAX lets XLA place an all-reduce.
Evaluation makes no host sync: launches are queued device after device, so
on a host with several cards their work overlaps, and results are read once
per group.
"""

from __future__ import annotations

from typing import Sequence

import torch

from montecarlo_gated_mil_tpu_torch.core.bag import Bag, stack_bags
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn, mc_head
from montecarlo_gated_mil_tpu_torch.models.resnet import exact_float_grads
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams
from montecarlo_gated_mil_tpu_torch.parallel.mesh import (
    Mesh,
    refresh_replicas,
    replicated,
    shard_batch,
)
from montecarlo_gated_mil_tpu_torch.train.state import TrainState, bag_loss


def make_dp_train_step(model, criterion, optimizer, mesh: Mesh, *,
                       replicas: Sequence | None = None):
    """Training over stacked groups of bags split over ``data``.

    Returns ``(step, apply_pending)``:

    - ``step(state, shards, seeds, weights, do_update)``: ``shards`` is
      :func:`pad_group_to_batch`'s list, bag ``b`` of the group draws its
      dropout from ``seeds[b]`` and carries ``weights[b]`` (0 for a padding
      slot).  Each bag's CE + aux loss is back-propagated alone on its data
      device's replica; ``weights[b]`` times its gradient is added to the
      model's ``.grad`` on the first device, in bag order, and ``acc_count``
      grows by the weights' sum.  A slot of weight 0 adds nothing and is not
      run.  With ``do_update`` the **mean** of what has accumulated is
      applied (:meth:`TrainState.apply_update`).  Returns ``(state,
      {"loss_sum", "aux_sum", "correct_sum", "count"})``, each weighted.
    - ``apply_pending(state)``: applies whatever has accumulated (nothing
      when nothing has): the epoch-end flush when the last group left
      ``do_update`` false.

    As JAX's step: a group of B real bags counts as B of the reference's
    microbatches and an update applies the mean over the bags since the
    last one.  When that count is ``grad_acc_steps``, this is the
    reference's ``sum(grad_i) / k``; at a partial epoch-end flush the
    reference divides by the full k, this path by the true count (JAX's
    documented divergence, kept).  ``optimizer`` holds ``model``'s weights;
    ``replicas`` (the model on each data device, made here if not given)
    take them before every step.
    """
    replicas = list(replicas or replicated(mesh, model))
    params = list(model.parameters())
    dev0 = params[0].device

    def step(state: TrainState, shards: Sequence[Bag], seeds: Sequence[int], weights,
             do_update: bool):
        refresh_replicas(model, replicas)
        weights = [float(w) for w in weights]
        zero = torch.zeros((), dtype=torch.promote_types(params[0].dtype, torch.float32),
                           device=dev0)
        loss_sum, aux_sum, correct_sum = zero, zero, zero
        slots = [(r, s, b) for r, s in zip(replicas, shards) for b in range(s.patches.shape[0])]
        for (replica, shard, b), seed, w in zip(slots, seeds, weights):
            if w == 0.0:
                continue
            label = shard.label[b]
            y, a = replica(shard.patches[b], shard.mask[b], train=True, seed=seed)
            loss, aux = bag_loss(replica, criterion, y, a, label)
            with exact_float_grads(replica.dtype):
                grads = torch.autograd.grad(loss * w, list(replica.parameters()),
                                            allow_unused=True)
            for p, g in zip(params, grads):
                if g is not None:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    p.grad.add_(g.to(dev0))
            correct = (torch.argmax(y) == label).to(torch.float32)
            loss_sum = loss_sum + w * loss.detach().to(dev0)
            aux_sum = aux_sum + w * aux.detach().to(dev0)
            correct_sum = correct_sum + w * correct.to(dev0)
        count = sum(weights)
        state.acc_count += int(count)
        if do_update:
            state.apply_update(mean=True)
        return state, {"loss_sum": loss_sum, "aux_sum": aux_sum, "correct_sum": correct_sum,
                       "count": torch.tensor(count, dtype=torch.float32)}

    def apply_pending(state: TrainState) -> TrainState:
        if state.acc_count > 0:
            state.apply_update(mean=True)
        return state

    return step, apply_pending


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
