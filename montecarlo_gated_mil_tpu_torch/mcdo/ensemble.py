"""Fold-ensemble MCDO: MC-dropout samples pooled across independently
trained models, such as the k cross-validation fold checkpoints.

Counterpart of ``montecarlo_gated_mil_tpu/mcdo/ensemble.py``.  The JAX
package stacks the members' parameter trees along a leading axis and maps
one program over it with ``lax.map``; here the ensemble is an ordered list
of member ``state_dict``s, kept on the host and loaded one after another
into one module, so a single backbone lives on the card at a time; each
member embeds under inference mode, so none of its activations outlive its
call.  Member ``m`` embeds the bag with its own backbone and runs its T
head samples seeded with ``fold_in(seed, m)`` (``core/rng.py``); on the
card those are the MC-head kernel (K1, or K2 for a shared gate).

The pooled ``(M * T, C)`` samples drop straight into
:func:`~montecarlo_gated_mil_tpu_torch.mcdo.sampling.predictive_stats` and
:func:`attention_stats`.  :func:`ensemble_mc_inference_sharded` spreads the
members over an axis of a device mesh (``parallel/mesh.py``), with the same
seeds, so its result equals the sequential one.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import MCOutputs, mc_head

StateDict = Mapping[str, torch.Tensor]


def stack_params(params_list: Sequence[StateDict]) -> list[StateDict]:
    """The ensemble of ``params_list``'s members, in order.  Refuses an
    empty list, and members whose keys or shapes differ (the JAX package's
    stack refuses both)."""
    members = list(params_list)
    if not members:
        raise ValueError("ensemble needs at least one member")
    first = members[0]
    for i, m in enumerate(members[1:], start=1):
        if set(m) != set(first):
            raise ValueError(f"ensemble member {i} has other keys than member 0: "
                             f"{sorted(set(m) ^ set(first))[:4]}")
        bad = [k for k in first if m[k].shape != first[k].shape]
        if bad:
            raise ValueError(f"ensemble member {i} differs in shape from member 0 at {bad[:4]}")
    return members


def ensemble_mc_inference(
    model: torch.nn.Module,
    members: Sequence[StateDict],
    patches: torch.Tensor,
    mask: torch.Tensor | None,
    num_samples: int,
    seed: int,
) -> MCOutputs:
    """MC inference pooled over ensemble members.

    Returns ``predictions (M*T, C)`` raw logits and ``attention (M*T, C,
    N)``, member-major (member 0's T samples first): the contract of
    ``mc_inference`` with a larger T.  ``model`` is the module the members
    load into, one after another; its own weights are put back at the end.
    """
    own = {k: v.detach().clone() for k, v in model.state_dict().items()}
    Ys, As = [], []
    try:
        for m, params in enumerate(members):
            model.load_state_dict(params)
            with torch.inference_mode():
                H = model.embed(patches, mask)
                out = mc_head(model, H, mask, num_samples, rng.fold_in(seed, m))
            Ys.append(out.predictions)
            As.append(out.attention)
    finally:
        model.load_state_dict(own)
    return MCOutputs(predictions=torch.cat(Ys), attention=torch.cat(As))


def ensemble_mc_inference_sharded(
    model: torch.nn.Module,
    members: Sequence[StateDict],
    patches: torch.Tensor,
    mask: torch.Tensor | None,
    num_samples: int,
    seed: int,
    mesh,
    axis: str = "data",
) -> MCOutputs:
    """:func:`ensemble_mc_inference` with the members spread over ``axis``
    of ``mesh``: device ``s`` of the axis runs members ``s * k .. s * k + k
    - 1`` (``k = M / axis size``) in its replica of ``model``, on its copy
    of the bag.  Members need no cross-device reduction (each embeds with
    its own BN statistics).  Member ``m`` samples with ``fold_in(seed, m)``
    of its GLOBAL index, so the pooled result is the sequential one for the
    same seed whatever the mesh.  Members run member-index-major across the
    devices, and nothing waits on the host until the gather at the end.

    A member count the axis size does not divide raises (a 5-fold ensemble
    on 4 devices): repeating members to pad would weight the pooled
    distribution toward the repeats.  Returns member-major ``(M * T, C)``
    and ``(M * T, C, N)`` on the axis's first device; each replica's own
    weights are put back at the end."""
    from montecarlo_gated_mil_tpu_torch.parallel.mesh import replicated

    size = mesh.shape[axis]
    if len(members) % size:
        raise ValueError(f"member count {len(members)} not divisible by {axis}={size}")
    local = len(members) // size
    devices = mesh.axis_devices(axis)
    replicas = replicated(mesh, model, axis)
    owns = {id(r): (r, {k: v.detach().clone() for k, v in r.state_dict().items()})
            for r in replicas}
    outs: dict[int, MCOutputs] = {}
    try:
        for j in range(local):
            for s, (dev, replica) in enumerate(zip(devices, replicas)):
                m = s * local + j
                replica.load_state_dict(members[m])
                with torch.inference_mode():
                    p = patches.to(dev)
                    mk = None if mask is None else mask.to(dev)
                    outs[m] = mc_head(replica, replica.embed(p, mk), mk, num_samples,
                                      rng.fold_in(seed, m))
    finally:
        for replica, own in owns.values():
            replica.load_state_dict(own)
    dev0 = devices[0]
    return MCOutputs(
        predictions=torch.cat([outs[m].predictions.to(dev0) for m in range(len(members))]),
        attention=torch.cat([outs[m].attention.to(dev0) for m in range(len(members))]),
    )


def load_fold_ensemble(cfg, manifest: dict) -> list[StateDict]:
    """The members of a CV manifest (``run_cross_validation``'s output or
    ``load_cv_manifest``'s merge), restored from their fold checkpoints on
    the CPU and stacked in fold order."""
    from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer

    ckpt = Checkpointer(cfg.model_path)
    return stack_params([
        ckpt.restore_params(entry["checkpoint"])
        for entry in sorted(manifest["folds"], key=lambda e: e["fold"])
    ])
