"""Instance (intra-bag) sharding: one oversized bag over the ``inst`` axis.

Counterpart of ``montecarlo_gated_mil_tpu/parallel/instance.py``, the MIL
analogue of sequence parallelism: a bag with more instances than one device
should embed (thousands of tiles of a full-size mammogram) is split into
``inst`` equal shards of rows, shard ``s`` on the mesh's ``inst`` device
``s``.

- The embed (:func:`sharded_embed`) runs the convolutions per shard, with
  the model's copy on the shard's device (``replicas``, by default
  ``parallel/mesh.py::replicated``; a caller that embeds many bags makes
  them once and passes them in); each BN's masked statistics are the one
  coupling between shards and are summed across them
  (``models/resnet.py::sharded_batch_norm``), so every shard normalizes
  with the whole bag's moments.
- The head (:func:`sharded_gated_attention`, :func:`sharded_mc_gated_attention`)
  computes its logits per shard and a two-pass masked softmax across them:
  the max of the shards' masked maxima, then the sum of the shards' sums of
  exponentials, then the shards' partial ``A Hd`` summed.  It keeps JAX's
  ``_MASK_FILL`` and its handling of an all-masked shard or bag.

Every cross-shard reduction runs on the first shard's device in shard order
(``parallel/mesh.py::reduce_shards``).  The head is plain PyTorch, as JAX's
is plain ``jnp`` outside any Pallas kernel; it draws all T samples of a shard
in one Philox call.

Dropout: shard ``s`` of rows ``[n0, n0 + n_s)`` draws, for sample ``t`` with
key ``seed + t``, feature-dropout elements ``n * L + l`` and attention-
dropout elements ``n * C + c`` of the whole bag's draws
(``ops/gated_attention.py::dropout_uniforms`` from an element offset).  So a
sharded sample equals the whole-bag head's sample (K1 on the card, its plain
version on the CPU) up to the order of its sums.  JAX's sharded head folds
its key per shard instead; the streams differ by design, the statistics
agree.

Every function raises when the instance count is not divisible by the axis
size, as JAX's do.
"""

from __future__ import annotations

import torch

from montecarlo_gated_mil_tpu_torch.models.resnet import sharded_features
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
    ATTENTION_DRAW,
    FEATURE_DRAW,
    GatedAttentionParams,
    _MASK32,
    dropout_uniforms,
)
from montecarlo_gated_mil_tpu_torch.ops.masked import MASK_FILL as _MASK_FILL
from montecarlo_gated_mil_tpu_torch.parallel.mesh import Mesh, reduce_shards, replicated


def _split(x: torch.Tensor, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """``x``'s leading (instance) axis in equal shards, shard ``s`` on
    device ``s`` of ``axis``."""
    devices = mesh.axis_devices(axis)
    n = x.shape[0]
    if n % len(devices):
        raise ValueError(f"instance count {n} not divisible by {axis}={len(devices)}")
    return [part.to(dev) for part, dev in zip(torch.chunk(x, len(devices)), devices)]


def _embed_shards(model, patches, mask, mesh: Mesh, axis: str, replicas):
    xs, ms = _split(patches, mesh, axis), _split(mask, mesh, axis)
    replicas = replicas or replicated(mesh, model, axis)
    return sharded_features([r.feature_extractor for r in replicas], xs, ms), ms


def sharded_embed(model, patches: torch.Tensor, mask: torch.Tensor, mesh: Mesh,
                  axis: str = "inst", replicas=None) -> torch.Tensor:
    """The ResNet embed of ``model`` with the instance axis sharded over
    ``axis``: ``patches (N, h, w, 3)``, ``mask (N,)``, N divisible by the
    axis size.  ``replicas``: ``replicated(mesh, model, axis)``, made here
    if not given.  Returns ``H (N, L)`` on the axis's first device, equal to
    ``model.embed`` up to the order of the BN statistics' sums."""
    hs, _ = _embed_shards(model, patches, mask, mesh, axis, replicas)
    return torch.cat([h.to(hs[0].device) for h in hs])


class _ShardedEmbedGrad(torch.autograd.Function):
    """The instance-sharded embed as one autograd node of the model's
    backbone weights (:func:`sharded_embed_grad`).

    The forward records each shard's graph on its replica of the backbone
    (the shards coupled by ``models/resnet.py::_ShardedMaskedBatchNorm``)
    and returns the gathered features.  The backward runs those graphs with
    the features' gradient split by shard, then sums each weight's gradient
    over the distinct replicas on the first device in replica order
    (``parallel/mesh.py::reduce_shards``) and hands it to the model's own
    weight.  Replicas that are one module (a mesh of one device repeated)
    give one gradient, already summed over the shards by autograd."""

    @staticmethod
    def forward(ctx, nets, xs, ms, *weights):
        with torch.enable_grad():
            hs = sharded_features(nets, xs, ms)
        ctx.nets, ctx.hs = nets, hs
        return torch.cat([h.detach().to(weights[0].device) for h in hs])

    @staticmethod
    def backward(ctx, dH):
        hs, nets = ctx.hs, ctx.nets
        del ctx.hs
        dev = dH.device
        gs = [g.to(h.device) for g, h in zip(torch.split(dH, [h.shape[0] for h in hs]), hs)]
        unique = list({id(n): n for n in nets}.values())
        leaves = [list(n.parameters()) for n in unique]
        grads = torch.autograd.grad(hs, [p for ps in leaves for p in ps], gs, allow_unused=True)
        del hs, gs
        k = len(leaves[0])
        out = []
        for j in range(k):
            parts = [grads[r * k + j] for r in range(len(unique)) if grads[r * k + j] is not None]
            out.append(reduce_shards(parts, dev) if parts else None)
        return (None, None, None, *out)


def sharded_embed_grad(model, patches: torch.Tensor, mask: torch.Tensor, mesh: Mesh,
                       axis: str = "inst", replicas=None) -> torch.Tensor:
    """Differentiable twin of :func:`sharded_embed`, for the training step.

    Returns ``H (N, L)`` on the axis's first device (the model's), with a
    gradient to ``model``'s backbone weights: each shard back-propagates its
    instances on its replica, the BN's channel sums reduce across shards in
    the backward as in the forward, and each weight's gradient is the sum of
    its replicas' gradients, taken on the first device in shard order.  So
    the gradient equals the whole-bag embed's up to the order of those sums
    (JAX's ``sharded_embed_grad`` sums the shards' cotangents with
    ``psum``).  ``replicas``: the model on each device of the axis
    (``replicated(mesh, model, axis)``, made here if not given); their
    weights must equal the model's (``parallel/mesh.py::refresh_replicas``
    after every update)."""
    xs, ms = _split(patches, mesh, axis), _split(mask, mesh, axis)
    replicas = replicas or replicated(mesh, model, axis)
    weights = list(model.feature_extractor.parameters())
    return _ShardedEmbedGrad.apply([r.feature_extractor for r in replicas], xs, ms, *weights)


def _head_shards(hs, ms, params: GatedAttentionParams, seeds, p_feat: float, p_att: float):
    """The gated-attention head over instance shards ``hs[s] (n_s, L)`` with
    validity ``ms[s]``: with ``seeds`` (T sample keys) the T dropout samples,
    else one deterministic pass.  Returns ``Y (T, C)`` on the first shard's
    device and each shard's ``A (T, C, n_s)``."""
    dev0 = hs[0].device
    C = params.b_att.shape[0]
    logits, hds, n0 = [], [], 0
    for h, m in zip(hs, ms):
        dt = torch.promote_types(h.dtype, torch.float32)
        p = params.to(h.device, dt)
        n, L = h.shape
        hd = h.to(dt)[None]  # (T or 1, n, L)
        draws = []
        if seeds is not None and p_feat > 0:
            draws.append((FEATURE_DRAW, n * L, n0 * L))
        if seeds is not None and p_att > 0:
            draws.append((ATTENTION_DRAW, n * C, n0 * C))
        keys = torch.tensor([s & _MASK32 for s in seeds or [0]], dtype=torch.int64)
        us = iter(dropout_uniforms(keys, draws, h.device))
        if seeds is not None and p_feat > 0:
            keep = next(us).view(-1, n, L) >= torch.tensor(p_feat, dtype=torch.float32)
            hd = hd * keep.to(dt) * (1.0 / (1.0 - p_feat))
        if p.separate:
            V = torch.tanh(torch.einsum("tnl,cld->tcnd", hd, p.w_V) + p.b_V[None, :, None, :])
            U = torch.sigmoid(torch.einsum("tnl,cld->tcnd", hd, p.w_U) + p.b_U[None, :, None, :])
            lg = torch.einsum("tcnd,cd->tcn", V * U, p.w_att) + p.b_att[None, :, None]
        else:
            G = torch.tanh(hd @ p.w_V + p.b_V) * torch.sigmoid(hd @ p.w_U + p.b_U)
            lg = (G @ p.w_att + p.b_att).transpose(1, 2)  # (T, C, n)
        if seeds is not None and p_att > 0:
            # Element n * C + c of the (n, C) logit matrix, as the whole-bag head.
            keep = next(us).view(-1, n, C) >= torch.tensor(p_att, dtype=torch.float32)
            lg = (lg.transpose(1, 2) * keep.to(dt) * (1.0 / (1.0 - p_att))).transpose(1, 2)
        logits.append(torch.where(m.bool()[None, None, :], lg, torch.full_like(lg, _MASK_FILL)))
        hds.append(hd)
        n0 += n
    # Pass 1: the bag's max over the shards' masked maxima.
    gmax = reduce_shards([lg.amax(-1) for lg in logits], dev0, op="max")  # (T, C)
    gmax = torch.where(gmax <= _MASK_FILL, torch.zeros_like(gmax), gmax)
    # Pass 2: the sum of exponentials, then the normalized shards.
    es = []
    for lg, m in zip(logits, ms):
        e = torch.exp(lg - gmax.to(lg.device)[..., None])
        es.append(torch.where(m.bool()[None, None, :], e, torch.zeros_like(e)))
    denom = reduce_shards([e.sum(-1) for e in es], dev0)  # (T, C)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    As = [e / safe.to(e.device)[..., None] for e in es]
    M = reduce_shards([a @ hd for a, hd in zip(As, hds)], dev0)  # (T, C, L)
    w_cls = params.w_cls.to(device=dev0, dtype=M.dtype)
    return (M * w_cls).sum(-1), As


def _gather(As, device) -> torch.Tensor:
    return torch.cat([a.to(device) for a in As], dim=-1)


def sharded_gated_attention(H: torch.Tensor, mask: torch.Tensor, params: GatedAttentionParams,
                            mesh: Mesh, axis: str = "inst") -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic gated-attention pooling with the instance axis sharded
    over ``axis``: ``H (N, L)``, ``mask (N,)``, N divisible by the axis size.
    Returns ``(Y (C,), A (C, N))`` on the axis's first device."""
    hs, ms = _split(H, mesh, axis), _split(mask, mesh, axis)
    Y, As = _head_shards(hs, ms, params, None, 0.0, 0.0)
    return Y[0], _gather(As, Y.device)[0]


def sharded_mc_gated_attention(
    H: torch.Tensor,
    mask: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    mesh: Mesh,
    *,
    feature_dropout: float = 0.1,
    attention_dropout: float = 0.1,
    axis: str = "inst",
) -> tuple[torch.Tensor, torch.Tensor]:
    """T MC-dropout samples of the instance-sharded head, sample ``t`` keyed
    ``seed + t`` as the whole-bag head's.  Returns ``(Y (T, C), A (T, C,
    N))`` on the axis's first device."""
    hs, ms = _split(H, mesh, axis), _split(mask, mesh, axis)
    Y, As = _head_shards(hs, ms, params, [seed + t for t in range(num_samples)],
                         feature_dropout, attention_dropout)
    return Y, _gather(As, Y.device)


def mc_inference_sharded(
    model,
    patches: torch.Tensor,
    mask: torch.Tensor,
    num_samples: int,
    seed: int,
    mesh: Mesh,
    axis: str = "inst",
    params: GatedAttentionParams | None = None,
    replicas=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oversized-bag MC inference: the instance-sharded embed, then the
    instance-sharded MC head on the features where they lie.  ``params``
    may carry the head's weights already converted, ``replicas`` the model
    on each device of the axis (as :func:`sharded_embed`).  Returns ``(Y (T,
    C), A (T, C, N))`` on the axis's first device."""
    if params is None:
        params = GatedAttentionParams.from_module(model)
    hs, ms = _embed_shards(model, patches, mask, mesh, axis, replicas)
    Y, As = _head_shards(hs, ms, params, [seed + t for t in range(num_samples)],
                         model.feature_dropout, model.attention_dropout)
    return Y, _gather(As, Y.device)
