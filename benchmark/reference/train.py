"""The shipped training step, written out in plain PyTorch.

One bag per step: the CC+MLO composite of a record (MLO over CC, each
file's pixels over ``2^BitsStored - 1``) through the pipeline of
``pipeline.py`` at the training overlap, every kept tile mirrored in x and
in y by the record's augment draw, the model of ``model.py`` with dropout
on (one head sample, keyed by the bag's seed), the loss CE(logits, label)
plus ``aux_scale`` times the pairwise attention loss (the distance of the
positive and negative heads' attention, ``torch.nn.functional.
pairwise_distance``'s epsilon 1e-6 added to the difference over the bag's
padded slots; pushed apart to ``margin`` on a positive bag, together on a
negative one), back-propagated divided by the accumulation steps; every
``k`` bags Adam (L2 weight decay added to the gradient first, bias
corrections of the published algorithm) takes one step.

The seeds of the system's stated contract: bag ``i`` of epoch ``e`` draws
its dropout from ``fold_in(fold_in(key, e), i)`` and the record's flips
from ``torch.rand((2, bucket))`` of a CPU generator seeded
``derive_seed(seed, "augment", e, record)``; ``fold_in`` is the splitmix64
finalizer of ``(seed << 32) | data`` and a name folds in as its FNV-1a
hash.  The bucket is the smallest of the registry at or above the bag's
valid tiles, a multiple of the largest above it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import spec
from benchmark.reference import model as ref_model
from benchmark.reference import pipeline as ref_pipe

MASK32, MASK64 = 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF


def fnv1a(name: str) -> int:
    h = 0x811C9DC5
    for byte in name.encode():
        h = ((h ^ byte) * 0x01000193) & MASK32
    return h


def fold_in(seed: int, data: int) -> int:
    z = ((((seed & MASK32) << 32) | (data & MASK32)) + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & MASK32


def derive_seed(seed: int, name: str, *counters: int) -> int:
    s = fold_in(seed, fnv1a(name))
    for c in counters:
        s = fold_in(s, c)
    return s


def bucket_for(n: int, buckets) -> int:
    if n > buckets[-1]:
        return -(-n // buckets[-1]) * buckets[-1]
    return min(b for b in buckets if b >= n)


def bag(cc: np.ndarray, mlo: np.ndarray, bits: int, laterality: str, record: int, epoch: int,
        loader_seed: int, config: dict, device):
    """``(tiles (n, p, p, 3), bucket)`` of one record's training bag."""
    top = np.float32((1 << bits) - 1)
    img = np.concatenate([mlo.astype(np.float32) / top, cc.astype(np.float32) / top], axis=0)
    H, W, p = config["H"], config["W"], config["patch"]
    can = ref_pipe.canonical(torch.from_numpy(img).to(device), laterality == "R", H, W)
    starts = ref_pipe.grid_starts(H, W, p, config["overlap_train"])
    idx = ref_pipe.valid_tiles(can, starts, p, config["empty_threshold"])
    n = int(idx.numel())
    bucket = bucket_for(n, config["buckets"])
    g = torch.Generator().manual_seed(derive_seed(loader_seed, "augment", epoch, record))
    u = torch.rand((2, bucket), generator=g)
    return ref_pipe.tiles(can, starts, idx, p, (u[0, :n] < 0.5, u[1, :n] < 0.5)), bucket


def _embed_checkpointed(p: dict, x: torch.Tensor, backbone: str) -> torch.Tensor:
    """``model.embed`` under autograd, recomputed block by block in the
    backward (the same function; only the memory differs)."""
    net = spec.load_backbone(backbone)
    x = checkpoint(lambda x: ref_model.stem(p, net, x.permute(0, 3, 1, 2), None), x,
                   use_reentrant=False)
    for blk in net.blocks:
        x = checkpoint(ref_model.block, p, blk, x, None, use_reentrant=False)
    return x.to(torch.float64).mean(dim=(2, 3)).to(torch.float32)


def bag_loss(p: dict, x: torch.Tensor, bucket: int, label: int, seed: int, config: dict):
    tc = config["train"]
    H = _embed_checkpointed(p, x, config["backbone"])
    Y, A = ref_model.head_samples(p, H, seed, 1, config["feature_dropout"],
                                  config["attention_dropout"], config["C"])
    ce = -torch.log_softmax(Y[0], dim=-1)[label]
    a = F.pad(A[0], (0, bucket - A.shape[-1]))
    d = torch.sqrt(torch.sum(torch.square(a[1] - a[0] + 1e-6)))
    aux = torch.clamp(tc["aux_margin"] - d, min=0.0) if label == 1 else d
    return ce + tc["aux_scale"] * aux


class Adam:
    """Adam with L2 weight decay (Kingma and Ba 2015; the decay added to
    the gradient, as torch.optim.Adam's ``weight_decay``)."""

    def __init__(self, params: dict, lr: float, wd: float, betas, eps: float):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict) -> dict:
        """The new parameters; returns the gradients as the update used them."""
        self.t += 1
        bc1, bc2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        used = {}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + self.wd * p
                used[k] = g
                self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
                self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
                denom = self.v[k].sqrt() / bc2**0.5 + self.eps
                p -= (self.lr / bc1) * self.m[k] / denom
        return used


def follow(weights: dict, bags: list, config: dict, steps: int):
    """The first ``steps`` optimizer steps over ``bags`` (``(x, bucket,
    label, seed)``, ``k`` a step): the loss of every bag, the gradients of
    the first step as Adam took them, and the parameters after ``steps``."""
    tc = config["train"]
    k = tc["grad_acc_steps"]
    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    opt = Adam(params, tc["lr"], tc["wd"], tc["adam_betas"], tc["adam_eps"])
    losses, first = [], None
    for s in range(steps):
        grads = {n: torch.zeros_like(w) for n, w in params.items()}
        for x, bucket, label, seed in bags[s * k:(s + 1) * k]:
            loss = bag_loss(params, x, bucket, label, seed, config)
            g = torch.autograd.grad(loss / k, list(params.values()))
            for n, gi in zip(params, g):
                grads[n] += gi
            losses.append(float(loss.detach()))
        used = opt.step(params, grads)
        if first is None:
            first = {n: g.detach().clone() for n, g in used.items()}
    return losses, first, {n: p.detach() for n, p in params.items()}
