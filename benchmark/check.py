"""What decides ``correct``: the served results against the plain reference.

Serving: a sample of the window's requests, drawn from the seed with the
request of the most valid tiles in it, is recomputed by the reference from
the same raw image, laterality, MC seed and weights: the tiles kept, the
embed (float32 without TF32, or the int8 scheme), the T head samples with
their Philox masks, the statistics.  Three numbers, each the worst over the
sample:

- ``tiles``: valid tiles that differ in count, plus attention the program
  put on a padded slot (exact: limit 0);
- ``stats``: the widest absolute gap of a predictive statistic (class
  means; P(positive)'s mean, std, median, IQR, min, max; mean entropy);
- ``attention``: the widest gap of the attention's per-tile mean or std
  over T, as a share of the reference's largest.

Training: the first optimizer steps of the set-up, followed by the
reference from the same weights, records, flips and dropout seeds:
``tiles`` (bags whose bucket or valid tiles differ), ``loss`` (the widest
relative gap of a bag's loss), ``grad1`` and ``update3`` (the worst leaf's
gap of the norm of the first gradient as Adam took it, and of the change
over the steps; see :func:`train_numbers`).

The control puts the reference in the program's place at the next lower
precision than the configuration states (TF32 for float32; int4 codes for
int8) and compares it with the reference the same way.
"""

from __future__ import annotations

import contextlib
import math
import sys

import numpy as np
import torch

from benchmark.reference import model as ref_model
from benchmark.reference import pipeline as ref_pipe
from benchmark.reference import quant as ref_quant

SERVE_NUMBERS = ("tiles", "stats", "attention")
STAT_KEYS = ("mean", "std", "median", "iqr", "low", "high", "mean_entropy")


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sample_requests(reqs, k: int, seed: int) -> list:
    """``k`` completed requests drawn from ``seed``, the one with the most
    valid tiles among them."""
    done = [r for r in reqs if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: r.n_valid)
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in pick]


def reference_request(weights: dict, pixels: np.ndarray, laterality: str, seed: int,
                      config: dict, pixel_max: float, control: bool = False,
                      device="cuda") -> dict:
    """The reference's statistics of one request (raw pixels scaled by
    ``1 / pixel_max``)."""
    img = torch.from_numpy(pixels.astype(np.int32)).to(device).to(torch.float32)
    img = img * np.float32(1.0 / pixel_max)
    H, W, p = config["H"], config["W"], config["patch"]
    can = ref_pipe.canonical(img, laterality == "R", H, W)
    starts = ref_pipe.grid_starts(H, W, p, config["overlap_serve"])
    idx = ref_pipe.valid_tiles(can, starts, p, config["empty_threshold"])
    x = ref_pipe.tiles(can, starts, idx, p)
    del can, img
    with torch.no_grad(), tf32(control and config["embed"] == "float32"):
        if config["embed"] == "int8":
            feats = ref_quant.embed(weights, x, levels=7 if control else 127,
                                    backbone=config["backbone"])
        else:
            feats = ref_model.embed(weights, x, config["backbone"])
        del x
        Y, A = ref_model.head_samples(weights, feats, seed, config["T"], config["feature_dropout"],
                                      config["attention_dropout"], config["C"])
    out = ref_model.predictive_stats(Y)
    att = ref_model.attention_stats(A)
    return {"n": int(idx.numel()), "stats": {k: v.cpu() for k, v in out.items()},
            "att_mean": att["mean"].cpu(), "att_std": att["std"].cpu()}


def _program_view(res) -> dict:
    s = res.stats
    stats = {k: getattr(s, k).double() for k in STAT_KEYS}
    stats["mean_probs"] = s.mean_probs.double()
    return {"n": int(res.num_instances), "stats": stats,
            "att_mean": res.attention.mean.double(), "att_std": res.attention.std.double()}


def compare(got: dict, ref: dict) -> dict[str, float]:
    """The three numbers for one request (``got`` may be padded)."""
    n = ref["n"]
    pad = int((got["att_mean"][:, n:] != 0).sum()) if got["att_mean"].shape[1] >= n else 0
    tiles = abs(got["n"] - n) + pad
    if got["n"] != n or got["att_mean"].shape[1] < n:
        return {"tiles": float(tiles), "stats": math.inf, "attention": math.inf}
    stats = max(float((got["stats"][k] - ref["stats"][k]).abs().max()) for k in ref["stats"])
    att = 0.0
    for key in ("att_mean", "att_std"):
        r = ref[key].double()
        att = max(att, float((got[key][:, :n] - r).abs().max() / r.abs().max()))
    return {"tiles": float(tiles), "stats": stats, "attention": att}


def worst(rows: list[dict[str, float]], names) -> dict[str, float]:
    if not rows:
        return {k: math.inf for k in names}
    return {k: max(r[k] for r in rows) for k in names}


def serve_check(sample, pool, weights: dict, config: dict, pixel_max: float,
                with_control: bool, device="cuda"):
    """``(program numbers, control numbers or None)`` over the sample."""
    prog, ctrl = [], []
    for r in sample:
        img = pool[r.image]
        ref = reference_request(weights, img.pixels, img.laterality, r.seed, config, pixel_max,
                                device=device)
        prog.append(compare(_program_view(r.result), ref))
        if with_control:
            low = reference_request(weights, img.pixels, img.laterality, r.seed, config,
                                    pixel_max, control=True, device=device)
            ctrl.append(compare(low, ref))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return (worst(prog, SERVE_NUMBERS),
            worst(ctrl, SERVE_NUMBERS) if with_control else None)


def verdict(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``; a number without a limit
    cannot pass."""
    rows, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        rows[k] = {"value": v, "limit": lim}
        ok = ok and lim is not None and v <= lim
    return ok, rows


# Training: the first optimizer steps of the set-up, followed by the
# reference from the same weights, records, seeds and flips.
TRAIN_NUMBERS = ("tiles", "loss", "grad1", "update3")
# A leaf whose first gradient (as Adam takes it) is under this share of the
# median leaf's moves by rounding alone: it is left out of ``update3``.
ROUNDING_LEAF = 1e-3


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _worst_leaf(got: dict[str, float], ref: dict[str, float], keys) -> float:
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(got[k] - ref[k]) / max(ref[k], med) for k in keys)


def train_numbers(losses, first_moment, p3, p0, ref_losses, ref_first, ref_p3, beta1):
    """loss: the widest relative gap of a bag's loss; grad1: of a leaf's
    first gradient norm as Adam took it (the program's from its first
    moment after one step, ``m / (1 - beta1)``); update3: of a leaf's change
    over the steps (leaves moved by rounding alone left out)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_ref = _norms(ref_first)
    g_got = _norms({k: v / (1 - beta1) for k, v in first_moment.items()})
    keys = list(g_ref)
    grad1 = _worst_leaf(g_got, g_ref, keys)
    med = float(np.median([g_ref[k] for k in keys]))
    moved = [k for k in keys if g_ref[k] >= ROUNDING_LEAF * med]
    d_ref = _norms({k: ref_p3[k] - p0[k] for k in keys})
    d_got = _norms({k: p3[k] - p0[k] for k in keys})
    return {"loss": loss, "grad1": grad1, "update3": _worst_leaf(d_got, d_ref, moved)}


def train_check(losses, bags, snap, p0, raw, weights, config, traffic, loader_seed, key,
                with_control: bool, device="cuda"):
    """``(program numbers, control numbers or None)`` for the first
    ``check_steps`` optimizer steps."""
    from benchmark.reference import train as ref_train

    tc = config["train"]
    k, steps, bits = tc["grad_acc_steps"], int(traffic["check_steps"]), int(traffic["pixel_bits"])
    ref_bags, tiles = [], 0
    for i in range(k * steps):
        cc, mlo, side, label = raw[i]
        x, bucket = ref_train.bag(cc, mlo, bits, side, i, 0, loader_seed, config, device)
        tiles += int((bucket, x.shape[0]) != tuple(bags[i]))
        ref_bags.append((x, bucket, label, ref_train.fold_in(ref_train.fold_in(key, 0), i)))
    if "m1" not in snap or "p3" not in snap:
        return {"tiles": float(tiles), "loss": math.inf, "grad1": math.inf, "update3": math.inf}, None
    beta1 = tc["adam_betas"][0]
    with tf32(False):
        ref = ref_train.follow(weights, ref_bags, config, steps)
    prog = dict(tiles=float(tiles), **train_numbers(losses, snap["m1"], snap["p3"], p0, *ref, beta1))
    gaps = ", ".join(f"{abs(a - b) / abs(b):.3g}" for a, b in zip(losses, ref[0]))
    print(f"loss gap by bag: {gaps}", file=sys.stderr)
    ctrl = None
    if with_control:
        with tf32(True):
            low = ref_train.follow(weights, ref_bags, config, steps)
        ctrl = dict(tiles=0.0, **train_numbers(low[0], {n: (1 - beta1) * g for n, g in
                                                         low[1].items()}, low[2], p0, *ref, beta1))
    return prog, ctrl
