"""Uncertainty acceptance: the port's MCDO uncertainty must be informative.

The harness of the JAX package's ``tests/test_uncertainty.py``, on the
port: a small r18 ``MultiHeadGatedAttentionMIL`` (dropout 0.25/0.25) trains
briefly (Adam 2e-4, 24 bags x 14 epochs, through ``make_train_step``) on
synthetic 16-tile bags whose positives carry 3 injected lesion tiles, then
T=30 MC samples per bag must show

  1. higher predictive uncertainty (std over T of the class-1 softmax
     probability, ddof=0, and the entropy of the mean softmax) on
     constructed-ambiguous bags (lesion contrast 0.28) than on clear ones;
  2. class-1 attention mass on the lesion tiles of clear positives far
     above the uniform share;
  3. the MC attention spread (std over T, ddof=1) larger on the lesion
     tiles than on the background.

The bags are built with numpy from the same seeds as the JAX test, so both
packages see the same pixels; the port's dropout streams and init are its
own, so its trained model is not JAX's.  ``tests/test_torch_uncertainty.py``
runs it on the CPU (marked slow), ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.core import rng as prng
from montecarlo_gated_mil_tpu_torch.core.bag import Bag

PATCH = 16
N_TILES = 16
N_LESION = 3  # lesion tiles per positive bag
T = 30
# What the acceptance requires (the JAX test's thresholds).
MIN_FIT_ACCURACY = 0.85
MIN_STD_RATIO = 1.2  # ambiguous / clear MC std of P(class 1)
MIN_ENTROPY_RATIO = 1.2  # ambiguous / clear predictive entropy
MIN_MASS_RATIO = 2.0  # lesion attention mass / uniform share
MIN_SPREAD_RATIO = 1.0  # lesion / background MC attention std
CRITERIA = (  # (name, threshold) in the order of :func:`criteria`
    ("fit accuracy", MIN_FIT_ACCURACY),
    ("ambiguous/clear MC std", MIN_STD_RATIO),
    ("ambiguous/clear entropy", MIN_ENTROPY_RATIO),
    ("lesion mass / uniform share", MIN_MASS_RATIO),
    ("lesion/background attention std", MIN_SPREAD_RATIO),
)


def _tile(rng: np.random.Generator, *, lesion: bool, amp: float = 0.9) -> np.ndarray:
    """One 16 px grayscale tissue tile; ``lesion`` adds a bright Gaussian
    mass of contrast ``amp``."""
    base = rng.uniform(0.25, 0.45) + rng.normal(0, 0.03, (PATCH, PATCH))
    img = np.clip(base, 0.05, 1.0).astype(np.float32)
    if lesion:
        y, x = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
        cy, cx = rng.uniform(5, 11, 2)
        r = rng.uniform(2.0, 3.5)
        img = np.clip(
            img + amp * np.exp(-(((y - cy) ** 2 + (x - cx) ** 2) / (2 * r**2))), 0.0, 1.0
        ).astype(np.float32)
    return img


def make_bag(seed: int, *, positive: bool, amp: float = 0.9,
             device: str | torch.device = "cuda") -> tuple[Bag, np.ndarray]:
    """A bag of ``N_TILES`` tiles on ``device``; positive bags carry
    ``N_LESION`` lesion tiles at contrast ``amp``.  Returns ``(bag,
    lesion_mask (N,) bool)``."""
    rng = np.random.default_rng(seed)
    lesion = np.zeros((N_TILES,), bool)
    if positive:
        lesion[rng.choice(N_TILES, N_LESION, replace=False)] = True
    tiles = np.stack([_tile(rng, lesion=bool(lesion[i]), amp=amp) for i in range(N_TILES)])
    patches = np.repeat(tiles[..., None], 3, axis=-1)  # grayscale -> RGB
    bag = Bag(
        patches=torch.from_numpy(patches).to(device),
        mask=torch.ones(N_TILES, dtype=torch.bool, device=device),
        label=torch.tensor(1 if positive else 0, device=device),
        tile_indices=torch.arange(N_TILES, device=device),
    )
    return bag, lesion


def train_toy_model(n_bags: int = 24, epochs: int = 14, *, seed: int = 0,
                    device: str | torch.device = "cuda"):
    """Briefly train the flagship model on clear synthetic bags, its init
    and dropout streams from ``seed`` (the acceptance's is 0, as the JAX
    test's key is).  On a card cuDNN runs deterministic and without TF32:
    its default backward algorithms sum in a varying order, which sends one
    seed down different trajectories from run to run.  Returns ``(model,
    per-epoch training accuracies)``."""
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MultiHeadGatedAttentionMIL(
            backbone="r18", feature_dropout=0.25, attention_dropout=0.25
        ).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=2e-4)
    state = TrainState(model, opt)
    step = make_train_step(model, cross_entropy, opt, accumulation_steps=1)
    bags = [make_bag(1000 + i, positive=i % 2 == 0, device=device)[0] for i in range(n_bags)]
    accs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for epoch in range(epochs):
            correct = 0.0
            for i, bag in enumerate(bags):
                state, out = step(state, bag, prng.fold_in(prng.fold_in(seed, epoch), i), True)
                correct += float(out["correct"])
            accs.append(correct / n_bags)
    return model, accs


def mc_stats(model, bag: Bag, seed: int = 0):
    """``(P(class 1) mean, its std ddof=0, predictive entropy, A (T, C, N))``
    of T MC samples."""
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference

    out = mc_inference(model, bag.patches, bag.mask, T, seed, device=bag.patches.device)
    probs = torch.softmax(out.predictions, dim=-1)  # (T, C)
    mean = probs.mean(0)
    entropy = float(-(mean * torch.log(torch.clamp(mean, 1e-12, 1.0))).sum())
    return (float(mean[1]), float(probs[:, 1].std(correction=0)), entropy,
            out.attention.cpu().numpy())


def predictive_values(model) -> tuple[np.ndarray, np.ndarray]:
    """Per bag ``(P(class 1) mean, MC std, predictive entropy)`` of 8 clear
    bags (positive at even index) and of 8 constructed-ambiguous bags
    (lesion contrast 0.28, far below the trained 0.9): two ``(8, 3)``
    arrays."""
    device = next(model.parameters()).device
    clear, ambig = [], []
    for i in range(8):
        bag, _ = make_bag(2000 + i, positive=i % 2 == 0, device=device)
        clear.append(mc_stats(model, bag, seed=i)[:3])
    for i in range(8):
        bag, _ = make_bag(3000 + i, positive=True, amp=0.28, device=device)
        ambig.append(mc_stats(model, bag, seed=100 + i)[:3])
    return np.array(clear), np.array(ambig)


def spread_ratios(clear: np.ndarray, ambig: np.ndarray) -> tuple[float, float]:
    """Mean MC std and entropy of the ambiguous bags over those of the clear
    bags, from :func:`predictive_values`: ``(std ratio, entropy ratio)``."""
    clear, ambig = clear[:, 1:].mean(axis=0), ambig[:, 1:].mean(axis=0)
    return float(ambig[0] / clear[0]), float(ambig[1] / clear[1])


def uncertainty_ratios(model) -> tuple[float, float]:
    """:func:`spread_ratios` of the model's bags."""
    return spread_ratios(*predictive_values(model))


def lesion_attention(model) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """On 8 clear positive bags, per bag: the class-1 attention mass on the
    lesion tiles, and the MC attention std (ddof=1) averaged over the lesion
    tiles and over the background: three ``(8,)`` arrays."""
    device = next(model.parameters()).device
    mass, lesion_std, background_std = [], [], []
    for i in range(8):
        bag, lesion = make_bag(4000 + i, positive=True, device=device)
        A = mc_stats(model, bag, seed=200 + i)[3][:, 1, :]  # (T, N), class-1 head
        mass.append(float(A.mean(0)[lesion].sum()))
        a_std = A.std(0, ddof=1)
        lesion_std.append(float(a_std[lesion].mean()))
        background_std.append(float(a_std[~lesion].mean()))
    return np.array(mass), np.array(lesion_std), np.array(background_std)


def lesion_ratios(mass, lesion_std, background_std) -> tuple[float, float]:
    """From :func:`lesion_attention`, each a mean over the bags: the lesion
    mass over the uniform share, and the lesion over the background MC
    attention std: ``(mass ratio, spread ratio)``."""
    spread = [float(s) / max(float(b), 1e-9) for s, b in zip(lesion_std, background_std)]
    return float(np.mean([float(m) / (N_LESION / N_TILES) for m in mass])), float(np.mean(spread))


def attention_ratios(model) -> tuple[float, float]:
    """:func:`lesion_ratios` of the model's clear positive bags."""
    return lesion_ratios(*lesion_attention(model))


def criteria(accs, ratios) -> tuple[tuple[float, ...], tuple[bool, ...]]:
    """The acceptance's five criteria (:data:`CRITERIA`) of one trained
    model: the values ``(last-epoch fit accuracy, *ratios)`` and whether
    each meets its threshold (the fit at least its threshold, each ratio
    above its own).  ``ratios``: :func:`uncertainty_ratios`, then
    :func:`attention_ratios`."""
    values = (float(accs[-1]), *map(float, ratios))
    oks = (values[0] >= MIN_FIT_ACCURACY,) + tuple(
        v > t for v, (_, t) in zip(values[1:], CRITERIA[1:]))
    return values, oks


def describe(values, oks) -> str:
    """One line of :func:`criteria`'s result: each value beside its
    threshold and whether it passes."""
    return "; ".join(f"{n} {v:.4f} (threshold {t:g}, {'pass' if o else 'FAIL'})"
                     for (n, t), v, o in zip(CRITERIA, values, oks))
