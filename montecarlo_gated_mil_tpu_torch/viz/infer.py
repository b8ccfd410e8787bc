"""MCDO inference and the uncertainty figures (the ``infer`` entry point).

Counterpart of ``montecarlo_gated_mil_tpu/viz/infer.py`` (reference
``infer.py:111-239``): for each saved fold model of a CV manifest and each
test item, T-sample MC inference (on the card: K3 builds the bag, K1 runs
the head), the per-class mean and std attention maps at full resolution,
the predictive statistics, and the five-panel figure.  With
``ensemble=True`` one pooled figure per test item from the fold ensemble's
M*T samples (members in turn, ``mcdo/ensemble.py``).  Maps and statistics
are computed on the bag's device; only the finished maps cross to the host.

The display image is the item re-read and canonicalized as the bag was,
as the reference re-loads the DICOM for display (``infer.py:201-210``).  A
DICOM reader's :class:`PixelData` is unwrapped first, and a CC+MLO pair is
stacked MLO over CC; the JAX package's ``_render_item`` unwraps only a
tuple (ROADMAP.md queue 3).
"""

from __future__ import annotations

import json
import os

import torch

from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.data.pipeline import canonicalize_image, stack_multimodal
from montecarlo_gated_mil_tpu_torch.data.records import PixelData
from montecarlo_gated_mil_tpu_torch.experiment import build_model, get_fold_dataloaders
from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import ensemble_mc_inference, load_fold_ensemble
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import (
    PredictiveStats,
    mc_inference,
    predictive_stats,
)
from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer
from montecarlo_gated_mil_tpu_torch.viz.attention import attention_map_stats
from montecarlo_gated_mil_tpu_torch.viz.figures import plot_attention_and_density


def _render_item(out, bag, rec, grid, reader, dest_dir, j, num_samples) -> str:
    """Maps, statistics and display image for one test item, then its
    figure ``dest_dir/{j + 1}_{class}.pdf/.png``.  The display image is
    the item as the bag saw it: :class:`PixelData` unwrapped, a (CC, MLO)
    pair stacked MLO over CC, then canonicalized on the bag's device."""
    stats = predictive_stats(out.predictions)
    # (C, H, W) each; std over samples, ddof=1, zero at one sample
    mean_maps, std_maps = attention_map_stats(out.attention, bag.tile_indices, bag.mask, grid)
    raw = reader(rec)
    if isinstance(raw, PixelData):
        raw = raw.images if len(raw.images) > 1 else raw.images[0]
    if isinstance(raw, tuple):
        raw = stack_multimodal(*raw)
    img = torch.as_tensor(raw, device=bag.patches.device).to(torch.float32)
    img = canonicalize_image(img, rec.laterality == "R", (grid.height, grid.width))
    host = PredictiveStats(**{k: v.cpu() for k, v in vars(stats).items()})
    path = os.path.join(dest_dir, f"{j + 1}_{rec.class_name}")
    plot_attention_and_density(
        img.cpu().numpy(),
        mean_maps[1].cpu().numpy(),
        std_maps[1].cpu().numpy(),
        mean_maps[0].cpu().numpy(),
        std_maps[0].cpu().numpy(),
        host,
        title_class=rec.class_name,
        num_samples=num_samples,
        save_path=path,
    )
    return path


def run_inference(
    cfg: Config,
    out_dir: str = "figures",
    manifest_path: str | None = None,
    max_items: int = 0,
    ensemble: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> list[str]:
    """Figures for every fold x test item under ``out_dir/figures_f{k}/``
    or, with ``ensemble``, one pooled fold-ensemble figure per test item
    under ``out_dir/figures_ensemble/``; ``max_items > 0`` stops after that
    many items.  Item ``j`` draws its dropout from ``fold_in(named_seed(
    cfg.seed, "infer"), j)``.  Returns the saved paths (without suffix)."""
    device = torch.device(device)
    manifest_path = manifest_path or os.path.join(cfg.model_path, "cv_manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    model = build_model(cfg).to(device)
    key = rng.named_seed(cfg.seed, "infer")
    saved: list[str] = []
    if ensemble:
        members = load_fold_ensemble(cfg, manifest)
        n_members = len(manifest["folds"])
        data = get_fold_dataloaders(cfg, 0, device=device)  # every fold's test split
        dest = os.path.join(out_dir, "figures_ensemble")
        os.makedirs(dest, exist_ok=True)
        grid = data.test.cfg.grid()
        for j, (bag, rec) in enumerate(data.test.epoch(0)):
            if max_items and j >= max_items:
                break
            out = ensemble_mc_inference(model, members, bag.patches, bag.mask, cfg.N,
                                        rng.fold_in(key, j))
            saved.append(_render_item(out, bag, rec, grid, data.test.reader, dest, j,
                                      n_members * cfg.N))
            print(f"done: {j + 1}/{len(data.test)} (ensemble of {n_members})")
        return saved
    ckpt = Checkpointer(cfg.model_path)
    for entry in manifest["folds"]:
        fold = entry["fold"]
        model.load_state_dict(ckpt.restore_params(entry["checkpoint"]))
        data = get_fold_dataloaders(cfg, fold - 1, device=device)
        fold_dir = os.path.join(out_dir, f"figures_f{fold - 1}")
        os.makedirs(fold_dir, exist_ok=True)
        grid = data.test.cfg.grid()
        for j, (bag, rec) in enumerate(data.test.epoch(0)):
            if max_items and j >= max_items:
                break
            out = mc_inference(model, bag.patches, bag.mask, cfg.N, rng.fold_in(key, j),
                               device=device)
            saved.append(_render_item(out, bag, rec, grid, data.test.reader, fold_dir, j,
                                      cfg.N))
            print(f"done: {j + 1}/{len(data.test)} (fold {fold})")
    return saved
