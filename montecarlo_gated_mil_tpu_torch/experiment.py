"""Experiment assembly: Config -> model, criterion, optimizer, loaders.

Counterpart of ``montecarlo_gated_mil_tpu/experiment.py`` (reference
``main.py:56-81``, ``utils.py:36-243``) for the single-split path.  Records
come from the synthetic generator (``data.synthetic_count > 0``); DICOM
records and the cross-validation loaders are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable

import torch

from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.data.pipeline import BagLoader, PipelineConfig, torch_dtype
from montecarlo_gated_mil_tpu_torch.data.records import BagRecord, class_weights
from montecarlo_gated_mil_tpu_torch.data.splits import random_split
from montecarlo_gated_mil_tpu_torch.data.synthetic import make_synthetic_reader, synthetic_records
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.ops.patching import compute_tile_grid
from montecarlo_gated_mil_tpu_torch.train.criteria import make_criterion
from montecarlo_gated_mil_tpu_torch.train.optim import make_optimizer


def build_model(
    cfg: Config, num_classes: int = 2, *, seed: int | None = None
) -> MultiHeadGatedAttentionMIL:
    """Flagship MH-GA-MIL from config (reference ``main.py:56-61``).

    ``seed`` makes the random init reproducible without touching the
    caller's global RNG state.
    """

    def build():
        return MultiHeadGatedAttentionMIL(
            num_classes=num_classes,
            backbone=cfg.model,
            feature_dropout=cfg.feature_dropout,
            attention_dropout=cfg.attention_dropout,
            shared_attention=cfg.shared_att,
            dtype=torch_dtype(cfg.tpu.compute_dtype),
        )

    if seed is None:
        return build()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def build_criterion(cfg: Config) -> Callable:
    return make_criterion(cfg.training_plan.criterion)


def build_optimizer(cfg: Config, model: torch.nn.Module, steps_per_epoch: int = 1):
    """``(optimizer, scheduler)`` over the model's parameters.
    ``steps_per_epoch`` (= ceil(train bags / grad_acc_steps)) places
    epoch-unit scheduler decays on epoch boundaries (``train/optim.py``)."""
    return make_optimizer(cfg.training_plan, model.parameters(), steps_per_epoch)


@dataclass
class DataBundle:
    train: BagLoader
    val: BagLoader
    test: BagLoader
    records: list[BagRecord]


def print_class_counts(train_recs, val_recs, test_recs) -> dict[int, float]:
    """Per-set class counts and the inverse-frequency weights (reference
    ``print_class_counts``, ``utils.py:246-275``)."""
    for name, recs in (("Train", train_recs), ("Validation", val_recs), ("Test", test_recs)):
        counts = dict(sorted(Counter(r.class_name for r in recs).items()))
        print(f"  {name} set class counts: {counts}  (Total: {len(recs)})")
    weights, _ = class_weights(train_recs)
    return weights


def _pipeline_cfgs(cfg: Config) -> tuple[PipelineConfig, PipelineConfig]:
    """Train (overlap_train, augmented) and eval (overlap_val_test)
    pipelines; each caps at the registry bucket of its grid's tile count."""
    d = cfg.data
    spec = BucketSpec(cfg.tpu.buckets)
    train_grid = compute_tile_grid(d.H, d.W, d.patch_size, d.overlap_train)
    eval_grid = compute_tile_grid(d.H, d.W, d.patch_size, d.overlap_val_test)
    common = dict(height=d.H, width=d.W, patch_size=d.patch_size,
                  empty_threshold=d.empty_threshold, dtype=cfg.tpu.compute_dtype)
    train_cfg = PipelineConfig(
        overlap=d.overlap_train, bag_size=d.bag_size_train,
        bucket=spec.bucket_for(train_grid.num_tiles), augment=True, **common,
    )
    eval_cfg = PipelineConfig(
        overlap=d.overlap_val_test, bag_size=d.bag_size_val_test,
        bucket=spec.bucket_for(eval_grid.num_tiles), augment=False, **common,
    )
    return train_cfg, eval_cfg


def load_records(cfg: Config) -> tuple[list[BagRecord], Callable]:
    """Records + pixel reader from the synthetic generator."""
    d = cfg.data
    if not d.synthetic_count:
        raise NotImplementedError(
            "the port reads synthetic records only (data.synthetic_count > 0); "
            "DICOM records are not ported yet (ROADMAP.md queue 1, item 13)"
        )
    return synthetic_records(d.synthetic_count, seed=cfg.seed), make_synthetic_reader(d.H, d.W)


def get_dataloaders(cfg: Config, *, device: str | torch.device = "cuda") -> DataBundle:
    """Single random split (reference ``utils.get_dataloaders``), the bags
    built on ``device``."""
    recs, reader = load_records(cfg)
    s = random_split(len(recs), cfg.data.fraction_train_rest, cfg.data.fraction_val_test, cfg.seed)
    train_cfg, eval_cfg = _pipeline_cfgs(cfg)
    train_recs, val_recs, test_recs = ([recs[i] for i in idx] for idx in (s.train, s.val, s.test))
    print_class_counts(train_recs, val_recs, test_recs)
    spec = BucketSpec(cfg.tpu.buckets) if cfg.tpu.adaptive_buckets else None
    mm = cfg.data.multimodal and not cfg.data.synthetic_count

    def loader(r, pc, **kw):
        return BagLoader(r, reader, pc, multimodal=mm, seed=cfg.seed, bucket_spec=spec,
                         oversized=cfg.tpu.oversized_bags, device=device, **kw)

    return DataBundle(
        train=loader(train_recs, train_cfg, shuffle=True),
        val=loader(val_recs, eval_cfg),
        test=loader(test_recs, eval_cfg),
        records=recs,
    )
