"""Experiment assembly: Config -> model, criterion, optimizer, loaders.

Counterpart of ``montecarlo_gated_mil_tpu/experiment.py`` (reference
``main.py:56-81``, ``utils.py:36-243``): the loaders of a single random
split or of one cross-validation fold.  Records come from the synthetic
generator (``data.synthetic_count > 0``) or from the metadata pickle and
its DICOM files: pandas reads the pickle, and pydicom, where installed, or
the port's native reader (``data/dicom_native.py``) reads the files.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable

import torch

from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.data.pipeline import BagLoader, PipelineConfig, torch_dtype
from montecarlo_gated_mil_tpu_torch.data.records import BagRecord, class_weights, select_records
from montecarlo_gated_mil_tpu_torch.data.splits import (
    kfold_split,
    random_split,
    stratified_test_split,
)
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
    """Records + pixel reader: the synthetic generator when
    ``data.synthetic_count > 0``, else ``select_records`` over the pandas
    pickle at ``data.metadata_path`` with a DICOM reader of
    ``data.root_path`` (pydicom where it imports, else the native reader).
    Without pandas the DICOM branch raises ``ImportError``."""
    d = cfg.data
    if d.synthetic_count:
        return synthetic_records(d.synthetic_count, seed=cfg.seed), make_synthetic_reader(d.H, d.W)
    import pandas as pd

    df = pd.read_pickle(d.metadata_path)
    recs = select_records(df.to_dict("records"), list(d.view), d.multimodal)
    from montecarlo_gated_mil_tpu_torch.data.dicom import HAVE_PYDICOM, make_dicom_reader

    if HAVE_PYDICOM:
        return recs, make_dicom_reader(d.root_path)
    from montecarlo_gated_mil_tpu_torch.data.dicom_native import make_native_dicom_reader

    return recs, make_native_dicom_reader(d.root_path)


def _bundle(cfg: Config, recs: list[BagRecord], reader, train_idx, val_idx, test_idx, *,
            weighted: bool, device) -> DataBundle:
    """Train, val and test loaders over the given record indices, the bags
    built on ``device``.  With ``weighted`` the train loader draws each
    epoch's order with replacement by the inverse-frequency sample weights
    (reference ``WeightedRandomSampler``, ``utils.py:217``)."""
    train_cfg, eval_cfg = _pipeline_cfgs(cfg)
    train_recs, val_recs, test_recs = ([recs[i] for i in idx] for idx in (train_idx, val_idx,
                                                                          test_idx))
    print_class_counts(train_recs, val_recs, test_recs)
    sample_w = class_weights(train_recs)[1] if weighted and train_recs else None
    spec = BucketSpec(cfg.tpu.buckets) if cfg.tpu.adaptive_buckets else None
    mm = cfg.data.multimodal and not cfg.data.synthetic_count

    # The reference's DataLoader worker count (config.yml:43, utils.py:99)
    # sizes the loader's pool of raw reads.
    io_workers = max(1, cfg.training_plan.parameters.num_workers)

    def loader(r, pc, **kw):
        return BagLoader(r, reader, pc, multimodal=mm, seed=cfg.seed, bucket_spec=spec,
                         oversized=cfg.tpu.oversized_bags, io_workers=io_workers, device=device,
                         **kw)

    return DataBundle(
        train=loader(train_recs, train_cfg, shuffle=True, sample_weights=sample_w),
        val=loader(val_recs, eval_cfg),
        test=loader(test_recs, eval_cfg),
        records=recs,
    )


def get_dataloaders(cfg: Config, *, device: str | torch.device = "cuda") -> DataBundle:
    """Single random split (reference ``utils.get_dataloaders``), the bags
    built on ``device``."""
    recs, reader = load_records(cfg)
    s = random_split(len(recs), cfg.data.fraction_train_rest, cfg.data.fraction_val_test, cfg.seed)
    return _bundle(cfg, recs, reader, s.train, s.val, s.test, weighted=False, device=device)


def get_fold_dataloaders(cfg: Config, fold: int, *,
                         device: str | torch.device = "cuda") -> DataBundle:
    """Fold ``fold`` (0-based) of cross-validation (reference
    ``utils.get_fold_dataloaders``): a stratified test split held out first,
    the same for every fold, then k-fold train/val over the rest; the train
    loader samples by class weight when ``training_plan.weighted_sampler``."""
    recs, reader = load_records(cfg)
    train_val, test_idx = stratified_test_split([r.label for r in recs], cfg.data.fraction_test,
                                                cfg.seed)
    tr, va = kfold_split(len(train_val), cfg.data.cv_folds, fold, cfg.seed)
    return _bundle(cfg, recs, reader, train_val[tr], train_val[va], test_idx,
                   weighted=cfg.training_plan.weighted_sampler, device=device)
