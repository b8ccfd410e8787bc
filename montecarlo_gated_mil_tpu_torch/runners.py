"""End-to-end runners: single-split training, k-fold CV, CV re-evaluation.

Counterpart of ``montecarlo_gated_mil_tpu/runners.py`` on one device:

- ``run_training`` (reference ``main.py:22-108``): build the model and
  loaders, train with gradient accumulation, validate each epoch, stop
  early, save the best weights under a uuid name, rebuild the model, reload
  them, and test;
- ``run_cross_validation`` (``cross_validation.py:21-135``): per fold a
  fresh model, loaders, optimizer and early stopping, fold-prefixed
  metrics, an epoch checkpoint directory per fold, the best weights saved
  as ``fold_{k}_{uuid}``, the MC or deterministic test, and a
  ``cv_manifest.json``; completed folds go to a progress file, so
  ``resume=True`` skips them and continues a fold from its last epoch;
- ``run_cv_eval`` (``cross_val_eval.py:37-163``): re-evaluates the saved
  fold models (MC and deterministic test, each timed), averages across
  folds, and with ``ensemble=True`` scores the pooled fold ensemble.

Every random stream derives from ``cfg.seed`` (``core/rng.py``): a fold's
from ``(seed, fold)`` alone, never from loop position, so a resumed run
trains the remaining folds as an uninterrupted one would.

Not ported yet (ROADMAP.md queue 1, item 1): data-parallel evaluation and
training, instance-sharded and oversize-routed bags, and multi-process fold
fan-out.
"""

from __future__ import annotations

import glob
import json
import os
import time
import uuid

import torch

from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.core.config import Config, config_to_dict
from montecarlo_gated_mil_tpu_torch.evaluation.report import (
    aggregate_classification_reports,
    aggregate_fold_accuracies,
)
from montecarlo_gated_mil_tpu_torch.experiment import (
    DataBundle,
    build_criterion,
    build_model,
    build_optimizer,
    get_dataloaders,
    get_fold_dataloaders,
)
from montecarlo_gated_mil_tpu_torch.parallel.distributed import (
    allgather_fold_accuracies,
    fold_assignment,
    process_count,
    process_index,
)
from montecarlo_gated_mil_tpu_torch.train.loops import (
    ensemble_mc_test,
    mc_test,
    mc_validate,
    test,
    train_epoch,
    validate,
)
from montecarlo_gated_mil_tpu_torch.train.state import (
    Checkpointer,
    EarlyStopping,
    TrainState,
    make_train_step,
)
from montecarlo_gated_mil_tpu_torch.utils.metrics import Metrics


def initial_model(cfg: Config, fold: int | None = None) -> torch.nn.Module:
    """The model a run starts from: seeded random init (fold ``k`` of CV
    folds ``k`` into the seed), and the backbone from
    ``cfg.backbone_weights`` when set (a torchvision-named state_dict,
    optionally under the reference's ``feature_extractor.`` prefix; running
    statistics and ``fc`` are dropped, as the model has neither)."""
    seed = rng.named_seed(cfg.seed, "params")
    if fold is not None:
        seed = rng.fold_in(seed, fold)
    model = build_model(cfg, seed=seed)
    if cfg.backbone_weights:
        sd = torch.load(cfg.backbone_weights, map_location="cpu", weights_only=True)
        prefix = "feature_extractor."
        sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
        own = model.feature_extractor.state_dict()
        model.feature_extractor.load_state_dict({k: v for k, v in sd.items() if k in own})
        print(f"Initialized backbone from {cfg.backbone_weights}")
    return model


def _mc_test(cfg: Config, model, loader, *, seed: int, metrics: Metrics, fold: int | None):
    """The MC test of one model, through the int8 embed when
    ``tpu.quantized_inference`` is set for an r18/r34/r50 backbone (JAX
    ``runners._mc_test``'s sequential branch; its data-parallel branch is
    ROADMAP.md queue 1, item 1)."""
    quantized = cfg.tpu.quantized_inference and cfg.model in ("r18", "r34", "r50")
    return mc_test(model, loader, num_samples=cfg.N, seed=seed, metrics=metrics, fold=fold,
                   quantized=quantized)


def _fit(
    cfg: Config,
    model: torch.nn.Module,
    data: DataBundle,
    metrics: Metrics,
    *,
    fold: int | None = None,
    checkpointer: Checkpointer | None = None,
    resume: bool = False,
) -> tuple[TrainState, EarlyStopping]:
    """Epoch loop with early stopping (reference ``main.py:83-91``,
    ``cross_validation.py:96-109``); with ``fold`` the metrics carry its
    prefix.  With a ``checkpointer`` the full state persists every
    ``cfg.tpu.checkpoint_every`` epochs and ``resume=True`` continues from
    the latest; a fresh run purges the directory's old steps first.
    ``tpu.debug_nans`` / ``debug_infs`` check every step's loss and
    gradients and raise ``FloatingPointError`` on a NaN / an Inf."""
    params = cfg.training_plan.parameters
    k = params.grad_acc_steps
    criterion = build_criterion(cfg)
    # Epoch-unit scheduler decays need the optimizer steps one epoch makes:
    # one every k bags plus the epoch-end flush, ceil(bags / k).
    steps_per_epoch = max(1, -(-len(data.train) // k))
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch)
    state = TrainState(model, optimizer, scheduler)
    step_fn = make_train_step(model, criterion, optimizer, k, debug_nans=cfg.tpu.debug_nans,
                              debug_infs=cfg.tpu.debug_infs)
    stopper = EarlyStopping(params.patience, metrics.scoped(fold))
    train_key = rng.named_seed(cfg.seed, "train-dropout")
    val_key = rng.named_seed(cfg.seed, "mc-val")
    start_epoch = 1
    if checkpointer is not None and checkpointer.latest_step() is not None:
        if resume:
            state, meta, best = checkpointer.restore(state)
            stopper.load_state_dict(meta["early_stop"])
            stopper.best_params = best
            start_epoch = int(meta["epoch"]) + 1
            print(f"Resumed from epoch {meta['epoch']} (next: {start_epoch})")
        elif cfg.tpu.checkpoint_every:
            print(f"Fresh run: purging stale checkpoints in {checkpointer.directory}")
            checkpointer.purge_steps()
    for epoch in range(start_epoch, params.epochs + 1):
        state = train_epoch(step_fn, state, data.train, epoch=epoch, accumulation_steps=k,
                            key=train_key, metrics=metrics, fold=fold)
        if cfg.is_mcdo_val:
            val_loss = mc_validate(model, data.val, criterion, epoch=epoch, num_samples=cfg.N,
                                   key=val_key, metrics=metrics, fold=fold)
        else:
            val_loss = validate(model, data.val, criterion, epoch=epoch, metrics=metrics,
                                fold=fold)
        stop = stopper(val_loss, model)
        every = cfg.tpu.checkpoint_every
        if checkpointer is not None and every and (epoch % every == 0 or stop):
            checkpointer.save(epoch, state, epoch=epoch, early_stop=stopper.state_dict(),
                              best_params=stopper.best_params)
        if stop:
            print(f"Early stopping at epoch {epoch}")
            break
    return state, stopper


def run_training(
    cfg: Config,
    metrics: Metrics | None = None,
    resume: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """Single-split train -> save best -> reload -> deterministic test.

    Returns ``best_model_path``, ``test_accuracy``, ``report``, and the
    in-memory ``best_params`` and reloaded, tested ``model``.
    """
    device = torch.device(device)
    metrics = metrics or Metrics()
    model = initial_model(cfg).to(device)
    data = get_dataloaders(cfg, device=device)
    state, stopper = _fit(
        cfg, model, data, metrics,
        checkpointer=Checkpointer(os.path.join(cfg.model_path, "train_state")), resume=resume,
    )
    best = stopper.best_params
    if best is None:
        best = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    ckpt = Checkpointer(cfg.model_path)
    # model_id pins the saved-model name; empty -> a fresh uuid4, as main.py:92-94.
    name = cfg.model_id or uuid.uuid4().hex
    path = ckpt.save_params(name, best)
    metrics.log("best_model_path", path)
    model2 = build_model(cfg).to(device)
    model2.load_state_dict(ckpt.restore_params(name))
    acc, report = test(model2, data.test, metrics=metrics)
    return {"best_model_path": path, "test_accuracy": acc, "report": report,
            "best_params": best, "model": model2}


def _load_cv_progress(model_path: str, my_folds: set) -> list[dict]:
    """Completed folds for resume, from every ``cv_progress*.json`` (a run
    may resume under another process layout).  Keeps well-formed entries of
    this process's folds whose checkpoint still exists, the first file
    (sorted by path) winning a duplicate; an unreadable or malformed file,
    as a crash mid-write leaves, is skipped with a message."""
    entries: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(model_path, "cv_progress*.json"))):
        try:
            with open(path) as f:
                loaded = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            print(f"ignoring unreadable CV progress file {path}: {e}")
            continue
        if not isinstance(loaded, list):
            print(f"ignoring malformed CV progress file {path}")
            continue
        for entry in loaded:
            fold = entry.get("fold") if isinstance(entry, dict) else None
            if (
                isinstance(fold, int)
                and fold - 1 in my_folds
                and fold not in entries
                and "accuracy" in entry
                and os.path.exists(str(entry.get("checkpoint", "")))
            ):
                entries[fold] = entry
    return [entries[f] for f in sorted(entries)]


def _write_cv_progress(progress_path: str, folds: list[dict]) -> None:
    """Atomic rewrite: the file must survive a crash that lands mid-write,
    the crash it exists for."""
    tmp = progress_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(folds, f, indent=2, default=str)
    os.replace(tmp, progress_path)


def run_cross_validation(
    cfg: Config,
    metrics: Metrics | None = None,
    resume: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """k-fold CV on ``device``; returns the manifest it writes to
    ``model_path/cv_manifest.json``: ``config``, ``folds`` (``fold``,
    ``checkpoint``, ``accuracy`` each), ``all_fold_accuracies`` and the
    fold-aggregated ``accuracy``.  ``resume=True`` skips the folds of the
    progress file whose checkpoints exist and continues an unfinished fold
    from its last checkpointed epoch."""
    device = torch.device(device)
    metrics = metrics or Metrics()
    ckpt = Checkpointer(cfg.model_path)
    test_seed = rng.named_seed(cfg.seed, "mc-test")
    n_proc = process_count()
    my_folds = fold_assignment(cfg.data.cv_folds, process_index(), n_proc)
    suffix = "" if n_proc == 1 else f"_p{process_index()}"
    progress_path = os.path.join(cfg.model_path, f"cv_progress{suffix}.json")
    folds = _load_cv_progress(cfg.model_path, set(my_folds)) if resume else []
    if folds:
        print(f"Resuming CV: folds {[f['fold'] for f in folds]} already done")
    done = {entry["fold"] for entry in folds}
    for fold in my_folds:
        k = fold + 1
        if k in done:
            continue
        print(f"Fold {k}/{cfg.data.cv_folds}")
        t0 = time.perf_counter()
        model = initial_model(cfg, fold=k).to(device)
        data = get_fold_dataloaders(cfg, fold, device=device)
        state, stopper = _fit(
            cfg, model, data, metrics, fold=k,
            checkpointer=Checkpointer(os.path.join(cfg.model_path, f"fold_{k}", "train_state")),
            resume=resume,
        )
        best = stopper.best_params
        if best is None:
            best = {n: v.detach().clone() for n, v in state.model.state_dict().items()}
        path = ckpt.save_params(f"fold_{k}_{uuid.uuid4().hex}", best)
        metrics.log(f"fold_{k}/best_model_path", path)
        model.load_state_dict(best)
        if cfg.is_mcdo_test:
            acc, _ = _mc_test(cfg, model, data.test, seed=rng.fold_in(test_seed, fold),
                              metrics=metrics, fold=k)
        else:
            acc, _ = test(model, data.test, metrics=metrics, fold=k)
        folds.append({"fold": k, "checkpoint": path, "accuracy": acc})
        _write_cv_progress(progress_path, folds)
        print(f"Fold {k}/{cfg.data.cv_folds} done in {time.perf_counter() - t0:.2f} s: "
              f"accuracy {acc:.4f}")
    folds.sort(key=lambda entry: entry["fold"])
    merged = allgather_fold_accuracies(
        [entry["fold"] - 1 for entry in folds], [entry["accuracy"] for entry in folds],
        cfg.data.cv_folds,
    )
    agg = aggregate_fold_accuracies([merged[f] for f in sorted(merged)])
    manifest = {
        "config": config_to_dict(cfg),
        "folds": folds,  # this process's folds (their checkpoints live here)
        "all_fold_accuracies": {str(f + 1): v for f, v in sorted(merged.items())},
        "accuracy": agg,
    }
    with open(os.path.join(cfg.model_path, f"cv_manifest{suffix}.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    # The manifest supersedes progress.  A single process also clears
    # other processes' stale progress files; one of many clears its own.
    stale = (glob.glob(os.path.join(cfg.model_path, "cv_progress*.json")) if n_proc == 1
             else [progress_path])
    for p in stale:
        if os.path.exists(p):
            os.remove(p)
    print(f"CV accuracy: {agg['mean']:.4f} ± {agg['std']:.4f}")
    return manifest


def load_cv_manifest(model_path: str, manifest_path: str | None = None) -> dict:
    """The CV manifest: ``manifest_path`` as it is, else
    ``model_path/cv_manifest.json`` or the merge of the per-process
    ``cv_manifest_p*.json`` files, whichever generation is newer on disk
    (the choice is printed).  Duplicate fold ids across per-process files
    raise ``ValueError``."""
    if manifest_path is not None:
        with open(manifest_path) as f:
            return json.load(f)
    single = os.path.join(model_path, "cv_manifest.json")
    per_proc = sorted(glob.glob(os.path.join(model_path, "cv_manifest_p*.json")))
    if not per_proc and not os.path.exists(single):
        raise FileNotFoundError(f"no cv_manifest*.json under {model_path}")
    if os.path.exists(single) and (
        not per_proc or os.path.getmtime(single) >= max(map(os.path.getmtime, per_proc))
    ):
        if per_proc:
            print(f"Using single-process manifest {single} (newer on disk than "
                  f"{len(per_proc)} per-process cv_manifest_p*.json; pass an explicit "
                  "manifest_path if that is not the run you want)")
        with open(single) as f:
            return json.load(f)
    if os.path.exists(single):
        print(f"Using {len(per_proc)} per-process manifests (newer on disk than {single}; "
              "pass an explicit manifest_path to override)")
    merged: dict | None = None
    for path in per_proc:
        with open(path) as f:
            part = json.load(f)
        if merged is None:
            merged = part
        else:
            merged["folds"] = merged.get("folds", []) + part.get("folds", [])
            merged.setdefault("all_fold_accuracies", {}).update(
                part.get("all_fold_accuracies", {}))
    seen = [e["fold"] for e in merged["folds"]]
    if len(seen) != len(set(seen)):
        raise ValueError(
            f"duplicate fold ids {sorted(seen)} across per-process manifests under "
            f"{model_path}; stale files from an earlier run? Pass an explicit "
            "manifest_path or clean the directory."
        )
    merged["folds"] = sorted(merged["folds"], key=lambda e: e["fold"])
    return merged


def run_cv_eval(
    cfg: Config,
    manifest_path: str | None = None,
    metrics: Metrics | None = None,
    ensemble: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """Re-evaluate the saved fold models on ``device``: per fold the MC and
    the deterministic test, each timed, then ``mc``, ``deterministic``
    (fold accuracies aggregated) and ``mc_report``, ``deterministic_report``
    (fold-averaged reports).  ``ensemble=True`` adds ``ensemble`` and
    ``ensemble_report``: the fold ensemble's MC test on the test split,
    which every fold shares."""
    device = torch.device(device)
    metrics = metrics or Metrics()
    manifest = load_cv_manifest(cfg.model_path, manifest_path)
    model = build_model(cfg).to(device)
    ckpt = Checkpointer(cfg.model_path)
    test_seed = rng.named_seed(cfg.seed, "cv-eval")
    mc_accs, det_accs, mc_reports, det_reports = [], [], [], []
    # Members are kept (on the host) only for the ensemble vote.
    fold_params: dict[int, dict] = {}
    for entry in manifest["folds"]:
        fold = entry["fold"]
        data = get_fold_dataloaders(cfg, fold - 1, device=device)
        params = ckpt.restore_params(entry["checkpoint"])
        model.load_state_dict(params)
        if ensemble:
            fold_params[fold] = params
        t0 = time.perf_counter()
        mc_acc, mc_report = _mc_test(cfg, model, data.test, seed=rng.fold_in(test_seed, fold),
                                     metrics=metrics, fold=fold)
        mc_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        det_acc, det_report = test(model, data.test, metrics=metrics, fold=fold)
        det_time = time.perf_counter() - t0
        print(f"fold {fold}: MC-ACC {mc_acc:.4f} ({mc_time:.2f}s)  "
              f"nMC-ACC {det_acc:.4f} ({det_time:.2f}s)")
        mc_accs.append(mc_acc)
        det_accs.append(det_acc)
        mc_reports.append(mc_report.data)
        det_reports.append(det_report.data)
    result = {
        "mc": aggregate_fold_accuracies(mc_accs),
        "deterministic": aggregate_fold_accuracies(det_accs),
        "mc_report": aggregate_classification_reports(mc_reports),
        "deterministic_report": aggregate_classification_reports(det_reports),
    }
    print(f"MC-ACC: {result['mc']['mean']:.4f} ± {result['mc']['std']:.4f}   "
          f"nMC-ACC: {result['deterministic']['mean']:.4f} ± "
          f"{result['deterministic']['std']:.4f}")
    if ensemble:
        from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import stack_params

        members = stack_params([fold_params[f] for f in sorted(fold_params)])
        data = get_fold_dataloaders(cfg, 0, device=device)  # the test split of every fold
        ens_acc, ens_report = ensemble_mc_test(
            model, members, data.test, num_samples=cfg.N,
            seed=rng.named_seed(cfg.seed, "ens-test"), metrics=metrics,
        )
        result["ensemble"] = {"accuracy": ens_acc}
        result["ensemble_report"] = ens_report.data
        print(f"ENS-ACC ({len(manifest['folds'])} folds x T={cfg.N}): {ens_acc:.4f}")
    return result
