"""End-to-end runner: single-split training.

Counterpart of ``montecarlo_gated_mil_tpu/runners.py::run_training``
(reference ``main.py:22-108``) on one device: build the model and loaders,
train with gradient accumulation, validate each epoch, stop early, save the
best weights under a uuid name, rebuild the model, reload them, and test.
Every random stream derives from ``cfg.seed`` (``core/rng.py``).

Not ported yet (ROADMAP.md): data-parallel, instance-sharded and
oversize-routed training, cross-validation and its re-evaluation, the MC
test and the ensemble.
"""

from __future__ import annotations

import os
import uuid

import torch

from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.experiment import (
    DataBundle,
    build_criterion,
    build_model,
    build_optimizer,
    get_dataloaders,
)
from montecarlo_gated_mil_tpu_torch.train.loops import mc_validate, test, train_epoch, validate
from montecarlo_gated_mil_tpu_torch.train.state import (
    Checkpointer,
    EarlyStopping,
    TrainState,
    make_train_step,
)
from montecarlo_gated_mil_tpu_torch.utils.metrics import Metrics


def initial_model(cfg: Config) -> torch.nn.Module:
    """The model a run starts from: seeded random init, and the backbone
    from ``cfg.backbone_weights`` when set (a torchvision-named state_dict,
    optionally under the reference's ``feature_extractor.`` prefix; running
    statistics and ``fc`` are dropped, as the model has neither)."""
    model = build_model(cfg, seed=rng.named_seed(cfg.seed, "params"))
    if cfg.backbone_weights:
        sd = torch.load(cfg.backbone_weights, map_location="cpu", weights_only=True)
        prefix = "feature_extractor."
        sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
        own = model.feature_extractor.state_dict()
        model.feature_extractor.load_state_dict({k: v for k, v in sd.items() if k in own})
        print(f"Initialized backbone from {cfg.backbone_weights}")
    return model


def _fit(
    cfg: Config,
    model: torch.nn.Module,
    data: DataBundle,
    metrics: Metrics,
    *,
    checkpointer: Checkpointer | None = None,
    resume: bool = False,
) -> tuple[TrainState, EarlyStopping]:
    """Epoch loop with early stopping (reference ``main.py:83-91``).  With a
    ``checkpointer`` the full state persists every
    ``cfg.tpu.checkpoint_every`` epochs and ``resume=True`` continues from
    the latest; a fresh run purges the directory's old steps first."""
    params = cfg.training_plan.parameters
    k = params.grad_acc_steps
    criterion = build_criterion(cfg)
    # Epoch-unit scheduler decays need the optimizer steps one epoch makes:
    # one every k bags plus the epoch-end flush, ceil(bags / k).
    steps_per_epoch = max(1, -(-len(data.train) // k))
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch)
    state = TrainState(model, optimizer, scheduler)
    step_fn = make_train_step(model, criterion, optimizer, k)
    stopper = EarlyStopping(params.patience, metrics)
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
                            key=train_key, metrics=metrics)
        if cfg.is_mcdo_val:
            val_loss = mc_validate(model, data.val, criterion, epoch=epoch, num_samples=cfg.N,
                                   key=val_key, metrics=metrics)
        else:
            val_loss = validate(model, data.val, criterion, epoch=epoch, metrics=metrics)
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
