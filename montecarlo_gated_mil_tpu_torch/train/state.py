"""Train state, gradient accumulation, early stopping, checkpointing.

Counterpart of ``montecarlo_gated_mil_tpu/train/state.py``:

- gradient accumulation: the loss is divided by the static
  ``accumulation_steps``, gradients accumulate in ``.grad``, and the
  optimizer steps every k bags and at epoch end (reference
  ``net_utils.py:52-57``);
- early stopping: counter starts at patience, resets on improvement,
  decrements otherwise, stops at zero, keeps a copy of the best weights
  (``net_utils.py:232-261``);
- checkpointing on ``torch.save``: the full state (weights, optimizer,
  scheduler, counters, epoch, early-stop state and the best weights) per
  epoch, written atomically, so a run resumes exactly.

PyTorch updates in place, so a step mutates the state it is given and
returns it.  On the card the head of a training step runs the forward kernel
(K1, or K2 for a shared gate) and its backward kernel (K5, or K4); on the CPU
its plain version under autograd.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import torch

from montecarlo_gated_mil_tpu_torch.core.bag import Bag


@dataclass
class TrainState:
    """What a training run carries from step to step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    acc_count: int = 0  # bags accumulated since the last optimizer step
    step: int = 0  # optimizer steps taken


def make_train_step(
    model: torch.nn.Module,
    criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    accumulation_steps: int,
    *,
    debug_nans: bool = False,
    debug_infs: bool = False,
):
    """The one-bag training step ``step(state, bag, seed, do_update)``.

    Computes CE(+scaled aux) for one bag with dropout drawn from the uint32
    ``seed``, back-propagates ``loss / k`` into the accumulated gradients,
    and when ``do_update`` (every k-th bag or at epoch end, decided by the
    loop) steps the optimizer and the scheduler and clears the gradients.
    Returns ``(state, {"loss", "aux_loss", "correct"})`` as detached
    scalars, like the JAX step.  ``debug_nans`` / ``debug_infs`` (the
    config's ``tpu.debug_nans`` / ``debug_infs``, which turn on JAX's NaN and
    Inf checks) raise ``FloatingPointError`` when the loss or an accumulated
    gradient holds a NaN / an Inf, before the optimizer steps; each costs a
    host sync per step.
    """

    def step(state: TrainState, bag: Bag, seed: int, do_update: bool):
        y, _, aux = model(bag.patches, bag.mask, bag.label, train=True, seed=seed)
        loss = criterion(y[None, :], bag.label[None]) + aux
        (loss / accumulation_steps).backward()
        if debug_nans or debug_infs:
            _check_finite(model, loss, debug_nans, debug_infs)
        state.acc_count += 1
        if do_update:
            optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
            optimizer.zero_grad(set_to_none=True)
            state.acc_count = 0
            state.step += 1
        correct = (torch.argmax(y) == bag.label).to(torch.float32)
        return state, {"loss": loss.detach(), "aux_loss": aux.detach(), "correct": correct}

    return step


def _check_finite(model: torch.nn.Module, loss: torch.Tensor, nans: bool, infs: bool) -> None:
    named = [("loss", loss.detach())] + [
        (f"gradient of {k}", p.grad) for k, p in model.named_parameters() if p.grad is not None
    ]
    for what, t in named:
        if nans and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in the training step's {what} (tpu.debug_nans)")
        if infs and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"Inf in the training step's {what} (tpu.debug_infs)")


def _copy_weights(params) -> dict[str, torch.Tensor]:
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    return {k: v.detach().clone() for k, v in sd.items()}


class EarlyStopping:
    """Reference-semantics early stopping (``net_utils.py:232-261``).  The
    best weights are a copy, not the live parameters the next step moves."""

    def __init__(self, patience: int = 5, metrics=None):
        self.patience = patience
        self.counter = patience
        self.best_loss = float("inf")
        self.best_params: dict[str, torch.Tensor] | None = None
        self.metrics = metrics

    def __call__(self, current_loss: float, params) -> bool:
        """``params``: the model or a state_dict.  True when training should stop."""
        if current_loss < self.best_loss:
            self.best_loss = current_loss
            self.counter = self.patience
            self.best_params = _copy_weights(params)
        else:
            self.counter -= 1
        if self.metrics is not None:
            self.metrics.log("val/patience_counter", self.counter)
        return self.counter <= 0

    def state_dict(self) -> dict:
        return {"patience": self.patience, "counter": self.counter, "best_loss": self.best_loss}

    def load_state_dict(self, d: dict):
        self.patience = int(d["patience"])
        self.counter = int(d["counter"])
        self.best_loss = float(d["best_loss"])


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Checkpointer:
    """``torch.save`` checkpoints of a :class:`TrainState` in ``directory``.

    One file per step (``step_00000007.pt``), written to a temporary name
    and renamed, so a crash never leaves half a checkpoint.  As the JAX
    package's Orbax checkpointer: a save onto an existing step raises (a
    fresh run into a directory a previous run used must ``purge_steps``
    first, or a later resume would restore the stale run), the early
    stopper's best weights ride along, and ``save_params`` /
    ``restore_params`` hold the best model alone.
    """

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def all_steps(self) -> list[int]:
        return sorted(
            int(f[len("step_"):-len(".pt")])
            for f in os.listdir(self.directory)
            if f.startswith("step_") and f.endswith(".pt")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(
        self,
        step: int,
        state: TrainState,
        *,
        epoch: int,
        early_stop: dict | None = None,
        extra: dict | None = None,
        best_params: dict | None = None,
    ) -> str:
        path = self._step_path(step)
        if os.path.exists(path):
            raise RuntimeError(
                f"checkpoint save refused: step {step} already exists in "
                f"{self.directory} (left by a previous run?). Resume it, "
                "purge_steps(), or use a fresh directory."
            )
        _atomic_save(
            {
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
                "acc_count": state.acc_count,
                "step": state.step,
                "meta": {
                    "epoch": epoch,
                    "early_stop": early_stop or {},
                    "extra": extra or {},
                    "has_best": best_params is not None,
                },
                "best": best_params,
            },
            path,
        )
        return path

    def purge_steps(self) -> None:
        """Delete every checkpointed step in the directory."""
        for step in self.all_steps():
            os.remove(self._step_path(step))

    def restore(self, state: TrainState, step: int | None = None):
        """Load step ``step`` (default: the latest) into ``state`` in place;
        returns ``(state, meta, best_params)``, ``best_params`` None when the
        checkpoint has none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ckpt = torch.load(self._step_path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        if state.scheduler is not None and ckpt["scheduler"] is not None:
            state.scheduler.load_state_dict(ckpt["scheduler"])
        state.acc_count = int(ckpt["acc_count"])
        state.step = int(ckpt["step"])
        best = ckpt["best"]
        if best is not None:
            device = next(state.model.parameters()).device
            best = {k: v.to(device) for k, v in best.items()}
        return state, ckpt["meta"], best

    def save_params(self, name: str, params) -> str:
        """Save weights alone (the reference's best-model ``torch.save``,
        ``main.py:92-94``) as ``directory/name``; a re-save overwrites."""
        path = os.path.join(self.directory, name)
        _atomic_save(_copy_weights(params), path)
        return path

    def restore_params(self, name_or_path: str) -> dict[str, torch.Tensor]:
        path = (
            name_or_path
            if os.path.isabs(name_or_path)
            else os.path.join(self.directory, name_or_path)
        )
        return torch.load(path, map_location="cpu", weights_only=True)
