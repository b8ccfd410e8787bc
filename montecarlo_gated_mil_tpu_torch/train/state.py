"""Train state, gradient accumulation, early stopping, checkpointing.

Counterpart of ``montecarlo_gated_mil_tpu/train/state.py``:

- gradient accumulation: the loss is divided by the static
  ``accumulation_steps``, gradients accumulate in ``.grad``, and the
  optimizer steps every k bags and at epoch end (reference
  ``net_utils.py:52-57``);
- early stopping: counter starts at patience, resets on improvement,
  decrements otherwise, stops at zero, keeps a copy of the best weights
  (``net_utils.py:232-261``);
- the instance-sharded step of an oversized bag
  (:func:`make_train_step_sharded`) and the data-parallel step's contract
  (``parallel/dp.py``): raw per-bag gradients summed in ``.grad`` with
  ``acc_count`` bags, applied as their mean (:meth:`TrainState.apply_update`);
- checkpointing on ``torch.save``: the full state (weights, optimizer,
  scheduler, counters, epoch, early-stop state and the best weights) per
  epoch, written atomically, so a run resumes exactly; with ``async_save``
  on a background thread (``tpu.async_checkpointing``).

PyTorch updates in place, so a step mutates the state it is given and
returns it.  On the card the head of a training step runs the forward kernel
(K1, or K2 for a shared gate) and its backward kernel (K5, or K4); on the CPU
its plain version under autograd.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as wait_futures
from dataclasses import dataclass
from typing import Callable

import torch

from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.models.gamil import auxiliary_loss
from montecarlo_gated_mil_tpu_torch.models.resnet import exact_float_grads
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import kernel_on


@dataclass
class TrainState:
    """What a training run carries from step to step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    acc_count: int = 0  # bags accumulated since the last optimizer step
    step: int = 0  # optimizer steps taken

    def apply_update(self, mean: bool = False) -> None:
        """Step the optimizer (and the scheduler) on the gradients
        accumulated in ``.grad``, then clear them.  ``mean``: they are raw
        per-bag sums (the data-parallel contract, JAX ``parallel/dp.py``), so
        divide them by ``acc_count`` first; else they are already ``loss /
        k`` sums (the sequential contract)."""
        if mean:
            denom = max(self.acc_count, 1)
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(denom)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.acc_count = 0
        self.step += 1


def bag_loss(model, criterion, y: torch.Tensor, a: torch.Tensor, label: torch.Tensor):
    """CE of the logits ``y (C,)`` plus the scaled auxiliary loss of the
    attention ``a (C, N)``, as the model's forward with ``targets`` gives
    it: ``(loss, aux)``."""
    aux = model.aux_scale * auxiliary_loss(
        a[1], a[0], label == 1, loss_type=model.aux_loss_type, margin=model.aux_margin
    )
    return criterion(y[None, :], label[None]) + aux, aux


def _finish_step(state: TrainState, do_update: bool, mean: bool, y, label, loss, aux):
    state.acc_count += 1
    if do_update:
        state.apply_update(mean)
    correct = (torch.argmax(y) == label).to(torch.float32)
    return state, {"loss": loss.detach(), "aux_loss": aux.detach(), "correct": correct}


def make_train_step(
    model: torch.nn.Module,
    criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    accumulation_steps: int,
    *,
    debug_nans: bool = False,
    debug_infs: bool = False,
    use_pallas: bool | None = None,
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

    ``use_pallas``: ``None`` (the default) and ``True`` run the head's
    forward and backward kernels (K1/K5, K2/K4 for a shared gate) on the
    card; ``False`` runs the plain head there, its backward by autograd.  On
    the CPU all three run the plain head.  JAX's default is ``False``,
    because the JAX package trains its head in jnp unless
    ``tpu.use_pallas_train`` is set; the port trains on its kernels
    (``core/config.py``), and ``use_pallas_train`` stays parsed only.
    """
    kernel = kernel_on(use_pallas)

    def step(state: TrainState, bag: Bag, seed: int, do_update: bool):
        y, _, aux = model(bag.patches, bag.mask, bag.label, train=True, seed=seed,
                          kernel=kernel)
        loss = criterion(y[None, :], bag.label[None]) + aux
        with exact_float_grads(model.dtype):
            (loss / accumulation_steps).backward()
        if debug_nans or debug_infs:
            _check_finite(model, loss, debug_nans, debug_infs)
        return _finish_step(state, do_update, False, y, bag.label, loss, aux)

    return step


def make_train_step_sharded(
    model: torch.nn.Module,
    criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    accumulation_steps: int,
    mesh,
    *,
    mean_scaling: bool = False,
    replicas=None,
):
    """The training step ``step(state, bag, seed, do_update)`` of an
    OVERSIZED bag (JAX ``train/state.py::make_train_step_sharded``): the
    embed runs with the instance axis split over ``mesh``'s ``inst`` axis
    (``parallel/instance.py::sharded_embed_grad``: per-bag BN statistics and
    their gradients reduced across shards), and the head runs on the
    gathered ``(N, L)`` features on the first device with the one-bag
    step's seed, so it draws the one-bag step's dropout (on the card
    through K1, then K5 in the backward).  ``optimizer`` holds the weights
    of ``model``, which lives on that first device; ``replicas`` (the model
    on each device of the axis, made here if not given) take its weights
    before every step.

    ``mean_scaling=False`` back-propagates ``loss / accumulation_steps`` and
    applies the sum: its state mixes mid-epoch with :func:`make_train_step`'s.
    ``mean_scaling=True`` back-propagates the raw loss and applies the mean
    over ``acc_count``: its state mixes with ``parallel/dp.py::
    make_dp_train_step``'s.  Returns what :func:`make_train_step` returns.
    """
    from montecarlo_gated_mil_tpu_torch.parallel.instance import sharded_embed_grad
    from montecarlo_gated_mil_tpu_torch.parallel.mesh import refresh_replicas, replicated

    replicas = replicas or replicated(mesh, model, "inst")

    def step(state: TrainState, bag: Bag, seed: int, do_update: bool):
        refresh_replicas(model, replicas)
        H = sharded_embed_grad(model, bag.patches, bag.mask, mesh, replicas=replicas)
        mask, label = bag.mask.to(H.device), bag.label.to(H.device)
        y, a = model.head(H, mask, train=True, seed=seed)
        loss, aux = bag_loss(model, criterion, y, a, label)
        with exact_float_grads(model.dtype):
            (loss if mean_scaling else loss / accumulation_steps).backward()
        return _finish_step(state, do_update, mean_scaling, y, label, loss, aux)

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


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the CPU, so that a save
    does not depend on what the next step does to the live tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class Checkpointer:
    """``torch.save`` checkpoints of a :class:`TrainState` in ``directory``.

    One file per step (``step_00000007.pt``), written to a temporary name
    and renamed, so a crash never leaves half a checkpoint.  As the JAX
    package's Orbax checkpointer: a save onto an existing step raises (a
    fresh run into a directory a previous run used must ``purge_steps``
    first, or a later resume would restore the stale run), the early
    stopper's best weights ride along, and ``save_params`` /
    ``restore_params`` hold the best model alone.

    ``save`` copies the state to host tensors before it returns (the next
    step changes the model in place).  With ``async_save`` the file is then
    written on one background thread, so the epoch loop does not wait for
    the disk; ``wait()`` blocks until every save in flight is on disk and
    raises the first error one of them met.  ``latest_step``, ``all_steps``,
    ``restore``, ``purge_steps`` and ``save_params`` wait first, so a resume
    never reads a file that is being written.  ``close()`` waits and stops
    the thread.  Under multi-process fold fan-out each process writes only
    its own folds' directories, so no save needs the other processes.
    """

    def __init__(self, directory: str, *, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.async_save = async_save
        self._writer = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: dict[int, Future] = {}

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def wait(self) -> None:
        """Block until every save in flight is written; re-raise the first
        error a background save met."""
        pending, self._pending = list(self._pending.values()), {}
        wait_futures(pending)
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait()
        if self._writer is not None:
            self._writer.shutdown()
            self._writer = None

    def all_steps(self) -> list[int]:
        self.wait()
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
        if os.path.exists(path) or step in self._pending:
            raise RuntimeError(
                f"checkpoint save refused: step {step} already exists in "
                f"{self.directory} (left by a previous run?). Resume it, "
                "purge_steps(), or use a fresh directory."
            )
        payload = _to_host({
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
        })
        if self._writer is None:
            _atomic_save(payload, path)
        else:
            self._pending[step] = self._writer.submit(_atomic_save, payload, path)
        return path

    def purge_steps(self) -> None:
        """Delete every checkpointed step in the directory (after the saves
        in flight)."""
        for step in self.all_steps():
            os.remove(self._step_path(step))

    def restore(self, state: TrainState, step: int | None = None):
        """Load step ``step`` (default: the latest) into ``state`` in place;
        returns ``(state, meta, best_params)``, ``best_params`` None when the
        checkpoint has none."""
        self.wait()
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
        self.wait()
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
