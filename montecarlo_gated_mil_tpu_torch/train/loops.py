"""Training, validation and test loops.

Counterpart of ``montecarlo_gated_mil_tpu/train/loops.py`` (reference
``net_utils.py``) on one device:

- ``train_epoch`` (``train_gacc``, ``net_utils.py:33-78``): CE(+scaled aux),
  an optimizer step every k bags and at epoch end, epoch metrics
  ``train/epoch_loss|epoch_acc|aux_loss``, and per step ``train/step`` =
  ``{"ms", "bucket", "instances"}`` (time by CUDA events on the card, the
  host clock on the CPU; the padded and the valid bag size);
- ``train_epoch_plain`` (``net_utils.py:6-30``): the single-head model's
  plain loop, sigmoid + BCE against the binary label, an optimizer step
  every bag, prediction = P > 0.5, epoch metrics
  ``train/epoch_loss|epoch_acc``;
- ``validate`` (``net_utils.py:82-114``): deterministic forward, CE loss,
  argmax accuracy; returns the epoch loss for early stopping;
- ``mc_validate`` (``net_utils.py:116-158``): T MC samples; loss = mean over
  T of (CE + aux) per sample; prediction = argmax of the mean **raw
  logits** over T;
- ``test`` (``net_utils.py:160-192``): accuracy and the classification
  report;
- ``mc_test`` (``net_utils.py:195-230``): T MC samples per bag, prediction =
  argmax of the mean **softmax** over T, optionally through the int8 embed;
- ``ensemble_mc_test``: the ``mc_test`` reduction over the M*T samples of a
  fold ensemble (``mcdo/ensemble.py``).

With ``fold=k`` the epoch metrics carry the reference's fold prefix
(``k/train/epoch_loss``) and the test metrics its suffix
(``test/accuracy_fold{k}``).

A loader is anything with ``epoch(e)`` yielding ``(Bag, record)``, or a
plain iterable of such pairs.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn, mc_head
from montecarlo_gated_mil_tpu_torch.models.gamil import auxiliary_loss
from montecarlo_gated_mil_tpu_torch.train.criteria import bce_on_probs
from montecarlo_gated_mil_tpu_torch.train.state import TrainState
from montecarlo_gated_mil_tpu_torch.utils.metrics import Metrics


def _items(loader, epoch: int):
    return loader.epoch(epoch) if hasattr(loader, "epoch") else iter(loader)


def _with_last_flag(items):
    """Yield ``(item, is_last)`` with one item of lookahead, so the epoch-end
    optimizer flush (``net_utils.py:55-57``) fires for any iterable."""
    it = iter(items)
    try:
        prev = next(it)
    except StopIteration:
        return
    for item in it:
        yield prev, False
        prev = item
    yield prev, True


class _StepTimer:
    """Wall time of one step: CUDA events on a card, the host clock on the
    CPU.  ``stop`` waits for the step's device work to end."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self._t0) * 1e3
        self._end.record()
        self._end.synchronize()
        return self._start.elapsed_time(self._end)


def train_epoch(
    step_fn,
    state: TrainState,
    loader: Iterable,
    *,
    epoch: int,
    accumulation_steps: int,
    key: int,
    metrics: Metrics | None = None,
    fold: int | None = None,
) -> TrainState:
    """One epoch of gradient-accumulated training.  Bag ``i`` of epoch ``e``
    draws its dropout from ``fold_in(fold_in(key, e), i)`` (``core/rng.py``)."""
    m = (metrics or Metrics([])).scoped(fold)
    running_loss = running_aux = correct = total = 0.0
    for batch_idx, ((bag, _rec), is_last) in enumerate(_with_last_flag(_items(loader, epoch))):
        seed = rng.fold_in(rng.fold_in(key, epoch), batch_idx)
        do_update = ((batch_idx + 1) % accumulation_steps == 0) or is_last
        timer = _StepTimer(bag.patches.device)
        state, out = step_fn(state, bag, seed, do_update)
        ms = timer.stop()
        m.log("train/step", {"ms": ms, "bucket": int(bag.mask.shape[0]),
                             "instances": int(bag.mask.sum())}, step=batch_idx)
        running_loss += float(out["loss"])
        running_aux += float(out["aux_loss"])
        correct += float(out["correct"])
        total += 1
    if total == 0:
        raise ValueError("empty training loader")
    m.log("train/epoch_loss", running_loss / total, step=epoch)
    m.log("train/epoch_acc", correct / total, step=epoch)
    m.log("train/aux_loss", running_aux / total, step=epoch)
    print(f"Epoch {epoch} - Train Loss: {running_loss / total:.4f}, "
          f"Accuracy: {correct / total:.4f}")
    return state


def _plain_step(model, optimizer, state: TrainState, bag, seed: int):
    """One plain step of the single-head model: sigmoid + BCE against the
    bag's label, autograd through the plain head and the masked-BN embed,
    and an optimizer step.  Returns ``(state, loss, correct)``."""
    y, _ = model(bag.patches, bag.mask, train=True, seed=seed)
    p = torch.sigmoid(y)
    loss = bce_on_probs(p, torch.full_like(p, float(bag.label)))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    correct = ((p[0] > 0.5).to(torch.int64) == bag.label).to(torch.float32)
    return state, loss.detach(), correct


def train_epoch_plain(
    model,
    state: TrainState,
    loader: Iterable,
    optimizer,
    *,
    epoch: int,
    key: int,
    metrics: Metrics | None = None,
) -> TrainState:
    """Plain per-bag training for the single-head ``GatedAttentionMIL``
    (reference ``net_utils.py:6-30``): sigmoid outputs + BCE against the
    binary label, an optimizer step every bag, prediction = P > 0.5.  Bag
    ``i`` of epoch ``e`` draws its dropout from ``fold_in(fold_in(key, e),
    i)`` (``core/rng.py``).  Unused by the main entry points, as in the JAX
    package."""
    running_loss = correct = total = 0.0
    for i, (bag, _rec) in enumerate(_items(loader, epoch)):
        seed = rng.fold_in(rng.fold_in(key, epoch), i)
        state, loss, c = _plain_step(model, optimizer, state, bag, seed)
        running_loss += float(loss)
        correct += float(c)
        total += 1
    m = metrics or Metrics([])
    m.log("train/epoch_loss", running_loss / max(total, 1), step=epoch)
    m.log("train/epoch_acc", correct / max(total, 1), step=epoch)
    print(f"Epoch {epoch} - Train Loss: {running_loss / max(total, 1):.4f}, "
          f"Accuracy: {correct / max(total, 1):.4f}")
    return state


def validate(
    model,
    loader: Iterable,
    criterion,
    *,
    epoch: int,
    metrics: Metrics | None = None,
    fold: int | None = None,
) -> float:
    running_loss = correct = total = 0.0
    with torch.no_grad():
        for bag, _rec in _items(loader, epoch):
            y, _ = model(bag.patches, bag.mask)
            running_loss += float(criterion(y[None, :], bag.label[None]))
            correct += float(torch.argmax(y) == bag.label)
            total += 1
    epoch_loss = running_loss / max(total, 1)
    m = (metrics or Metrics([])).scoped(fold)
    m.log("val/epoch_loss", epoch_loss, step=epoch)
    m.log("val/epoch_acc", correct / max(total, 1), step=epoch)
    print(f"Epoch {epoch} - Val Loss: {epoch_loss:.4f}, Accuracy: {correct / max(total, 1):.4f}")
    return epoch_loss


def _mc_val_finish(model, criterion, preds, attn, label):
    """mc-validate reduction: mean over T of (CE + aux), prediction = argmax
    of the mean RAW logits (``net_utils.py:139``)."""
    aux_losses = model.aux_scale * auxiliary_loss(
        attn[:, 1, :], attn[:, 0, :], label == 1,
        loss_type=model.aux_loss_type, margin=model.aux_margin,
    )
    ce = torch.stack([criterion(y[None, :], label[None]) for y in preds])
    return (ce + aux_losses).mean(), aux_losses.mean(), torch.argmax(preds.mean(0))


def mc_validate(
    model,
    loader: Iterable,
    criterion,
    *,
    epoch: int,
    num_samples: int = 50,
    key: int,
    metrics: Metrics | None = None,
    fold: int | None = None,
) -> float:
    """MC validation; bag ``i`` of epoch ``e`` samples with seed
    ``fold_in(fold_in(key, e), i)``."""
    running_loss = running_aux = correct = total = 0.0
    with torch.no_grad():
        for i, (bag, _rec) in enumerate(_items(loader, epoch)):
            seed = rng.fold_in(rng.fold_in(key, epoch), i)
            H = model.embed(bag.patches, bag.mask)
            out = mc_head(model, H, bag.mask, num_samples, seed)
            loss, aux, pred = _mc_val_finish(
                model, criterion, out.predictions, out.attention, bag.label
            )
            running_loss += float(loss)
            running_aux += float(aux)
            correct += float(pred == bag.label)
            total += 1
    epoch_loss = running_loss / max(total, 1)
    m = (metrics or Metrics([])).scoped(fold)
    m.log("val/epoch_loss", epoch_loss, step=epoch)
    m.log("val/epoch_acc", correct / max(total, 1), step=epoch)
    m.log("val/aux_loss", running_aux / max(total, 1), step=epoch)
    print(f"Epoch {epoch} - Val Loss: {epoch_loss:.4f}, Accuracy: {correct / max(total, 1):.4f}")
    return epoch_loss


def _finish_test(all_targets, all_preds, metrics, fold=None, prefix="test"):
    from montecarlo_gated_mil_tpu_torch.evaluation.report import classification_report

    acc = float(np.mean(np.asarray(all_preds) == np.asarray(all_targets)))
    report = classification_report(all_targets, all_preds)
    m = metrics or Metrics([])
    suffix = "" if fold is None else f"_fold{fold}"
    m.log(f"{prefix}/accuracy{suffix}", acc)
    m.log(f"{prefix}/classification_report{suffix}", report)
    print(f"Test Accuracy: {acc:.4f}")
    print("Classification Report:\n", report)
    return acc, report


def test(
    model,
    loader: Iterable,
    *,
    metrics: Metrics | None = None,
    fold: int | None = None,
):
    """Deterministic test pass: ``(accuracy, Report)``."""
    preds, targets = [], []
    with torch.no_grad():
        for bag, _rec in _items(loader, 0):
            y, _ = model(bag.patches, bag.mask)
            preds.append(int(torch.argmax(y)))
            targets.append(int(bag.label))
    return _finish_test(targets, preds, metrics, fold)


def mc_test(
    model,
    loader: Iterable,
    *,
    num_samples: int = 50,
    seed: int,
    metrics: Metrics | None = None,
    fold: int | None = None,
    quantized: bool = False,
):
    """MC test pass: ``(accuracy, Report)`` from the argmax of the MC-mean
    softmax.  Bag ``i`` samples with seed ``fold_in(seed, i)``;
    ``quantized=True`` embeds through the int8 PTQ path.  An oversized bag
    runs whole on the one card."""
    embed = make_embed_fn(model, quantized)
    preds, targets = [], []
    with torch.no_grad():
        for i, (bag, _rec) in enumerate(_items(loader, 0)):
            H = embed(bag.patches, bag.mask)
            out = mc_head(model, H, bag.mask, num_samples, rng.fold_in(seed, i))
            probs = torch.softmax(out.predictions, dim=-1)
            preds.append(int(torch.argmax(probs.mean(0))))
            targets.append(int(bag.label))
    return _finish_test(targets, preds, metrics, fold)


def ensemble_mc_test(
    model,
    members,
    loader: Iterable,
    *,
    num_samples: int = 50,
    seed: int,
    metrics: Metrics | None = None,
):
    """MC test of a fold ensemble: ``(accuracy, Report)`` from the argmax
    of the softmax mean over all members' pooled M*T samples.  Bag ``i``
    samples with seed ``fold_in(seed, i)``; ``members`` is
    ``mcdo/ensemble.py::stack_params``'s list, run one after another in
    ``model`` on the float embed.  Logged as ``ensemble_test/accuracy``, so a
    shared metrics stream keeps it apart from a single model's."""
    from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import ensemble_mc_inference

    preds, targets = [], []
    for i, (bag, _rec) in enumerate(_items(loader, 0)):
        out = ensemble_mc_inference(model, members, bag.patches, bag.mask, num_samples,
                                    rng.fold_in(seed, i))
        probs = torch.softmax(out.predictions, dim=-1)
        preds.append(int(torch.argmax(probs.mean(0))))
        targets.append(int(bag.label))
    return _finish_test(targets, preds, metrics, prefix="ensemble_test")
