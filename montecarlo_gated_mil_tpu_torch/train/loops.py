"""Training, validation and test loops.

Counterpart of ``montecarlo_gated_mil_tpu/train/loops.py`` (reference
``net_utils.py``):

- ``train_epoch`` (``train_gacc``, ``net_utils.py:33-78``): CE(+scaled aux),
  an optimizer step every k bags and at epoch end, epoch metrics
  ``train/epoch_loss|epoch_acc|aux_loss``, and per step ``train/step`` =
  ``{"ms", "bucket", "instances"}`` (time by CUDA events on the card, the
  host clock on the CPU; the padded and the valid bag size);
- ``train_epoch_dp``: the same epoch data-parallel over a mesh's ``data``
  axis (``parallel/dp.py::make_dp_train_step``, bags grouped per bucket by
  ``BucketBatcher``; the mean of the accumulated gradients applied once
  ``accumulation_steps`` real bags have accumulated, and at epoch end);
  the runners take it under ``tpu.data_parallel_train`` with one process
  and several cards;
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

``shard_over``: every loop sends an OVERSIZED bag (its bucket above
``shard_over``, as the loader pads it under ``oversized_bags='extend'``)
through the instance-sharded path (``parallel/instance.py``) over every
device of ``mesh`` (default: every visible CUDA device), on the float
embed; the training loops through their ``sharded_step_fn``
(``train/state.py::make_train_step_sharded``).  On one device, or when the
bucket does not divide over the devices, it runs whole, as JAX's does on
one chip.  Any training bag that trains whole and would not fit the card
raises before its step (:func:`_check_unrouted_train_bag`).

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
from montecarlo_gated_mil_tpu_torch.models.resnet import exact_float_grads
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams, kernel_on
from montecarlo_gated_mil_tpu_torch.parallel.mesh import Mesh, replicated, shard_mesh_for
from montecarlo_gated_mil_tpu_torch.train.criteria import bce_on_probs
from montecarlo_gated_mil_tpu_torch.train.state import TrainState
from montecarlo_gated_mil_tpu_torch.utils.metrics import Metrics


def _items(loader, epoch: int):
    return loader.epoch(epoch) if hasattr(loader, "epoch") else iter(loader)


# Training-step memory per input element on the card, by backbone and
# compute dtype.  The shipped step (r18, f32, CE + aux) peaked at 26.15 GiB at
# bucket 1024 of 224x224x3 patches, 182 B per element (PERF.md section 5,
# chip_smoke.py phase 7 on an H100), about linear in the bucket; rounded up
# to 192, which also covers the 27.5-27.8 GiB that phase 7's whole
# run_training has since read with the loader's bags in flight.  The others
# are chip_smoke.py phase 14 (c)'s peaks (tools/measure_hbm.py::train_peaks,
# buckets 256-1024, NVIDIA H100 80GB HBM3 at 700 W): the largest peak over
# input elements of each pair, plus 5 %, rounded up to a multiple of 16 --
# r18 bf16 196.5 B, r34 f32 235.4, r34 bf16 198.6, r50 f32 589.4 (its
# bucket 1024 would not fit the card), r50 bf16 322.8.  A bf16 step of r18
# or r34 takes as much as the f32 one or more (PERF.md section 7).  float64
# by the same rule from phase 14 (c)'s buckets 128-512 (the same card):
# r18 354.1 B, r34 440.3, r50 1203.5.
_TRAIN_BYTES_PER_INPUT_ELEM = {
    ("r18", torch.float32): 192.0,
    ("r18", torch.bfloat16): 208.0,
    ("r18", torch.float64): 384.0,
    ("r34", torch.float32): 256.0,
    ("r34", torch.bfloat16): 224.0,
    ("r34", torch.float64): 464.0,
    ("r50", torch.float32): 624.0,
    ("r50", torch.bfloat16): 352.0,
    ("r50", torch.float64): 1264.0,
}


def _train_step_bytes(bag, model=None) -> float:
    """The card memory a whole-bag training step of ``bag`` through
    ``model`` is estimated to take at its peak: the bytes per input element
    of its backbone and compute dtype, plus 0.5 GiB; with no model, the
    largest entry."""
    if model is None:
        per_elem = max(_TRAIN_BYTES_PER_INPUT_ELEM.values())
    else:
        per_elem = _TRAIN_BYTES_PER_INPUT_ELEM[(model.backbone, model.dtype)]
    return bag.patches.numel() * per_elem + (1 << 29)


def _check_unrouted_train_bag(bag, shard_over: int | None, model=None) -> None:
    """Fail fast, with what to do, when a training bag that trains whole
    would not fit the card.

    Every bag that the loops do not route to the instance-sharded step
    trains whole: one within the registry's buckets, and an OVERSIZED one
    (bucket above ``shard_over``) that could not route -- on one device,
    under multi-process fold fan-out, or when the extended bucket does not
    divide over the devices (``parallel/mesh.py::shard_mesh_for``).  Where
    its step's estimate (:func:`_train_step_bytes` for ``model``, the model
    the step trains) exceeds 95 % of the limit, the step would fail with an
    out-of-memory error deep in its backward, so this raises before it.  The
    limit is the bag's card's memory (``MCGMIL_HBM_LIMIT_BYTES`` overrides
    it, as in the JAX package); on the CPU, with no override, there is none.
    """
    import os

    env = os.environ.get("MCGMIL_HBM_LIMIT_BYTES")
    if env is not None:
        limit = float(env)
    elif bag.patches.is_cuda:
        limit = float(torch.cuda.get_device_properties(bag.patches.device).total_memory)
    else:
        return
    est = _train_step_bytes(bag, model)
    if est <= 0.95 * limit:
        return
    need = (f"(bucket {bag.bucket}, patches {tuple(bag.patches.shape)}) needs "
            f"~{est / 2**30:.1f} GiB for the training step but the device has "
            f"{limit / 2**30:.1f} GiB")
    if shard_over is not None and bag.bucket > shard_over:
        raise ValueError(
            f"oversized training bag {need}; it could not instance-shard (single device, "
            "multi-process fold fan-out, or bucket not divisible by the device count). "
            "Options: run on several cards (oversized bags then train instance-sharded), "
            "reduce the tile count (lower overlap, raise empty_threshold), or accept "
            "truncation with tpu.oversized_bags='truncate'."
        )
    what = "" if model is None else f" of {model.backbone} in {str(model.dtype)[6:]}"
    raise ValueError(
        f"training bag {need}: a whole-bag step{what} does not fit. Options: lower the "
        "largest of tpu.buckets so that bags this large are oversized (they then train "
        "instance-sharded on several cards, or are cut to the largest bucket with "
        "tpu.oversized_bags='truncate'), or train a backbone or compute dtype whose step "
        "takes less (train/loops.py::_TRAIN_BYTES_PER_INPUT_ELEM; r50's bfloat16 step, "
        "for one, takes about half of its float32 one)."
    )


def warn_float_shard(quantized: bool = False, use_pallas: bool = False) -> None:
    """Oversized bags evaluate on the float instance-sharded path, whose
    head is plain (``parallel/instance.py``); the int8 embed and the fused
    head kernel are single-device programs and do not apply there.  Callers
    say so once per loop, so a metric labeled int8 or fused-kernel is never
    silently a mixed-regime number."""
    import warnings

    what = " + ".join(
        n for n, on in (("int8", quantized), ("fused-kernel", use_pallas)) if on
    )
    warnings.warn(
        f"oversized bag routed to the instance-sharded EXACT float path; the {what} "
        "single-device variant does not apply there — this metric mixes evaluation "
        "regimes for such bags",
        stacklevel=3,
    )


def _det_step_sharded(model, mesh: Mesh):
    """Deterministic forward of an oversized bag with its instances sharded
    over ``mesh``'s ``inst`` axis: ``f(patches, mask) -> Y (C,)``, the
    sequential forward's logits up to the order of the cross-shard sums.
    The model's copies on the mesh's devices are made here, once."""
    from montecarlo_gated_mil_tpu_torch.parallel.instance import (
        sharded_embed,
        sharded_gated_attention,
    )

    replicas = replicated(mesh, model, "inst")
    params = GatedAttentionParams.from_module(model)

    def f(patches, mask):
        H = sharded_embed(model, patches, mask, mesh, replicas=replicas)
        return sharded_gated_attention(H, mask, params, mesh)[0]

    return f


def _mc_test_step_sharded(model, num_samples: int, mesh: Mesh):
    """MC test step of an oversized bag, instance-sharded over ``mesh``
    (float path): ``f(patches, mask, seed) -> Y (T, C)``."""
    from montecarlo_gated_mil_tpu_torch.parallel.instance import mc_inference_sharded

    replicas = replicated(mesh, model, "inst")

    def f(patches, mask, seed):
        return mc_inference_sharded(model, patches, mask, num_samples, seed, mesh,
                                    replicas=replicas)[0]

    return f


def _mc_labels(preds: torch.Tensor) -> torch.Tensor:
    """``mc_test``'s reduction of MC logits ``(..., T, C)``: the argmax of
    the mean softmax over T."""
    return torch.argmax(torch.softmax(preds, dim=-1).mean(-2), dim=-1)


def _mc_val_step_sharded(model, criterion, num_samples: int, mesh: Mesh):
    """MC validation step of an oversized bag, instance-sharded over
    ``mesh``: ``f(patches, mask, label, seed) -> (loss, aux, prediction)``
    with ``mc_validate``'s reductions."""
    from montecarlo_gated_mil_tpu_torch.parallel.instance import mc_inference_sharded

    replicas = replicated(mesh, model, "inst")

    def f(patches, mask, label, seed):
        y, a = mc_inference_sharded(model, patches, mask, num_samples, seed, mesh,
                                    replicas=replicas)
        return _mc_val_finish(model, criterion, y, a, label.to(y.device))

    return f


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
    sharded_step_fn=None,
    shard_over: int | None = None,
    mesh: Mesh | None = None,
) -> TrainState:
    """One epoch of gradient-accumulated training.  Bag ``i`` of epoch ``e``
    draws its dropout from ``fold_in(fold_in(key, e), i)`` (``core/rng.py``).

    ``sharded_step_fn`` + ``shard_over``: an OVERSIZED bag trains through the
    instance-sharded step (``make_train_step_sharded(mean_scaling=False)``,
    built over ``mesh``'s devices, default every visible card) where it can
    shard, else whole after :func:`_check_unrouted_train_bag`.  The two
    steps share the accumulator, so the route is chosen bag by bag."""
    m = (metrics or Metrics([])).scoped(fold)
    running_loss = running_aux = correct = total = 0.0
    for batch_idx, ((bag, _rec), is_last) in enumerate(_with_last_flag(_items(loader, epoch))):
        seed = rng.fold_in(rng.fold_in(key, epoch), batch_idx)
        do_update = ((batch_idx + 1) % accumulation_steps == 0) or is_last
        fn = step_fn
        if sharded_step_fn is not None and shard_mesh_for(
                bag.bucket, shard_over, mesh) is not None:
            fn = sharded_step_fn
        else:
            _check_unrouted_train_bag(bag, shard_over, getattr(state, "model", None))
        timer = _StepTimer(bag.patches.device)
        state, out = fn(state, bag, seed, do_update)
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


def train_epoch_dp(
    step_fn,
    apply_pending,
    state: TrainState,
    loader: Iterable,
    mesh: Mesh,
    *,
    epoch: int,
    accumulation_steps: int,
    key: int,
    metrics: Metrics | None = None,
    fold: int | None = None,
    sharded_step_fn=None,
    shard_over: int | None = None,
) -> TrainState:
    """One epoch of data-parallel training over ``mesh``'s ``data`` axis
    (JAX ``train_epoch_dp``).

    Bags group per bucket into mesh-sized groups (``parallel/dp.py::
    BucketBatcher``); a partial group pads with weight-0 repeats
    (``pad_group_to_batch``), and ``step_fn`` (``make_dp_train_step``'s)
    takes each group.  Bag ``i`` draws its dropout from ``fold_in(fold_in(key,
    e), i)``, as in :func:`train_epoch`, whichever group it lands in.  The
    optimizer updates once ``accumulation_steps`` real bags have
    accumulated (a group of B bags is B of the reference's microbatches),
    and what is left applies at epoch end through ``apply_pending``.  An
    OVERSIZED bag that can shard over the mesh's devices never enters the
    batcher: it trains through ``sharded_step_fn``
    (``make_train_step_sharded(mean_scaling=True)``, the same accumulator
    contract).  With ``accumulation_steps`` equal to the number of bags
    (one update at epoch end) this epoch equals :func:`train_epoch` up to
    the order of the gradient sums, dropout on.
    """
    from montecarlo_gated_mil_tpu_torch.parallel.dp import BucketBatcher, pad_group_to_batch

    batch = mesh.shape["data"]
    running_loss = running_aux = correct = total = 0.0
    pending = 0  # real bags accumulated since the last optimizer update
    ekey = rng.fold_in(key, epoch)

    def flush(group, state, pending):
        bags = [b for b, _ in group]
        shards, seeds, n_real = pad_group_to_batch(
            mesh, bags, [rng.fold_in(ekey, i) for _, i in group])
        pending += n_real
        do_update = pending >= accumulation_steps
        state, out = step_fn(state, shards, seeds, [1.0] * n_real + [0.0] * (batch - n_real),
                             do_update)
        return state, 0 if do_update else pending, out

    def add(out):
        nonlocal running_loss, running_aux, correct, total
        running_loss += float(out["loss_sum"])
        running_aux += float(out["aux_sum"])
        correct += float(out["correct_sum"])
        total += float(out["count"])

    batcher = BucketBatcher(batch)
    for i, (bag, _rec) in enumerate(_items(loader, epoch)):
        if sharded_step_fn is not None and shard_mesh_for(
                bag.bucket, shard_over, mesh) is not None:
            pending += 1
            do_update = pending >= accumulation_steps
            state, out = sharded_step_fn(state, bag, rng.fold_in(ekey, i), do_update)
            pending = 0 if do_update else pending
            add({"loss_sum": out["loss"], "aux_sum": out["aux_loss"],
                 "correct_sum": out["correct"], "count": 1})
            continue
        _check_unrouted_train_bag(bag, shard_over, getattr(state, "model", None))
        for group in batcher.add(bag, i):
            state, pending, out = flush(group, state, pending)
            add(out)
    for group in batcher.drain():
        state, pending, out = flush(group, state, pending)
        add(out)
    if pending > 0:  # epoch-end flush (reference net_utils.py:55-57)
        state = apply_pending(state)
    if total == 0:
        raise ValueError("empty training loader")
    m = (metrics or Metrics([])).scoped(fold)
    m.log("train/epoch_loss", running_loss / total, step=epoch)
    m.log("train/epoch_acc", correct / total, step=epoch)
    m.log("train/aux_loss", running_aux / total, step=epoch)
    print(f"Epoch {epoch} - Train Loss: {running_loss / total:.4f}, "
          f"Accuracy: {correct / total:.4f} (dp x{batch})")
    return state


def _plain_step(model, optimizer, state: TrainState, bag, seed: int):
    """One plain step of the single-head model: sigmoid + BCE against the
    bag's label, autograd through the plain head and the masked-BN embed,
    and an optimizer step.  Returns ``(state, loss, correct)``."""
    y, _ = model(bag.patches, bag.mask, train=True, seed=seed)
    p = torch.sigmoid(y)
    loss = bce_on_probs(p, torch.full_like(p, float(bag.label)))
    optimizer.zero_grad(set_to_none=True)
    with exact_float_grads(model.dtype):
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
    shard_over: int | None = None,
    mesh: Mesh | None = None,
) -> float:
    running_loss = correct = total = 0.0
    sharded = None
    with torch.no_grad():
        for bag, _rec in _items(loader, epoch):
            shard_mesh = shard_mesh_for(bag.bucket, shard_over, mesh)
            if shard_mesh is not None:
                sharded = sharded or _det_step_sharded(model, shard_mesh)
                y = sharded(bag.patches, bag.mask)
            else:
                y, _ = model(bag.patches, bag.mask)
            loss = criterion(y[None, :], bag.label.to(y.device)[None])
            pred = torch.argmax(y)
            running_loss += float(loss)
            correct += float(pred.cpu() == bag.label.cpu())
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
    use_pallas: bool | None = None,
    shard_over: int | None = None,
    mesh: Mesh | None = None,
) -> float:
    """MC validation; bag ``i`` of epoch ``e`` samples with seed
    ``fold_in(fold_in(key, e), i)``.  ``use_pallas``: ``None`` and ``True``
    run the head kernel on the card, ``False`` the plain head there; on the
    CPU all three run the plain head.  JAX's default is ``False`` (its
    kernel runs on a TPU only); the port's kernel runs on every card.  An
    oversized bag's sharded head is plain, and the kernel path says so once
    (:func:`warn_float_shard`)."""
    running_loss = running_aux = correct = total = 0.0
    sharded = None
    with torch.no_grad():
        for i, (bag, _rec) in enumerate(_items(loader, epoch)):
            seed = rng.fold_in(rng.fold_in(key, epoch), i)
            shard_mesh = shard_mesh_for(bag.bucket, shard_over, mesh)
            if shard_mesh is not None:
                if sharded is None and kernel_on(use_pallas) and bag.patches.is_cuda:
                    warn_float_shard(use_pallas=True)
                sharded = sharded or _mc_val_step_sharded(model, criterion, num_samples,
                                                          shard_mesh)
                loss, aux, pred = sharded(bag.patches, bag.mask, bag.label, seed)
            else:
                H = model.embed(bag.patches, bag.mask)
                out = mc_head(model, H, bag.mask, num_samples, seed,
                              kernel=kernel_on(use_pallas))
                loss, aux, pred = _mc_val_finish(
                    model, criterion, out.predictions, out.attention, bag.label
                )
            running_loss += float(loss)
            running_aux += float(aux)
            correct += float(pred.cpu() == bag.label.cpu())
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
    shard_over: int | None = None,
    mesh: Mesh | None = None,
):
    """Deterministic test pass: ``(accuracy, Report)``."""
    preds, targets = [], []
    sharded = None
    with torch.no_grad():
        for bag, _rec in _items(loader, 0):
            shard_mesh = shard_mesh_for(bag.bucket, shard_over, mesh)
            if shard_mesh is not None:
                sharded = sharded or _det_step_sharded(model, shard_mesh)
                y = sharded(bag.patches, bag.mask)
            else:
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
    use_pallas: bool | None = None,
    quantized: bool = False,
    shard_over: int | None = None,
    mesh: Mesh | None = None,
):
    """MC test pass: ``(accuracy, Report)`` from the argmax of the MC-mean
    softmax.  Bag ``i`` samples with seed ``fold_in(seed, i)``;
    ``quantized=True`` embeds through the int8 PTQ path; ``use_pallas`` as
    in :func:`mc_validate` (JAX's default ``False``, the port's kernel on
    every card).  An oversized bag (bucket above ``shard_over``) evaluates
    instance-sharded over ``mesh``'s devices on the float embed and the
    plain head, where there are several (see the module docstring); the
    int8 or kernel path then says once that the metric mixes regimes
    (:func:`warn_float_shard`)."""
    targets, preds, _ = _mc_test_outputs(
        model, loader, num_samples=num_samples, seed=seed, use_pallas=use_pallas,
        quantized=quantized, shard_over=shard_over, mesh=mesh,
    )
    return _finish_test(targets, preds, metrics, fold)


def _mc_test_outputs(model, loader, *, num_samples, seed, use_pallas=None, quantized=False,
                     shard_over=None, mesh=None) -> tuple[list[int], list[int], list[torch.Tensor]]:
    """:func:`mc_test`'s pass: per bag its target, predicted label and MC
    logits ``Y (T, C)`` on the CPU, in stream order."""
    embed = make_embed_fn(model, quantized)
    targets, preds, ys = [], [], []
    sharded = None
    with torch.no_grad():
        for i, (bag, _rec) in enumerate(_items(loader, 0)):
            seed_i = rng.fold_in(seed, i)
            shard_mesh = shard_mesh_for(bag.bucket, shard_over, mesh)
            if shard_mesh is not None:
                kernel = kernel_on(use_pallas) and bag.patches.is_cuda
                if sharded is None and (quantized or kernel):
                    warn_float_shard(quantized=quantized, use_pallas=kernel)
                sharded = sharded or _mc_test_step_sharded(model, num_samples, shard_mesh)
                y = sharded(bag.patches, bag.mask, seed_i)
            else:
                H = embed(bag.patches, bag.mask)
                y = mc_head(model, H, bag.mask, num_samples, seed_i,
                            kernel=kernel_on(use_pallas)).predictions
            preds.append(int(_mc_labels(y)))
            ys.append(y.cpu())
            targets.append(int(bag.label))
    return targets, preds, ys


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
