"""A training cell: the port's ``train_epoch`` over its ``BagLoader`` of
full-size DICOM records.

Set-up writes the traffic's records, CC+MLO pairs of 16-bit uncompressed
DICOM files made from the seed, under ``TMPDIR``, builds the model with
seeded weights, Adam and the one-bag step as shipped, and drives that one
state through ``train_epoch`` over the first ``setup_bags`` bags (every
record once, so every shape the window uses is warm).  The first
``check_steps`` optimizer steps of it are what the reference follows.  The
window is the next epoch, bags in the same record order, cut at
``--seconds``; its rate counts every step that ended in it.
"""

from __future__ import annotations

import itertools
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import dicom_writer, images
from benchmark.device import sync
from benchmark.reference.model import make_weights


@dataclass
class Step:
    bucket: int
    n_valid: int
    loss: object  # the step's loss tensor
    end: float


class _Take:
    """The first ``n`` bags of a loader's epoch."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def epoch(self, e: int):
        gen = self.loader.epoch(e)
        try:
            yield from itertools.islice(gen, self.n)
        finally:
            gen.close()


class _Until:
    """A loader's epoch, ended when the host clock passes ``deadline``."""

    def __init__(self, loader, deadline: float):
        self.loader, self.deadline = loader, deadline

    def epoch(self, e: int):
        gen = self.loader.epoch(e)
        try:
            while time.perf_counter() < self.deadline:
                with torch.profiler.record_function("bench.loader_next"):
                    item = next(gen, None)
                if item is None:
                    return
                yield item
        finally:
            gen.close()


class _Recorder:
    """Wraps the program's step: records each step's loss and end, and the
    optimizer's state where the check reads it."""

    def __init__(self, step_fn, on_step=None):
        self.step_fn, self.on_step, self.steps = step_fn, on_step, []

    def __call__(self, state, bag, seed, do_update):
        with torch.profiler.record_function("bench.train_step"):
            state, out = self.step_fn(state, bag, seed, do_update)
        sync()
        self.steps.append(Step(bag.bucket, int(bag.mask.sum()), out["loss"], time.perf_counter()))
        if self.on_step is not None:
            self.on_step(len(self.steps), state)
        return state, out


def write_records(root: str, config: dict, traffic: dict, seed: int, device):
    """The traffic's records as DICOM pairs under ``root``: ``(records,
    raw)`` with ``raw[i] = (cc, mlo, laterality, label)``."""
    from montecarlo_gated_mil_tpu_torch.data.records import BagRecord

    n = int(traffic["records"])
    bits = int(traffic["pixel_bits"])
    geo = images.geometry(2 * n)
    g = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    n_pos = round(n * float(traffic["positive_share"]))
    n_right = round(n * float(traffic["right_share"]))
    records, raw = [], []
    for i in range(n):
        right = (i * 7 + 1) % n < n_right
        positive = (i * 5 + 2) % n < n_pos
        side = "R" if right else "L"
        views = []
        for v, name in enumerate(("CC", "MLO")):
            cy, ry, rx = geo[2 * i + v]
            img = images.mammogram(config["H"], config["W"], cy, ry, rx, positive, g, device, bits)
            if right:
                img = torch.flip(img, dims=(1,))
            px = images.to_pixels(img, bits)
            path = os.path.join(root, f"p{i:03d}_{side}_{name}.dcm")
            dicom_writer.write(path, px, bits, f"P{i:03d}", "055Y", side)
            views.append((path, px))
        records.append(BagRecord(paths=(views[0][0], views[1][0]),
                                 class_name="Malignant" if positive else "Normal",
                                 view="Left" if side == "L" else "Right", laterality=side))
        raw.append((views[0][1], views[1][1], side, int(positive)))
    return records, raw


def train_cell(cell, args, t_start: float, device: str = "cuda") -> dict:
    """Set-up, the window of training steps, and the check."""
    from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
    from montecarlo_gated_mil_tpu_torch.data.dicom_native import (
        load_library,
        make_native_dicom_reader,
    )
    from montecarlo_gated_mil_tpu_torch.data.pipeline import BagLoader, PipelineConfig
    from montecarlo_gated_mil_tpu_torch.experiment import (
        build_criterion,
        build_model,
        build_optimizer,
    )
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import use_pallas_from
    from montecarlo_gated_mil_tpu_torch.ops.patching import compute_tile_grid
    from montecarlo_gated_mil_tpu_torch.train.loops import train_epoch
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    from benchmark import trace
    from benchmark.check import train_check, verdict
    from benchmark.readers import Context

    cfg, traffic = cell.config, cell.traffic
    tc = cfg["train"]
    cuda = device == "cuda"
    marks = [("start", time.perf_counter())]
    if cuda:
        cuda_build.build_all()
    load_library()
    marks.append(("build", time.perf_counter()))
    port = config_from_dict(cfg["port_config"])
    root = tempfile.mkdtemp(prefix="bench-dicom-")
    try:
        records, raw = write_records(root, cfg, traffic, args.seed, device)
        marks.append(("records", time.perf_counter()))
        weights = make_weights(cfg["backbone"], cfg["L"], cfg["D"], cfg["C"], args.seed, device)
        model = build_model(port)
        model.load_state_dict(weights)
        model.to(device)
        k = tc["grad_acc_steps"]
        optimizer, scheduler = build_optimizer(port, model, 1)
        state = TrainState(model, optimizer, scheduler)
        step_fn = make_train_step(model, build_criterion(port), optimizer, k,
                                  use_pallas=use_pallas_from(port))
        d = port.data
        grid = compute_tile_grid(d.H, d.W, d.patch_size, d.overlap_train)
        spec = BucketSpec(port.tpu.buckets)
        pcfg = PipelineConfig(height=d.H, width=d.W, patch_size=d.patch_size,
                              overlap=d.overlap_train, empty_threshold=d.empty_threshold,
                              bag_size=d.bag_size_train, bucket=spec.bucket_for(grid.num_tiles),
                              augment=True, dtype=port.tpu.compute_dtype)
        loader_seed = args.seed & 0x7FFFFFFF
        n_rec = len(records)
        per_epoch = max(int(traffic["setup_bags"]), math.ceil(args.seconds * 8))
        loader = BagLoader(records, make_native_dicom_reader(), pcfg, multimodal=True,
                           seed=loader_seed, bucket_spec=spec, oversized=port.tpu.oversized_bags,
                           io_workers=int(tc["io_workers"]), device=device,
                           sample_order=np.arange(per_epoch) % n_rec)
        key = args.seed & 0xFFFFFFFF
        check_bags = k * int(traffic["check_steps"])
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        snap = {}

        def on_step(i, st):
            if i == k:  # the first optimizer step: its first moment is 0.1 g
                # (no state: the optimizer never stepped, as if g were 0)
                snap["m1"] = {n: st.optimizer.state.get(p, {}).get("exp_avg",
                                                                   torch.zeros_like(p)).clone()
                              for n, p in st.model.named_parameters()}
            if i == check_bags:
                snap["p3"] = {n: p.detach().clone() for n, p in st.model.named_parameters()}

        rec = _Recorder(step_fn, on_step)
        train_epoch(rec, state, _Take(loader, int(traffic["setup_bags"])), epoch=0,
                    accumulation_steps=k, key=key)
        setup_losses = [float(s.loss) for s in rec.steps[:check_bags]]
        setup_bags = [(s.bucket, s.n_valid) for s in rec.steps[:check_bags]]
        rec.on_step = None
        marks.append(("warm steps", time.perf_counter()))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        rec.steps = []
        raised = ""
        with trace.traced(bool(args.trace)) as tr:
            t0 = time.perf_counter()
            try:
                train_epoch(rec, state, _Until(loader, t0 + args.seconds), epoch=1,
                            accumulation_steps=k, key=key)
            except Exception as e:  # a failed step counts against the run
                raised = f"{type(e).__name__}: {e}"
                print(f"training step failed: {raised}", file=sys.stderr)
            sync()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        steps = rec.steps
        t_end = steps[-1].end if steps else time.perf_counter()
        window = t_end - t0
        bad = sum(1 for s in steps if not math.isfinite(float(s.loss)))
        failed = bad + (1 if raised else 0)
        attempted = len(steps) + (1 if raised else 0)
        e2e = {"train_bags_per_s": len(steps) / window, "peak_gib": peak / 2**30,
               "setup_s": setup_s}
        print(f"window {window:.3f} s: {len(steps)} steps, buckets "
              f"{sorted({s.bucket for s in steps})}, valid tiles "
              f"{min((s.n_valid for s in steps), default=0)}-"
              f"{max((s.n_valid for s in steps), default=0)}", file=sys.stderr, flush=True)
        ctx = Context(cell, tr.timeline, steps=steps, window_s=window)
        del model, optimizer, scheduler, state, step_fn, rec, loader
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        prog, ctrl = train_check(setup_losses, setup_bags, snap, p0, raw, weights, cfg, traffic,
                                 loader_seed, key, bool(args.control), device)
        print(f"check of {len(setup_losses)} bags: {time.perf_counter() - t_check:.1f} s",
              file=sys.stderr, flush=True)
        if ctrl is not None:
            print(f"control (reference at the lower precision) against the reference: {ctrl}",
                  file=sys.stderr)
        correct, checks = verdict(prog, cfg["limits"])
        return {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
                "e2e": e2e, "ctx": ctx, "peak": peak, "checks": checks, "marks": marks}
    finally:
        shutil.rmtree(root, ignore_errors=True)
