"""The training step by phase on the card, with the hand-written head and
with the plain one.

Counterpart of the JAX package's ``tools/profile_train.py``.  Two steps of
``train/state.py::make_train_step``: the bench's (r18 in bf16, dropout 0.25,
Adam at 3e-5, a bag of 256 patches at 224 px, shared gate: K2 forward and
K4 backward on the card) and the shipped configuration's at bucket 1024
(``Config()``: f32, separate gates, 650 valid tiles: K1 and K5), the step
PERF.md section 5 records.  Each runs with the kernels' head and with the
plain head (``ops/gated_attention.py::mc_head_reference`` under autograd),
as the JAX tool runs with and without ``use_pallas``: the whole step by the
chained slope (``utils/profiling.py::train_step_chain``), its phases (embed
forward, head forward, loss, backward, optimizer) by a ``PhaseTimer`` that
synchronizes the card around each, and on the card the kernel table of one
step with the head kernels' share.

    python -m montecarlo_gated_mil_tpu_torch.tools.profile_train [--patches 256] [--patch 224] [--bucket 1024]
"""

from __future__ import annotations

import contextlib

import torch

from montecarlo_gated_mil_tpu_torch.models.resnet import exact_float_grads
from montecarlo_gated_mil_tpu_torch.tools import _common
from montecarlo_gated_mil_tpu_torch.utils.profiling import (
    PhaseTimer,
    kernel_table,
    slope_of_chain,
    train_step_chain,
)

PHASES = ("embed fwd", "head fwd", "loss", "backward", "optimizer")
HEAD_SOURCES = ("mc_head.cu", "mc_head_bwd.cu")


@contextlib.contextmanager
def plain_head():
    """Every head of the models runs its plain version, on the card too:
    ``mc_gated_attention`` is swapped for ``mc_head_reference``."""
    from montecarlo_gated_mil_tpu_torch.ops import gated_attention as ga

    kernel = ga.mc_gated_attention
    ga.mc_gated_attention = ga.mc_head_reference
    try:
        yield
    finally:
        ga.mc_gated_attention = kernel


def phase_step(timer: PhaseTimer, state, criterion, bag, seed: int) -> None:
    """One training step, as ``make_train_step`` computes it, with each
    phase in ``timer``."""
    from montecarlo_gated_mil_tpu_torch.train.state import bag_loss

    model = state.model
    with timer.phase("embed fwd"):
        H = model.embed(bag.patches, bag.mask)
    with timer.phase("head fwd"):
        y, a = model.head(H, bag.mask, train=True, seed=seed)
    with timer.phase("loss"):
        loss, _ = bag_loss(model, criterion, y, a, bag.label)
    with timer.phase("backward"), exact_float_grads(model.dtype):
        loss.backward()
    with timer.phase("optimizer"):
        state.apply_update()


def bench_step(patches: int, patch: int, device):
    from montecarlo_gated_mil_tpu_torch import bench
    from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy

    state, step, bag = bench.train_workload(bag_size=patches, patch=patch, device=device)
    return state, step, bag, cross_entropy


def shipped_step(bucket: int, patch: int, device, valid: float = 650 / 1024):
    """The shipped configuration's step on a seeded bag at ``bucket`` with
    that share of valid tiles (K1 (c)'s training shape at 1024)."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.experiment import (
        build_criterion,
        build_model,
        build_optimizer,
    )
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    cfg = Config()
    model = build_model(cfg, seed=11).to(device)
    opt, sched = build_optimizer(cfg, model)
    crit = build_criterion(cfg)
    g = torch.Generator(device=device).manual_seed(1)
    mask = torch.arange(bucket, device=device) < round(bucket * valid)
    x = torch.rand(bucket, patch, patch, 3, generator=g, device=device) * mask[:, None, None, None]
    bag = Bag(x, mask, torch.tensor(1, device=device),
              torch.where(mask, torch.arange(bucket, device=device), 0))
    return TrainState(model, opt, sched), make_train_step(model, crit, opt, 1), bag, crit


def profile(label: str, make, args, cuda: bool) -> dict:
    """The whole step's slope, its phases and, on the card, its kernel
    table, with the kernels' head and with the plain head."""
    out = {}
    for head in ("kernels", "plain"):
        with plain_head() if head == "plain" else contextlib.nullcontext():
            state, step, bag, crit = make()
            full = slope_of_chain(train_step_chain(step, state, bag, 100), ks=args.ks,
                                  reps=args.reps)
            timer = PhaseTimer(device=bag.patches.device)
            for i in range(args.steps):
                phase_step(timer, state, crit, bag, 200 + i)
            table = kernel_table(lambda: step(state, bag, 300, True)) if cuda else None
        phases = {p: timer.mean_seconds(p) for p in PHASES}
        print(f"\n{label}, {head} head: full step {_common.ms(full)} (chained slope)", flush=True)
        for p, t in phases.items():
            print(f"  {p:10s} {_common.ms(t)}  {t / full:6.1%} of the full step "
                  f"(PhaseTimer, mean of {args.steps})", flush=True)
        print(f"  phases sum {_common.ms(sum(phases.values()))}", flush=True)
        row = dict(full=full, phases=phases)
        if table is not None:
            table.check_launched()
            heads = {src: sum(table.functions(src).values()) for src in HEAD_SOURCES}
            print(f"  kernel table, one step: device {table.total_ms:.3f} ms, idle "
                  f"{table.idle_share():.1%} of its window; head kernels (ms): "
                  + ", ".join(f"{s} {v:.4f}" for s, v in heads.items())
                  + "; the largest:", flush=True)
            print(table.lines(6), flush=True)
            row.update(table=table, head_ms=heads)
        out[head] = row
        del state, step, bag
        if cuda:
            torch.cuda.empty_cache()
    return out


def main(argv=None, *, device="cuda") -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--patches", type=int, default=256, help="the bench bag's patches")
    ap.add_argument("--patch", type=int, default=224)
    ap.add_argument("--bucket", type=int, default=1024,
                    help="the shipped step's bucket (0: skip it)")
    ap.add_argument("--steps", type=int, default=3, help="steps timed by phase")
    _common.slope_args(ap, ks=(2, 5, 10))
    args = ap.parse_args(argv)
    device = _common.start(device)
    cuda = device.type == "cuda"
    results = {}
    with _common.main_path_settings():
        results["bench"] = profile(
            f"bench step (r18 bf16, bag {args.patches}x{args.patch}px, CE+aux, Adam)",
            lambda: bench_step(args.patches, args.patch, device), args, cuda)
        if args.bucket:
            results["shipped"] = profile(
                f"shipped step (Config(), f32, bucket {args.bucket} at {args.patch}px)",
                lambda: shipped_step(args.bucket, args.patch, device), args, cuda)
    return results


if __name__ == "__main__":
    main()
