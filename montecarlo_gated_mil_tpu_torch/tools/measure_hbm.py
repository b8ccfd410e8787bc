"""Card memory per bucket: int8 MC, float MC and the training step.

Counterpart of the JAX package's ``tools/measure_hbm.py``, which reads XLA's
compile-time memory analysis.  PyTorch has none, so this runs each workload
once to warm up and once more between ``torch.cuda.reset_peak_memory_stats``
and ``max_memory_allocated``: the peak allocated in all while it runs, its
weights, optimizer state and bag included (counted from what the process
held when the tool started), at each bucket of a sweep of 224 px bags of
random patches at the shipped widths (``Config()``: r18, f32, separate
gates, T=50):

  - int8 MC inference (the int8 embed, K6-K8, then the head, K1);
  - float MC inference (the exact f32 embed, then K1);
  - the training step (``train/state.py::make_train_step``: embed forward
    and backward, CE + aux, K1 and K5, the shipped optimizer; :func:`
    train_peaks`, which also takes another backbone and compute dtype),
    beside the estimate of ``train/loops.py``'s memory guard for a bag
    that trains whole, which must not lie below it.  A bucket whose
    estimate exceeds 95 % of the card is not run: the guard refuses it.

On the CPU the rows print without peaks.

    python -m montecarlo_gated_mil_tpu_torch.tools.measure_hbm [bucket ...]
"""

from __future__ import annotations

import torch

from montecarlo_gated_mil_tpu_torch.tools import _common

DEFAULT_BUCKETS = (256, 512, 1024, 2048, 3072, 4096, 6144)


def _peak(run, cuda: bool, base: int) -> float | None:
    """Bytes allocated in all at ``run()``'s peak above ``base``, after a
    warm-up call; ``None`` on the CPU."""
    run()
    if not cuda:
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


# A bucket of train_peaks runs only where the bytes per input element of the
# largest bucket measured before it put it within this share of the card.
_FITS = 0.9


def train_peaks(cfg=None, buckets=DEFAULT_BUCKETS, *, patch: int = 224, device="cuda") -> dict:
    """The whole-bag training step's peak per bucket for ``cfg``'s backbone
    and compute dtype (``Config()`` unless given), beside the memory guard's
    estimate for the model it trains (``train/loops.py::_train_step_bytes``):
    ``{bucket: {"train": bytes or None, "guard": bytes, "skipped": reason or
    None}}``.  Each bag is a seeded one of random patches in the compute
    dtype, all valid, label 1; the step is ``make_train_step``'s with
    the config's optimizer (K1/K5 on the card), run once to warm up and once
    measured.  The peak counts from what was allocated before the model was
    built: the weights, gradients, optimizer state and bag are in it.  A
    bucket runs only where the training loops' guard
    (``train/loops.py::_check_unrouted_train_bag``) lets its bag through, and
    where the bytes per input element of the largest bucket measured so far
    put it within 90 % of the card.  On the CPU the steps run and the peaks
    are ``None``."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.pipeline import torch_dtype
    from montecarlo_gated_mil_tpu_torch.experiment import (
        build_criterion,
        build_model,
        build_optimizer,
    )
    from montecarlo_gated_mil_tpu_torch.train import loops
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    cfg = cfg or Config()
    device = torch.device(device)
    cuda = device.type == "cuda"
    card = torch.cuda.get_device_properties(device).total_memory if cuda else None
    if cuda:
        torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device) if cuda else 0
    dtype = torch_dtype(cfg.tpu.compute_dtype)
    model = build_model(cfg, seed=1).to(device)
    opt, sched = build_optimizer(cfg, model)
    state = TrainState(model, opt, sched)
    step = make_train_step(model, build_criterion(cfg), opt, 1)
    rows, per_elem = {}, None
    for b in buckets:
        numel = b * patch * patch * 3
        g = torch.Generator(device=device).manual_seed(b)
        bag = Bag(torch.rand(b, patch, patch, 3, generator=g, device=device).to(dtype),
                  torch.ones(b, dtype=torch.bool, device=device),
                  torch.tensor(1, device=device), torch.arange(b, device=device))
        row = {"train": None, "guard": loops._train_step_bytes(bag, model), "skipped": None}
        rows[b] = row
        try:
            loops._check_unrouted_train_bag(bag, None, model)
        except ValueError:
            row["skipped"] = "the training loops refuse it"
        if row["skipped"] is None and cuda and per_elem is not None \
                and per_elem * numel > _FITS * card:
            row["skipped"] = f"would pass {_FITS:.0%} of the card"
        if row["skipped"] is None:
            row["train"] = _peak(lambda: step(state, bag, 0, True), cuda, base)
            if row["train"] is not None:
                per_elem = row["train"] / numel
        del bag
        if cuda:
            torch.cuda.empty_cache()
    del model, opt, sched, state, step
    if cuda:
        torch.cuda.empty_cache()
    return rows


def main(argv=None, *, device="cuda") -> dict:
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn, mc_head

    ap = _common.parser(__doc__)
    ap.add_argument("buckets", type=int, nargs="*", default=DEFAULT_BUCKETS)
    ap.add_argument("--patch", type=int, default=224)
    args = ap.parse_args(argv)
    device = _common.start(device)
    cuda = device.type == "cuda"
    cfg = Config()
    gib = 1 / 2**30
    card = torch.cuda.get_device_properties(device).total_memory if cuda else None
    if cuda:
        torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device) if cuda else 0
    print(f"patch {args.patch} px, T={cfg.N}, {cfg.model} f32; peak allocated in all, GiB"
          + (f"; card {card * gib:.2f} GiB" if cuda else " (not measured on the CPU)"),
          flush=True)
    rows = {}
    with _common.main_path_settings():
        model = _common.shipped_model(device, cfg)
        embeds = {"int8": make_embed_fn(model, True), "float": make_embed_fn(model, False)}
        for b in args.buckets:
            g = torch.Generator(device=device).manual_seed(b)
            bag = Bag(torch.rand(b, args.patch, args.patch, 3, generator=g, device=device),
                      torch.ones(b, dtype=torch.bool, device=device),
                      torch.tensor(1, device=device), torch.arange(b, device=device))
            row = {}
            for name, embed in embeds.items():
                def infer(embed=embed):
                    with torch.inference_mode():
                        H = embed(bag.patches, bag.mask)
                        return mc_head(model, H, bag.mask, cfg.N, 0).predictions

                row[name] = _peak(infer, cuda, base)
            rows[b] = row
            del bag
            if cuda:
                torch.cuda.empty_cache()
        del model, embeds
        for b, train in train_peaks(cfg, args.buckets, patch=args.patch, device=device).items():
            rows[b].update(train)

    def fmt(v):
        return "-" if v is None else f"{v * gib:.3f}"

    print(f"{'bucket':>7} | {'int8 MC':>9} | {'float MC':>9} | {'train step':>10} | "
          f"{'guard estimate':>14} | guard holds", flush=True)
    for b, row in rows.items():
        holds = row["skipped"] or (
            "-" if row["train"] is None else str(row["guard"] >= row["train"]))
        print(f"{b:>7} | {fmt(row['int8']):>9} | {fmt(row['float']):>9} | "
              f"{fmt(row['train']):>10} | {row['guard'] * gib:>14.3f} | {holds}", flush=True)
    return rows


if __name__ == "__main__":
    main()
