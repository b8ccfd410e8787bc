"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with the port (``montecarlo_gated_mil_tpu_torch``)
beside ``benchmark/`` and a CUDA card.  Set-up (the kernels' build on a
checkout's first run, the weights and inputs made from the seed on the
card, warm-up of every shape the cell's traffic uses) counts into
``setup_s``; then the cell's traffic runs for ``--seconds``.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the whole window.  Then the window's outputs are compared with the
plain reference (``benchmark/check.py``), the numbers compared go to
standard error beside their limits, and the result line is printed.

``--control 1`` (calibration only; the driver never passes it) also puts
the reference in the program's place at the next lower precision and
prints those numbers.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

# Fixed cache directories inside the checkout, so that only a checkout's
# first run builds or compiles.
os.environ.setdefault("TRITON_CACHE_DIR", str(spec.BENCH_DIR / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(spec.BENCH_DIR / ".cache" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"


def _finite(x):
    """JSON has no infinity: a non-finite number is written as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def phases(marks, t_start: float) -> str:
    """Set-up by phase: imports, then each named step."""
    steps = [("imports", marks[0][1] - t_start)]
    steps += [(b[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])]
    return "set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in steps)


def report(cell, trace: bool, e2e: dict, ctx) -> dict:
    """The end-to-end metrics (``--trace 0``) or the per-layer ones."""
    if not trace:
        return {m.name: {"value": e2e[m.name], "unit": m.unit} for m in cell.end_to_end}
    out = {}
    for m in cell.per_layer:
        v = spec.load_metric_reader(m.name)(ctx)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out


def run_cell(cell, args, t_start: float, device: str = "cuda") -> dict:
    """The cell's set-up, window and check; ``metrics`` as ``report`` gives
    them, with the rest of what the cell observed."""
    if cell.traffic["loop"] == "train":
        from benchmark.training import train_cell as cell_fn
    else:
        from benchmark.serving import serve_cell as cell_fn
    out = cell_fn(cell, args, t_start, device)
    print(phases(out["marks"], t_start), file=sys.stderr, flush=True)
    out["metrics"] = report(cell, bool(args.trace), out["e2e"], out["ctx"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    try:
        import montecarlo_gated_mil_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 2
    t_torch = time.perf_counter()
    from benchmark import device, guard

    t_import = time.perf_counter()
    try:
        device.require_cards(cell.chips)
    except device.NoCard as e:
        print(str(e), file=sys.stderr)
        return 2
    power = device.query_power(0)
    print(f"start-up s: interpreter and harness {t_torch - T_START:.3f}, torch "
          f"{t_import - t_torch:.3f}, CUDA init {time.perf_counter() - t_import:.3f}",
          file=sys.stderr, flush=True)
    out = run_cell(cell, args, T_START)
    print(f"card: {device.power_line(power)}", file=sys.stderr, flush=True)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    dev = device.device_record(cell.chips, out["peak"])
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": dev}
    if args.trace:
        tl = out["ctx"].timeline
        dev["busy_s"] = tl.busy_s
        dev["window_s"] = tl.window_s
        result["breakdown"] = tl.breakdown()
    result["checks"] = out["checks"]
    for k, row in out["checks"].items():
        print(f"check {k}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
