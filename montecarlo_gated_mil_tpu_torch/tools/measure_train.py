"""Training-step time on the card by the chained slope.

Counterpart of the JAX package's ``tools/measure_train.py``: the whole
one-bag step of ``train/state.py::make_train_step`` (r18 embed and the
gated-attention head forward with dropout, CE + aux, backward, Adam) at the
bench's workload (``bench.py::train_workload``: 256 patches at 224 px,
bf16, K2 and K4 on the card), k steps in a row with the state carried
(``utils/profiling.py::train_step_chain``), the median pairwise slope of
the totals (``slope_of_chain``).

    python -m montecarlo_gated_mil_tpu_torch.tools.measure_train [--patches 256] [--patch 224]
"""

from __future__ import annotations

from montecarlo_gated_mil_tpu_torch import bench
from montecarlo_gated_mil_tpu_torch.tools import _common
from montecarlo_gated_mil_tpu_torch.utils.profiling import slope_of_chain, train_step_chain


def main(argv=None, *, device="cuda") -> float:
    ap = _common.parser(__doc__)
    ap.add_argument("--patches", type=int, default=256)
    ap.add_argument("--patch", type=int, default=224)
    _common.slope_args(ap, ks=(2, 5, 10))
    args = ap.parse_args(argv)
    device = _common.start(device)
    with _common.main_path_settings():
        state, step, bag = bench.train_workload(bag_size=args.patches, patch=args.patch,
                                                device=device)
        per_step = slope_of_chain(train_step_chain(step, state, bag, 0), ks=args.ks,
                                  reps=args.reps)
    what = "bags/s/card" if device.type == "cuda" else "bags/s on the CPU"
    print(f"train step (r18 bf16, bag {args.patches}x{args.patch}px, CE+aux, Adam): "
          f"{per_step * 1e3:.2f} ms/step = {1.0 / per_step:.1f} {what}", flush=True)
    return per_step


if __name__ == "__main__":
    main()
