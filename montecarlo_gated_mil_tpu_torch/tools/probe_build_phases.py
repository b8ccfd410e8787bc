"""Where a predictor's construction goes, phase by phase.

Counterpart of the JAX package's ``tools/probe_build_phases.py``: the
phases of ``server.build_predictor`` / ``MCDOPredictor.from_config`` for the
shipped configuration (``Config()``, or ``--config``), each in a
``PhaseTimer`` that synchronizes the card around it: the config, the seeded
model's init, the predictor (weights to the device, the head's kernel
layout), the int8 plan (``quantize_backbone_static``, which a quantized
predictor builds), the kernels' build (``ops/cuda_build.py``, from the
sources unless this process or an earlier one built them) and the warm-up of
every registry bucket and input dtype.

    python -m montecarlo_gated_mil_tpu_torch.tools.probe_build_phases [--config C.yml]
"""

from __future__ import annotations

from montecarlo_gated_mil_tpu_torch.tools import _common
from montecarlo_gated_mil_tpu_torch.utils.profiling import PhaseTimer


def main(argv=None, *, device="cuda") -> dict:
    from montecarlo_gated_mil_tpu_torch.core.config import Config, load_config
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    ap = _common.parser(__doc__)
    ap.add_argument("--config", help="YAML config (default: the shipped Config())")
    args = ap.parse_args(argv)
    device = _common.start(device)
    timer = PhaseTimer(device=device)
    with _common.main_path_settings():
        with timer.phase("config"):
            cfg = load_config(args.config) if args.config else Config()
        with timer.phase("init"):
            weights = build_model(cfg, seed=cfg.seed).state_dict()
        with timer.phase("predictor"):
            pred = MCDOPredictor.from_config(cfg, weights, device=device)
        with timer.phase("int8 plan"):
            make_embed_fn(pred.model, True)
        with timer.phase("kernel build"):
            if device.type == "cuda":
                cuda_build.build_all()
        with timer.phase("warm-up"):
            pred.warmup()
    for name, row in timer.as_dict().items():
        print(f"{name}: {row['total_s']:.3f} s", flush=True)
    print(f"TOTAL: {sum(timer.totals.values()):.3f} s", flush=True)
    return timer.as_dict()


if __name__ == "__main__":
    main()
