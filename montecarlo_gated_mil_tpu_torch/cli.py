"""Command-line entry points of the port.

Counterpart of ``montecarlo_gated_mil_tpu/cli.py``, with the same
subcommands and flags:

    python -m montecarlo_gated_mil_tpu_torch.cli train --config config.yml
    python -m montecarlo_gated_mil_tpu_torch.cli cv --config config.yml [--resume]
    python -m montecarlo_gated_mil_tpu_torch.cli cv-eval --config config.yml \
        [--manifest M] [--ensemble]
    python -m montecarlo_gated_mil_tpu_torch.cli infer --config config.yml --out DIR \
        [--manifest M] [--max-items K] [--ensemble]
    python -m montecarlo_gated_mil_tpu_torch.cli bench --config config.yml [--samples T]
    python -m montecarlo_gated_mil_tpu_torch.cli serve --config config.yml \
        [--checkpoint NAME] [--input requests.jsonl | --port 8000 --data-root DIR]

``train`` runs ``runners.run_training``, ``cv`` ``run_cross_validation``,
``cv-eval`` ``run_cv_eval``, ``infer`` ``viz.infer.run_inference`` (the
figures need matplotlib), ``bench`` ``bench.run_bench`` (one JSON line)
and ``serve`` the JSONL or HTTP front-end of ``server.py``, on the CUDA card.
Metrics go to stdout, to TensorBoard event files under ``--tensorboard
DIR`` and, with ``neptune: true`` in the YAML, to a Neptune run where
``neptune`` imports.  With ``tpu.coordinator_address`` set, each process
of a multi-process run joins the group first
(``parallel/distributed.py::initialize`` with ``tpu.num_processes`` and
``tpu.process_id``; ``cv`` then fans its folds out over the processes), and
leaves it at the end.  ``--aot-cache`` is not ported and exits non-zero
with a message naming its ROADMAP.md item, never doing something else
instead.
"""

from __future__ import annotations

import argparse
import sys

import torch


def get_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="montecarlo_gated_mil_tpu_torch",
        description="Monte Carlo Gated-Attention MIL on one CUDA card (PyTorch port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, help_ in (
        ("train", "single-split training with early stopping + final test"),
        ("cv", "k-fold cross-validation training"),
        ("cv-eval", "re-evaluate saved CV fold models (MC vs deterministic)"),
        ("infer", "MCDO inference with attention/uncertainty figures"),
        ("bench", "MCDO throughput benchmark"),
        ("serve", "serving front-end: JSONL batch scoring or HTTP server"),
    ):
        p = sub.add_parser(name, help=help_)
        p.add_argument(
            "--config", type=str, required=True,
            help="path to .yml config file specifying datasets/training params",
        )
        p.add_argument(
            "--tensorboard", type=str, default=None, metavar="DIR",
            help="also log metrics as TensorBoard event files under DIR",
        )
        if name == "train":
            p.add_argument(
                "--resume", action="store_true",
                help="resume from the latest training-state checkpoint",
            )
        if name == "cv":
            p.add_argument(
                "--resume", action="store_true",
                help="skip folds already completed by a crashed run (cv_progress.json)",
            )
        if name == "cv-eval":
            p.add_argument("--manifest", type=str, default=None)
            p.add_argument(
                "--ensemble", action="store_true",
                help="also score the stacked fold ensemble (pooled MC samples) on the "
                "shared test split",
            )
        if name == "infer":
            p.add_argument("--out", type=str, default="figures")
            p.add_argument("--manifest", type=str, default=None)
            p.add_argument("--max-items", type=int, default=0)
            p.add_argument(
                "--ensemble", action="store_true",
                help="one pooled fold-ensemble figure per item instead of one per fold",
            )
        if name == "bench":
            p.add_argument("--samples", type=int, default=30)
        if name == "serve":
            p.add_argument(
                "--checkpoint", type=str, default=None,
                help="saved model (name under model_path or absolute path, as "
                "run_training saves it); fresh seeded init if omitted",
            )
            p.add_argument(
                "--input", type=str, default=None,
                help="JSONL request file ('-' for stdin); omits HTTP mode",
            )
            p.add_argument(
                "--output", type=str, default=None,
                help="JSONL result file (default stdout)",
            )
            p.add_argument("--maps-dir", type=str, default=None)
            p.add_argument("--port", type=int, default=8000)
            p.add_argument("--host", type=str, default="127.0.0.1")
            p.add_argument("--no-warmup", action="store_true")
            p.add_argument(
                "--background-warmup", action="store_true",
                help="HTTP mode: listen once the cap bucket is warm and warm the "
                "remaining buckets in a background thread",
            )
            p.add_argument(
                "--aot-cache", type=str, default=None, metavar="DIR",
                help="warm via an on-disk serialized-executable cache (JAX package "
                "only; not ported)",
            )
            p.add_argument(
                "--data-root", type=str, default=None,
                help="directory HTTP image_path requests may read from "
                "(omitted: image_path requests are rejected in HTTP mode)",
            )
    return parser


def _unported(what: str) -> SystemExit:
    return SystemExit(f"montecarlo_gated_mil_tpu_torch: {what} is not ported yet")


def main(argv: list[str] | None = None, *, device: str | torch.device = "cuda") -> int:
    """Run one subcommand on ``device`` (the card unless a caller, such as
    a test, passes ``"cpu"``).  Raises ``SystemExit`` with a message for
    what is not ported."""
    args = get_args_parser().parse_args(argv)
    if args.command == "serve" and args.aot_cache:
        raise _unported("--aot-cache, the JAX package's executable cache (ROADMAP.md queue 1, "
                        "'Never to be ported': CUDA needs no compile cache)")
    from montecarlo_gated_mil_tpu_torch.core.config import load_config

    cfg = load_config(args.config)
    if not cfg.tpu.coordinator_address:
        return _run(args, cfg, device)
    import torch.distributed as dist

    from montecarlo_gated_mil_tpu_torch.parallel.distributed import initialize

    own_group = not dist.is_initialized()
    initialize(cfg.tpu.coordinator_address, cfg.tpu.num_processes, cfg.tpu.process_id)
    try:
        return _run(args, cfg, device)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, cfg, device) -> int:
    from montecarlo_gated_mil_tpu_torch.utils.metrics import Metrics, StdoutSink

    metrics = Metrics([StdoutSink()])
    if args.tensorboard:
        from montecarlo_gated_mil_tpu_torch.utils.metrics import TensorBoardSink

        metrics.sinks.append(TensorBoardSink(args.tensorboard))
    if cfg.neptune:
        try:
            import neptune

            from montecarlo_gated_mil_tpu_torch.utils.metrics import NeptuneSink

            run = neptune.init_run()
            run["config"] = {"yml": args.config}
            metrics.sinks.append(NeptuneSink(run))
        except ImportError:
            print("neptune not installed; continuing with stdout metrics")

    if args.command == "train":
        from montecarlo_gated_mil_tpu_torch.runners import run_training

        run_training(cfg, metrics, resume=args.resume, device=device)
    elif args.command == "cv":
        from montecarlo_gated_mil_tpu_torch.runners import run_cross_validation

        run_cross_validation(cfg, metrics, resume=args.resume, device=device)
    elif args.command == "cv-eval":
        from montecarlo_gated_mil_tpu_torch.runners import run_cv_eval

        run_cv_eval(cfg, args.manifest, metrics, ensemble=args.ensemble, device=device)
    elif args.command == "infer":
        from montecarlo_gated_mil_tpu_torch.viz.infer import run_inference

        run_inference(cfg, out_dir=args.out, manifest_path=args.manifest,
                      max_items=args.max_items, ensemble=args.ensemble, device=device)
    elif args.command == "bench":
        import json

        from montecarlo_gated_mil_tpu_torch.bench import run_bench

        print(json.dumps(run_bench(cfg, num_samples=args.samples, device=device)))
    elif args.command == "serve":
        from montecarlo_gated_mil_tpu_torch.server import build_predictor, run_server, serve_jsonl

        if args.input is not None:
            predictor = build_predictor(cfg, args.checkpoint, device=device)
            if not args.no_warmup:
                predictor.warmup()
            fin = sys.stdin if args.input == "-" else open(args.input)
            fout = sys.stdout if args.output is None else open(args.output, "w")
            try:
                serve_jsonl(predictor, fin, fout, maps_dir=args.maps_dir)
            finally:
                if fin is not sys.stdin:
                    fin.close()
                if fout is not sys.stdout:
                    fout.close()
        else:
            run_server(
                cfg,
                checkpoint=args.checkpoint,
                port=args.port,
                host=args.host,
                warmup=not args.no_warmup,
                background_warmup=args.background_warmup,
                maps_dir=args.maps_dir,
                data_root=args.data_root,
                device=device,
            )
    metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
