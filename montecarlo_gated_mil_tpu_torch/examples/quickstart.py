"""End-to-end quickstart on the built-in synthetic mammogram generator.

Counterpart of the JAX package's ``examples/quickstart.py``: the whole
reference workflow (train -> cross-validate -> re-evaluate -> uncertainty
figures -> serving) through the port's public API, the calls the CLI's
subcommands make, at a small geometry (128x128 synthetic images, 64 px
patches, buckets 8 and 16, 2 folds, T=8).  It runs on the card unless
``--device cpu``; the figures need matplotlib and are skipped, with a line
saying so, where it does not import.  Swap ``synthetic_count`` for the
reference's ``metadata_path`` / ``data_path`` keys to run on DICOM data.

    python -m montecarlo_gated_mil_tpu_torch.examples.quickstart [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def make_config(workdir: str):
    """A small but complete config (the reference's config.yml schema and
    the tpu block): 128x128 synthetic images, 64 px patches, two buckets,
    2 CV folds, T=8 MCDO samples."""
    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict

    return config_from_dict({
        "seed": 42,
        "model_path": os.path.join(workdir, "models"),
        "model": "r18",
        "is_MCDO-val": True,
        "is_MCDO-test": True,
        "N": 8,  # MCDO samples (the reference's T)
        "feature_dropout": 0.2,
        "attention_dropout": 0.1,
        "shared_att": True,
        "data": {
            "H": 128, "W": 128, "patch_size": 64,
            "overlap_train": 0.25, "overlap_val_test": 0.25, "empty_threshold": 0.05,
            "cv_folds": 2, "fraction_test": 0.3, "fraction_train_rest": 0.6,
            "fraction_val_test": 0.5, "synthetic_count": 16,
        },
        "training_plan": {
            "weighted_sampler": True, "criterion": "ce", "optimizer": "adam",
            "parameters": {"lr": 1e-4, "wd": 1e-4, "epochs": 2, "patience": 3,
                           "grad_acc_steps": 2},
        },
        "tpu": {"buckets": [8, 16], "compute_dtype": "float32"},
    })


def main(argv=None) -> dict:
    from montecarlo_gated_mil_tpu_torch.runners import (
        run_cross_validation,
        run_cv_eval,
        run_training,
    )
    from montecarlo_gated_mil_tpu_torch.utils.metrics import JsonlSink, Metrics, StdoutSink

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="output directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    workdir = args.out or tempfile.mkdtemp(prefix="mcgmil_quickstart_")
    os.makedirs(workdir, exist_ok=True)
    cfg = make_config(workdir)
    device = args.device
    metrics = Metrics([StdoutSink(), JsonlSink(os.path.join(workdir, "metrics.jsonl"))])

    # 1. Single-split training -> early stopping -> save best -> test
    #    (the reference's main.py workflow).
    print(f"== 1/5 train (workdir: {workdir}, device: {device})")
    result = run_training(cfg, metrics, device=device)
    print(f"   test accuracy {result['test_accuracy']:.3f}; best model at "
          f"{result['best_model_path']}")

    # 2. k-fold cross-validation (cross_validation.py): per fold a fresh
    #    model, optimizer and early stop, MC validation, a manifest on disk.
    print("== 2/5 cross-validation")
    manifest = run_cross_validation(cfg, metrics, device=device)
    print(f"   fold accuracies: {[round(f['accuracy'], 3) for f in manifest['folds']]}")

    # 3. Re-evaluate every fold from the manifest, timed MCDO against
    #    deterministic (cross_val_eval.py), plus the pooled fold ensemble.
    print("== 3/5 CV re-evaluation (MC vs deterministic vs fold ensemble)")
    manifest_path = os.path.join(cfg.model_path, "cv_manifest.json")
    ev = run_cv_eval(cfg, manifest_path, metrics, ensemble=True, device=device)
    print(f"   MC  acc {ev['mc']['mean']:.3f} +- {ev['mc']['std']:.3f}   det acc "
          f"{ev['deterministic']['mean']:.3f} +- {ev['deterministic']['std']:.3f}   ens acc "
          f"{ev['ensemble']['accuracy']:.3f}")

    # 4. MCDO inference and the 5-panel attention/uncertainty figures (infer.py).
    print("== 4/5 uncertainty figures")
    figs = []
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("   skipped: matplotlib does not import here")
    else:
        from montecarlo_gated_mil_tpu_torch.viz.infer import run_inference

        figs = run_inference(cfg, out_dir=os.path.join(workdir, "figures"), max_items=1,
                             device=device)
        print(f"   wrote {', '.join(p + '.png' for p in figs)}")

    # 5. Serving: a warm predictor answering single-image requests with
    #    predictive statistics and attention maps.
    print("== 5/5 serving")
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import interpret_entropy
    from montecarlo_gated_mil_tpu_torch.server import build_predictor

    predictor = build_predictor(cfg, checkpoint=result["best_model_path"], device=device)
    predictor.warmup()
    image = synthetic_image(cfg.data.H, cfg.data.W, positive=True, seed=3)
    r = predictor.predict(image, laterality="L", return_maps=True, map_downsample=4)
    answer = {
        "prediction": int(r.prediction),
        "p_cancer_mean": round(float(r.stats.mean), 4),
        "p_cancer_std": round(float(r.stats.std), 4),
        "mean_entropy": round(float(r.stats.mean_entropy), 4),
        "interpretation": interpret_entropy(float(r.stats.mean_entropy)),
        "attention_map_shape": list(np.shape(r.attention_mean_maps)),
    }
    print(json.dumps(answer, indent=2))
    print(f"done; artifacts in {workdir}")
    return {"training": result, "manifest": manifest, "cv_eval": ev, "figures": figs,
            "serving": answer}


if __name__ == "__main__":
    main()
