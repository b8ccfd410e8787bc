"""Full production scale on the card: one raw mammogram -> MCDO samples.

Counterpart of the JAX package's ``tools/measure_fullscale.py``: one
synthetic 7036x2800 mammogram (a breast-like filled blob on black, drawn
from a seeded generator on the device as the JAX tool draws it), the
shipped 75 %-overlap tile grid, tiling and fill-ranked selection into a
1024-instance bucket (``data/pipeline.py::image_to_bag``, K3 on the card),
the r18 embed, then the T samples of the shipped head (K1), timed by the
chained slope (``utils/profiling.py::slope_time``): device time per image,
with the embed in f32 (exact, as served), in bf16, and int8 with the conv
store in bf16 and in f8 (``ops/quantized.py``; K6-K8 on the card).  The
MCDO statistics of each variant are printed once.

    python -m montecarlo_gated_mil_tpu_torch.tools.measure_fullscale [--bucket 1024]
"""

from __future__ import annotations

import torch

from montecarlo_gated_mil_tpu_torch.tools import _common
from montecarlo_gated_mil_tpu_torch.utils.profiling import slope_time


def mammogram(h: int, w: int, seed: int, device) -> torch.Tensor:
    """A filled blob on black with seeded noise, values in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, h, device=device),
                            torch.linspace(-1, 1, w, device=device), indexing="ij")
    noise = torch.randn(h, w, generator=g, device=device)
    return torch.clamp((1.0 - (yy**2 + 2.0 * (xx + 0.45) ** 2)) + 0.08 * noise, 0.0, 1.0)


def main(argv=None, *, device="cuda") -> dict:
    from dataclasses import replace

    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.pipeline import PipelineConfig, image_to_bag
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_head, predictive_stats
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams
    from montecarlo_gated_mil_tpu_torch.ops.quantized import (
        quantize_backbone_static,
        quantized_embed_static,
    )

    d = Config().data
    ap = _common.parser(__doc__)
    ap.add_argument("--height", type=int, default=d.H)
    ap.add_argument("--width", type=int, default=d.W)
    ap.add_argument("--patch", type=int, default=d.patch_size)
    ap.add_argument("--bucket", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=Config().N, help="T, the head's samples")
    _common.slope_args(ap, ks=(1, 3, 6))
    args = ap.parse_args(argv)
    device = _common.start(device)
    cfg = Config()
    T = args.samples
    pipe = PipelineConfig(height=args.height, width=args.width, patch_size=args.patch,
                          overlap=d.overlap_val_test, empty_threshold=d.empty_threshold,
                          bucket=args.bucket)
    starts = torch.as_tensor(pipe.grid().tiles_array()[:, :2], device=device)
    print(f"grid: {pipe.grid().num_tiles} candidate tiles -> bucket {args.bucket}; T={T}",
          flush=True)
    results = {}
    with _common.main_path_settings(), torch.no_grad():
        image = mammogram(args.height, args.width, 0, device)
        model = _common.shipped_model(device, cfg)
        params = GatedAttentionParams.from_module(model).to(device)
        bf16 = _common.shipped_model(device, cfg, dtype="bfloat16")
        variants = {"float f32": (model.embed, "float32"), "float bf16": (bf16.embed, "bfloat16")}
        for store in ("bf16", "f8"):
            plan = quantize_backbone_static(model.feature_extractor, model.backbone,
                                            conv_store=store)
            variants[f"int8, conv_store={store}"] = (
                lambda p, m, plan=plan: quantized_embed_static(plan, p, m,
                                                               backbone=model.backbone),
                "float32")
        for label, (embed, dtype) in variants.items():
            cfg_v = replace(pipe, dtype=dtype)

            def full(img, embed=embed, cfg_v=cfg_v):
                bag = image_to_bag(img, False, 0, starts, cfg_v, device=device)
                H = embed(bag.patches, bag.mask)
                return mc_head(model, H, bag.mask, T, 7, params).predictions

            t = slope_time(full, image, ks=args.ks, reps=args.reps, what=label)
            st = predictive_stats(full(image))
            rate = "/s/card" if device.type == "cuda" else "/s on the CPU"
            print(f"{label:24s}: {t * 1e3:8.2f} ms/mammogram = {1.0 / t:6.2f}{rate}; P(pos) "
                  f"{float(st.mean):.4f}±{float(st.std):.4f}, entropy "
                  f"{float(st.mean_entropy):.4f}", flush=True)
            results[label] = t
    return results


if __name__ == "__main__":
    main()
