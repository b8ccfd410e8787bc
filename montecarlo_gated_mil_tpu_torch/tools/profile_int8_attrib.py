"""The int8 embed against the bf16 embed, stage by stage, on the card.

Counterpart of the JAX package's ``tools/profile_int8_attrib.py``: at the
bench's workload (256 patches at 224 px, r18, bf16 model, shared gate,
T=30) it decomposes both embeds so their ratio is attributed stage by stage:

  1. totals: the bf16 embed, the int8 embed (``ops/quantized.py``: the bf16
     stem conv, then K6-K8) and the head (K2), so the stages reconcile with
     the bench;
  2. stages: each real stage (stem, l1-l4) of both embeds, epilogues
     included (``ResNetFeatures.stages``, ``quantized_stages``), on the
     activations the stages before it give;
  3. conv only: the same stage's convolutions alone on the same inputs, in
     bf16 (cuDNN) and int8 (K6 with a bf16 store, on int8 inputs made
     before timing), with the rate against the data-sheet peaks.

Every time is the median over ``rounds`` interleaved rounds of the chained
slope (``utils/profiling.py::slope_time``), with the spread.

    python -m montecarlo_gated_mil_tpu_torch.tools.profile_int8_attrib [--rounds 3]
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.tools import _common
from montecarlo_gated_mil_tpu_torch.tools.profile_embed import conv_flops
from montecarlo_gated_mil_tpu_torch.utils.profiling import (
    PEAK_BF16_FLOPS,
    PEAK_INT8_OPS,
    slope_time,
)

T = 30


def conv_only(net, plan, stage: int, kind: str, x: torch.Tensor):
    """The convolutions of one stage alone, on its input ``x``: in bf16 (an
    NCHW view of channels-last) each reads the one before; in int8 (NHWC,
    K6 with a bf16 store) each conv after the first reads an int8 input
    made once here from the conv before it (rounded and clamped), so no
    requantize pass is timed."""
    from montecarlo_gated_mil_tpu_torch.ops.quant_kernels import qconv

    blocks = [(b, plan[f"layer{stage}_{i}"]) for i, b in enumerate(getattr(net, f"layer{stage}"))]

    def conv(a, module, q):
        s, p = module.stride[0], module.padding[0]
        if kind == "int8":
            return qconv(a, q["w"], q["s"], s, (p,) * 4, "bf16")
        return F.conv2d(a, module.weight.to(torch.bfloat16), None, s, p)

    def walk(x0, fixed=None):
        """Every conv of the stage in order: the last output, and the input
        each conv read (``fixed``: the int8 inputs made before)."""
        inputs, out = [], None

        def run(a, module, q):
            if fixed is not None and inputs:
                a = fixed[len(inputs)]
            inputs.append(a)
            return conv(a, module, q)

        x = x0
        for block, q in blocks:
            y = x
            for k in range(1, block.depth + 1):
                out = run(y, getattr(block, f"conv{k}"), q[f"conv{k}"])
                y = out if kind == "bf16" or fixed is not None else (
                    torch.clamp(torch.round(out), -127, 127).to(torch.int8))
            if block.downsample is not None:
                out = run(x, block.downsample[0], q["downsample_conv"])
            x = y
        return out, inputs

    if kind == "bf16":
        return lambda x0: walk(x0)[0]
    _, made = walk(x)
    return lambda x0: walk(x0, made)[0]


def main(argv=None, *, device="cuda") -> dict:
    from montecarlo_gated_mil_tpu_torch import bench
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_head
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.ops.quantized import (
        quantize_backbone_static,
        quantized_embed_static,
        quantized_stages,
    )

    ap = _common.parser(__doc__)
    ap.add_argument("--patches", type=int, default=256)
    ap.add_argument("--patch", type=int, default=224)
    ap.add_argument("--rounds", type=int, default=3)
    _common.slope_args(ap)
    args = ap.parse_args(argv)
    device = _common.start(device)
    cuda = device.type == "cuda"
    n, kw = args.patches, dict(ks=args.ks, reps=args.reps)
    meas: dict[str, tuple] = {}
    with _common.main_path_settings(), torch.no_grad():
        model = bench._seeded(lambda: MultiHeadGatedAttentionMIL(dtype=torch.bfloat16)).to(device)
        net = model.feature_extractor
        plan = quantize_backbone_static(net, model.backbone)
        patches, mask = bench._workload(n, args.patch, torch.bfloat16, device)
        g = torch.Generator(device=device).manual_seed(7)
        emb = torch.rand(n, model.L, generator=g, device=device) * 2.0
        meas["total int8"] = (lambda p: quantized_embed_static(plan, p, mask), patches)
        meas["total bf16"] = (lambda p: model.embed(p, mask), patches)
        meas["head"] = (lambda h: mc_head(model, h, mask, T, 0).predictions, emb)
        w7 = net.conv1.weight.to(torch.bfloat16)
        meas["stem conv"] = (lambda p: F.conv2d(p.permute(0, 3, 1, 2), w7, None, 2, 3), patches)
        x_i8, x_bf, stages = patches, patches, []
        for (s, f_i8), (_, f_bf) in zip(quantized_stages(plan, mask, backbone=model.backbone),
                                         net.stages(mask)):
            stages.append(s)
            meas[f"{s} int8"] = (f_i8, x_i8)
            meas[f"{s} bf16"] = (f_bf, x_bf)
            if s != "stem":
                i = int(s[1:])
                meas[f"{s} conv int8"] = (conv_only(net, plan, i, "int8", x_i8), x_i8)
                meas[f"{s} conv bf16"] = (conv_only(net, plan, i, "bf16", x_bf), x_bf)
            x_i8, x_bf = f_i8(x_i8), f_bf(x_bf)
        samples: dict[str, list[float]] = {k: [] for k in meas}
        for r in range(args.rounds):
            for name, (fn, arg) in meas.items():
                samples[name].append(slope_time(fn, arg, **kw, what=name))
            print(f"  round {r + 1}/{args.rounds} done", flush=True)
    med = {k: statistics.median(v) for k, v in samples.items()}
    spread = {k: (max(v) - min(v)) / med[k] if med[k] else 0.0 for k, v in samples.items()}
    flops = conv_flops(net, n, args.patch)

    def util(f, t, peak):
        return f"{f / t / peak:5.1%}" if cuda else "not measured (CPU)"

    def line(name, t, extra=""):
        print(f"  {name:34s}: {t * 1e3:8.3f} ms  {extra}", flush=True)

    print("\n== totals (medians) ==")
    line("int8 embed", med["total int8"], f"spread {spread['total int8']:.0%}")
    line("bf16 embed", med["total bf16"],
         f"ratio bf16/int8 {med['total bf16'] / med['total int8']:.2f}x, spread "
         f"{spread['total bf16']:.0%}")
    line(f"MC head (T={T})", med["head"])
    print(f"  predicted bench: int8 {1.0 / (med['total int8'] + med['head']):.1f} bags/s, "
          f"bf16 {1.0 / (med['total bf16'] + med['head']):.1f} bags/s")
    print("\n== real stages, epilogues included (medians) ==")
    for s in stages:
        ti, tb = med[f"{s} int8"], med[f"{s} bf16"]
        line(f"{s} int8", ti, f"(bf16 {tb * 1e3:.3f} ms, ratio {tb / ti:.2f}x)")
    sum_i = sum(med[f"{s} int8"] for s in stages)
    sum_b = sum(med[f"{s} bf16"] for s in stages)
    print(f"  stage sums: int8 {sum_i * 1e3:.3f} ms against the whole {med['total int8'] * 1e3:.3f};"
          f" bf16 {sum_b * 1e3:.3f} ms against {med['total bf16'] * 1e3:.3f}")
    print("\n== conv only, no epilogues (medians) ==")
    line("stem conv (bf16 in both embeds)", med["stem conv"],
         f"(bf16 {util(flops['stem'], med['stem conv'], PEAK_BF16_FLOPS)} of peak)")
    for s in stages[1:]:
        ti, tb = med[f"{s} conv int8"], med[f"{s} conv bf16"]
        epi = 1 - ti / med[f"{s} int8"]
        line(f"{s} convs int8", ti,
             f"(bf16 {tb * 1e3:.3f} ms, ratio {tb / ti:.2f}x; int8 "
             f"{util(flops[s], ti, PEAK_INT8_OPS)}, bf16 {util(flops[s], tb, PEAK_BF16_FLOPS)} of "
             f"peak; epilogue {epi:.0%} of the int8 stage)")
    return {"median": med, "spread": spread}


if __name__ == "__main__":
    main()
