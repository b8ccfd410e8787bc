"""The ResNet embed by stage on the card: time, FLOP and where the time goes.

Counterpart of the JAX package's ``tools/profile_embed.py``, at its
workload (a bag of 256 patches at 224 px, all valid, r18): each stage (stem,
l1-l4) and the whole embed timed by the chained slope
(``utils/profiling.py::slope_time``) in f32 (exact convolutions, no TF32, as
the shipped model serves) and in bf16, with its FLOP (2 x MAC, counted from
the model's ``Conv2d`` modules, so r34 and r50 count too) and rate; each
stage's device time split by the kernel table into cuDNN's convolutions,
the max pool and the rest (the masked BN's statistics and normalize, ReLU,
residual adds); then the isolated norm + ReLU -> conv -> statistics pass at
layers 1-3's shapes.

    python -m montecarlo_gated_mil_tpu_torch.tools.profile_embed [--patches 256] [--patch 224]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.models.resnet import _exact_float_convs
from montecarlo_gated_mil_tpu_torch.tools import _common
from montecarlo_gated_mil_tpu_torch.utils.profiling import (
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    kernel_table,
    slope_time,
)

DTYPES = {"float32": (torch.float32, PEAK_FP32_FLOPS), "bfloat16": (torch.bfloat16, PEAK_BF16_FLOPS)}
# cuDNN's convolution kernels and its layout transforms, by the names the
# profiler records for them; everything else in a stage is the max pool or
# the masked BN's elementwise passes and reductions.
CONV_KERNELS = ("conv", "cudnn", "xmma", "gemm", "winograd", "fft", "cutlass", "nchwToNhwc",
                "nhwcToNchw")
POOL_KERNELS = ("max_pool", "MaxPool")


def _out(h: int, conv: torch.nn.Conv2d) -> int:
    return (h + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1


def _flops(n: int, h_out: int, conv: torch.nn.Conv2d) -> float:
    k = conv.kernel_size[0]
    return 2.0 * n * h_out * h_out * k * k * conv.in_channels * conv.out_channels


def conv_flops(net, n: int, hw: int) -> dict[str, float]:
    """FLOP (2 x MAC) of each stage's convolutions for ``n`` patches of
    ``hw`` px, from the backbone's ``Conv2d`` modules: ``{"stem": ..., "l1":
    ...}``.  The s2d stem counts as its 7x7 conv."""
    h = _out(hw, net.conv1)
    out = {"stem": _flops(n, h, net.conv1)}
    h = (h + 2 - 3) // 2 + 1  # the 3x3/2 max pool
    for i in range(1, net.num_stages + 1):
        total = 0.0
        for block in getattr(net, f"layer{i}"):
            h_in = h
            for k in range(1, block.depth + 1):
                conv = getattr(block, f"conv{k}")
                h = _out(h, conv)
                total += _flops(n, h, conv)
            if block.downsample is not None:
                conv = block.downsample[0]
                total += _flops(n, _out(h_in, conv), conv)
        out[f"l{i}"] = total
    return out


def kernel_split(table) -> dict[str, float]:
    """ms a call in cuDNN's convolutions, the max pool and the rest."""
    convs, pool = table.ms(*CONV_KERNELS), table.ms(*POOL_KERNELS)
    return {"convs": convs, "max pool": pool, "BN and elementwise": table.total_ms - convs - pool}


def _isolated_pass(n: int, h: int, c: int, dtype: torch.dtype, device, g):
    """norm + ReLU -> 3x3 conv -> channel sums, on an NHWC-stored input."""
    x = torch.randn(n, h, h, c, generator=g, device=device).to(dtype).permute(0, 3, 1, 2)
    w = (torch.randn(c, c, 3, 3, generator=g, device=device) * 0.05).to(dtype)
    scale = torch.ones(c, device=device)[:, None, None]
    shift = torch.zeros(c, device=device)[:, None, None]

    def run(x):
        a = torch.relu(x.float() * scale + shift).to(dtype)
        with _exact_float_convs(dtype):
            y = F.conv2d(a, w, padding=1)
        yf = y.float()
        return y, torch.stack([yf.sum((0, 2, 3)), yf.square().sum((0, 2, 3))])

    return run, x


def main(argv=None, *, device="cuda") -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--patches", type=int, default=256)
    ap.add_argument("--patch", type=int, default=224)
    ap.add_argument("--backbone", default="r18")
    _common.slope_args(ap)
    args = ap.parse_args(argv)
    device = _common.start(device)
    cuda = device.type == "cuda"
    n, hw, kw = args.patches, args.patch, dict(ks=args.ks, reps=args.reps)
    from montecarlo_gated_mil_tpu_torch.core.config import Config

    cfg = Config(model=args.backbone)
    results: dict = {}
    with _common.main_path_settings(), torch.no_grad():
        g = torch.Generator(device=device).manual_seed(0)
        patches = torch.randn(n, hw, hw, 3, generator=g, device=device)
        mask = torch.ones(n, dtype=torch.bool, device=device)
        for name, (dtype, peak) in DTYPES.items():
            model = _common.shipped_model(device, cfg, dtype=name)
            net = model.feature_extractor
            flops = conv_flops(net, n, hw)
            stages, x = [], patches
            for stage, run in net.stages(mask):
                stages.append((stage, run, x))
                x = run(x)
            times = {s: slope_time(run, x, **kw, what=f"{name} {s}") for s, run, x in stages}
            embed = slope_time(lambda p, m=model: m.embed(p, mask), patches, **kw,
                               what=f"{name} embed")
            splits = {s: kernel_split(kernel_table(lambda r=run, x=x: r(x)))
                      for s, run, x in stages} if cuda else {}
            print(f"\nper stage ({n}-patch bag at {hw} px, {args.backbone}, {name}):", flush=True)
            for s in times:
                rate = (f"{flops[s] / times[s] / 1e12:6.1f} TF/s" if cuda
                        else "rate not measured (CPU)")
                split = ", ".join(f"{k} {v:.3f}" for k, v in splits[s].items()) if cuda else ""
                print(f"  {s:4s}: {_common.ms(times[s])}  {flops[s] / 1e9:7.1f} GFLOP  {rate}"
                      + (f"; kernels (ms): {split}" if split else ""), flush=True)
            total = sum(flops.values())
            staged = sum(times.values())
            rate = (f" -> {total / embed / 1e12:.1f} TF/s ({total / embed / peak:.1%} of the "
                    f"data-sheet peak)" if cuda else "")
            print(f"  stages sum: {_common.ms(staged)}; whole embed: {_common.ms(embed)}, "
                  f"{total / 1e9:.1f} GFLOP{rate}", flush=True)
            if cuda:
                sums = {k: sum(sp[k] for sp in splits.values()) for k in next(iter(splits.values()))}
                print("  kernels over the stages (ms): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in sums.items()), flush=True)
            results[name] = dict(stages=times, embed=embed, flops=flops, splits=splits)
            del model, net, stages, x

        print("\nisolated norm + ReLU -> conv -> statistics pass:", flush=True)
        for dtype_name, (dtype, _) in DTYPES.items():
            for h, c in ((hw // 4, 64), (hw // 8, 128), (hw // 16, 256)):
                run, x = _isolated_pass(n, h, c, dtype, device, g)
                t = slope_time(run, x, **kw, what=f"isolated pass {h}x{h}x{c}")
                gf = 2 * n * h * h * 9 * c * c
                rate = f" ({gf / t / 1e12:.1f} TF/s)" if cuda else ""
                print(f"  {dtype_name} {h}x{h}x{c}: {_common.ms(t)}{rate}", flush=True)
                results.setdefault("isolated", {})[f"{dtype_name} {h}x{h}x{c}"] = t
    return results


if __name__ == "__main__":
    main()
