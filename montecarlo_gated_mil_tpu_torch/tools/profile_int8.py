"""The int8 embed's traffic experiments on the card.

Counterpart of the JAX package's ``tools/profile_int8.py``, on the port's
int8 embed (``ops/quantized.py``: cuDNN's bf16 stem conv, then K6 int8
convs, K7 BN statistics and K8 normalize + ReLU + requantize), at its bag
(256 patches at 224 px, r18 with seeded bf16 weights, all valid):

  stem    the stem conv alone, with K7's statistics, and the whole stem two
          ways: pool-fused (K8's ``pool_i8`` mode, the shipped stem, which
          max-pools the raw conv output before it quantizes), and quantize
          then pool (K8's ``i8`` mode, then a 3x3/2 max pool of the int8
          codes, the JAX package's order); the two agree code for code.
          Beside them, the stem conv in the int8 space-to-depth form (K6's
          gather path, ``stem="s2d_i8"``, off on the main path);
  blocks  layers 1 and 2 with every pre-BN conv output ``t`` stored in bf16
          (the shipped store), float8_e4m3fn or int8 with its static scale;
          K6's epilogue writes all three and K7/K8 read all three.  The
          shipped plan narrows a store only where Cout >= 128 (layers 2-4),
          so layer 1's narrow rows are the experiment's alone;
  full    the whole int8 embed by ``conv_store``, then each stage with K7's
          statistics and again with them given (replayed from a first call),
          so the difference is what K7's re-read of each conv output costs
          (ROADMAP queue 2, item 6), beside that re-read's byte bound.

Each row is the chained slope (``utils/profiling.py::slope_time``) and, on
the card, the CUDA-event time behind a sleep kernel (``time_ms``).  The
JAX tool's ``lax.scan`` chain has no counterpart here.

    python -m montecarlo_gated_mil_tpu_torch.tools.profile_int8 [stem|blocks|full|all]
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.ops import quantized as qz
from montecarlo_gated_mil_tpu_torch.tools import _common
from montecarlo_gated_mil_tpu_torch.utils.profiling import PEAK_BYTES, slope_time, time_ms

STORES = ("bf16", "f8", "i8")


def measure(name: str, fn, arg, kw: dict, cuda: bool) -> dict:
    """``fn(arg)`` by the chained slope and, on the card, by events."""
    row = {"slope": slope_time(fn, arg, **kw, what=name)}
    if cuda:
        row["events"] = time_ms(lambda: fn(arg), iters=5, what=name).ms / 1e3
    events = f"events {_common.ms(row['events'])}" if cuda else "events not measured (CPU)"
    print(f"  {name:44s}: slope {_common.ms(row['slope'])}, {events}", flush=True)
    return row


def _model_and_bag(args, device):
    from montecarlo_gated_mil_tpu_torch import bench
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL

    model = bench._seeded(lambda: MultiHeadGatedAttentionMIL(dtype=torch.bfloat16)).to(device)
    patches, mask = bench._workload(args.patches, args.patch, torch.bfloat16, device)
    return model.feature_extractor, patches, mask


def run_stem(net, patches, mask, kw, cuda) -> dict:
    from montecarlo_gated_mil_tpu_torch.ops.quant_kernels import bn_relu_quant

    print("\n== stem: bf16 conv -> K7 statistics -> normalize + ReLU + quantize, 3x3/2 max "
          "pool -> int8 ==", flush=True)
    plan = qz.quantize_backbone_static(net, "r18")
    m = mask.to(torch.float32)
    b1 = plan["layer1_0"]["in_scale"]

    def conv_stats(p):
        t = qz._stem(plan, p)
        return t, *qz._bn_affine(t, None, plan["bn1"], m)

    def quantize_then_pool(p):
        t, se, be = conv_stats(p)
        codes = bn_relu_quant(t, None, se / b1, be / b1, mode="i8")
        pooled = F.max_pool2d(codes.permute(0, 3, 1, 2).to(torch.bfloat16), 3, 2, 1)
        return pooled.to(torch.int8).permute(0, 2, 3, 1)

    def fused(p):
        return qz._stem_quant(plan, p, m)

    rows = {"conv only": measure("stem conv (cuDNN bf16)", lambda p: qz._stem(plan, p),
                                 patches, kw, cuda)}
    rows["conv + stats"] = measure("stem conv + K7 statistics", conv_stats, patches, kw, cuda)
    rows["quantize then pool"] = measure("stem, quantize then pool (K8 i8 + max pool)",
                                         quantize_then_pool, patches, kw, cuda)
    rows["pool-fused"] = measure("stem, pool-fused (K8 pool_i8, shipped)", fused, patches, kw,
                                 cuda)
    ratio = rows["quantize then pool"]["slope"] / rows["pool-fused"]["slope"]
    same = float((fused(patches) == quantize_then_pool(patches)).float().mean())
    print(f"  pool-fused against quantize then pool: {ratio:.2f}x by the slope; codes equal "
          f"{same:.6f}", flush=True)
    s2d = qz.quantize_backbone_static(net, "r18", stem="s2d_i8")
    rows["s2d conv"] = measure("stem conv, s2d int8 (K6 gather path)", lambda p: qz._stem(s2d, p),
                               patches, kw, cuda)
    rows["agreement"] = same
    return rows


@contextlib.contextmanager
def every_conv_stored():
    """Every conv's output in the plan's ``conv_store``, narrow or not
    (the shipped plan keeps Cout < 128 in bf16: ``quantized._store_for``)."""
    shipped = qz._store_for
    qz._store_for = lambda qw, store: store
    try:
        yield
    finally:
        qz._store_for = shipped


def run_blocks(net, mask, kw, cuda, h: int, g) -> dict:
    print("\n== layers 1 and 2 with the pre-BN conv outputs stored bf16 / f8 / i8 ==", flush=True)
    print("  K6's epilogue writes each store itself (bf16, float8_e4m3fn after a clamp to +-448, "
          "int8 at the plan's static scale t), and K7/K8 read each back, so no store is timed "
          "as a plain-PyTorch store-and-reload", flush=True)
    x_q = torch.randint(-127, 128, (mask.shape[0], h, h, 64), generator=g, device=mask.device,
                        dtype=torch.int8)
    rows = {}
    for store in STORES:
        plan = qz.quantize_backbone_static(net, "r18", conv_store=store)
        stages = dict(qz.quantized_stages(plan, mask))
        with every_conv_stored():
            for stage in ("l1", "l2"):
                rows[(stage, store)] = measure(
                    f"layer{stage[1]} t={store}" + (" (shipped)" if store == "bf16" else ""),
                    stages[stage], x_q, kw, cuda)
    for stage in ("l1", "l2"):
        base = rows[(stage, "bf16")]["slope"]
        print(f"  layer{stage[1]}: bf16 / f8 {base / rows[(stage, 'f8')]['slope']:.2f}x, "
              f"bf16 / i8 {base / rows[(stage, 'i8')]['slope']:.2f}x by the slope", flush=True)
    return rows


class _ReplayedStats:
    """``bn_stats`` recorded on one call of a stage, then given back in the
    same order on every later call, with the bytes each launch read."""

    def __init__(self):
        self.kernel = qz.bn_stats
        self.outputs, self.nbytes, self.i = [], 0, 0

    def record(self, t, tq=None):
        out = self.kernel(t, tq)
        self.outputs.append(out)
        self.nbytes += t.numel() * t.element_size()
        return out

    def replay(self, t, tq=None):
        out = self.outputs[self.i % len(self.outputs)]
        self.i += 1
        return out


def run_full(net, patches, mask, kw, cuda) -> dict:
    print("\n== the whole int8 embed by conv_store (the shipped pool-fused stem) ==", flush=True)
    rows = {}
    for store in STORES:
        plan = qz.quantize_backbone_static(net, "r18", conv_store=store)
        rows[store] = measure(f"quantized_embed_static conv_store={store}",
                              lambda p, plan=plan: qz.quantized_embed_static(plan, p, mask),
                              patches, kw, cuda)
    print("\n== K7's re-read of each conv output, by stage (conv_store=bf16) ==", flush=True)
    plan = qz.quantize_backbone_static(net, "r18")
    x = patches
    for stage, run in qz.quantized_stages(plan, mask):
        stats = _ReplayedStats()
        qz.bn_stats = stats.record
        try:
            nxt = run(x)
            qz.bn_stats = stats.kernel
            with_k7 = measure(f"{stage} with K7", run, x, kw, cuda)
            qz.bn_stats = stats.replay
            given = measure(f"{stage} with its statistics given", run, x, kw, cuda)
        finally:
            qz.bn_stats = stats.kernel
        cost = with_k7["slope"] - given["slope"]
        bound = stats.nbytes / PEAK_BYTES
        print(f"  {stage}: K7 costs {_common.ms(cost)} of {_common.ms(with_k7['slope'])} by the "
              f"slope ({len(stats.outputs)} launches re-reading {stats.nbytes / 1e6:.1f} MB; "
              f"that read's byte bound {_common.ms(bound)})", flush=True)
        rows[f"{stage} K7"] = dict(with_k7=with_k7, given=given, cost=cost, bound=bound,
                                   nbytes=stats.nbytes, launches=len(stats.outputs))
        x = nxt
    return rows


def main(argv=None, *, device="cuda") -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("which", nargs="?", default="all", choices=("stem", "blocks", "full", "all"))
    ap.add_argument("--patches", type=int, default=256)
    ap.add_argument("--patch", type=int, default=224)
    _common.slope_args(ap)
    args = ap.parse_args(argv)
    device = _common.start(device)
    cuda = device.type == "cuda"
    kw = dict(ks=args.ks, reps=args.reps)
    results = {}
    with _common.main_path_settings(), torch.no_grad():
        net, patches, mask = _model_and_bag(args, device)
        g = torch.Generator(device=device).manual_seed(1)
        if args.which in ("stem", "all"):
            results["stem"] = run_stem(net, patches, mask, kw, cuda)
        if args.which in ("blocks", "all"):
            results["blocks"] = run_blocks(net, mask, kw, cuda, args.patch // 4, g)
        if args.which in ("full", "all"):
            results["full"] = run_full(net, patches, mask, kw, cuda)
    return results


if __name__ == "__main__":
    main()
