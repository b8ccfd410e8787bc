"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. the card: refuses to run without CUDA; prints ``nvidia-smi``'s name and
   power limit;
2. builds every hand-written kernel (``csrc/*.cu``, one ``nvcc`` per source,
   all at once) and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, dropout off and on, and times both with CUDA events;
4. serves: ``MCDOPredictor.from_config(Config(), seeded weights)``,
   ``warmup()``, then requests on full-size 7036x2800 synthetic mammograms
   (float and uint16, both lateralities, a repeated seed that must reproduce
   bit for bit), and checks that the requests went through the kernels;
   a small request is held against the CPU plain path;
5. the shared-gate workload of the JAX package's ``bench.py`` (a 256-tile
   224x224 bag, r18, T=30) through ``mc_inference``;
6. prints the ``kernels`` JSON line, then the result line.

Imports nothing of JAX.  TF32 is off throughout: the shipped configuration
computes in float32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

# H100 SXM data-sheet peaks used for the bounds.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 5, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_mc_head(name, cfg, n, n_valid, T, seed):
    """One MC-head kernel against its plain version at dropout 0 and 0.1."""
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
        GatedAttentionParams,
        mc_gated_attention,
        mc_head_reference,
    )

    g = torch.Generator().manual_seed(seed)
    model = build_model(cfg, seed=seed)
    params = GatedAttentionParams.from_module(model).to("cuda")
    L, D, C = model.L, model.D, model.num_classes
    H = (torch.rand(n, L, generator=g) * 2.0).cuda()  # post-ReLU pooled features are >= 0
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.randperm(n, generator=g)[:n_valid]] = True
    mask = mask.cuda()
    tol_y, tol_a = 1e-4, 1e-5
    errs = []
    for p in (0.0, 0.1):
        before = cuda_build.KERNELS[name].launches
        y_k, a_k = mc_gated_attention(H, mask, params, T, 17, p, p)
        torch.cuda.synchronize()
        if cuda_build.KERNELS[name].launches != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch its kernel")
        y_r, a_r = mc_head_reference(H, mask, params, T, 17, p, p)
        ey = float((y_k - y_r).abs().max())
        ea = float((a_k - a_r).abs().max())
        pad = float(a_k[:, :, ~mask].abs().max()) if n_valid < n else 0.0
        sums = float((a_k.sum(-1) - 1).abs().max())
        print(f"  {name} p={p}: max|dY|={ey:.3e} (tol {tol_y:g})  max|dA|={ea:.3e} "
              f"(tol {tol_a:g})  padded max={pad}  max|sum A - 1|={sums:.2e}")
        if not (ey <= tol_y and ea <= tol_a and pad == 0.0 and sums <= 1e-4):
            raise RuntimeError(f"{name} disagrees with its plain version at p={p}")
        errs.append(max(ey, ea))
    ms = _time_ms(lambda: mc_gated_attention(H, mask, params, T, 17, 0.1, 0.1), iters=10)
    plain_ms = _time_ms(lambda: mc_head_reference(H, mask, params, T, 17, 0.1, 0.1), iters=2)
    G = C if params.separate else 1
    # Work this data needs: the gate product and pooling over valid rows.
    flops = T * (2 * n_valid * L * 2 * G * D + 2 * n_valid * D * C + 2 * C * n_valid * L)
    nbytes = 4 * (n * L + n + params.w_V.numel() * 2 + T * C * (n + L))
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}; {flops / 1e9:.2f} GFLOP) at N={n} ({n_valid} valid) L={L} D={D} "
          f"C={C} T={T}")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_gather(image: torch.Tensor, starts: torch.Tensor, p: int):
    from montecarlo_gated_mil_tpu_torch.ops.patching import (
        gather_selected,
        gather_tiles_reference,
    )

    got = gather_selected(image, starts, p)
    want = gather_tiles_reference(image, starts, p)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"  gather_tiles: K={starts.shape[0]} p={p}: max|d|={err} (tol 0, bit-exact)")
    if not torch.equal(got, want):
        raise RuntimeError("gather_tiles disagrees with its plain version")
    ms = _time_ms(lambda: gather_selected(image, starts, p), iters=20)
    plain_ms = _time_ms(lambda: gather_tiles_reference(image, starts, p), iters=5)
    nbytes = 2 * starts.shape[0] * p * p * 4 + starts.numel() * 8
    bound_ms, bound_by = _bound(0, nbytes)
    print(f"  gather_tiles: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {nbytes / 1e9:.3f} GB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops.patching import compute_tile_grid
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_line()
    print(f"[1] card: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"[2] built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s", flush=True)

    print("[3] kernels against their plain versions (TF32 off)", flush=True)
    rows = {}
    rows["mc_head_sep"] = check_mc_head("mc_head_sep", Config(), 3072, 2400, 50, seed=1)
    rows["mc_head_shared"] = check_mc_head(
        "mc_head_shared", Config(shared_att=True), 256, 256, 30, seed=2
    )
    cfg = Config()
    d = cfg.data
    grid = compute_tile_grid(d.H, d.W, d.patch_size, d.overlap_val_test)
    g = torch.Generator().manual_seed(3)
    image = torch.from_numpy(synthetic_image(d.H, d.W, positive=True, seed=0)).cuda()
    starts = torch.from_numpy(grid.tiles_array()[:, :2]).long()
    starts = starts[torch.randperm(grid.num_tiles, generator=g)[:3072]].cuda()
    rows["gather_tiles"] = check_gather(image, starts, d.patch_size)

    u16 = np.random.default_rng(0).integers(0, 65536, (d.H, d.W), dtype=np.uint16)
    on_card = torch.from_numpy(u16).cuda().to(torch.float32).cpu().numpy()
    if not np.array_equal(on_card, u16.astype(np.float32)):
        raise RuntimeError("uint16 pixels did not survive upload and conversion on the card")
    print("  uint16 upload + conversion on the card: exact", flush=True)

    print("[4] serving: MCDOPredictor.from_config(Config(), seeded weights)", flush=True)
    weights = build_model(cfg, seed=0).state_dict()
    pred = MCDOPredictor.from_config(cfg, weights)
    t0 = time.perf_counter()
    pred.warmup()
    print(f"  warmup: {time.perf_counter() - t0:.1f} s", flush=True)
    requests = [
        ("float", "L", 0, 100),
        ("uint16", "R", 1, 101),
        ("float", "R", 2, 102),
        ("uint16", "L", 3, 103),
        ("float", "L", 0, 100),  # repeat of the first: must reproduce bit for bit
    ]
    cuda_build.reset_launch_counts()
    results = []
    for kind, lat, img_seed, seed in requests:
        img = synthetic_image(d.H, d.W, positive=bool(img_seed % 2), seed=img_seed)
        if kind == "uint16":
            img = np.round(img * 65535).astype(np.uint16)
        t0 = time.perf_counter()
        r = pred.predict(img, lat, seed=seed)
        ms = (time.perf_counter() - t0) * 1e3
        results.append(r)
        att, n = r.attention.mean, r.num_instances
        stats = [getattr(r.stats, f) for f in vars(r.stats)]
        finite = all(bool(torch.isfinite(s).all()) for s in stats) and bool(
            torch.isfinite(att).all() and torch.isfinite(r.attention.std).all()
        )
        sums = float((att[:, :n].sum(-1) - 1).abs().max())
        pad = float(att[:, n:].abs().max()) if n < att.shape[1] else 0.0
        print(f"  request {kind:6s} {lat} image {img_seed} seed {seed}: bucket {r.bucket} "
              f"num_instances {n} prediction {r.prediction} P(pos) "
              f"{float(r.stats.mean):.4f}±{float(r.stats.std):.4f} entropy "
              f"{float(r.stats.mean_entropy):.4f}  {ms:.1f} ms", flush=True)
        if not (finite and sums <= 1e-4 and pad == 0.0 and n > 0):
            raise RuntimeError(f"bad request result: finite={finite} sum={sums} pad={pad} n={n}")
    first, again = results[0], results[-1]
    if not (torch.equal(first.stats.mean_probs, again.stats.mean_probs)
            and torch.equal(first.attention.mean, again.attention.mean)):
        raise RuntimeError("a repeated seed did not reproduce its result bit for bit")
    serve_launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    print(f"  launches over {len(requests)} requests: {serve_launches}", flush=True)
    if serve_launches["mc_head_sep"] < len(requests) or serve_launches["gather_tiles"] < len(requests):
        raise RuntimeError("the served requests did not go through the kernels")
    request_breakdown(pred, d)
    check_small_request_against_cpu()

    print("[5] shared-gate workload (256x224 bag, r18, T=30) through mc_inference", flush=True)
    cfg2 = Config(shared_att=True)
    model2 = build_model(cfg2, seed=4).cuda().eval()
    patches = torch.randn(256, 224, 224, 3, generator=g).cuda()
    mask2 = torch.ones(256, dtype=torch.bool, device="cuda")
    mc_inference(model2, patches, mask2, 30, 0)  # warm
    cuda_build.reset_launch_counts()
    bench_ms = _time_ms(lambda: mc_inference(model2, patches, mask2, 30, 0), iters=5, warm=0)
    shared_launches = cuda_build.KERNELS["mc_head_shared"].launches
    print(f"  mc_inference: {bench_ms:.2f} ms per bag; mc_head_shared launches {shared_launches}")
    if shared_launches < 1:
        raise RuntimeError("the shared-gate workload did not go through its kernel")

    launches = dict(serve_launches, mc_head_shared=shared_launches)
    kernels = []
    for k in cuda_build.KERNELS.values():
        kernels.append(dict(
            name=k.name, route="cuda", source=f"montecarlo_gated_mil_tpu_torch/csrc/{k.source}",
            replaces=k.replaces, launches=launches[k.name], **rows[k.name],
        ))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def request_breakdown(pred, d, reps: int = 3) -> None:
    """Where one request's time goes, stage by stage, by CUDA events around
    each stage of ``MCDOPredictor`` (image 2, right laterality, bucket 3072)."""
    from montecarlo_gated_mil_tpu_torch.data.pipeline import image_to_bag
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import (
        attention_stats,
        mc_head,
        predictive_stats,
    )
    from montecarlo_gated_mil_tpu_torch.serve import _prepare_image

    img = synthetic_image(d.H, d.W, positive=False, seed=2)
    names = ("upload", "image_to_bag", "embed", "mc_head", "stats")
    totals = dict.fromkeys(("host_prep",) + names, 0.0)
    for _ in range(reps):
        t0 = time.perf_counter()
        arr, inv_max = _prepare_image(img, None)
        bucket = pred._pick_bucket(arr, "R")
        totals["host_prep"] += (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        with torch.inference_mode():
            torch.cuda.synchronize()
            ev[0].record()
            dev = pred._upload(arr)
            ev[1].record()
            image = dev.to(torch.float32) * inv_max
            bag = image_to_bag(image, True, 0, pred._starts,
                               replace(pred.pipeline, bucket=bucket), device="cuda")
            ev[2].record()
            H = pred.model.embed(bag.patches, bag.mask)
            ev[3].record()
            out = mc_head(pred.model, H, bag.mask, pred.num_samples, 0, pred._head_params)
            ev[4].record()
            predictive_stats(out.predictions), attention_stats(out.attention, bag.mask)
            ev[5].record()
            torch.cuda.synchronize()
        for i, n in enumerate(names):
            totals[n] += ev[i].elapsed_time(ev[i + 1])
    parts = ", ".join(f"{k} {v / reps:.2f}" for k, v in totals.items())
    device_ms = sum(totals[n] for n in names) / reps
    print(f"  breakdown at bucket {bucket} (ms, mean of {reps}): {parts}; "
          f"device stages total {device_ms:.2f}", flush=True)


def check_small_request_against_cpu() -> None:
    """A small request with dropout on, served on the card (kernels) and on
    the CPU (plain versions): the same Philox bits feed both."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.pipeline import PipelineConfig
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    pipe = PipelineConfig(height=256, width=256, patch_size=64, overlap=0.5,
                          empty_threshold=0.3, bucket=16)
    img = synthetic_image(256, 256, positive=True, seed=5)
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(Config(), seed=9)
        out[device] = MCDOPredictor(model, pipe, num_samples=8, device=device).predict(
            img, "R", seed=4
        )
    a, b = out["cuda"], out["cpu"]
    err = max(float((a.stats.mean_probs - b.stats.mean_probs).abs().max()),
              float((a.attention.mean - b.attention.mean).abs().max()))
    print(f"  small request, card vs CPU plain path (dropout 0.1): max|d|={err:.2e} (tol 1e-4), "
          f"{a.num_instances} instances", flush=True)
    if a.num_instances != b.num_instances or err > 1e-4:
        raise RuntimeError("the card's request path disagrees with the CPU plain path")


if __name__ == "__main__":
    sys.exit(main())
