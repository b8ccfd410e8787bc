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
6. holds the backward kernels (K5 separate gates, K4 shared) against their
   plain version and against autograd of the plain forward, dropout off and
   on, and times all three;
7. trains: ``run_training`` on the shipped configuration with 8 full-size
   synthetic mammograms and 2 epochs (train bags at bucket 1024, val/test
   at about 3072), and checks that every train step went through K1 and K5,
   that the losses are finite, the weights moved and the saved best reloads;
8. one full-size training bag from ``BagLoader``: the step's breakdown
   (CUDA events, ``torch.profiler``), two shared-gate steps through K2/K4,
   and a small training step on the card against the CPU plain path;
9. prints the ``kernels`` JSON line, then the result line.

Imports nothing of JAX.  TF32 is off throughout: the shipped configuration
computes in float32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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


def check_mc_head_bwd(name, cfg, n, n_valid, T, seed):
    """One MC-head backward kernel (K4/K5) against its plain version and
    against autograd of the plain forward, at dropout 0 and 0.1/0.1.  The
    cotangent of M is ``dY w_cls``, so both references see the same
    cotangents: ``loss = sum(Y dY) + sum(A dA)``."""
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
        _HEAD_FIELDS,
        GatedAttentionParams,
        _mc_head_bwd_cuda,
        _mc_head_cuda,
        mc_head_backward_reference,
        mc_head_reference,
        param_layout_grads,
    )

    g = torch.Generator().manual_seed(seed)
    model = build_model(cfg, seed=seed)
    params = GatedAttentionParams.from_module(model).to("cuda")
    L, D, C = model.L, model.D, model.num_classes
    G = C if params.separate else 1
    H = (torch.rand(n, L, generator=g) * 2.0).cuda()
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.randperm(n, generator=g)[:n_valid]] = True
    mask = mask.cuda()
    dY = torch.randn(T, C, generator=g).cuda()
    dA = (torch.randn(T, C, n, generator=g) * 0.1).cuda()
    dM = dY[:, :, None] * params.w_cls[None]
    names = ("H",) + _HEAD_FIELDS
    errs = []

    def kernel(p, A):
        dH, *w = _mc_head_bwd_cuda(H, params, T, 17, p, p, A, dM, dA)
        return (dH, *param_layout_grads(params.separate, *w))

    def autograd_ref(p):
        leaves = [H.clone().requires_grad_(True)] + [
            getattr(params, f).clone().requires_grad_(True) for f in _HEAD_FIELDS
        ]
        prm = GatedAttentionParams(*leaves[1:], params.w_cls)
        y, a = mc_head_reference(leaves[0], mask, prm, T, 17, p, p)
        loss = (y * dY).sum() + (a * dA).sum()
        return torch.autograd.grad(loss, leaves)

    for p in (0.0, 0.1):
        _, A = _mc_head_cuda(H, mask, params, T, 17, p, p)
        before = cuda_build.KERNELS[name].launches
        got = kernel(p, A)
        torch.cuda.synchronize()
        if cuda_build.KERNELS[name].launches != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch its kernel")
        again = kernel(p, A)
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        plain = mc_head_backward_reference(H, mask, params, T, 17, p, p, dM, dA)
        auto = autograd_ref(p)
        pad = float(got[0][~mask].abs().max()) if n_valid < n else 0.0
        # Each gradient is held to its own size: 1e-3 of its largest entry,
        # plus a floor of 5e-5 of the largest entry of any of them, which is
        # where f32 rounding leaves db_att: at dropout 0 it is a sum over
        # the bag that cancels to 0.
        floor = 5e-5 * max(float(r.abs().max()) for r in plain)
        worst = 0.0
        print(f"  {name} p={p}: per gradient max|ref|, max|d| against the plain version and "
              "against autograd, tol 1e-3*max|ref| + 5e-5*max over all |ref|:", flush=True)
        for nm, k, r1, r2 in zip(names, got, plain, auto):
            size = float(r1.abs().max())
            tol = 1e-3 * size + floor
            e1, e2 = float((k - r1).abs().max()), float((k - r2).abs().max())
            worst = max(worst, e1, e2)
            print(f"    d{nm:6s} max|ref| {size:.3e}  plain {e1:.3e}  autograd {e2:.3e}  "
                  f"tol {tol:.3e}", flush=True)
            if not (e1 <= tol and e2 <= tol):
                raise RuntimeError(f"{name} p={p}: d{nm} max|d| plain {e1:.3e} autograd "
                                   f"{e2:.3e} (tol {tol:.3e})")
        print(f"  {name} p={p}: padded rows of dH max {pad}; two calls bitwise equal {bitwise}",
              flush=True)
        if pad != 0.0 or not bitwise:
            raise RuntimeError(f"{name} p={p}: padded dH {pad}, bitwise {bitwise}")
        errs.append(worst)
    _, A = _mc_head_cuda(H, mask, params, T, 17, 0.1, 0.1)
    ms = _time_ms(lambda: kernel(0.1, A), iters=10)
    plain_ms = _time_ms(
        lambda: mc_head_backward_reference(H, mask, params, T, 17, 0.1, 0.1, dM, dA), iters=2
    )
    autograd_ms = _time_ms(lambda: autograd_ref(0.1), iters=2)
    # Work this data needs: gate recompute, dH and dW products over the valid
    # rows, plus the row dot and pooling terms.
    flops = T * (3 * 2 * n_valid * L * 2 * G * D + 2 * 2 * n_valid * L * C)
    nbytes = 4 * (2 * n * L + n + 2 * 2 * G * L * D + T * C * (2 * n + L))
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, autograd of plain "
          f"{autograd_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP) "
          f"at N={n} ({n_valid} valid) L={L} D={D} C={C} G={G} T={T}", flush=True)
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

    print("[6] backward kernels against their plain versions (TF32 off)", flush=True)
    rows["mc_head_bwd_sep"] = check_mc_head_bwd("mc_head_bwd_sep", Config(), 1024, 650, 1, seed=5)
    check_mc_head_bwd("mc_head_bwd_sep", Config(), 1024, 650, 4, seed=6)
    rows["mc_head_bwd_shared"] = check_mc_head_bwd(
        "mc_head_bwd_shared", Config(shared_att=True), 256, 200, 1, seed=7
    )

    print("[7] training: run_training(Config(synthetic_count=8, epochs=2)), shipped widths",
          flush=True)
    train_launches = check_run_training()

    print("[8] one full-size training bag: the step's breakdown; the shared-gate step", flush=True)
    shared_train_launches = check_train_bag_paths()
    check_small_train_step_against_cpu()

    launches = dict(
        serve_launches, mc_head_shared=shared_launches,
        mc_head_bwd_sep=train_launches["mc_head_bwd_sep"],
        mc_head_bwd_shared=shared_train_launches["mc_head_bwd_shared"],
    )
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


def check_run_training() -> dict:
    """``run_training`` on the card: the shipped configuration with only
    ``data.synthetic_count``, ``epochs`` and ``model_path`` replaced.
    Returns the launch counts of that run."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.runners import initial_model, run_training
    from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics

    base = Config()
    tp = base.training_plan
    with tempfile.TemporaryDirectory() as tmp:
        cfg = replace(
            base, model_path=tmp, data=replace(base.data, synthetic_count=8),
            training_plan=replace(tp, parameters=replace(tp.parameters, epochs=2)),
        )
        sink = MemorySink()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_training(cfg, Metrics([sink]), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        peak = torch.cuda.max_memory_allocated()
        saved = torch.load(result["best_model_path"], map_location="cuda", weights_only=True)
    steps = sink.values("train/step")
    train_loss, val_loss = sink.values("train/epoch_loss"), sink.values("val/epoch_loss")
    step_ms = float(np.mean([s["ms"] for s in steps[1:]]))
    buckets = sorted({s["bucket"] for s in steps})
    inst = [s["instances"] for s in steps]
    print(f"  train bags: buckets {buckets}, {min(inst)}-{max(inst)} valid tiles; "
          f"{len(steps)} train steps")
    for e, (tl, vl) in enumerate(zip(train_loss, val_loss), 1):
        print(f"  epoch {e}: train loss {tl:.6f}, val loss {vl:.6f}")
    print(f"  test accuracy {result['test_accuracy']:.4f}; {step_ms:.1f} ms per train step "
          f"(CUDA events, mean of steps 2-{len(steps)}; first {steps[0]['ms']:.1f} ms); peak "
          f"memory {peak / 2**30:.2f} GiB; run_training {wall:.1f} s", flush=True)
    print(f"  launches in run_training: K1 mc_head_sep {launches['mc_head_sep']}, K3 "
          f"gather_tiles {launches['gather_tiles']}, K5 mc_head_bwd_sep "
          f"{launches['mc_head_bwd_sep']}", flush=True)
    best = result["best_params"]
    init = initial_model(cfg).state_dict()
    moved = {part: any(not torch.equal(init[k], best[k].cpu()) for k in init
                       if k.startswith("feature_extractor.") == (part == "backbone"))
             for part in ("backbone", "head")}
    reloads = all(torch.equal(saved[k], best[k]) for k in best) and all(
        torch.equal(v, best[k]) for k, v in result["model"].state_dict().items()
    )
    finite = all(np.isfinite(v) for v in train_loss + val_loss)
    print(f"  params moved {moved}; saved best reloads bitwise equal {reloads}; losses "
          f"finite {finite}", flush=True)
    if not (launches["mc_head_bwd_sep"] >= len(steps) and launches["mc_head_sep"] >= len(steps)):
        raise RuntimeError(f"training steps did not all go through K1 and K5: {launches}")
    if not (finite and all(moved.values()) and reloads and len(train_loss) == 2):
        raise RuntimeError("run_training: a loss is not finite, the params did not move, "
                           "or the saved best did not reload")
    return launches


def check_train_bag_paths() -> dict:
    """One full-size training bag from ``BagLoader``: the separate-gate
    step's breakdown (CUDA events, and kernel time by ``torch.profiler``),
    then two shared-gate steps, each through K2 forward and K4 backward.
    Returns the shared-gate steps' launch counts."""
    from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.pipeline import BagLoader
    from montecarlo_gated_mil_tpu_torch.data.synthetic import (
        make_synthetic_reader,
        synthetic_records,
    )
    from montecarlo_gated_mil_tpu_torch.experiment import (
        _pipeline_cfgs,
        build_criterion,
        build_model,
        build_optimizer,
    )
    from montecarlo_gated_mil_tpu_torch.models.gamil import auxiliary_loss
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    cfg = Config()
    train_cfg, _ = _pipeline_cfgs(cfg)
    loader = BagLoader(
        synthetic_records(8, seed=cfg.seed), make_synthetic_reader(cfg.data.H, cfg.data.W),
        train_cfg, seed=cfg.seed, bucket_spec=BucketSpec(cfg.tpu.buckets), device="cuda",
    )
    # The first record whose bag lands in the main path's bucket.
    bag = next(b for b, _ in loader.epoch(1) if b.mask.shape[0] == train_cfg.bucket)
    print(f"  bag: bucket {bag.mask.shape[0]}, {int(bag.mask.sum())} valid 224x224 tiles "
          f"(overlap {train_cfg.overlap}, flips on)", flush=True)

    def trainer(c, seed):
        model = build_model(c, seed=seed).cuda()
        opt, sched = build_optimizer(c, model)
        return model, TrainState(model, opt, sched), make_train_step(
            model, build_criterion(c), opt, 1
        )

    model, state, step = trainer(cfg, 11)
    state, _ = step(state, bag, 1, True)  # warm: cuDNN picks its algorithms
    crit = build_criterion(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    H = model.embed(bag.patches, bag.mask)
    ev[1].record()
    y, a = model.head(H, bag.mask, train=True, seed=2)
    loss = crit(y[None], bag.label[None]) + model.aux_scale * auxiliary_loss(
        a[1], a[0], bag.label == 1
    )
    ev[2].record()
    loss.backward()
    ev[3].record()
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    ev[4].record()
    torch.cuda.synchronize()
    parts = ("embed fwd", "head fwd (K1) + loss", "backward (embed + K5)", "optimizer")
    print("  step breakdown (CUDA events, ms): " + ", ".join(
        f"{n} {ev[i].elapsed_time(ev[i + 1]):.2f}" for i, n in enumerate(parts)
    ), flush=True)
    profile_train_step(state, step, bag)

    cfg2 = Config(shared_att=True)
    _, state2, step2 = trainer(cfg2, 12)
    step2(state2, bag, 2, True)  # warm
    cuda_build.reset_launch_counts()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(2):
        state2, out = step2(state2, bag, 100 + i, True)
    t1.record()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    print(f"  shared gate: 2 steps, {t0.elapsed_time(t1) / 2:.1f} ms per step, loss "
          f"{float(out['loss']):.6f}; launches K2 mc_head_shared {launches['mc_head_shared']}, "
          f"K4 mc_head_bwd_shared {launches['mc_head_bwd_shared']}", flush=True)
    if launches["mc_head_shared"] != 2 or launches["mc_head_bwd_shared"] != 2:
        raise RuntimeError(f"the shared-gate steps did not each launch K2 and K4: {launches}")
    return launches


def profile_train_step(state, step, bag) -> None:
    """Device time of one training step by kernel, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, bag, 3, True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3

    total = sum(dev_ms(e) for e in kernels)
    if total <= 0:
        print("  profiler: no device time recorded; the CUDA events above stand alone")
        return
    k1 = sum(dev_ms(e) for e in kernels if any(
        n in e.key for n in ("mc_logits_kernel", "mc_softmax_kernel", "mc_pool_kernel")))
    k5 = sum(dev_ms(e) for e in kernels if "bwd_" in e.key and "_kernel" in e.key)
    top = sorted(kernels, key=dev_ms, reverse=True)[:6]
    print(f"  profiler, one step: device kernels {total:.2f} ms; K1 {k1:.3f} ms, K5 {k5:.3f} ms "
          f"({100 * (k1 + k5) / total:.2f} %); the rest is the r18 embed forward and backward, "
          "BN and the optimizer", flush=True)
    for e in top:
        print(f"    {dev_ms(e):9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def check_small_train_step_against_cpu() -> None:
    """One training step (SGD, dropout 0.1/0.1, the same seed) of a small
    bag on the card (K1 forward, K5 backward) and on the CPU (plain version
    under autograd): the same Philox bits feed both."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.experiment import (
        build_criterion,
        build_model,
        build_optimizer,
    )
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    cfg = Config()
    g = torch.Generator().manual_seed(13)
    n, hw = 16, 96
    mask = torch.arange(n) < 12
    patches = torch.randn(n, hw, hw, 3, generator=g) * mask[:, None, None, None]
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, seed=9).to(device)
        opt, sched = build_optimizer(cfg, model)
        before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        names = {id(p): k for k, p in model.named_parameters()}
        grads = {}

        def keep_grads(optimizer, args, kwargs, grads=grads, names=names):
            for group in optimizer.param_groups:
                for p in group["params"]:
                    grads[names[id(p)]] = p.grad.detach().cpu().clone()

        opt.register_step_pre_hook(keep_grads)
        state = TrainState(model, opt, sched)
        step = make_train_step(model, build_criterion(cfg), opt, 1)
        bag = Bag(patches.to(device), mask.to(device), torch.tensor(1, device=device),
                  torch.arange(n, device=device))
        state, res = step(state, bag, 77, True)
        updates = {k: p.detach().cpu() - before[k] for k, p in model.named_parameters()}
        out[device] = (float(res["loss"]), grads, updates)
    (loss_k, g_k, u_k), (loss_c, g_c, u_c) = out["cuda"], out["cpu"]
    # Each tensor's gradient and update against its own norm.  The two
    # embeddings differ by f32 rounding (cuDNN and the CPU sum convolutions
    # in different orders, and the batch-statistics backward of a random
    # r18 amplifies it), which sets the limits: a head tensor (from K5)
    # within 3e-3, a backbone tensor within 5e-2; a wrong term of K5 moves
    # them by tens of percent.
    if not (set(g_k) == set(g_c) == set(u_c)):
        raise RuntimeError("the optimizer step did not see every parameter's gradient")
    tol = {"head": 3e-3, "backbone": 5e-2}
    worst = {"head": (0.0, ""), "backbone": (0.0, "")}
    for k in g_c:
        part = "backbone" if k.startswith("feature_extractor.") else "head"
        for a, b in ((g_k[k], g_c[k]), (u_k[k], u_c[k])):
            d = float((a - b).norm())
            worst[part] = max(worst[part], (d and d / float(b.norm()), k))
    print(f"  small train step, card vs CPU plain path (dropout 0.1): |d loss| "
          f"{abs(loss_k - loss_c):.2e} (tol 1e-5); worst |d|/|ref| per tensor over gradients "
          "and updates: " + ", ".join(
              f"{part} {r:.3e} in {k} (tol {tol[part]:g})" for part, (r, k) in worst.items()
          ), flush=True)
    if abs(loss_k - loss_c) > 1e-5 or any(worst[p][0] > tol[p] for p in tol):
        raise RuntimeError("the card's training step disagrees with the CPU plain path")


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
