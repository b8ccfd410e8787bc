"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. the card: refuses to run without CUDA; prints ``nvidia-smi``'s name and
   power limit;
2. builds every hand-written kernel (``csrc/*.cu``, one ``nvcc`` per source,
   all at once) and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, dropout off and on, and times both with CUDA events;
   K1 at four shapes: (a) N=3072, 2400 valid at random positions, T=50,
   beside a ``torch.matmul`` of its dense gate product as a yardstick;
   (b) the same with the valid rows first, as serving lays a bag out;
   (c) training's N=1024, 650 valid first, T=1; (d) the extended bucket
   N=6144, 4800 valid first, T=50; K3 at 3072 and at 6144 starts.  Each
   prints the kernel time, its tensor-core (3xTF32) bound, its FP32-core
   bound and both shares, and holds the forward's logits against an f64
   product;
4. serves: ``MCDOPredictor.from_config(Config(), seeded weights)``,
   ``warmup()``, then requests on full-size 7036x2800 synthetic mammograms
   (float and uint16, both lateralities, a repeated seed that must reproduce
   bit for bit), and checks that the requests went through the kernels;
   a small request is held against the CPU plain path; the first request
   again through ``MCDOPredictor(use_pallas=False)`` (the plain head on the
   card): no K1/K2 launch, its statistics within 1e-4 and attention within
   1e-5 of the kernel predictor's, both predictors' ms;
4f. the f32 embed's masked BN (``ops/float_bn.py``) at bucket 3072, 2400
   valid instances: K9 at every distinct (shape, epilogue) one r18 request
   launches (``K9_SHAPES``), bit for bit against the plain chain, and K7 in
   f32 at every shape (``K7_SHAPES``, all 20 of a request) against float64
   sums; each timed beside its byte bound and the plain chain, then the
   per-request sums weighted by launches;
4b. the serving front-ends on full-size mammograms written as ``.npy``:
   ``serve_jsonl`` through phase 4's predictor (with a malformed line and a
   missing file), ``cli.main(["serve", ...])`` with a YAML of ``Config()``,
   and the HTTP server (``make_server``) with four concurrent clients, a
   path outside its data root and two maps requests (``map_downsample`` 8
   and 1); every result must equal the direct ``predict`` bit for bit, and
   the maps request's memory above a plain request stays under 2 GiB;
4q. the int8 serving path: K6 (int8 conv) at every distinct conv shape of
   r18 at N=3072 for each conv store, bit for bit against its plain version
   on 256 instances (on all 3072 at layer 1's 3x3, the shape launched
   most), timed beside its plain version (bf16 store) and beside
   ``torch._int_mm`` and a cuDNN bf16 conv as yardsticks; at every conv
   but the s2d stem's, K6 with K7's BN sums in
   its epilogue (``qconv_stats``, the main path's call): its store bit for
   bit the plain version's, its sums within 1e-6 of K7's plain version, the
   fold of its partials bit for bit the fold's plain version, and its time
   beside K6 alone and the fold alone; K7/K8 (BN statistics, normalize +
   requantize) at every distinct shape, mode and residual of one request
   (K7 still runs for the stem alone), with the per-request sums weighted
   by launches and K6 + K7 (+ fold) a request both ways; then
   ``MCDOPredictor.from_config`` with ``tpu.quantized_inference`` serving phase 4's five requests beside their
   float results (a profile of one int8 embed shows each of its 19 convs
   on the wgmma kernel ``QCONV_PATH`` names: 9 on the paired kernel; K7
   once, for the stem, and the fold 14 times),
   ``cli serve`` on a quantized YAML, and a small
   quantized request held against the CPU plain path;
5. the shared-gate workload of the JAX package's ``bench.py`` (a 256-tile
   224x224 bag, r18, T=30) through ``mc_inference``;
6. holds the backward kernels (K5 separate gates, K4 shared) against their
   plain version and against autograd of the plain forward, dropout off and
   on, and their products against the f64 plain version, and times all
   three; K5 also at 3 classes (N=3072, T=1) and at 8 (N=4500, T=9), where
   its dH block walks the depth in chunks;
7. trains: ``run_training`` on the shipped configuration with 8 full-size
   synthetic mammograms and 1 epoch (train bags at bucket 1024, val/test
   at about 3072), and checks that every train step went through K1 and K5,
   that the losses are finite, the weights moved and the saved best reloads;
8. one full-size training bag from ``BagLoader``: the step's breakdown
   (CUDA events, ``torch.profiler``), two shared-gate steps through K2/K4,
   and a small training step on the card against the CPU plain path, at 2
   and at 3 classes;
9. the bench: each K6-K8 launch of ``bench.run_bench``'s int8 embed (256
   patches at 224 px) against its plain version, the bf16 float embed's
   statistics dtype and a few of its patches against the CPU, then
   ``bench.run_bench_both()`` (int8 headline, bf16 float path, bf16 train
   step), its JSON record printed on its own line and its launches counted
   (K6-K8 per int8 bag, K2 per bag and train step, K4 per train step); then
   ``cli bench`` on a YAML with ``tpu.use_pallas_attention: false`` (bf16,
   T=3), which launches no head kernel;
10. cross-validation at the shipped configuration's widths: ``cli cv``,
   ``cli cv-eval --ensemble`` and ``cli cv --resume`` after a crash in fold
   2, cut to 2 folds of 10 synthetic records and 1 epoch: the manifest,
   accuracies, K1 launched for every train, val and test bag, K5 for every
   train step, fold 1 reused and fold 2 retrained on resume, and the
   ensemble's peak memory on one test bag;
11. DICOM and ``infer``: four full-size 7036x2800 16-bit DICOM files (a
   CC+MLO pair per side, uncompressed and RLE Lossless) written here and
   read exactly through the port's native reader; their records
   (``select_records``) through ``BagLoader`` with two read workers, each
   CC+MLO bag equal bit for bit to the bag of the same pixels given as
   arrays, then ``mc_inference`` at T=50 (K3 and K1 once per bag); ``cli
   infer`` per fold and ``--ensemble`` on phase 10's models (K1 once per
   fold or member and item, the maps and statistics checked, the
   ensemble's peak one member's), the figures drawn where matplotlib
   imports; and a small ``run_inference`` item on the card against the
   CPU;
12. the rest of the model surface at ``Config()``'s widths: (a) the
   single-head ``GatedAttentionMIL`` (K=1, one class, seeded weights) on
   phase 4's first full-size mammogram, ``image_to_bag`` (K3) then
   ``mc_inference_single_head`` at T=50 (plain head, sigmoid inside), its
   stages by CUDA events and its peak, and a small bag on the card against
   the CPU with dropout on; (b) ``mc_inference_serial`` at T=50 on the
   shipped model beside ``mc_inference`` (50 K1 launches, bit-equal or
   within K1's tolerances), with ``targets``; (c) causal counterfactual
   dropout at T=50; (d) ``train_epoch_plain``: 4 SGD steps of the
   single-head model on full-size training bags at bucket 1024; (e) the
   uncertainty acceptance (``evaluation/uncertainty.py``) trained and
   checked on the card; (f) (d)'s metrics through ``TensorBoardSink`` where
   ``torch.utils.tensorboard`` imports;
13. the parallel paths (``parallel/``) on meshes of repeated ``cuda:0``
   entries: (a) phase 4's full-size requests through a predictor with an
   ``inst`` mesh of 2 and of 4 (instance-sharded embed and head), each
   against the whole-bag ``predict`` of the same seed (statistics 1e-4,
   attention 1e-5), with ms and peak beside the whole bag's; (b)
   ``mc_test_dp`` on a ``data`` mesh of 4 over ten bags of mixed buckets,
   one oversized, in f32 and int8, labels and MC logits equal to the
   sequential ``mc_test``'s bag for bag; (c) ``predict_many(dp=True)`` on a
   ``data`` mesh of 2 over phase 4b's four requests, equal to ``predict``
   bit for bit; (d) the member-sharded ensemble of phase 10's two fold
   models against the sequential one (2e-5).  A repeated-device mesh
   checks the arithmetic and the launches, not transfers between cards;
14. parallel training at ``Config()``'s widths, cuDNN deterministic, on
   meshes of repeated ``cuda:0``: (a) ``train_epoch_dp`` on a ``data`` mesh
   of 2 over five bags at buckets 256-1024 (a padded partial group, one
   update at epoch end) against ``train_epoch`` (final weights within 2e-5),
   ms per bag and peaks; (b) one oversized training bag at bucket 2048 (phase
   4's first mammogram) through ``make_train_step_sharded`` at ``inst`` 2 and
   4 against the whole-bag ``make_train_step`` (loss rtol 1e-4, gradients
   rtol 2e-3 / atol 2e-5), and through ``make_train_step(use_pallas=False)``
   (the plain head: no K1/K5 launch, within the same limits of the kernel
   step); (c) the training-memory guard: a bucket-3072 bag on the
   single-device route raises before its step, 2048 does not, (b)'s
   whole-bag peak stays under the guard's estimate, and at every backbone
   and compute dtype the config accepts (r18, r34, r50 x f32, bf16, f64)
   the whole-bag step's peak at buckets 256, 512 and, where it fits, 1024
   (f64: 128 and 256; ``tools/measure_hbm.py::train_peaks``) stays under
   the estimate for the model trained; (d) phase 7's
   ``run_training`` with ``tpu.async_checkpointing``: its checkpoints load
   equal to a synchronous run's, and a resume from them writes the next one
   again equal; (e) ``cli cv`` with phase 10's config fanned out over two
   processes on a ``gloo`` group, each manifest's fold accuracies equal to
   phase 10's.  K1, K3 and K5 are counted around each path;
15. the measurement tools (``montecarlo_gated_mil_tpu_torch/tools``) at
   full width, each once through its ``main``: first ``slope_time`` of K1
   (a) against phase 3's event time (10 %), and of K1 (c) beside the
   carry's own slope; then ``profile_embed`` (the f32 stages must sum to
   within 15 % of the whole embed), ``profile_train`` (its kernel tables
   must time every hand-written kernel the step launched), ``measure_train``,
   ``measure_fullscale``, ``measure_serving`` (10 requests, then a 10 s HTTP
   soak at concurrency 1 and 4 with no failed request: a check that the
   server answers, too short for its tails), ``measure_hbm`` at
   buckets 256, 1024 and 2048 (the memory guard's estimate at or above each
   training-step peak), ``profile_int8_attrib`` and ``probe_build_phases``,
   with K1-K8 counted around them;
16. (a) one f32 training step of the shipped model at bucket 1024 in a
   process of its own with TF32 at PyTorch's defaults: its gradients within
   phase 14's limits (rtol 2e-3, atol 2e-5) of an f64 step of the same
   weights, bag and dropout, printed beside those of the same loss
   back-propagated outside ``exact_float_grads`` (TF32 backward
   convolutions, as before that repair), and its ms per step beside phase
   7's; (b) each kernel of the ``kernels`` line beside the one PyTorch call
   that computes its function (K3: an index of the image's unfolded
   windows, at 3072 and at 6144 starts; K6: cuDNN's bf16 conv at each 3x3
   shape, ``torch._int_mm`` at each 1x1/2; K7: ``torch.var_mean`` at every
   shape, beside what the same sums cost in K6's epilogue; the fold:
   ``part.sum(dim=1)``), or the reason none does, which fills
   ``library_ms``; (c) ``tools/validate_uncertainty.py`` at seed 0
   (the figure where matplotlib imports), whose fit and uncertainty ratios
   must pass; (d) ``tools/profile_int8.py all`` at 256 patches of 224 px,
   whose two stems must agree code for code; (e) ``tools/fuzz_dicom.py``
   with 100 trials a seed under ASan and UBSan, which must find no fault
   (or, where the compiler cannot build with sanitizers, its refusal on a
   line of its own);
17. prints each phase's seconds, the ``kernels`` JSON line, the total
   seconds, the card's line and the result line.

The timers and profiler readers are ``montecarlo_gated_mil_tpu_torch/utils/
profiling.py``'s, loaded from its file.  Every timed call prints three
numbers (``profiling.time_ms``): its device time, the back-to-back time of
the timer of earlier versions of this script, and the host's time to queue
it.  ``python3 chip_smoke.py --heads-from DIR`` only
times the MC head kernels (K1, K2, K4, K5) of the port found under DIR,
another checkout such as the parent commit or ``.``, at phases 3 and 6's
shapes and inputs with this script's timer, and prints them as one JSON
line with SHA-256 digests of the backward kernels' outputs (a shape the
tree's K5 refuses is listed as refused): run it for both trees on one
card, one after the other, to compare them.  ``python3 chip_smoke.py
--kernels-from DIR`` does the same for the int8 embed's kernels: K6 at
every ``QCONV_SHAPES`` shape (and, where the tree has it, K6 with K7's
sums and the fold), K7 and K8 at every ``K7_SHAPES``/``K8_SHAPES`` launch,
with each kernel's per-request sum, K6 + K7 (+ fold) a request as the
tree's int8 path runs them, and SHA-256 digests of every output and of a
seeded int8 embed, which two bit-exact trees share.

Imports nothing of JAX.  TF32 is off throughout (phase 16 (a)'s process
apart): the shipped configuration computes in float32.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import tempfile
import time
import warnings
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _load_profiling():
    """This checkout's ``utils/profiling.py``, loaded from its file: the
    timers and profiler readers of every phase.  By path, not through the
    package, so that ``--heads-from`` and ``--kernels-from`` can import
    another tree's port package and still time it with this script's
    timer."""
    import importlib.util

    path = Path(__file__).resolve().parent / "montecarlo_gated_mil_tpu_torch/utils/profiling.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_profiling", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


profiling = _load_profiling()
device_line, kernel_table, peak_gib, time_ms = (
    profiling.device_line, profiling.kernel_table, profiling.peak_gib, profiling.time_ms)
# H100 SXM data-sheet peaks used for the bounds.
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS = profiling.PEAK_FP32_FLOPS, profiling.PEAK_TF32_FLOPS
PEAK_INT8_OPS, PEAK_BYTES = profiling.PEAK_INT8_OPS, profiling.PEAK_BYTES
# Limits against f64 (tests/test_torch_tf32_split.py shows on the CPU that
# 3xTF32 meets them and plain TF32 fails them; A and Y alone cannot tell).
LOGITS_VS_F64 = 5e-6  # max |logit - exact logit| on the valid rows
PRODUCTS_VS_F64 = 1e-5  # max |d - exact| / max |exact| of dH, dw_V, dw_U

# The MC head shapes of phase 3 (forward) and phase 6 (backward): label,
# kernel, shared gate, N, valid rows, where they lie, T, seed (and for the
# backward the classes, each with its own gate where the gates are
# separate).  The first of each kernel gives its row of the ``kernels``
# line.  K5 at 3 classes (the JAX package's 3-class model at the shipped
# widths) and at 8 (K1's limit) needs the dH block's chunked depth.
HEAD_SHAPES = (
    ("K1 (a)", "mc_head_sep", False, 3072, 2400, "random", 50, 1),
    ("K1 (b)", "mc_head_sep", False, 3072, 2400, "first", 50, 1),
    ("K1 (c)", "mc_head_sep", False, 1024, 650, "first", 1, 1),
    ("K1 (d)", "mc_head_sep", False, 6144, 4800, "first", 50, 1),  # the extended bucket
    ("K2", "mc_head_shared", True, 256, 256, "random", 30, 2),
)
BWD_SHAPES = (
    ("K5 T=1", "mc_head_bwd_sep", False, 1024, 650, "random", 1, 5, 2),
    ("K5 T=4", "mc_head_bwd_sep", False, 1024, 650, "random", 4, 6, 2),
    ("K5 C=3", "mc_head_bwd_sep", False, 3072, 2400, "random", 1, 8, 3),
    ("K5 C=8 T=9", "mc_head_bwd_sep", False, 4500, 3000, "random", 9, 9, 8),
    ("K4", "mc_head_bwd_shared", True, 256, 200, "random", 1, 7, 2),
)


def _bound(nbytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` and doing ``work``, given as
    (FLOP, peak FLOP/s) pairs whose times add: the larger of the two."""
    t_ops = sum(flops / peak for flops, peak in work) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bounds(products: float, rest: float, nbytes: float) -> dict:
    """The tensor-core bound (3xTF32: three TF32 products, the rest on the
    FP32 cores) and, for continuity with the FP32 kernels, the FP32-core
    bound of the same work."""
    bound_ms, bound_by = _bound(nbytes, (3 * products, PEAK_TF32_FLOPS), (rest, PEAK_FP32_FLOPS))
    fp32_ms, _ = _bound(nbytes, (products + rest, PEAK_FP32_FLOPS))
    return dict(bound_ms=bound_ms, bound_by=bound_by, fp32_bound_ms=fp32_ms)


def _bag_mask(n: int, n_valid: int, layout: str, g: torch.Generator) -> torch.Tensor:
    """Valid rows at random positions, or first (as serving lays a bag out)."""
    mask = torch.zeros(n, dtype=torch.bool)
    if layout == "first":
        mask[:n_valid] = True
    else:
        mask[torch.randperm(n, generator=g)[:n_valid]] = True
    return mask


def _head_inputs(shared: bool, n: int, n_valid: int, layout: str, seed: int, classes: int = 2):
    """Seeded head weights at the shipped widths (``classes`` classes),
    ``H (n, L)`` in [0, 2) (as post-ReLU pooled features are) and the mask;
    the generator goes on to draw the backward's cotangents."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams

    g = torch.Generator().manual_seed(seed)
    model = build_model(Config(shared_att=shared), classes, seed=seed)
    params = GatedAttentionParams.from_module(model).to("cuda")
    H = (torch.rand(n, model.L, generator=g) * 2.0).cuda()
    mask = _bag_mask(n, n_valid, layout, g).cuda()
    return model, params, H, mask, g


def _cotangents(model, params, n: int, T: int, g: torch.Generator):
    """``dY (T, C)``, ``dA (T, C, n)`` and the cotangent of M, ``dY w_cls``."""
    C = model.num_classes
    dY = torch.randn(T, C, generator=g).cuda()
    dA = (torch.randn(T, C, n, generator=g) * 0.1).cuda()
    return dY, dA, dY[:, :, None] * params.w_cls[None]


def check_mc_head(name, shared, n, n_valid, layout, T, seed):
    """One MC-head kernel against its plain version at dropout 0 and 0.1,
    and its logits against the f64 plain version."""
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
        _mc_head_cuda,
        mc_gated_attention,
        mc_head_logits_reference,
        mc_head_reference,
    )

    model, params, H, mask, _ = _head_inputs(shared, n, n_valid, layout, seed)
    L, D, C = model.L, model.D, model.num_classes
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
    _, _, logits = _mc_head_cuda(H, mask, params, T, 17, 0.1, 0.1, keep_logits=True)
    exact = mc_head_logits_reference(H.double(), params.to(dtype=torch.float64), T, 17, 0.1, 0.1)
    e64 = float((logits.double() - exact)[:, :, mask].abs().max())
    print(f"  {name} p=0.1: logits against f64 on the valid rows max|d|={e64:.3e} (limit "
          f"{LOGITS_VS_F64:g}; plain TF32 products would give about 2e-4)", flush=True)
    if e64 > LOGITS_VS_F64:
        raise RuntimeError(f"{name}: logits {e64:.3e} from f64, over {LOGITS_VS_F64:g}")
    ms = time_ms(lambda: mc_gated_attention(H, mask, params, T, 17, 0.1, 0.1), iters=10,
                  what=name)
    plain_ms = time_ms(lambda: mc_head_reference(H, mask, params, T, 17, 0.1, 0.1), iters=2,
                        what="plain version").ms
    G = C if params.separate else 1
    # Work this data needs: the gate product (the tensor-core part) over the
    # valid rows; the wa dot and pooling.
    products = T * 2 * n_valid * L * 2 * G * D
    rest = T * (2 * n_valid * D * C + 2 * C * n_valid * L)
    nbytes = 4 * (n * L + n + params.w_V.numel() * 2 + T * C * (n + L))
    b = _bounds(products, rest, nbytes)
    print(f"  {name}: kernel {ms}; plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms "
          f"on the tensor cores ({b['bound_by']}; share {b['bound_ms'] / ms.ms:.1%}), "
          f"{b['fp32_bound_ms']:.4f} ms on the FP32 cores (share "
          f"{b['fp32_bound_ms'] / ms.ms:.1%}); {(products + rest) / 1e9:.2f} GFLOP at N={n} "
          f"({n_valid} valid, {layout}) L={L} D={D} C={C} T={T}", flush=True)
    table = kernel_table(lambda: mc_gated_attention(H, mask, params, T, 17, 0.1, 0.1), calls=5)
    print("    by device function (ms per call, profiler): " + ", ".join(
        f"{f} {ms:.4f}" for f, ms in table.functions("mc_head.cu").items()), flush=True)
    return dict(max_abs_err=max(errs), ms=ms.ms, plain_ms=plain_ms, library_ms=None, **b)


def matmul_yardstick(m: int, k: int, n: int) -> None:
    """The dense gate product alone as one ``torch.matmul`` in f32 (TF32
    off): a yardstick for K1 (a), not the same function (no dropout, no
    gates, no softmax or pooling), so it is no ``library_ms``."""
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(m, k, device="cuda", generator=g)
    b = torch.rand(k, n, device="cuda", generator=g)
    ms = time_ms(lambda: torch.matmul(a, b), iters=10).ms
    tflops = 2 * m * k * n / ms / 1e9
    print(f"  yardstick: torch.matmul ({m} x {k}) @ ({k} x {n}) f32, TF32 off: {ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s)", flush=True)


def check_mc_head_bwd(name, shared, n, n_valid, layout, T, seed, classes=2):
    """One MC-head backward kernel (K4/K5) against its plain version and
    against autograd of the plain forward, at dropout 0 and 0.1/0.1, and
    its products against the f64 plain version.  The cotangent of M is
    ``dY w_cls``, so both references see the same cotangents:
    ``loss = sum(Y dY) + sum(A dA)``."""
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

    model, params, H, mask, g = _head_inputs(shared, n, n_valid, layout, seed, classes)
    L, D, C = model.L, model.D, model.num_classes
    G = C if params.separate else 1
    dY, dA, dM = _cotangents(model, params, n, T, g)
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
    exact = mc_head_backward_reference(H.double(), mask, params.to(dtype=torch.float64), T, 17,
                                       0.1, 0.1, dM.double(), dA.double())
    rel = {nm: float((k.double() - r).abs().max() / r.abs().max())
           for nm, k, r in zip(names, got, exact) if nm in ("H", "w_V", "w_U")}
    print(f"  {name} p=0.1: products against f64, max|d|/max|ref|: " + ", ".join(
        f"d{nm} {r:.3e}" for nm, r in rel.items()) + f" (limit {PRODUCTS_VS_F64:g}; plain TF32 "
        "products would give 1e-4 and more)", flush=True)
    if max(rel.values()) > PRODUCTS_VS_F64:
        raise RuntimeError(f"{name}: products against f64 {rel}, over {PRODUCTS_VS_F64:g}")
    _, A = _mc_head_cuda(H, mask, params, T, 17, 0.1, 0.1)
    ms = time_ms(lambda: kernel(0.1, A), iters=10, what=name)
    plain_ms = time_ms(
        lambda: mc_head_backward_reference(H, mask, params, T, 17, 0.1, 0.1, dM, dA), iters=2,
        what="plain version",
    ).ms
    autograd_ms = time_ms(lambda: autograd_ref(0.1), iters=2,
                           what="autograd of the plain version").ms
    # Work this data needs: gate recompute, dH and dW products over the valid
    # rows (the tensor-core part), plus the row dot and pooling terms.
    products = T * 3 * 2 * n_valid * L * 2 * G * D
    rest = T * 2 * 2 * n_valid * L * C
    nbytes = 4 * (2 * n * L + n + 2 * 2 * G * L * D + T * C * (2 * n + L))
    b = _bounds(products, rest, nbytes)
    print(f"  {name}: kernel {ms}; plain {plain_ms:.3f} ms, autograd of plain "
          f"{autograd_ms:.3f} ms; bound {b['bound_ms']:.4f} ms on the tensor cores "
          f"({b['bound_by']}; share {b['bound_ms'] / ms.ms:.1%}), {b['fp32_bound_ms']:.4f} ms on "
          f"the FP32 cores (share {b['fp32_bound_ms'] / ms.ms:.1%}); "
          f"{(products + rest) / 1e9:.2f} GFLOP at N={n} ({n_valid} valid) L={L} D={D} C={C} "
          f"G={G} T={T}", flush=True)
    table = kernel_table(lambda: kernel(0.1, A), calls=5)
    print("    by device function (ms per call, profiler): " + ", ".join(
        f"{f} {ms:.4f}" for f, ms in table.functions("mc_head_bwd.cu").items()), flush=True)
    return dict(max_abs_err=max(errs), ms=ms.ms, plain_ms=plain_ms, library_ms=None, **b)


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
    ms = time_ms(lambda: gather_selected(image, starts, p), iters=20)
    plain_ms = time_ms(lambda: gather_tiles_reference(image, starts, p), iters=5).ms
    nbytes = 2 * starts.shape[0] * p * p * 4 + starts.numel() * 8
    bound_ms, bound_by = _bound(nbytes)
    print(f"  gather_tiles: kernel {ms}; plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}; {nbytes / 1e9:.3f} GB)")
    return dict(max_abs_err=err, ms=ms.ms, plain_ms=plain_ms, bound_ms=bound_ms,
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

    t_start = time.perf_counter()
    marks = [("1-2", t_start)]  # each phase's start, for its seconds

    def header(phase: str, text: str) -> None:
        marks.append((phase, time.perf_counter()))
        print(f"[{phase}] {text}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = device_line("cuda")
    print(f"[1] card: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"[2] built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s", flush=True)

    header("3", "kernels against their plain versions (TF32 off)")
    rows = {}
    for label, name, shared, n, n_valid, layout, T, seed in HEAD_SHAPES:
        print(f"  {label}: N={n}, {n_valid} valid ({layout}), T={T}", flush=True)
        row = check_mc_head(name, shared, n, n_valid, layout, T, seed)
        rows.setdefault(name, row)
        if label == "K1 (a)":
            matmul_yardstick(2400 * 50, 512, 512)
    cfg = Config()
    d = cfg.data
    grid = compute_tile_grid(d.H, d.W, d.patch_size, d.overlap_val_test)
    g = torch.Generator().manual_seed(3)
    image = torch.from_numpy(synthetic_image(d.H, d.W, positive=True, seed=0)).cuda()
    starts = torch.from_numpy(grid.tiles_array()[:, :2]).long()
    starts = starts[torch.randperm(grid.num_tiles, generator=g)[:3072]].cuda()
    rows["gather_tiles"] = check_gather(image, starts, d.patch_size)
    # The extended bucket: starts drawn with repeats, as many as an oversized bag holds.
    starts = torch.from_numpy(grid.tiles_array()[:, :2]).long()
    check_gather(image, starts[torch.randint(grid.num_tiles, (6144,), generator=g)].cuda(),
                 d.patch_size)

    u16 = np.random.default_rng(0).integers(0, 65536, (d.H, d.W), dtype=np.uint16)
    on_card = torch.from_numpy(u16).cuda().to(torch.float32).cpu().numpy()
    if not np.array_equal(on_card, u16.astype(np.float32)):
        raise RuntimeError("uint16 pixels did not survive upload and conversion on the card")
    print("  uint16 upload + conversion on the card: exact", flush=True)

    header("4", "serving: MCDOPredictor.from_config(Config(), seeded weights)")
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
    check_plain_head_request(pred, cfg, weights, requests[0], first)

    header("4f", "the f32 embed's masked BN: K9 and K7 in f32 at bucket 3072's shapes")
    rows["bn_apply"] = check_float_bn()

    header("4b", "serving front-ends: serve_jsonl, cli serve, HTTP server (full-size requests)")
    front_launches = check_front_ends(pred, d)

    header("4q", "int8 serving path: K6-K8, then quantized requests at full width")
    quant_launches = check_quantized(rows, pred, weights, results, requests, d)

    header("5", "shared-gate workload (256x224 bag, r18, T=30) through mc_inference")
    cfg2 = Config(shared_att=True)
    model2 = build_model(cfg2, seed=4).cuda().eval()
    patches = torch.randn(256, 224, 224, 3, generator=g).cuda()
    mask2 = torch.ones(256, dtype=torch.bool, device="cuda")
    mc_inference(model2, patches, mask2, 30, 0)  # warm
    cuda_build.reset_launch_counts()
    bench_ms = time_ms(lambda: mc_inference(model2, patches, mask2, 30, 0), iters=5, warm=0).ms
    shared_launches = cuda_build.KERNELS["mc_head_shared"].launches
    print(f"  mc_inference: {bench_ms:.2f} ms per bag; mc_head_shared launches {shared_launches}")
    if shared_launches < 1:
        raise RuntimeError("the shared-gate workload did not go through its kernel")

    header("6", "backward kernels against their plain versions (TF32 off)")
    for label, name, shared, n, n_valid, layout, T, seed, classes in BWD_SHAPES:
        print(f"  {label}: N={n}, {n_valid} valid ({layout}), T={T}, {classes} classes",
              flush=True)
        rows.setdefault(name, check_mc_head_bwd(name, shared, n, n_valid, layout, T, seed,
                                                classes))

    header("7", "training: run_training(Config(synthetic_count=8, epochs=1)), shipped widths")
    train_launches, phase7_ms = check_run_training()

    header("8", "one full-size training bag: the step's breakdown; the shared-gate step")
    shared_train_launches = check_train_bag_paths()
    check_small_train_step_against_cpu()
    check_small_train_step_against_cpu(3, head_floor=5e-5)

    header("9", "bench: run_bench_both() at the JAX package's workload (256x224 bag, r18, T=30)")
    bench_launches = check_bench()

    header("10", "cross-validation: cli cv, cv-eval --ensemble, cv --resume at Config()'s widths")
    with tempfile.TemporaryDirectory() as cv_tmp:
        cv_launches, cv_cfg, cv_peak = check_cv(cv_tmp)
        header("11", "DICOM and infer: full-size DICOM files, DICOM bags, cli infer per fold and "
               "--ensemble")
        infer_launches = check_dicom_and_infer(cv_cfg, cv_peak)
        members, member_bag = phase10_members(cv_cfg)
        cv_accuracies = json.loads(
            Path(cv_cfg.model_path, "cv_manifest.json").read_text())["all_fold_accuracies"]

    header("12", "the model surface: the single-head request, serial MC, counterfactual dropout, "
           "train_epoch_plain, the uncertainty acceptance, the TensorBoard sink")
    surface_launches = check_model_surface(pred, d)

    header("13", "parallel paths on the card: instance-sharded requests, mc_test_dp, "
           "predict_many(dp=True), the member-sharded ensemble (meshes of repeated cuda:0)")
    parallel_launches = check_parallel_paths(pred, weights, requests, d, members, member_bag)
    del members, member_bag
    torch.cuda.empty_cache()

    header("14", "parallel training on the card: train_epoch_dp, the sharded training step of an "
           "oversized bag, the memory guard, async checkpoints, cli cv over two processes")
    training_launches = check_parallel_training(cv_cfg, cv_accuracies)
    torch.cuda.empty_cache()

    header("15", "the measurement tools at full width: profile_embed, profile_train, "
           "measure_train, measure_fullscale, measure_serving, measure_hbm, "
           "profile_int8_attrib, probe_build_phases")
    tool_launches = check_tools(rows["mc_head_sep"]["ms"])

    header("16", "the exact f32 backward under PyTorch's default TF32 flags, the kernels' library "
           "calls, validate_uncertainty, profile_int8, fuzz_dicom")
    exact_launches = check_exact_step(phase7_ms)
    check_library_calls(rows, d)
    with tempfile.TemporaryDirectory() as tool_tmp:
        new_tool_launches = check_new_tools(tool_tmp)

    # Serving kernels: phase 4's direct requests, phase 4b's front-ends and
    # phase 4q's quantized requests; then the bench's, CV's and infer's runs
    # and phases 12-16's paths.
    launches = dict(
        {k: n + front_launches.get(k, 0) + quant_launches.get(k, 0)
         for k, n in serve_launches.items()},
        mc_head_shared=shared_launches,
        mc_head_bwd_sep=train_launches["mc_head_bwd_sep"],
        mc_head_bwd_shared=shared_train_launches["mc_head_bwd_shared"],
    )
    launches = {k: n + bench_launches[k] + cv_launches[k] + infer_launches[k]
                + surface_launches[k] + parallel_launches[k] + training_launches[k]
                + tool_launches[k] + exact_launches[k] + new_tool_launches[k]
                for k, n in launches.items()}
    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in cuda_build.KERNELS.values():
        kernels.append(dict(
            name=k.name, route="cuda", source=f"montecarlo_gated_mil_tpu_torch/csrc/{k.source}",
            replaces=k.replaces, launches=launches[k.name], **{x: rows[k.name][x] for x in keys},
        ))
    t_end = time.perf_counter()
    print("phase seconds: " + ", ".join(
        f"{phase} {end - start:.1f}"
        for (phase, start), end in zip(marks, [t for _, t in marks[1:]] + [t_end])), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {t_end - t_start:.1f} s in all", flush=True)
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# The plain head against K1 on one request: the statistics and the attention
# within K1's limits against its plain version (phase 3; PERF.md section 2).
PLAIN_STATS_TOL, PLAIN_ATTN_TOL = 1e-4, 1e-5


def check_plain_head_request(pred, cfg, weights, request, want) -> None:
    """Phase 4's first request through ``MCDOPredictor(use_pallas=False)``,
    which runs the plain head (``mc_head_reference``, full f32) on the card:
    no K1 or K2 launch, K3 as before, and its statistics and attention
    within K1's limits of phase 4's kernel predictor's result ``want`` (same
    image and seed).  Both predictors' ms are printed (host clock, after one
    warm request each)."""
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    d = cfg.data
    kind, lat, img_seed, seed = request
    img = synthetic_image(d.H, d.W, positive=bool(img_seed % 2), seed=img_seed)
    plain = MCDOPredictor.from_config(cfg, weights, use_pallas=False)
    ms = {}
    for name, p in (("kernel", pred), ("plain", plain)):
        p.predict(img, lat, seed=seed)  # warm
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        r = p.predict(img, lat, seed=seed)
        ms[name] = (time.perf_counter() - t0) * 1e3
        launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        if name == "plain":
            got, plain_launches = r, launches
    se = max(float((getattr(got.stats, f) - getattr(want.stats, f)).abs().max())
             for f in vars(want.stats))
    ae = max(float((got.attention.mean - want.attention.mean).abs().max()),
             float((got.attention.std - want.attention.std).abs().max()))
    head = {k: plain_launches[k] for k in ("mc_head_sep", "mc_head_shared")}
    print(f"  plain head (MCDOPredictor(use_pallas=False)), request {kind} {lat} image "
          f"{img_seed} seed {seed}: {ms['plain']:.1f} ms against the kernel predictor's "
          f"{ms['kernel']:.1f} ms; bucket {got.bucket}; max |d statistics| {se:.3e} (<= "
          f"{PLAIN_STATS_TOL}), max |d attention| {ae:.3e} (<= {PLAIN_ATTN_TOL}); launches "
          f"K1/K2 {head}, K3 {plain_launches['gather_tiles']}", flush=True)
    if (any(head.values()) or plain_launches["gather_tiles"] != 1 or got.bucket != want.bucket
            or got.num_instances != want.num_instances or got.prediction != want.prediction
            or not se <= PLAIN_STATS_TOL or not ae <= PLAIN_ATTN_TOL):
        raise RuntimeError(f"plain head request: launches {plain_launches}, statistics {se}, "
                           f"attention {ae}, bucket {got.bucket}/{want.bucket}")
    del plain
    torch.cuda.empty_cache()


def check_run_training() -> tuple[dict, float]:
    """``run_training`` on the card: the shipped configuration with only
    ``data.synthetic_count``, ``epochs`` and ``model_path`` replaced.
    Returns the launch counts of that run and its ms per train step."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.runners import initial_model, run_training
    from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics

    base = Config()
    tp = base.training_plan
    with tempfile.TemporaryDirectory() as tmp:
        cfg = replace(
            base, model_path=tmp, data=replace(base.data, synthetic_count=8),
            training_plan=replace(tp, parameters=replace(tp.parameters, epochs=1)),
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
    if not (finite and all(moved.values()) and reloads and len(train_loss) == 1):
        raise RuntimeError("run_training: a loss is not finite, the params did not move, "
                           "or the saved best did not reload")
    return launches, step_ms


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
    """Device time of one training step by kernel (``kernel_table``).  K1
    and K5 are found by the device functions ``cuda_build`` lists for their
    sources; either reading 0 ms in a step that launched it fails."""
    table = kernel_table(lambda: step(state, bag, 3, True))
    table.check_launched()
    k1, k5 = (sum(table.functions(src).values()) for src in ("mc_head.cu", "mc_head_bwd.cu"))
    total = table.total_ms
    print(f"  profiler, one step: device kernels {total:.2f} ms; K1 {k1:.3f} ms, K5 {k5:.3f} ms "
          f"({100 * (k1 + k5) / total:.2f} %); the rest is the r18 embed forward and backward, "
          "BN and the optimizer", flush=True)
    print(table.lines(6), flush=True)


def check_small_train_step_against_cpu(classes: int = 2, head_floor: float = 0.0) -> None:
    """One training step (SGD, dropout 0.1/0.1, the same seed) of a small
    bag of the last class on the card (K1 forward, K5 backward) and on the
    CPU (plain version under autograd), for a model of ``classes`` classes
    with a gate each: the same Philox bits feed both.  ``head_floor``, a
    share of the largest head gradient's (or update's) norm, is allowed
    each head tensor's gradient (or update) beside its relative limit: an
    attention bias's gradient is a sum over the bag that cancels, and with
    three classes it can sit at f32 rounding (K5's own limits add 5e-5 of
    the largest gradient for the same reason)."""
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
        model = build_model(cfg, classes, seed=9).to(device)
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
        bag = Bag(patches.to(device), mask.to(device), torch.tensor(classes - 1, device=device),
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
    head = [k for k in g_c if not k.startswith("feature_extractor.")]
    floors = [head_floor * max(float(x[k].norm()) for k in head) for x in (g_c, u_c)]
    for k in g_c:
        part = "backbone" if k.startswith("feature_extractor.") else "head"
        for (a, b), floor in zip(((g_k[k], g_c[k]), (u_k[k], u_c[k])), floors):
            d = max(0.0, float((a - b).norm()) - (floor if part == "head" else 0.0))
            worst[part] = max(worst[part], (d and d / float(b.norm()), k))
    print(f"  small train step, {classes} classes, card vs CPU plain path (dropout 0.1): |d loss| "
          f"{abs(loss_k - loss_c):.2e} (tol 1e-5); worst |d|/|ref| per tensor over gradients "
          "and updates: " + ", ".join(
              f"{part} {r:.3e} in {k} (tol {tol[part]:g})" for part, (r, k) in worst.items()
          ), flush=True)
    if abs(loss_k - loss_c) > 1e-5 or any(worst[p][0] > tol[p] for p in tol):
        raise RuntimeError("the card's training step disagrees with the CPU plain path")


def request_breakdown(pred, d, reps: int = 3) -> None:
    """Where one request's time goes, stage by stage, by CUDA events around
    each stage of ``MCDOPredictor`` (image 2, right laterality, bucket 3072);
    the embed is the predictor's own, f32 or int8."""
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
            H = pred._embed(bag.patches, bag.mask)
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
    print(f"  breakdown at bucket {bucket} (ms, mean of {reps}; embed "
          f"{'int8' if pred.quantized else 'f32'}): {parts}; device stages total {device_ms:.2f}",
          flush=True)


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


MAPS_EXTRA_LIMIT = 2 * 2**30  # a (T, C, H, W) map stack alone would be 7.9 GB


def _http(port: int, method: str, path: str, body: dict | None = None) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, data, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def check_front_ends(pred, d) -> dict:
    """Phase 4b: the front-ends a user calls, on full-size mammograms
    written as ``.npy`` (float and uint16, both lateralities).  JSONL and
    HTTP go through phase 4's warm predictor, the CLI through its own.
    Every result record must equal the record of a direct ``predict`` of
    the same image and seed, bit for bit.  Returns the launch counts over
    the phase, which must cover every request scored."""
    import io
    import threading

    import yaml

    from montecarlo_gated_mil_tpu_torch import cli
    from montecarlo_gated_mil_tpu_torch.core.config import Config, config_to_dict
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.serve import _prepare_image
    from montecarlo_gated_mil_tpu_torch.server import (
        build_predictor,
        make_server,
        result_to_dict,
        serve_jsonl,
    )
    from montecarlo_gated_mil_tpu_torch.viz.attention import _box_mean, attention_map_stats

    def record(p, req, **kw):
        r = p.predict(np.load(req["image"]), req["laterality"], seed=req["seed"], **kw)
        return result_to_dict(r)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        reqs = []
        for kind, lat, img_seed, seed in (("float", "L", 10, 200), ("uint16", "R", 11, 201),
                                          ("float", "R", 12, 202), ("uint16", "L", 13, 203)):
            img = synthetic_image(d.H, d.W, positive=bool(img_seed % 2), seed=img_seed)
            if kind == "uint16":
                img = np.round(img * 65535).astype(np.uint16)
            np.save(tmp / f"scan_{img_seed}.npy", img)
            reqs.append({"image": str(tmp / f"scan_{img_seed}.npy"), "laterality": lat,
                         "seed": seed})
        cuda_build.reset_launch_counts()
        want = [record(pred, r) for r in reqs]
        scored = len(reqs)

        # JSONL, in-process: a malformed line and a missing file among them.
        lines = [json.dumps(r) for r in reqs]
        lines.insert(2, "{not json")
        lines.append(json.dumps({"image": str(tmp / "missing.npy"), "seed": 1}))
        out = io.StringIO()
        t0 = time.perf_counter()
        n = serve_jsonl(pred, io.StringIO("\n".join(lines) + "\n"), out)
        jsonl_s = time.perf_counter() - t0
        got = [json.loads(line) for line in out.getvalue().splitlines()]
        scored += len(reqs)
        errors = [i for i, g in enumerate(got) if set(g) == {"error"}]
        same = [g == w for g, w in zip([got[i] for i in (0, 1, 3, 4)], want)]
        print(f"  JSONL: {n} lines in {jsonl_s:.2f} s; error lines at {errors} (expected [2, 5]); "
              f"records equal to the direct predict bit for bit (prediction, p_mean, mean_probs "
              f"and every other key): {same}", flush=True)
        if n != 6 or errors != [2, 5] or not all(same):
            raise RuntimeError("serve_jsonl: wrong error lines, or a record differs from predict")

        # CLI: cli.main serve on a YAML of Config(), its own predictor.
        cfg_path = tmp / "config.yml"
        cfg_path.write_text(yaml.safe_dump(config_to_dict(Config())))
        (tmp / "cli.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs[:2]))
        t0 = time.perf_counter()
        rc = cli.main(["serve", "--config", str(cfg_path), "--input", str(tmp / "cli.jsonl"),
                       "--output", str(tmp / "cli_out.jsonl")])
        cli_s = time.perf_counter() - t0
        cli_got = [json.loads(line) for line in (tmp / "cli_out.jsonl").read_text().splitlines()]
        scored += 2
        ref = build_predictor(Config())
        cli_same = [g == record(ref, r) for g, r in zip(cli_got, reqs)]
        del ref
        print(f"  CLI: cli.main serve exit {rc}, {len(cli_got)} result lines in {cli_s:.1f} s "
              f"(model build, warmup, 2 requests); equal to build_predictor(Config()).predict "
              f"bit for bit: {cli_same}", flush=True)
        if rc != 0 or len(cli_got) != 2 or not all(cli_same):
            raise RuntimeError("cli serve: non-zero exit, wrong line count or a differing record")

        # HTTP: concurrent clients by image_path, confinement, map artifacts.
        srv = make_server(pred, port=0, data_root=str(tmp), maps_dir=str(tmp / "maps"))
        port = srv.server_address[1]
        server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
        server_thread.start()
        try:
            status, health = _http(port, "GET", "/healthz")
            print(f"  HTTP: GET /healthz {status} {health}", flush=True)
            if status != 200 or health.get("status") != "ok":
                raise RuntimeError("HTTP /healthz failed")

            def body(i, **kw):
                r = reqs[i]
                return {"image_path": r["image"], "laterality": r["laterality"],
                        "seed": r["seed"], **kw}

            answers, failures = {}, []

            def client(ci):
                try:
                    for j in range(2):
                        i = (ci + j) % len(reqs)
                        answers[(ci, j)] = (i, *_http(port, "POST", "/predict", body(i)))
                except Exception as e:  # noqa: BLE001 — reported by the main thread
                    failures.append(f"client {ci}: {type(e).__name__}: {e}")

            clients = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
            t0 = time.perf_counter()
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            burst_s = time.perf_counter() - t0
            scored += 2 * len(clients)
            exact = [s == 200 and p == want[i] for i, s, p in answers.values()]
            print(f"  HTTP: 4 client threads x 2 requests in {burst_s:.2f} s; each equal to the "
                  f"direct predict bit for bit: {exact}", flush=True)
            if failures or any(c.is_alive() for c in clients) or len(exact) != 8 or not all(exact):
                raise RuntimeError(f"HTTP concurrent requests failed: {failures}")

            status, err = _http(port, "POST", "/predict",
                                {"image_path": str(tmp / ".." / "outside.npy")})
            print(f"  HTTP: image_path outside the data root: {status} {err}", flush=True)
            if status != 400:
                raise RuntimeError("HTTP served an image_path outside its data root")

            http_ms, direct_ms = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                status, payload = _http(port, "POST", "/predict", body(0))
                http_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                direct = record(pred, reqs[0])
                direct_ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200 or payload != direct:
                    raise RuntimeError("a serial HTTP request differs from the direct predict")
            scored += 6
            print("  latency, host clock, image 10 (float, L, bucket "
                  f"{pred._pick_bucket(np.load(reqs[0]['image']), 'L')}): HTTP "
                  + ", ".join(f"{t:.1f}" for t in http_ms) + " ms; direct predict "
                  + ", ".join(f"{t:.1f}" for t in direct_ms) + " ms", flush=True)

            maps, maps_ms = {}, {}
            for k in (8, 1):
                t0 = time.perf_counter()
                status, payload = _http(port, "POST", "/predict",
                                        body(1, maps=True, map_downsample=k))
                maps_ms[k] = (time.perf_counter() - t0) * 1e3
                if status != 200:
                    raise RuntimeError(f"HTTP maps request k={k}: {status} {payload}")
                stats_same = {key: v for key, v in payload.items() if "maps" not in key} == want[1]
                maps[k] = [np.load(payload[f"attention_{s}_maps"]) for s in ("mean", "std")]
                if not stats_same:
                    raise RuntimeError(f"HTTP maps request k={k}: statistics differ from predict")
            scored += 2
        finally:
            srv.shutdown()
            srv.server_close()
            server_thread.join(timeout=60)
        shapes = {k: [m.shape for m in v] for k, v in maps.items()}
        box_err = [float(np.abs(_box_mean(torch.from_numpy(full), 8).numpy() - small).max())
                   for full, small in zip(maps[1], maps[8])]
        peaks = [float(m.max()) for v in maps.values() for m in v]
        print(f"  maps (image 11, uint16, R): shapes {shapes}; host 8-fold box mean of the k=1 "
              f"maps against the k=8 maps: max|d| mean {box_err[0]:.2e}, std {box_err[1]:.2e} "
              f"(tol 1e-6); max of each map {[round(p, 6) for p in peaks]} (<= 1); HTTP request "
              f"k=8 {maps_ms[8]:.1f} ms, k=1 {maps_ms[1]:.1f} ms (.npy writes included)",
              flush=True)
        if (shapes[8] != [(2, -(-d.H // 8), -(-d.W // 8))] * 2 or shapes[1] != [(2, d.H, d.W)] * 2
                or max(box_err) > 1e-6 or max(peaks) > 1.0):
            raise RuntimeError("maps: wrong shape, box mean off, or a map above 1")

        # The maps request's time and memory above a plain one (direct predict).
        img1 = np.load(reqs[1]["image"])
        cost = {}
        for label, kw in (("plain", {}), ("maps k=8", dict(return_maps=True, map_downsample=8)),
                          ("maps k=1", dict(return_maps=True))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            pred.predict(img1, "R", seed=reqs[1]["seed"], **kw)
            cost[label] = ((time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() - base)
        scored += 3
        # The maps stage alone, on the attention of the same request.
        with torch.inference_mode():
            arr, inv_max = _prepare_image(img1, None)
            bucket1 = pred._pick_bucket(arr, "R")
            bag, _, a, _, _ = pred._infer(pred._upload(arr), True, reqs[1]["seed"], inv_max,
                                          bucket1)
            stage = {}
            for k in (8, 1):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = attention_map_stats(a, bag.tile_indices, bag.mask, pred._grid, downsample=k)
                ev[1].record()
                torch.cuda.synchronize()
                stage[k] = (ev[0].elapsed_time(ev[1]), torch.cuda.max_memory_allocated() - base)
                del out
            del bag, a
        extra = {k: cost[k][1] - cost["plain"][1] for k in ("maps k=8", "maps k=1")}
        print("  direct predict (host clock, peak device memory above the request's start): "
              + "; ".join(f"{k} {ms:.1f} ms, {b / 2**30:.3f} GiB" for k, (ms, b) in cost.items())
              + "; maps above plain: " + ", ".join(
                  f"{k} +{cost[k][0] - cost['plain'][0]:.1f} ms, {extra[k] / 2**30:+.3f} GiB"
                  for k in extra) + f" (limit {MAPS_EXTRA_LIMIT / 2**30:.0f} GiB)", flush=True)
        print(f"  attention_map_stats alone at bucket {bucket1}, T="
              f"{pred.num_samples}: " + ", ".join(
                  f"k={k} {ms:.3f} ms (CUDA events around the call, its host work "
                  f"included), {b / 2**20:.1f} MiB peak"
                  for k, (ms, b) in stage.items()), flush=True)
        if max(extra.values()) > MAPS_EXTRA_LIMIT or max(b for _, b in stage.values()) > MAPS_EXTRA_LIMIT:
            raise RuntimeError("maps: more than 2 GiB of device memory above a plain request")

    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    print(f"  launches over the phase: K1 mc_head_sep {launches['mc_head_sep']}, K3 gather_tiles "
          f"{launches['gather_tiles']} ({scored} requests scored, plus the CLI's warmup and "
          f"the maps stage's own request); phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if launches["mc_head_sep"] < scored or launches["gather_tiles"] < scored:
        raise RuntimeError("the front-ends' requests did not all go through K1 and K3")
    return launches


# r18's int8 convs at 224x224 patches: label, H, W, Cin, Cout, k, stride,
# padding (top, bottom, left, right), launches per request.  The s2d stem is
# the ``stem="s2d_i8"`` option, off on the main path.
QCONV_SHAPES = (
    ("layer1 3x3", 56, 56, 64, 64, 3, 1, (1, 1, 1, 1), 4),
    ("layer2 3x3/2", 56, 56, 64, 128, 3, 2, (1, 1, 1, 1), 1),
    ("layer2 1x1/2", 56, 56, 64, 128, 1, 2, (0, 0, 0, 0), 1),
    ("layer2 3x3", 28, 28, 128, 128, 3, 1, (1, 1, 1, 1), 3),
    ("layer3 3x3/2", 28, 28, 128, 256, 3, 2, (1, 1, 1, 1), 1),
    ("layer3 1x1/2", 28, 28, 128, 256, 1, 2, (0, 0, 0, 0), 1),
    ("layer3 3x3", 14, 14, 256, 256, 3, 1, (1, 1, 1, 1), 3),
    ("layer4 3x3/2", 14, 14, 256, 512, 3, 2, (1, 1, 1, 1), 1),
    ("layer4 1x1/2", 14, 14, 256, 512, 1, 2, (0, 0, 0, 0), 1),
    ("layer4 3x3", 7, 7, 512, 512, 3, 1, (1, 1, 1, 1), 3),
    ("stem s2d 4x4", 112, 112, 12, 64, 4, 1, (2, 1, 2, 1), 0),
)
# The device function of K6 each shape runs on the main path (``qconv_i8``
# picks it): the paired kernel where the column tile is 256 channels and the
# weights do not stay resident in one block; the gather kernel for the s2d
# stem, which the main path does not launch.
QCONV_PATH = {label: "qconv_wgmma_kernel" for label, *_ in QCONV_SHAPES}
QCONV_PATH.update({label: "qconv_wgmma_pair_kernel" for label in (
    "layer3 3x3/2", "layer3 3x3", "layer4 3x3/2", "layer4 1x1/2", "layer4 3x3")})
QCONV_PATH["stem s2d 4x4"] = "qconv_gather_kernel"
QUANT_N = 3072  # instances: the bucket of a full-size request
QUANT_CHECK_N = 256  # instances held bit for bit against the plain version
K8_FLIP_LIMIT = 1e-5  # share of K8's codes allowed one off
SUMS_LIMIT = 1e-6  # K7's sums, standalone or in K6's epilogue, against the plain version
FOLD_ROW = "layer3 3x3"  # the shape of the fold's row of the ``kernels`` line


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _map_tiles(h: int, w: int, k: int, stride: int, pad) -> int:
    """8 x 8 tiles of one instance's output map (``quant_kernels.sum_tiles``
    of ``conv_out_hw``), worked out here: this module imports nothing of the
    port when it loads, so that ``--kernels-from`` can import another
    tree's."""
    top, bottom, left, right = pad
    oh, ow = (h + top + bottom - k) // stride + 1, (w + left + right - k) // stride + 1
    return -(-oh // 8) * -(-ow // 8)


# Launches per request of the fold of K7's sums: every conv whose map is
# more than one 8 x 8 tile (all but layer 4's five).
FOLDS_PER_REQUEST = sum(per for _, h, w, _, _, k, stride, pad, per in QCONV_SHAPES
                        if per and _map_tiles(h, w, k, stride, pad) > 1)


def _int8(shape, g) -> torch.Tensor:
    return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)


def _pixels_read(h: int, w: int, k: int, stride: int, pad) -> int:
    """Input pixels of one instance that a k x k conv's taps read: a 1x1/2
    conv reads one pixel in four, a 3x3/2 with padding 1 reads them all."""
    top, bottom, left, right = pad

    def axis(size, lo, hi):
        out = (size + lo + hi - k) // stride + 1
        return len({o * stride + t - lo for o in range(out) for t in range(k)} & set(range(size)))

    return axis(h, top, bottom) * axis(w, left, right)


def check_fused_sums(label, a, wt, scale, stride, pad, k6_ms: float, rows: dict | None) -> float:
    """K6 with K7's sums at QUANT_N, bf16 store: timed beside K6 alone
    (``k6_ms``); the fold alone on the kernel's own partials, bit for bit
    against its plain version and timed, with its byte bound (the partials
    read once, the f32 sums written once).  At FOLD_ROW fills ``rows``'
    fold row (its library call is timed in phase 16 (b)).  Returns the ms
    of K6 with the sums (the fold included)."""
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk

    n, cout = a.shape[0], wt.shape[0]
    fused = time_ms(lambda: qk.qconv_stats(a, wt, scale, stride, pad, "bf16"), iters=5,
                    what=f"K6 with sums {label}")
    _, part, run, _, _ = qk._qconv_cuda(a, wt, scale, stride, pad, "bf16", sums=True)
    line = (f"  K6 with K7's sums {label}, N={n} bf16: {fused}; K6 alone {k6_ms:.4f} ms; the "
            f"sums cost {fused.ms - k6_ms:.4f} ms")
    if part is None:
        print(line + " (one tile a map: no fold)", flush=True)
        return fused.ms
    got = qk.bn_stats_fold(part, run)
    want = qk.bn_stats_fold_reference(part, run)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"the fold at {label}: differs from its plain version")
    fold = time_ms(lambda: qk.bn_stats_fold(part, run), iters=10, what=f"fold {label}")
    plain = time_ms(lambda: qk.bn_stats_fold_reference(part, run), iters=2,
                    what="plain fold").ms
    ends = int(qk.run_ends(n, part.shape[1], run).sum())
    bound, by = _bound(ends * cout * 16 + 2 * n * cout * 4)
    print(line + f", of which the fold {fold.ms:.4f} ms ({part.shape[1]} tiles an instance, runs "
          f"of {run}, {ends * cout * 16 / 1e6:.1f} MB of partials; bit for bit against its plain "
          f"version, {plain:.3f} ms; bound {bound:.4f} ms ({by}), share "
          f"{bound / fold.ms:.1%})", flush=True)
    if rows is not None and label == FOLD_ROW:
        rows["bn_stats_fold"] = dict(max_abs_err=0.0, ms=fold.ms, plain_ms=plain, bound_ms=bound,
                                     bound_by=by, library_ms=None)
    return fused.ms


def check_qconv(label, h, w, cin, cout, k, stride, pad, g, full: bool = False,
                rows: dict | None = None) -> dict:
    """K6 at one r18 conv shape, for each store: bit for bit against the
    plain version (exact f64 accumulators) on QUANT_CHECK_N instances, or
    with ``full`` on all QUANT_N; timed at QUANT_N beside its int8
    tensor-core and byte bounds and its plain version (for every store with
    ``full``, else for bf16).  Then K6
    with K7's sums in its epilogue (``qconv_stats``, the main path's call)
    on the same inputs: its store equal to the plain version's
    bit for bit, its sums within SUMS_LIMIT of ``bn_stats_reference``, the
    fold of its partials equal to the fold's plain version bit for bit;
    timed at QUANT_N (bf16) beside K6 alone and the fold alone (at
    FOLD_ROW the fold's row of the ``kernels`` line goes into ``rows``).
    Then two yardsticks that the port never calls."""
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk

    import torch.nn.functional as F

    n = QUANT_N
    n_check = n if full else QUANT_CHECK_N
    a = _int8((n, h, w, cin), g)
    wt = _int8((cout, k, k, cin), g)
    K = k * k * cin
    std_acc = K**0.5 * 127**2 / 3  # of a sum of K products of uniform codes
    oh, ow = qk.conv_out_hw(h, w, k, k, stride, pad)
    m = n * oh * ow
    ops = 2.0 * m * cout * K
    sums = qk._wgmma_takes(cin, k, k, stride, h, w)  # the s2d stem's conv (gather) takes none
    out = {}
    for store in ("bf16", "f8", "i8"):
        scale = torch.rand(cout, generator=g, device="cuda") + 0.5
        scale = scale * ((40.0 if store == "i8" else 2.0) / std_acc)
        tq = torch.rand(cout, generator=g, device="cuda") * 0.05 + 0.01 if store == "i8" else None
        got = qk.qconv(a[:n_check], wt, scale, stride, pad, store)
        want = qk.qconv_reference(a[:n_check], wt, scale, stride, pad, store)
        torch.cuda.synchronize()
        exact = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        spread = float(got.float().abs().max())
        if not exact:
            err = float((got.float() - want.float()).abs().max())
            raise RuntimeError(f"K6 {label} {store}: differs from its plain version (max|d| {err})")
        if sums:  # K6 with K7's sums: the same store, and the sums
            fused, s1, s2 = qk.qconv_stats(a[:n_check], wt, scale, stride, pad, store, tq)
            r1, r2 = qk.bn_stats_reference(want, tq)
            torch.cuda.synchronize()
            same = torch.equal(fused.view(torch.uint8), want.view(torch.uint8))
            sums_err = max(_rel(s1, r1), _rel(s2, r2))
            print(f"  K6 with K7's sums {label} store {store}, {n_check} instances: store bit "
                  f"for bit {same}; sums max|d| / max|plain| {sums_err:.2e} (limit "
                  f"{SUMS_LIMIT:g})", flush=True)
            if not same or sums_err > SUMS_LIMIT:
                raise RuntimeError(f"K6 with sums {label} {store}: store equal {same}, sums "
                                   f"{sums_err}")
            del fused, s1, s2, r1, r2
        del got, want
        ms = time_ms(lambda: qk.qconv(a, wt, scale, stride, pad, store), iters=5,
                      what=f"K6 {label} {store}")
        plain = None
        if full or store == "bf16":
            plain = time_ms(lambda: qk.qconv_reference(a, wt, scale, stride, pad, store),
                             iters=2, what="plain K6").ms
        nbytes = (n * _pixels_read(h, w, k, stride, pad) * cin + wt.numel()
                  + m * cout * (2 if store == "bf16" else 1) + 4 * cout)
        t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"  K6 {label} store {store}: bit-exact on {n_check} instances (max|out| "
              f"{spread:.3g}); at N={n}: {ms}; bound {bound:.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: int8 tensor cores {t_ops:.4f} "
              f"ms, bytes {t_bytes:.4f} ms), share {bound / ms.ms:.1%}; "
              f"{ops / ms.ms / 1e9:.1f} TOP/s"
              + ("" if plain is None else f"; plain version (f64 cuDNN conv of the codes, then "
                 f"the epilogue) {plain:.3f} ms"), flush=True)
        out[store] = dict(max_abs_err=0.0, ms=ms.ms, plain_ms=plain, bound_ms=bound,
                          bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None)
        if sums and store == "bf16":
            out["sums_ms"] = check_fused_sums(label, a, wt, scale, stride, pad, ms.ms, rows)
    try:  # yardsticks: the GEMM alone, and cuDNN's bf16 conv of the same shape
        A = _int8((m, K), g)
        B = _int8((cout, K), g).t()
        mm = time_ms(lambda: torch._int_mm(A, B), iters=5, what="torch._int_mm").ms
        del A, B
        x = torch.randn(n, cin, h + pad[0] + pad[1], w + pad[2] + pad[3], device="cuda",
                        dtype=torch.bfloat16).to(memory_format=torch.channels_last)
        wb = torch.randn(cout, cin, k, k, device="cuda", dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        cd = time_ms(lambda: F.conv2d(x, wb, stride=stride), iters=5, what="cuDNN bf16").ms
        del x, wb
        print(f"  yardsticks, {label}: torch._int_mm ({m} x {K}) @ ({K} x {cout}) int8, the "
              f"GEMM alone without its im2col: {mm:.4f} ms ({ops / mm / 1e9:.1f} TOP/s); cuDNN "
              f"bf16 conv, channels_last: {cd:.4f} ms ({ops / cd / 1e9:.1f} TFLOP/s)", flush=True)
    except RuntimeError as e:
        print(f"  yardsticks, {label}: not measured ({type(e).__name__}: {e})", flush=True)
    return out


# One r18 int8 request's BN epilogues at 224 px, each distinct launch:
# label, (H, W, C), launches per request; K8 adds its mode and residual.
# The BN sums: K7 reads the stem's output back; every other shape's sums
# come from K6's epilogue (``qconv_stats``), the count being its convs.
K7_SHAPES = (
    ("stem", (112, 112, 64), 1),
    ("layer1", (56, 56, 64), 4),
    ("layer2", (28, 28, 128), 5),
    ("layer3", (14, 14, 256), 5),
    ("layer4", (7, 7, 512), 5),
)
K8_SHAPES = (
    ("stem pool", (112, 112, 64), "pool_i8", None, 1),
    ("layer1", (56, 56, 64), "i8", None, 2),
    ("layer1 identity", (56, 56, 64), "i8", "identity", 2),
    ("layer2", (28, 28, 128), "i8", None, 2),
    ("layer2 identity", (28, 28, 128), "i8", "identity", 1),
    ("layer2 downsample", (28, 28, 128), "i8", "downsample", 1),
    ("layer3", (14, 14, 256), "i8", None, 2),
    ("layer3 identity", (14, 14, 256), "i8", "identity", 1),
    ("layer3 downsample", (14, 14, 256), "i8", "downsample", 1),
    ("layer4", (7, 7, 512), "i8", None, 2),
    ("layer4 downsample", (7, 7, 512), "i8", "downsample", 1),
    ("layer4 mean", (7, 7, 512), "mean", "identity", 1),
)


def _bn_stored(shape, g) -> torch.Tensor:
    """A seeded bf16 conv output."""
    return (torch.randn(shape, generator=g, device="cuda") * 3.0).to(torch.bfloat16)


def _k8_inputs(shape, res, g):
    """Seeded inputs of one K8 launch: the stored ``t``, its affine and the
    residual, and the bytes the launch reads."""
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk

    def affine(c):
        return ((torch.rand(c, generator=g, device="cuda") + 0.5) * 20.0,
                torch.randn(c, generator=g, device="cuda") * 10.0)

    t = _bn_stored(shape, g)
    A, B = affine(shape[-1])
    residual, nbytes = None, t.numel() * 2
    if res == "identity":
        residual = qk.Residual(_int8(shape, g), None, affine(shape[-1])[0] / 100.0, None)
        nbytes += t.numel()
    elif res == "downsample":
        residual = qk.Residual(_bn_stored(shape, g), None, *affine(shape[-1]))
        nbytes += t.numel() * 2
    return t, A, B, residual, nbytes


def _k8_out_bytes(t, mode) -> int:
    n, h, w, c = t.shape
    if mode == "mean":
        return n * c * 4
    if mode == "pool_i8":
        return n * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1) * c
    return t.numel()


def check_bn_epilogues(g) -> tuple[dict, dict, float]:
    """K7 and K8 at every distinct shape, mode and residual of one r18 int8
    request at QUANT_N, bf16 store: each against its plain version and
    timed beside its byte bound, then the per-request sums weighted by
    launches.  K7 runs on a request for the stem alone now (the convs' sums
    come from K6's epilogue); at the other shapes it is timed as the
    standalone read it replaced.  Returns the rows of the ``kernels`` line
    (the stem's) and K7's ms at every shape weighted by the 20 launches a
    request made when K7 read back every conv output."""
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk

    n = QUANT_N
    rows = {}
    sums = {"K7": [0.0, 0.0], "K8": [0.0, 0.0]}  # launch-weighted ms and bound per request
    every_shape = 0.0
    for label, hwc, launches in K7_SHAPES:
        t = _bn_stored((n, *hwc), g)
        s1, s2 = qk.bn_stats(t)
        r1, r2 = qk.bn_stats_reference(t)
        torch.cuda.synchronize()
        err = max(float((s1 - r1).abs().max() / r1.abs().max()),
                  float((s2 - r2).abs().max() / r2.abs().max()))
        del s1, s2, r1, r2
        ms = time_ms(lambda: qk.bn_stats(t), iters=5, what=f"K7 {label}")
        plain = time_ms(lambda: qk.bn_stats_reference(t), iters=2, what="plain K7").ms
        bound, by = _bound(t.numel() * 2 + 2 * n * hwc[-1] * 4)
        print(f"  K7 bn_stats {label} {tuple(t.shape)} bf16, {launches} per request: "
              f"max|d| / max|plain| {err:.2e} (limit 1e-6); kernel {ms}; plain {plain:.3f} ms; "
              f"bound {bound:.4f} ms ({by}), share {bound / ms.ms:.1%}", flush=True)
        if err > SUMS_LIMIT:
            raise RuntimeError(f"K7 {label}: {err:.2e} from its plain version")
        rows.setdefault("bn_stats", dict(max_abs_err=err, ms=ms.ms, plain_ms=plain,
                                         bound_ms=bound, bound_by=by, library_ms=None))
        every_shape += launches * ms.ms
        if label == "stem":  # the only launch of K7 on a request now
            sums["K7"][0] += launches * ms.ms
            sums["K7"][1] += launches * bound
        del t
    for label, hwc, mode, res, launches in K8_SHAPES:
        t, A, B, residual, in_bytes = _k8_inputs((n, *hwc), res, g)

        def kernel():
            return qk.bn_relu_quant(t, None, A, B, residual, mode=mode)

        def plain_fn():
            return qk.bn_relu_quant_reference(t, None, A, B, residual, mode=mode)

        got, want = kernel(), plain_fn()
        torch.cuda.synchronize()
        if mode == "mean":
            err = float((got - want).abs().max() / want.abs().max())
            verdict = f"max|d| / max|plain| {err:.2e} (limit 1e-6)"
            bad = err > 1e-6
        else:
            d = (got.to(torch.int16) - want.to(torch.int16)).abs()
            flips, err = int((d > 0).sum()), float(d.max())
            verdict = (f"codes differing {flips} of {got.numel()} (limit "
                       f"{K8_FLIP_LIMIT:g} of them, by 1), max|d| {err:g}; "
                       f"codes above 0: {float((got > 0).float().mean()):.1%}")
            bad = err > 1 or flips > K8_FLIP_LIMIT * got.numel()
        del got, want
        ms = time_ms(kernel, iters=5, what=f"K8 {label}")
        plain = time_ms(plain_fn, iters=2, what="plain K8").ms
        bound, by = _bound(in_bytes + _k8_out_bytes(t, mode))
        print(f"  K8 bn_relu_quant {label} {tuple(t.shape)} mode {mode}, residual {res}, "
              f"{launches} per request: {verdict}; kernel {ms}; plain {plain:.3f} ms; bound "
              f"{bound:.4f} ms ({by}), share {bound / ms.ms:.1%}", flush=True)
        if bad:
            raise RuntimeError(f"K8 {label}: disagrees with its plain version")
        rows.setdefault("bn_relu_quant", dict(max_abs_err=err, ms=ms.ms, plain_ms=plain,
                                              bound_ms=bound, bound_by=by, library_ms=None))
        sums["K8"][0] += launches * ms.ms
        sums["K8"][1] += launches * bound
        del t, residual
    for name, (ms, bound) in sums.items():
        print(f"  {name} per request (launch-weighted, N={n}): {ms:.4f} ms against a bound of "
              f"{bound:.4f} ms ({bound / ms:.1%})", flush=True)
    print(f"  K7 at every shape, weighted by the 20 launches a request made before its sums "
          f"moved into K6's epilogue: {every_shape:.4f} ms", flush=True)
    return rows["bn_stats"], rows["bn_relu_quant"], every_shape


# One r18 f32 request's K9 launches at 224 px: label, (H, W, C), epilogue,
# launches per request (17: the downsample's BN runs inside its block end's).
K9_SHAPES = (
    ("stem pool", (112, 112, 64), "pool", 1),
    ("layer1 relu", (56, 56, 64), "relu", 2),
    ("layer1 identity", (56, 56, 64), "identity", 2),
    ("layer2 relu", (28, 28, 128), "relu", 2),
    ("layer2 identity", (28, 28, 128), "identity", 1),
    ("layer2 downsample", (28, 28, 128), "downsample", 1),
    ("layer3 relu", (14, 14, 256), "relu", 2),
    ("layer3 identity", (14, 14, 256), "identity", 1),
    ("layer3 downsample", (14, 14, 256), "downsample", 1),
    ("layer4 relu", (7, 7, 512), "relu", 2),
    ("layer4 identity", (7, 7, 512), "identity", 1),
    ("layer4 downsample", (7, 7, 512), "downsample", 1),
)
F32_BN_VALID = 2400  # valid instances of the QUANT_N bucket, at seeded positions


def f32_bn_case(hwc, epilogue, n, n_valid, g, dtype=torch.float32):
    """Seeded inputs of one K9 launch: raw conv output ``t (n, C, H, W)``
    in channels_last memory, ``scale`` and :class:`Norm` from K7's sums
    under a mask of ``n_valid`` random instances (weights of both signs),
    and the keyword arguments of the epilogue; plus the bytes the launch
    reads and writes."""
    from montecarlo_gated_mil_tpu_torch.models import resnet
    from montecarlo_gated_mil_tpu_torch.ops import float_bn as fb

    h, w, c = hwc

    def raw():
        return (torch.randn((n, h, w, c), generator=g, device="cuda") * 3.0 + 0.5).to(
            dtype).permute(0, 3, 1, 2)

    def norm(x):
        _, _, mean, inv, scale = resnet._moments(x, mask, 1e-5)
        return scale, fb.Norm(mean, inv, torch.randn(c, generator=g, device="cuda"),
                              torch.randn(c, generator=g, device="cuda") * 0.1)

    mask = torch.zeros(n, dtype=torch.bool, device="cuda")
    mask[torch.randperm(n, generator=g, device="cuda")[:n_valid]] = True
    t = raw()
    scale, nm = norm(t)
    kw = dict(relu=True)
    size = t.numel() * t.element_size()
    nbytes = 2 * size
    if epilogue == "pool":
        kw["pool"] = True
        nbytes = size + size // 4
    elif epilogue == "identity":
        kw["residual"] = raw()
        nbytes += size
    elif epilogue == "downsample":
        d = raw()
        kw["residual"] = fb.Downsample(d, norm(d)[1])
        nbytes += size
    return t, scale, nm, kw, nbytes


def check_float_bn() -> dict:
    """Phase 4f: K9 at every ``K9_SHAPES`` launch and K7 in f32 at every
    ``K7_SHAPES`` launch of one r18 f32 request at QUANT_N, F32_BN_VALID
    valid.  K9 against the plain chain (``float_bn.bn_apply_chain`` on the
    card), bit for bit; K7 against float64 sums within one f32 rounding
    (2^-24 of the sum) and 1e-11 of the sum of |x| (the f64 accumulation).
    Each timed (K9 out of place, as the training forward runs it; serving
    writes over its input, the same bytes) beside its byte bound and the
    plain chain's time, the library yardstick: PyTorch's own kernels are
    what the f32 embed ran before.  Returns the ``kernels`` line's row for
    K9 (the stem's)."""
    from montecarlo_gated_mil_tpu_torch.ops import float_bn as fb
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk

    g = torch.Generator(device="cuda").manual_seed(23)
    n, rows = QUANT_N, {}
    sums = {"K9": [0.0, 0.0, 0.0], "K7 f32": [0.0, 0.0, 0.0]}  # ms, bound, chain a request
    for label, hwc, epilogue, launches in K9_SHAPES:
        t, scale, nm, kw, nbytes = f32_bn_case(hwc, epilogue, n, F32_BN_VALID, g)

        def kernel():
            return fb.bn_apply(t, scale, nm, **kw)

        def chain():
            return fb.bn_apply_chain(t, scale, nm, **kw)

        got, want = kernel(), chain()
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        differ = int((got != want).sum()) if not same else 0
        del got, want
        ms = time_ms(kernel, iters=5, what=f"K9 {label}")
        plain = time_ms(chain, iters=2, what=f"chain {label}").ms
        bound, by = _bound(nbytes)
        print(f"  K9 bn_apply {label} {tuple(t.shape)} f32, {launches} per request: "
              f"{'bit for bit' if same else f'{differ} elements DIFFER'} from the plain chain; "
              f"kernel {ms}; chain {plain:.3f} ms ({plain / ms.ms:.2f}x); bound {bound:.4f} ms "
              f"({by}), share {bound / ms.ms:.1%}", flush=True)
        if not same:
            raise RuntimeError(f"K9 {label}: {differ} elements differ from the plain chain")
        rows.setdefault("bn_apply", dict(max_abs_err=0.0, ms=ms.ms, plain_ms=plain,
                                         bound_ms=bound, bound_by=by, library_ms=plain))
        for i, v in enumerate((ms.ms, bound, plain)):
            sums["K9"][i] += launches * v
        del t, kw
        torch.cuda.empty_cache()
    for label, hwc, launches in K7_SHAPES:
        x = torch.randn((n, *hwc), generator=g, device="cuda") * 3.0 + 0.5
        s1, s2 = qk.bn_stats(x)
        xd = x.to(torch.float64)
        worst = 0.0
        for got, v in ((s1, xd), (s2, xd.square())):
            exact = v.sum(dim=(1, 2))
            room = 2.0**-24 * exact.abs() + 1e-11 * v.abs().sum(dim=(1, 2))
            worst = max(worst, float(((got.to(torch.float64) - exact).abs() / room).max()))
        del xd, s1, s2
        ms = time_ms(lambda: qk.bn_stats(x), iters=5, what=f"K7 f32 {label}")
        nchw = x.permute(0, 3, 1, 2)
        plain = time_ms(lambda: fb.bn_sums_chain(nchw), iters=2, what="chain sums").ms
        bound, by = _bound(x.numel() * 4 + 2 * n * hwc[-1] * 4)
        print(f"  K7 bn_stats {label} {tuple(x.shape)} f32, {launches} per request: gap over "
              f"its room {worst:.3f} (limit 1); kernel {ms}; chain's sums {plain:.3f} ms "
              f"({plain / ms.ms:.2f}x); bound {bound:.4f} ms ({by}), share {bound / ms.ms:.1%}",
              flush=True)
        if worst > 1.0:
            raise RuntimeError(f"K7 f32 {label}: sums off the float64 sums by {worst:.3f} of "
                               "their room")
        for i, v in enumerate((ms.ms, bound, plain)):
            sums["K7 f32"][i] += launches * v
        del x, nchw
        torch.cuda.empty_cache()
    for name, (ms, bound, plain) in sums.items():
        print(f"  {name} per request (launch-weighted, N={n}): {ms:.4f} ms against a bound of "
              f"{bound:.4f} ms ({bound / ms:.1%}); the plain chain {plain:.4f} ms", flush=True)
    return rows["bn_apply"]


def check_int8_embed(qpred, d) -> float:
    """One request's bag (image 2, R): the minimum per-instance cosine of
    the int8 features against the f32 embed (same weights), and the int8
    embed's device time by kernel (``torch.profiler``), which must show
    each of its convs on K6's wgmma kernel.  Returns the cosine."""
    from montecarlo_gated_mil_tpu_torch.data.pipeline import image_to_bag
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.serve import _prepare_image

    arr, inv_max = _prepare_image(synthetic_image(d.H, d.W, positive=False, seed=2), None)
    bucket = qpred._pick_bucket(arr, "R")
    with torch.inference_mode():
        image = qpred._upload(arr).to(torch.float32) * inv_max
        bag = image_to_bag(image, True, 0, qpred._starts, replace(qpred.pipeline, bucket=bucket),
                           device="cuda")
        hq = qpred._embed(bag.patches, bag.mask)
        hf = qpred.model.embed(bag.patches, bag.mask)
        cos = torch.nn.functional.cosine_similarity(hq[bag.mask], hf[bag.mask], dim=-1)
        del hf
        table = kernel_table(lambda: qpred._embed(bag.patches, bag.mask))
    print(f"  int8 features against the f32 embed, image 2 R, bucket {bucket}, "
          f"{int(bag.mask.sum())} valid tiles: per-instance cosine min {float(cos.min()):.5f}, "
          f"mean {float(cos.mean()):.5f} (limit 0.97)", flush=True)
    table.check_launched()
    wgmma_fn, pair_fn, gather_fn = cuda_build.DEVICE_FUNCTIONS["qconv.cu"]
    groups = {f"K6 {fn}": (fn,) for fn in (wgmma_fn, pair_fn, gather_fn)}
    groups.update({"K7": ("bn_stats_kernel",), "K7 fold": ("bn_stats_fold_kernel",),
                   "K8": ("bn_relu_quant_kernel", "bn_relu_mean_kernel", "stem_pool_quant_kernel")})
    launches = {name: table.count(*fns) for name, fns in groups.items()}
    parts = [f"{name} {table.ms(*fns):.2f} ms in {launches[name]} launches"
             for name, fns in groups.items()]
    grouped = [f for fns in groups.values() for f in fns]
    rest = [(k, ms, n) for k, ms, n in table.top(len(table.kernels))
            if not any(f in k for f in grouped)]
    print(f"  int8 embed by kernel (torch.profiler, one call at bucket {bucket}): device "
          f"{table.total_ms:.2f} ms; " + "; ".join(parts) + f"; other "
          f"{sum(ms for _, ms, _ in rest):.2f} ms in {sum(n for _, _, n in rest)} launches, the "
          "largest:", flush=True)
    for k, ms, n in rest[:5]:
        print(f"    {ms:9.3f} ms  x{n:<4d} {k[:90]}", flush=True)
    need = {fn: sum(shape[-1] for shape in QCONV_SHAPES if QCONV_PATH[shape[0]] == fn)
            for fn in (wgmma_fn, pair_fn, gather_fn)}
    print("  K6 by device function in that embed: " + ", ".join(
        f"{fn} {launches[f'K6 {fn}']} (need {need[fn]})" for fn in need), flush=True)
    if any(launches[f"K6 {fn}"] != n for fn, n in need.items()):
        raise RuntimeError(f"the int8 embed's convs did not run the device functions {need}")
    print(f"  K7 in that embed: {launches['K7']} launch (the stem's; need 1), its fold "
          f"{launches['K7 fold']} (need {FOLDS_PER_REQUEST})", flush=True)
    if launches["K7"] != 1 or launches["K7 fold"] != FOLDS_PER_REQUEST:
        raise RuntimeError("the int8 embed did not take its convs' sums in K6's epilogue")
    return float(cos.min())


def check_quantized(rows, pred, weights, results, requests, d) -> dict:
    """Phase 4q.  K6-K8 against their plain versions and timed, then the
    quantized predictor at full width: phase 4's requests, the CLI on a
    quantized YAML, a small request against the CPU.  Fills ``rows`` and
    returns the launch counts of the quantized requests."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(21)
    k6_alone = k6_sums = 0.0  # launch-weighted ms per request, bf16 store
    for label, h, w, cin, cout, k, stride, pad, per_request in QCONV_SHAPES:
        print(f"  K6 {label}: ({QUANT_N}, {h}, {w}, {cin}) -> {cout}, {k}x{k}/{stride}, pad "
              f"{pad}; {per_request} per request", flush=True)
        # The kernels line's row is the shape launched most, held whole.
        full = label == "layer1 3x3"
        by_store = check_qconv(label, h, w, cin, cout, k, stride, pad, g, full=full, rows=rows)
        if full:
            rows["qconv_i8"] = by_store["bf16"]
        k6_alone += per_request * by_store["bf16"]["ms"]
        k6_sums += per_request * by_store.get("sums_ms", 0.0)
        torch.cuda.empty_cache()
    rows["bn_stats"], rows["bn_relu_quant"], k7_every = check_bn_epilogues(g)
    k7_stem = rows["bn_stats"]["ms"]
    print(f"  K6 + K7 (+ fold) per request (launch-weighted, N={QUANT_N}, bf16): the main path, "
          f"K6 with the sums (folds included) and the stem's K7, {k6_sums + k7_stem:.4f} ms; K6 "
          f"alone and K7 at every shape (the path before the sums moved) "
          f"{k6_alone + k7_every:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    print(f"  kernel checks: {time.perf_counter() - t_phase:.1f} s", flush=True)

    cfg = Config()
    qcfg = replace(cfg, tpu=replace(cfg.tpu, quantized_inference=True))
    t0 = time.perf_counter()
    qpred = MCDOPredictor.from_config(qcfg, weights)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    qpred.warmup()
    print(f"  quantized predictor: plan built in {built:.2f} s (with the model), warmup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cuda_build.reset_launch_counts()
    qres = []
    for (kind, lat, img_seed, seed), fr in zip(requests, results):
        img = synthetic_image(d.H, d.W, positive=bool(img_seed % 2), seed=img_seed)
        if kind == "uint16":
            img = np.round(img * 65535).astype(np.uint16)
        t0 = time.perf_counter()
        r = qpred.predict(img, lat, seed=seed)
        ms = (time.perf_counter() - t0) * 1e3
        qres.append(r)
        finite = all(bool(torch.isfinite(getattr(r.stats, f)).all()) for f in vars(r.stats))
        print(f"  int8 request {kind:6s} {lat} image {img_seed} seed {seed}: bucket {r.bucket} "
              f"prediction {r.prediction} P(pos) {float(r.stats.mean):.4f} entropy "
              f"{float(r.stats.mean_entropy):.4f} {ms:.1f} ms | f32: prediction {fr.prediction} "
              f"P(pos) {float(fr.stats.mean):.4f} entropy {float(fr.stats.mean_entropy):.4f}; "
              f"|d P(pos)| {abs(float(r.stats.mean) - float(fr.stats.mean)):.4f}", flush=True)
        if not finite or r.num_instances != fr.num_instances:
            raise RuntimeError("int8 request: a statistic is not finite or the bag differs")
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    per = {k: launches[k] / len(requests) for k in ("qconv_i8", "bn_stats", "bn_stats_fold",
                                                   "bn_relu_quant", "mc_head_sep",
                                                   "gather_tiles")}
    gap = max(abs(float(q.stats.mean) - float(f.stats.mean)) for q, f in zip(qres, results))
    agree = sum(q.prediction == f.prediction for q, f in zip(qres, results))
    repeat = (torch.equal(qres[0].stats.mean_probs, qres[-1].stats.mean_probs)
              and torch.equal(qres[0].attention.mean, qres[-1].attention.mean))
    print(f"  launches per int8 request: {per}; max |d P(pos)| against f32 {gap:.4f} (limit "
          f"0.05); predictions agree on {agree} of {len(requests)} (need 4); repeated seed bit "
          f"for bit: {repeat}", flush=True)
    want = {"qconv_i8": 19, "bn_stats": 1, "bn_stats_fold": FOLDS_PER_REQUEST,
            "bn_relu_quant": 17}
    if any(per[k] != n for k, n in want.items()) or min(per.values()) < 1:
        raise RuntimeError(f"the int8 requests did not go through K6-K8, K1 and K3 as an r18 "
                           f"request does ({want} each): {launches}")
    if gap > 0.05 or agree < 4 or not repeat:
        raise RuntimeError("int8 requests: P(pos) gap, prediction agreement or repeat failed")
    if check_int8_embed(qpred, d) < 0.97:
        raise RuntimeError("int8 features: cosine against the f32 embed under 0.97")
    request_breakdown(qpred, d)
    img2 = synthetic_image(d.H, d.W, positive=False, seed=2)
    peaks = {}
    for name, p in (("f32", pred), ("int8", qpred)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        p.predict(img2, "R", seed=102)
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
    print("  peak device memory of one request above its start (image 2 R): " + ", ".join(
        f"{k} {v:.3f} GiB" for k, v in peaks.items()), flush=True)
    check_quantized_cli(qcfg, d)
    check_small_quantized_request_against_cpu()
    print(f"  phase 4q: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def check_quantized_cli(qcfg, d) -> None:
    """``cli.main(["serve", ...])`` on a YAML with ``tpu.quantized_inference:
    true`` and two of phase 4b's records: each line equals the direct
    quantized ``predict`` of a predictor built the same way."""
    import yaml

    from montecarlo_gated_mil_tpu_torch import cli
    from montecarlo_gated_mil_tpu_torch.core.config import config_to_dict
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.server import build_predictor, result_to_dict

    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        reqs = []
        for kind, lat, img_seed, seed in (("float", "L", 10, 200), ("uint16", "R", 11, 201)):
            img = synthetic_image(d.H, d.W, positive=bool(img_seed % 2), seed=img_seed)
            if kind == "uint16":
                img = np.round(img * 65535).astype(np.uint16)
            np.save(tmp / f"scan_{img_seed}.npy", img)
            reqs.append({"image": str(tmp / f"scan_{img_seed}.npy"), "laterality": lat,
                         "seed": seed})
        (tmp / "config.yml").write_text(yaml.safe_dump(config_to_dict(qcfg)))
        (tmp / "in.jsonl").write_text("".join(json.dumps(r) + "\n" for r in reqs))
        t0 = time.perf_counter()
        rc = cli.main(["serve", "--config", str(tmp / "config.yml"), "--input",
                       str(tmp / "in.jsonl"), "--output", str(tmp / "out.jsonl")])
        cli_s = time.perf_counter() - t0
        got = [json.loads(line) for line in (tmp / "out.jsonl").read_text().splitlines()]
        ref = build_predictor(qcfg)
        same = [g == result_to_dict(ref.predict(np.load(r["image"]), r["laterality"],
                                                seed=r["seed"]))
                for g, r in zip(got, reqs)]
        del ref
    print(f"  CLI on a quantized YAML: exit {rc}, {len(got)} lines in {cli_s:.1f} s (model and "
          f"plan build, warmup, 2 requests); quantized {qcfg.tpu.quantized_inference}; equal to "
          f"build_predictor(that config).predict bit for bit: {same}", flush=True)
    if rc != 0 or len(got) != 2 or not all(same):
        raise RuntimeError("cli serve, quantized: non-zero exit, wrong count or a differing record")


def check_small_quantized_request_against_cpu() -> None:
    """A small quantized request with dropout on, on the card (K6-K8, K1,
    K3) and on the CPU (plain versions): the same codes except where the
    bf16 stem (cuDNN against the CPU's conv) or a statistic's last bit
    differs."""
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
        out[device] = MCDOPredictor(model, pipe, num_samples=8, quantized=True,
                                    device=device).predict(img, "R", seed=4)
    a, b = out["cuda"], out["cpu"]
    err = max(float((a.stats.mean_probs - b.stats.mean_probs).abs().max()),
              float((a.attention.mean - b.attention.mean).abs().max()))
    print(f"  small int8 request, card vs CPU plain path (dropout 0.1): max|d| {err:.2e} (limit "
          f"5e-3), predictions {a.prediction} and {b.prediction}, {a.num_instances} instances",
          flush=True)
    if a.num_instances != b.num_instances or a.prediction != b.prediction or err > 5e-3:
        raise RuntimeError("the card's int8 request disagrees with the CPU plain path")


BENCH_CHECK_BN = 1e-6  # K7's sums and K8's mean against the plain version, relative to max|plain|


def check_bench_kernels() -> None:
    """Each K6-K8 launch of the bench's int8 embed (``bench.run_bench``'s
    bag: 256 patches at 224 px, bf16, all valid) against its plain version
    on the same inputs: K6's stores bit for bit and the K7 sums of its
    epilogue within BENCH_CHECK_BN of max|plain| (19 launches), the stem's
    K7 and K8's mean within BENCH_CHECK_BN, K8's codes with at most
    K8_FLIP_LIMIT of them one off.  Then the bench's bf16 float embed: masked BN keeps its
    statistics in f32, and 8 of its patches embed on the card as on the
    CPU (per-instance cosine >= 0.999)."""
    from montecarlo_gated_mil_tpu_torch import bench
    from montecarlo_gated_mil_tpu_torch.models import resnet
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk
    from montecarlo_gated_mil_tpu_torch.ops import quantized

    model = bench._seeded(lambda: MultiHeadGatedAttentionMIL(dtype=torch.bfloat16)).cuda()
    plan = quantized.quantize_backbone_static(model.feature_extractor, "r18")
    patches, mask = bench._workload(256, 224, torch.bfloat16, torch.device("cuda"))
    worst = {"qconv_i8": [0, 0.0], "bn_stats": [0, 0.0], "bn_relu_quant": [0, 0.0]}
    flips = [0, 0]  # K8 codes one off, codes compared
    orig = quantized.qconv_stats, quantized.bn_stats, quantized.bn_relu_quant

    def seen(name, err):
        worst[name][0] += 1
        worst[name][1] = max(worst[name][1], err)

    def qconv_stats(a, w, scale, stride, pad, store, tq=None):
        got = orig[0](a, w, scale, stride, pad, store, tq)
        want = qk.qconv_reference(a, w, scale, stride, pad, store)
        if not torch.equal(got[0].view(torch.uint8), want.view(torch.uint8)):
            raise RuntimeError(f"K6 at N=256, a {tuple(a.shape)}, w {tuple(w.shape)}: differs "
                               "from its plain version")
        seen("qconv_i8", max(_rel(x, y) for x, y in zip(got[1:], qk.bn_stats_reference(want, tq))))
        return got

    def bn_stats(t, tq=None):
        got = orig[1](t, tq)
        want = qk.bn_stats_reference(t, tq)
        seen("bn_stats", max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)))
        return got

    def bn_relu_quant(t, tq, scale, shift, residual=None, mode="i8"):
        got = orig[2](t, tq, scale, shift, residual, mode)
        want = qk.bn_relu_quant_reference(t, tq, scale, shift, residual, mode)
        if mode == "mean":
            seen("bn_relu_quant", float((got - want).abs().max() / want.abs().max()))
        else:
            d = (got.to(torch.int16) - want.to(torch.int16)).abs()
            if float(d.max()) > 1:
                raise RuntimeError(f"K8 at N=256, {tuple(t.shape)} {mode}: a code is off by more "
                                   "than one")
            flips[0] += int((d > 0).sum())
            flips[1] += d.numel()
            seen("bn_relu_quant", 0.0)
        return got

    quantized.qconv_stats, quantized.bn_stats, quantized.bn_relu_quant = (
        qconv_stats, bn_stats, bn_relu_quant)
    try:
        with torch.inference_mode():
            quantized.quantized_embed_static(plan, patches, mask)
        torch.cuda.synchronize()
    finally:
        quantized.qconv_stats, quantized.bn_stats, quantized.bn_relu_quant = orig
    print(f"  int8 embed of the bench bag (N=256), every launch against its plain version: K6 "
          f"{worst['qconv_i8'][0]} launches with K7's sums in the epilogue, stores bit-exact, sums "
          f"max|d| / max|plain| {worst['qconv_i8'][1]:.2e} (limit {BENCH_CHECK_BN:g}); K7 (the "
          f"stem) {worst['bn_stats'][0]} launch, max|d| / max|plain| {worst['bn_stats'][1]:.2e} "
          f"(limit {BENCH_CHECK_BN:g}); K8 {worst['bn_relu_quant'][0]} launches, codes one off "
          f"{flips[0]} of {flips[1]} (limit {K8_FLIP_LIMIT:g} of them), the mean's max|d| / "
          f"max|plain| {worst['bn_relu_quant'][1]:.2e} (limit {BENCH_CHECK_BN:g})", flush=True)
    if [worst[k][0] for k in worst] != [19, 1, 17] or max(
            worst["qconv_i8"][1], worst["bn_stats"][1],
            worst["bn_relu_quant"][1]) > BENCH_CHECK_BN or flips[0] > K8_FLIP_LIMIT * flips[1]:
        raise RuntimeError(f"the bench's int8 embed: launches {worst}, flips {flips}")

    dtypes = []
    stats_dtype = resnet._stats_dtype

    def recording(dtype):
        dtypes.append(stats_dtype(dtype))
        return dtypes[-1]

    resnet._stats_dtype = recording
    try:
        with torch.inference_mode():
            model.embed(patches, mask)
    finally:
        resnet._stats_dtype = stats_dtype
    cpu = bench._seeded(lambda: MultiHeadGatedAttentionMIL(dtype=torch.bfloat16))
    with torch.inference_mode():
        hk = model.embed(patches[:8], mask[:8]).cpu()
        hc = cpu.embed(patches[:8].cpu(), mask[:8].cpu())
    cos = float(torch.nn.functional.cosine_similarity(hk, hc, dim=-1).min())
    print(f"  bf16 float embed: masked BN statistics in {sorted({str(d) for d in dtypes})} over "
          f"{len(dtypes)} BNs; 8 patches on the card against the CPU: per-instance cosine min "
          f"{cos:.6f} (limit 0.999)", flush=True)
    if set(dtypes) != {torch.float32} or cos < 0.999:
        raise RuntimeError("the bf16 embed: statistics not in f32, or the card disagrees with "
                           "the CPU")


def check_bench() -> dict:
    """``bench.run_bench_both()`` at the JAX package's workload (int8 headline,
    the bf16 float path, the bf16 train step), its K6-K8 launches held against
    their plain versions first.  Prints the record on its own line; returns
    the launch counts of ``run_bench_both``."""
    from montecarlo_gated_mil_tpu_torch import bench
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    check_bench_kernels()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    rec = bench.run_bench_both()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    print("  run_bench_both() record:", flush=True)
    print(json.dumps(rec), flush=True)
    for quantized in (True, False):
        profile_bench_bag(quantized)
    bags = 1 + bench.TRIALS * 20  # the warm-up bag, then TRIALS runs of repeats=20
    steps = 1 + bench.TRIALS * bench.TRAIN_STEPS
    want = dict(qconv_i8=19 * bags, bn_stats=bags, bn_stats_fold=FOLDS_PER_REQUEST * bags,
                bn_relu_quant=17 * bags, mc_head_shared=2 * bags + steps,
                mc_head_bwd_shared=steps, mc_head_sep=0, mc_head_bwd_sep=0, gather_tiles=0)
    print(f"  run_bench_both: {wall:.1f} s; {rec['value']} bags/s int8, "
          f"{rec['value_exact_bf16']} bags/s bf16, train step {rec['train_step_ms']} ms; launches "
          f"{launches} (need {want}: {bags} bags in each of the int8 and bf16 runs, {steps} train "
          f"steps); phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    numbers = [rec["value"], rec["value_exact_bf16"], rec["train_step_ms"], rec["vs_baseline"]]
    if not all(isinstance(v, float) and np.isfinite(v) and v > 0 for v in numbers):
        raise RuntimeError(f"bench: a number is not finite and positive: {rec}")
    if launches != want or rec["device"] != device_line("cuda") or "int8" not in rec["metric"]:
        raise RuntimeError(f"bench: launches {launches} (need {want}) or device line wrong")
    plain = check_plain_head_bench()
    return {k: n + plain[k] for k, n in launches.items()}


def check_plain_head_bench() -> dict:
    """``cli bench`` on a YAML with ``tpu.use_pallas_attention: false`` (and
    ``compute_dtype: bfloat16``, the bench's float path) at the bench's bag,
    3 samples a bag: the record printed, and no head kernel (K1, K2, K4, K5)
    launched.  Returns its launch counts."""
    import contextlib
    import io

    import yaml

    from montecarlo_gated_mil_tpu_torch import bench, cli
    from montecarlo_gated_mil_tpu_torch.core.config import Config, config_to_dict
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build

    base = Config()
    cfg = replace(base, tpu=replace(base.tpu, use_pallas_attention=False,
                                    compute_dtype="bfloat16"))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "config.yml")
        path.write_text(yaml.safe_dump(config_to_dict(cfg)))
        cuda_build.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["bench", "--config", str(path), "--samples", "3"])
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    heads = {k: launches[k] for k in ("mc_head_sep", "mc_head_shared", "mc_head_bwd_sep",
                                      "mc_head_bwd_shared")}
    print(f"  cli bench, tpu.use_pallas_attention: false, bf16, T=3: exit {rc}, {wall:.1f} s, "
          f"{rec['value']} bags/s ({1 + bench.TRIALS * 20} bags); head kernel launches {heads}",
          flush=True)
    print(json.dumps(rec), flush=True)
    if rc != 0 or any(heads.values()) or not rec["value"] > 0:
        raise RuntimeError(f"cli bench with the plain head: exit {rc}, launches {launches}")
    return launches


def profile_bench_bag(quantized: bool, bags: int = 5) -> None:
    """Where a bench bag's time goes: CUDA events around ``bags`` bags queued
    back to back as ``run_bench`` queues them, beside the device time of
    their kernels by ``torch.profiler``; the difference is time the device
    waits for the host."""
    from montecarlo_gated_mil_tpu_torch import bench
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn, mc_head
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams

    model = bench._seeded(lambda: MultiHeadGatedAttentionMIL(dtype=torch.bfloat16)).cuda()
    params = GatedAttentionParams.from_module(model)
    patches, mask = bench._workload(256, 224, torch.bfloat16, torch.device("cuda"))
    embed = make_embed_fn(model, quantized)

    def run():
        carry = torch.zeros((), device="cuda")
        for i in range(bags):
            H = embed(patches + carry * 1e-6, mask)
            carry = mc_head(model, H, mask, 30, i, params).predictions.sum()

    with torch.inference_mode():
        run()
        wall = time_ms(run, iters=1, warm=0, what="bench bags").b2b_ms / bags
        table = kernel_table(run)
    total, launches = table.total_ms / bags, sum(n for _, n in table.kernels.values()) / bags
    print(f"  bench bag, {'int8' if quantized else 'bf16 float'} embed: {wall:.3f} ms a bag back "
          f"to back (CUDA events); device kernels {total:.3f} ms in {launches:.0f} launches a bag "
          f"(torch.profiler); device idle {table.idle_share(wall * bags):.1%} of the bag; "
          "largest:", flush=True)
    for k, ms, n in table.top(6):
        print(f"    {ms / bags:8.3f} ms a bag  x{n // bags:<4d} {k[:90]}", flush=True)


class _Capture:
    """stdout kept in a buffer while a CLI run prints its metrics lines."""

    def __init__(self):
        import io

        self.buf = io.StringIO()

    def __enter__(self):
        import contextlib

        self._redirect = contextlib.redirect_stdout(self.buf)
        self._redirect.__enter__()
        return self

    def __exit__(self, *exc):
        self._redirect.__exit__(*exc)
        if exc[0] is not None:  # show what the run printed before it failed
            print(self.buf.getvalue()[-6000:], flush=True)
        return False

    def lines(self, *starts: str) -> list[str]:
        return [ln for ln in self.buf.getvalue().splitlines() if ln.startswith(starts)]


def check_cv(tmp: str) -> tuple[dict, object, float]:
    """``cli cv`` then ``cli cv-eval --ensemble`` at the shipped ``Config()``
    (r18, 7036x2800, patch 224), depth cut to 2 folds of 10 synthetic
    records, 1 epoch; then ``cli cv --resume`` after a crash in fold 2.
    Checks the manifest, accuracies and launch counts, and the ensemble's
    peak memory on one test bag.  The models stay under ``tmp`` for phase
    11.  Returns the launch counts of the three CLI runs, the config and
    the ensemble's peak GiB."""
    import os
    import shutil

    import yaml

    from montecarlo_gated_mil_tpu_torch import cli
    from montecarlo_gated_mil_tpu_torch.core.config import Config, config_to_dict
    from montecarlo_gated_mil_tpu_torch.experiment import build_model, get_fold_dataloaders
    from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import (
        ensemble_mc_inference,
        load_fold_ensemble,
    )
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    base = Config()
    tp = base.training_plan
    totals: dict = {}

    def count(into: dict) -> dict:
        got = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        for k, v in got.items():
            into[k] = into.get(k, 0) + v
        return got

    cfg = replace(
        base, model_path=os.path.join(tmp, "models"),
        data=replace(base.data, cv_folds=2, synthetic_count=10),
        training_plan=replace(tp, parameters=replace(tp.parameters, epochs=1)),
    )
    yml = os.path.join(tmp, "config.yml")
    Path(yml).write_text(yaml.safe_dump(config_to_dict(cfg)))
    print(f"  Config() cut in depth only: data.cv_folds {base.data.cv_folds} -> 2, "
          f"data.synthetic_count {base.data.synthetic_count} -> 10, epochs "
          f"{tp.parameters.epochs} -> 1, model_path a temporary directory; r18, "
          f"{cfg.data.H}x{cfg.data.W}, patch {cfg.data.patch_size}, T={cfg.N}, weighted "
          f"sampler {tp.weighted_sampler}", flush=True)
    split = [get_fold_dataloaders(cfg, f, device="cuda") for f in range(2)]
    n = [(len(b.train), len(b.val), len(b.test)) for b in split]
    n_test = n[0][2]
    del split
    print(f"  bags per fold (train, val, test): {n}", flush=True)

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with _Capture() as out:
        rc = cli.main(["cv", "--config", yml])
    cv_s = time.perf_counter() - t0
    cv = count(totals)
    manifest = json.loads(Path(cfg.model_path, "cv_manifest.json").read_text())
    for ln in out.lines("Fold ", "CV accuracy"):
        print(f"  | {ln}", flush=True)
    folds = manifest["folds"]
    ok = (rc == 0 and [f["fold"] for f in folds] == [1, 2]
          and all(os.path.exists(f["checkpoint"]) and 0 <= f["accuracy"] <= 1 for f in folds))
    k1_cv = sum(tr + va + te for tr, va, te in n)  # a train step, a val and a test bag each
    print(f"  cli cv: exit {rc}, {cv_s:.1f} s; accuracies {[f['accuracy'] for f in folds]}; "
          f"launches K1 {cv['mc_head_sep']} (need {k1_cv}: every train, val and test bag), "
          f"K5 {cv['mc_head_bwd_sep']} (need {sum(x[0] for x in n)}), K3 "
          f"{cv['gather_tiles']}", flush=True)
    if not ok or cv["mc_head_sep"] != k1_cv or cv["mc_head_bwd_sep"] != sum(
            x[0] for x in n) or cv["gather_tiles"] < k1_cv:
        raise RuntimeError(f"cli cv: bad manifest or launches {cv}")

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with _Capture() as out:
        rc = cli.main(["cv-eval", "--config", yml, "--ensemble"])
    eval_s = time.perf_counter() - t0
    ev = count(totals)
    for ln in out.lines("fold ", "MC-ACC", "ENS-ACC"):
        print(f"  | {ln}", flush=True)
    k1_eval = 2 * 2 * n_test + 2 * n_test  # MC and deterministic test per fold, 2 members
    print(f"  cli cv-eval --ensemble: exit {rc}, {eval_s:.1f} s; launches K1 "
          f"{ev['mc_head_sep']} (need {k1_eval}: each test bag's MC and deterministic test "
          f"per fold, and each ensemble member), K3 {ev['gather_tiles']}", flush=True)
    if rc != 0 or not out.lines("ENS-ACC") or ev["mc_head_sep"] != k1_eval:
        raise RuntimeError(f"cli cv-eval --ensemble: exit {rc} or launches {ev}")

    members = load_fold_ensemble(cfg, manifest)
    model = build_model(cfg).cuda()
    bag, _ = next(iter(get_fold_dataloaders(cfg, 0, device="cuda").test.epoch(0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    outs = ensemble_mc_inference(model, members, bag.patches, bag.mask, cfg.N, 1)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - start) / 2**30
    print(f"  ensemble of {len(members)} members on one test bag (bucket "
          f"{bag.mask.shape[0]}, {int(bag.mask.sum())} valid): peak {peak:.3f} GiB above "
          f"its start; samples {tuple(outs.predictions.shape)}", flush=True)
    if not bool(torch.isfinite(outs.predictions).all()):
        raise RuntimeError("ensemble: logits not finite")
    del model, members, bag, outs

    # A crash in fold 2: fold 1 in the progress file, fold 2's epochs gone.
    Path(cfg.model_path, "cv_manifest.json").unlink()
    shutil.rmtree(os.path.join(cfg.model_path, "fold_2"))
    Path(cfg.model_path, "cv_progress.json").write_text(json.dumps([folds[0]]))
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    with _Capture() as out:
        rc = cli.main(["cv", "--config", yml, "--resume"])
    resume_s = time.perf_counter() - t0
    rs = count(totals)
    resumed = json.loads(Path(cfg.model_path, "cv_manifest.json").read_text())["folds"]
    print(f"  cli cv --resume after a crash in fold 2: exit {rc}, {resume_s:.1f} s; fold 1 "
          f"reused {resumed[0] == folds[0]}, fold 2 retrained to a new checkpoint "
          f"{resumed[1]['checkpoint'] != folds[1]['checkpoint']} (accuracy "
          f"{resumed[1]['accuracy']}, before {folds[1]['accuracy']}); launches K5 "
          f"{rs['mc_head_bwd_sep']} (need {n[1][0]}: fold 2's train steps alone)", flush=True)
    if (rc != 0 or resumed[0] != folds[0] or resumed[1]["fold"] != 2
            or resumed[1]["checkpoint"] == folds[1]["checkpoint"]
            or not os.path.exists(resumed[1]["checkpoint"])
            or rs["mc_head_bwd_sep"] != n[1][0] or not out.lines("Resuming CV: folds [1]")):
        raise RuntimeError(f"cli cv --resume: fold 1 not reused or fold 2 not retrained: {rs}")
    print(f"  phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals, cfg, peak


# Phase 11's DICOM files: (view, side, transfer syntax, BitsStored, image
# seed).  One CC+MLO pair per side; the left pair uncompressed, the right
# pair RLE Lossless.
DICOM_FILES = (
    ("CC", "L", "1.2.840.10008.1.2.1", 12, 20),
    ("MLO", "L", "1.2.840.10008.1.2.1", 12, 21),
    ("CC", "R", "1.2.840.10008.1.2.5", 14, 22),
    ("MLO", "R", "1.2.840.10008.1.2.5", 14, 23),
)
AGES = {"L": "061Y", "R": "062Y"}


def _dicom_element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    """One explicit VR little endian element (PS3.5 7.1.2)."""
    import struct

    if len(value) % 2:
        value += b"\x00" if vr in (b"OB", b"UI") else b" "
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def _packbits_rows(plane: np.ndarray) -> bytes:
    """PackBits (PS3.5 G.3.1) of a byte plane, row by row: each row's zero
    background at either end as replicate runs, the rest as literal runs of
    at most 128 bytes."""
    out = []
    for row in plane:
        nz = np.flatnonzero(row)
        lead, tail = (int(nz[0]), int(len(row) - 1 - nz[-1])) if len(nz) else (len(row), 0)
        mid = row[lead:len(row) - tail]
        for zeros in (lead, None, tail):
            if zeros is None:
                m = len(mid)
                if m:
                    heads = np.minimum(128, m - np.arange(0, m, 128)) - 1
                    out.append(np.insert(mid, np.arange(0, m, 128), heads.astype(np.uint8))
                               .tobytes())
                continue
            while zeros >= 2:
                r = min(zeros, 128)
                out.append(bytes([257 - r, 0]))
                zeros -= r
            if zeros == 1:
                out.append(b"\x00\x00")  # a literal run of one zero byte
    return b"".join(out)


def _dicom_bytes(px: np.ndarray, bits: int, syntax: str, patient: str, age: str,
                 side: str) -> bytes:
    """A Part 10 file of one 16-bit grayscale frame with the header fields
    the reader returns: uncompressed, or RLE Lossless (two byte-plane
    segments, the most significant first)."""
    import struct

    rows, cols = px.shape
    out = b"\x00" * 128 + b"DICM" + _dicom_element(0x0002, 0x0010, b"UI", syntax.encode())
    for group, elem, vr, value in (
        (0x0010, 0x0020, b"LO", patient.encode()),
        (0x0010, 0x1010, b"AS", age.encode()),
        (0x0020, 0x0062, b"CS", side.encode()),
        (0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        (0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        (0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        (0x0028, 0x0101, b"US", struct.pack("<H", bits)),
        (0x0028, 0x0103, b"US", struct.pack("<H", 0)),
    ):
        out += _dicom_element(group, elem, vr, value)
    if syntax != "1.2.840.10008.1.2.5":
        return out + _dicom_element(0x7FE0, 0x0010, b"OW", px.astype("<u2").tobytes())
    msb = _packbits_rows((px >> 8).astype(np.uint8))
    lsb = _packbits_rows((px & 0xFF).astype(np.uint8))
    msb += b"\x00" * (len(msb) % 2)
    lsb += b"\x00" * (len(lsb) % 2)
    frame = struct.pack("<16I", 2, 64, 64 + len(msb), *([0] * 13)) + msb + lsb
    out += struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
    out += struct.pack("<HHI", 0xFFFE, 0xE000, 0)  # empty basic offset table
    out += struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame
    return out + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)


def check_dicom_and_infer(cv_cfg, cv_peak: float) -> dict:
    """Phase 11: full-size DICOM files through the port's reader, their
    CC+MLO records through ``BagLoader`` and the MC head, then ``cli infer``
    per fold and ``--ensemble`` on phase 10's models, and a small item on
    the card against the CPU.  Returns the launch counts of the phase's
    main paths."""
    from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.dicom_native import (
        library_path,
        load_library,
        make_native_dicom_reader,
        read_dicom_native,
    )
    from montecarlo_gated_mil_tpu_torch.data.pipeline import BagLoader
    from montecarlo_gated_mil_tpu_torch.data.dicom import split_cc_mlo
    from montecarlo_gated_mil_tpu_torch.data.records import select_records
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.experiment import _pipeline_cfgs, build_model
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    totals: dict = {k: 0 for k in cuda_build.KERNELS}

    def count() -> dict:
        got = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        for k, v in got.items():
            totals[k] += v
        return got

    built = not library_path().exists()
    t0 = time.perf_counter()
    load_library()
    print(f"  DICOM reader (csrc/dicom.cc): {'g++ build and load' if built else 'loaded'} in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{library_path().relative_to(Path(__file__).resolve().parent)}", flush=True)
    cfg = Config()
    d = cfg.data
    with tempfile.TemporaryDirectory() as tmp:
        # (a) full-size files, read back exactly
        root = Path(tmp, "dicom")
        (root / "Malignant").mkdir(parents=True)
        pixels, names = {}, {}
        for view, side, syntax, bits, seed in DICOM_FILES:
            img = synthetic_image(d.H, d.W, positive=True, seed=seed)
            if side == "R":
                img = img[:, ::-1]  # a right breast, anchored at the right edge
            px = np.round(img * (2**bits - 1)).astype(np.uint16)
            name = f"P{side}_{side}_{view}.dcm"
            t0 = time.perf_counter()
            data = _dicom_bytes(px, bits, syntax, f"PAT-{side}", AGES[side], side)
            Path(root, "Malignant", name).write_bytes(data)
            pixels[name], names[(side, view)] = (px, bits, syntax), name
            print(f"  wrote {name}: {syntax}, BitsStored {bits}, {len(data) / 2**20:.1f} MiB "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
        read_ms: dict = {}
        for name, (px, bits, syntax) in pixels.items():
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                img, meta = read_dicom_native(root / "Malignant" / name)
                times.append((time.perf_counter() - t0) * 1e3)
            side = name[1]
            exact = np.array_equal(img, px.astype(np.float32) / np.float32(2**bits - 1))
            header = (meta.patient_id, f"{meta.age:03d}Y", meta.laterality) == (
                f"PAT-{side}", AGES[side], side)
            read_ms.setdefault(syntax, []).extend(times)
            print(f"  read {name} ({syntax}): {img.shape}, exact {exact}, header {header}; "
                  f"{times[0]:.1f} / {times[1]:.1f} ms", flush=True)
            if not (exact and header and img.shape == (d.H, d.W)):
                raise RuntimeError(f"DICOM read of {name} is not exact: pixels {exact}, "
                                   f"header {meta}")
        for syntax, times in read_ms.items():
            print(f"  host ms per full-size file, {syntax}: "
                  + ", ".join(f"{t:.1f}" for t in times), flush=True)

        # (b) the records through the loader (2 read workers) and the head
        table = [{"view": [f"{s}{v}" for s, v in names], "class": ["Malignant"] * 4,
                  "filename": [names[k] for k in names]}]
        recs = select_records(table, d.view, multimodal=True)
        # The table claims L for both sides: the right pair's header must win.
        recs = [replace(r, laterality="L") for r in recs]
        _, eval_cfg = _pipeline_cfgs(cfg)
        spec = BucketSpec(cfg.tpu.buckets) if cfg.tpu.adaptive_buckets else None
        kw = dict(multimodal=True, seed=cfg.seed, bucket_spec=spec,
                  oversized=cfg.tpu.oversized_bags, device="cuda")
        model = build_model(cfg, seed=0).cuda().eval()
        cuda_build.reset_launch_counts()
        bags, outs = [], []
        for bag, rec in BagLoader(recs, make_native_dicom_reader(str(root)), eval_cfg,
                                  io_workers=2, **kw).epoch(0):
            bags.append((bag, rec))
            outs.append(mc_inference(model, bag.patches, bag.mask, cfg.N, 11))
        torch.cuda.synchronize()
        got = count()
        lats = [r.laterality for _, r in bags]
        pids = [(r.patient_id, r.age) for _, r in bags]
        print(f"  {len(bags)} CC+MLO records (select_records, multimodal): lateralities "
              f"{lats} from the headers (the table said L, L); patient ids and ages "
              f"{pids}; buckets "
              f"{[b.mask.shape[0] for b, _ in bags]}, valid "
              f"{[int(b.mask.sum()) for b, _ in bags]}; launches K3 {got['gather_tiles']}, K1 "
              f"{got['mc_head_sep']} (need {len(bags)} each)", flush=True)
        if (lats != ["L", "R"] or pids != [("PAT-L", 61), ("PAT-R", 62)]
                or got["gather_tiles"] != len(bags)
                or got["mc_head_sep"] != len(bags) or len(bags) != 2):
            raise RuntimeError(f"DICOM bags: lateralities {lats}, launches {got}")
        for out, (bag, _) in zip(outs, bags):
            n = bag.mask.shape[0]
            if (tuple(out.attention.shape) != (cfg.N, 2, n)
                    or not bool(torch.isfinite(out.predictions).all())):
                raise RuntimeError("DICOM bags: the head's outputs are not K1's at the bucket")

        def as_arrays(rec):
            return tuple(pixels[p][0].astype(np.float32) / np.float32(2 ** pixels[p][1] - 1)
                         for p in split_cc_mlo(rec.paths))

        ref_loader = BagLoader([r for _, r in bags], as_arrays, eval_cfg, io_workers=1, **kw)
        for (bag, rec), (ref, _) in zip(bags, ref_loader.epoch(0), strict=True):
            same = all(torch.equal(a, b) for a, b in zip(
                (bag.patches, bag.mask, bag.tile_indices), (ref.patches, ref.mask,
                                                            ref.tile_indices)))
            if not same:
                raise RuntimeError(f"the DICOM bag of {rec.paths} differs from the array bag")
        print("  each DICOM bag (2 read workers) equals the bag of its pixels given as arrays "
              "(1 worker) bit for bit", flush=True)
        loader = BagLoader(recs, make_native_dicom_reader(str(root)), eval_cfg, **kw)
        reader = loader.reader
        for i, rec in enumerate(recs):
            t0 = time.perf_counter()
            raw = reader(rec)
            host_ms = (time.perf_counter() - t0) * 1e3
            start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            torch.cuda.synchronize()
            start.record()
            bag, _ = loader._make_bag(i, 0, raw)
            mid.record()
            _, peak = peak_gib(lambda: mc_inference(model, bag.patches, bag.mask, cfg.N, 11))
            end.record()
            torch.cuda.synchronize()
            print(f"  {rec.view} pair: host read {host_ms:.1f} ms, bag (upload, resize "
                  f"{2 * d.H}x{d.W} -> {d.H}x{d.W}, K3) {start.elapsed_time(mid):.1f} ms, "
                  f"request (embed, K1, T={cfg.N}) {mid.elapsed_time(end):.1f} ms; bucket "
                  f"{bag.mask.shape[0]} ({int(bag.mask.sum())} valid); peak {peak:.3f} GiB",
                  flush=True)
        del model, bags, outs, bag

    check_infer_cli(cv_cfg, cv_peak, count)
    check_small_infer_against_cpu()
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals


def check_infer_cli(cfg, cv_peak: float, count) -> None:
    """``cli infer --max-items 2`` per fold and ``--ensemble`` on phase 10's
    models and manifest.  Where matplotlib does not import, the figure is
    the one step not run (a line says so); the arrays and statistics it
    would draw are checked either way: maps finite, mean maps in [0, 1],
    statistics equal to ``predictive_stats`` of the same outputs."""
    import os

    import yaml

    from montecarlo_gated_mil_tpu_torch import cli
    from montecarlo_gated_mil_tpu_torch.core.config import config_to_dict
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import predictive_stats
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.viz import infer as infer_mod

    real_plot = infer_mod.plot_attention_and_density
    try:
        import matplotlib  # noqa: F401

        draw = real_plot
        print("  matplotlib imports: cli infer draws every figure", flush=True)
    except ImportError as e:
        draw = None
        print(f"  figures not drawn: {e.name} does not import on this machine; everything "
              "before the figure runs and is checked", flush=True)
    real_mc, real_ens = infer_mod.mc_inference, infer_mod.ensemble_mc_inference
    calls, peaks = [], {"fold": [], "ensemble": []}

    def spy(kind, fn):
        def run(*args, **kw):
            out, peak = peak_gib(lambda: fn(*args, **kw))
            peaks[kind].append(peak)
            calls.append({"out": out})
            return out
        return run

    def figure(image, pos_att, pos_std, neg_att, neg_std, stats, **kw):
        calls[-1].update(image=image, maps=(pos_att, pos_std, neg_att, neg_std), stats=stats,
                         kw=kw)
        if draw is not None:
            draw(image, pos_att, pos_std, neg_att, neg_std, stats, **kw)
        return kw["save_path"]

    infer_mod.mc_inference = spy("fold", real_mc)
    infer_mod.ensemble_mc_inference = spy("ensemble", real_ens)
    infer_mod.plot_attention_and_density = figure
    try:
        with tempfile.TemporaryDirectory() as tmp:
            yml = os.path.join(tmp, "config.yml")
            Path(yml).write_text(yaml.safe_dump(config_to_dict(cfg)))
            folds = 2  # phase 10's, each an ensemble member
            for flag, kind in (([], "fold"), (["--ensemble"], "ensemble")):
                calls.clear()
                out_dir = os.path.join(tmp, "figures" + "".join(flag))
                cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                with _Capture() as out:
                    rc = cli.main(["infer", "--config", yml, "--out", out_dir, "--max-items", "2",
                                   *flag])
                secs = time.perf_counter() - t0
                got = count()
                items = len(calls)
                need = folds * 2  # K1 per fold (or member) and item
                print(f"  cli infer {' '.join(flag) or '(per fold)'}: exit {rc}, {secs:.1f} s, "
                      f"{items} items ({secs / max(items, 1):.2f} s per item); launches K1 "
                      f"{got['mc_head_sep']} (need {need}), K3 {got['gather_tiles']}; peak per "
                      f"item {', '.join(f'{p:.3f}' for p in peaks[kind])} GiB", flush=True)
                for ln in out.lines("done:"):
                    print(f"  | {ln}", flush=True)
                if rc != 0 or got["mc_head_sep"] != need or got["gather_tiles"] < items:
                    raise RuntimeError(f"cli infer {flag}: exit {rc}, launches {got}")
                for c in calls:
                    maps = [torch.as_tensor(m) for m in c["maps"]]
                    want = predictive_stats(c["out"].predictions)
                    finite = all(bool(torch.isfinite(m).all()) for m in maps)
                    unit = all(0.0 <= float(m.min()) and float(m.max()) <= 1.0
                               for m in (maps[0], maps[2]))
                    same = all(torch.equal(getattr(c["stats"], f).cpu(), getattr(want, f).cpu())
                               for f in vars(want))
                    if not (finite and unit and same):
                        raise RuntimeError(f"cli infer {flag}: maps finite {finite}, in [0, 1] "
                                           f"{unit}, statistics as recomputed {same}")
                    if draw is not None and not all(
                            os.path.exists(c["kw"]["save_path"] + e) for e in (".pdf", ".png")):
                        raise RuntimeError(f"cli infer {flag}: a figure was not written")
                if kind == "ensemble" and c["kw"]["num_samples"] != folds * cfg.N:
                    raise RuntimeError("cli infer --ensemble: not M * T samples")
        one, ens = max(peaks["fold"]), max(peaks["ensemble"])
        print(f"  the ensemble's peak on one item {ens:.3f} GiB against one member's "
              f"{one:.3f} GiB (phase 10's ensemble on one bag: {cv_peak:.3f} GiB)", flush=True)
        if ens > 1.1 * one + 0.5:
            raise RuntimeError("cli infer --ensemble holds more than one member's memory")
    finally:
        infer_mod.mc_inference, infer_mod.ensemble_mc_inference = real_mc, real_ens
        infer_mod.plot_attention_and_density = real_plot


def check_small_infer_against_cpu() -> None:
    """One ``run_inference`` item per fold at the CPU tests' geometry
    (128x128, patch 64, buckets (8, 16), 10 synthetic records, 2 folds,
    T=3, dropout 0), seeded weights: the statistics and maps of the card
    equal the CPU's within 1e-4."""
    import os

    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer
    from montecarlo_gated_mil_tpu_torch.viz import infer as infer_mod

    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_from_dict({
            "seed": 7, "model_path": tmp, "model": "r18", "N": 3, "feature_dropout": 0.0,
            "attention_dropout": 0.0, "shared_att": False,
            "data": {"H": 128, "W": 128, "patch_size": 64, "overlap_train": 0.0,
                     "overlap_val_test": 0.0, "empty_threshold": 0.05, "cv_folds": 2,
                     "fraction_test": 0.3, "synthetic_count": 10},
            "tpu": {"buckets": [8, 16]},
        })
        ck = Checkpointer(tmp)
        folds = [{"fold": k, "checkpoint": ck.save_params(
            f"fold_{k}", build_model(cfg, seed=k).state_dict()), "accuracy": 0.0} for k in (1, 2)]
        Path(tmp, "cv_manifest.json").write_text(json.dumps({"folds": folds}))
        real = infer_mod.plot_attention_and_density
        runs = {}
        try:
            for dev in ("cuda", "cpu"):
                got = []
                infer_mod.plot_attention_and_density = (
                    lambda *a, save_path, **k: got.append(a) or save_path)
                with _Capture():
                    infer_mod.run_inference(cfg, out_dir=os.path.join(tmp, dev), max_items=1,
                                            device=dev)
                runs[dev] = got
        finally:
            infer_mod.plot_attention_and_density = real
    err = 0.0
    for a, b in zip(runs["cuda"], runs["cpu"], strict=True):
        for x, y in zip(a[:5], b[:5]):
            err = max(err, float(np.abs(np.asarray(x) - np.asarray(y)).max()))
        for f in vars(a[5]):
            err = max(err, float((getattr(a[5], f).double() - getattr(b[5], f).double()).abs()
                                 .max()))
    print(f"  small run_inference (2 folds x 1 item, 128x128, T=3, dropout 0), card against "
          f"CPU: max |d| {err:.2e} over the maps, display image and statistics", flush=True)
    if len(runs["cuda"]) != 2 or err > 1e-4:
        raise RuntimeError(f"small run_inference: the card differs from the CPU by {err}")


# Phase 12's tolerances: the single-head head on the card against the CPU
# with dropout on (the same Philox masks), and serial against batched MC
# (K1's limits, as phase 3 holds it to its plain version).
SINGLE_HEAD_TOL = 1e-5
SERIAL_TOL_Y, SERIAL_TOL_A = 1e-4, 1e-5


def _events(n: int) -> list:
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def check_model_surface(pred, d) -> dict:
    """Phase 12: the single-head model's request, serial MC, counterfactual
    dropout, ``train_epoch_plain``, the uncertainty acceptance and the
    TensorBoard sink, at ``Config()``'s widths.  ``pred`` is phase 4's
    predictor: its shipped multi-head model, bucket choice and tile starts.
    Returns the launch counts of the phase's main paths: only the runs made
    through ``main``, never warm-ups, timing loops or the seed sweep."""
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    totals: dict = {k: 0 for k in cuda_build.KERNELS}

    def main(fn):
        """Runs ``fn`` as a main path, its launch counts zeroed just before
        and read just after: ``(fn's result, the counts)``."""
        cuda_build.reset_launch_counts()
        out = fn()
        got = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        for k, v in got.items():
            totals[k] += v
        return out, got

    bag = check_single_head_request(pred, d, main)
    check_serial_mc(pred, bag, main)
    check_counterfactuals(pred, bag, main)
    del bag
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tb_dir:
        tb = _tensorboard_sink(tb_dir)
        check_train_epoch_plain(main, tb)
        if tb is not None:
            events = list(Path(tb_dir).glob("events.out.tfevents.*"))
            size = sum(e.stat().st_size for e in events)
            print(f"  (f) TensorBoardSink: (d)'s epoch metrics in {len(events)} event file(s), "
                  f"{size} bytes", flush=True)
            if size == 0:
                raise RuntimeError("the TensorBoard sink wrote no events")
    check_uncertainty_acceptance(main)
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s; main-path launches "
          f"{ {k: n for k, n in totals.items() if n} }", flush=True)
    return totals


def _tensorboard_sink(log_dir: str):
    """A ``TensorBoardSink`` where ``torch.utils.tensorboard`` imports, else
    None and a line saying why the sink is not exercised."""
    from montecarlo_gated_mil_tpu_torch.utils.metrics import TensorBoardSink

    try:
        return TensorBoardSink(log_dir)
    except ImportError as e:
        print(f"  (f) TensorBoardSink not exercised: torch.utils.tensorboard does not import "
              f"here ({e})", flush=True)
        return None


def check_single_head_request(pred, d, main):
    """(a) The single-head model (K=1, one class, dropout 0.1/0.1, seeded
    weights) on phase 4's first full-size mammogram: ``image_to_bag`` (K3),
    the embed and ``mc_inference_single_head`` at T=50, then a small bag on
    the card against the CPU with dropout on.  Returns the bag."""
    from montecarlo_gated_mil_tpu_torch.data.pipeline import image_to_bag
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference_single_head
    from montecarlo_gated_mil_tpu_torch.models.gamil import GatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.serve import _prepare_image

    T = 50
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = GatedAttentionMIL(backbone="r18", D=128).cuda()
    img = synthetic_image(d.H, d.W, positive=False, seed=0)  # phase 4's first request, "L"
    arr, inv_max = _prepare_image(img, None)
    bucket = pred._pick_bucket(arr, "L")
    cfg = replace(pred.pipeline, bucket=bucket)

    def request():
        ev = _events(4)
        torch.cuda.synchronize()
        ev[0].record()
        image = torch.from_numpy(arr).cuda().to(torch.float32) * inv_max
        ev[1].record()
        with torch.inference_mode():
            bag = image_to_bag(image, False, 0, pred._starts, cfg, device="cuda")
        ev[2].record()
        out = mc_inference_single_head(model, bag.patches, bag.mask, T, 100)
        ev[3].record()
        torch.cuda.synchronize()
        return bag, out, [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    request()  # warm
    ((bag, out, ms), peak), launches = main(lambda: peak_gib(request))
    with torch.inference_mode():
        e0, e1 = _events(2)
        e0.record()
        model.embed(bag.patches, bag.mask)
        e1.record()
        torch.cuda.synchronize()
    embed_ms = e0.elapsed_time(e1)
    p, a = out.predictions, out.attention
    n = int(bag.mask.sum())
    print(f"  (a) single-head request: bucket {bucket}, {n} valid; upload {ms[0]:.2f} ms, "
          f"image_to_bag (K3) {ms[1]:.2f}, mc_inference_single_head T={T} {ms[2]:.2f} (its "
          f"embed alone {embed_ms:.2f}, so the head's {T} samples about "
          f"{ms[2] - embed_ms:.2f}); peak {peak:.3f} GiB; P {float(p.mean()):.4f}"
          f"±{float(p.std(correction=0)):.4f}; launches K3 {launches['gather_tiles']}, "
          f"K1 {launches['mc_head_sep']}", flush=True)
    sums = float((a[..., :n].sum(-1) - 1).abs().max())
    if not (p.shape == (T, 1) and a.shape == (T, 1, bucket) and bool(torch.isfinite(p).all())
            and bool(((p >= 0) & (p <= 1)).all()) and bool((a[..., ~bag.mask] == 0).all())
            and sums <= 1e-4 and out.aux_losses is None and launches["gather_tiles"] == 1):
        raise RuntimeError("the single-head request's predictions or attention are wrong")
    check_small_single_head_against_cpu()
    del model
    return bag


def check_small_single_head_against_cpu() -> None:
    """The single-head MC (dropout 0.25) of a small bag on the card and on
    the CPU: the same seed draws the same Philox masks on both."""
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference_single_head
    from montecarlo_gated_mil_tpu_torch.models.gamil import GatedAttentionMIL

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = GatedAttentionMIL(feature_dropout=0.25, attention_dropout=0.25)
    g = torch.Generator().manual_seed(5)
    mask = torch.arange(16) < 12
    patches = torch.randn(16, 64, 64, 3, generator=g) * mask[:, None, None, None]
    want = mc_inference_single_head(model, patches, mask, 8, 31, device="cpu")
    got = mc_inference_single_head(model.cuda(), patches.cuda(), mask.cuda(), 8, 31)
    err = max(float((got.predictions.cpu() - want.predictions).abs().max()),
              float((got.attention.cpu() - want.attention).abs().max()))
    print(f"  small single-head bag, card vs CPU (dropout 0.25, T=8): max|d| {err:.2e} "
          f"(tol {SINGLE_HEAD_TOL:g})", flush=True)
    if err > SINGLE_HEAD_TOL:
        raise RuntimeError("the single-head MC on the card disagrees with the CPU")


def check_serial_mc(pred, bag, main) -> None:
    """(b) ``mc_inference_serial`` at T=50 with ``targets`` on the shipped
    multi-head model beside ``mc_inference`` on (a)'s bag: 50 K1 launches,
    equal or within K1's tolerances, and 50 auxiliary losses; then the head
    stage alone, serial and batched."""
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import (
        mc_head,
        mc_head_serial,
        mc_inference,
        mc_inference_serial,
    )
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import GatedAttentionParams

    T, seed, model = 50, 7, pred.model
    serial, launches = main(lambda: mc_inference_serial(model, bag.patches, bag.mask, T, seed,
                                                        targets=1))
    batched, _ = main(lambda: mc_inference(model, bag.patches, bag.mask, T, seed))
    aux = serial.aux_losses
    dy = float((serial.predictions - batched.predictions).abs().max())
    da = float((serial.attention - batched.attention).abs().max())
    equal = torch.equal(serial.predictions, batched.predictions) and torch.equal(
        serial.attention, batched.attention)
    params = GatedAttentionParams.from_module(model)
    with torch.inference_mode():
        H = model.embed(bag.patches, bag.mask)
        times = {}
        for name, fn in (("serial", mc_head_serial), ("batched", mc_head)):
            fn(model, H, bag.mask, T, seed, params)  # warm
            ev = _events(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            fn(model, H, bag.mask, T, seed, params)
            ev[1].record()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            times[name] = (ev[0].elapsed_time(ev[1]), host)
        del H
    print(f"  (b) serial MC, T={T}: K1 launches {launches['mc_head_sep']}; serial vs "
          f"mc_inference {'bit-equal' if equal else 'not bit-equal'}, max|dY| {dy:.3e} (tol "
          f"{SERIAL_TOL_Y:g}), max|dA| {da:.3e} (tol {SERIAL_TOL_A:g}); head stage serial "
          f"{times['serial'][0]:.2f} ms ({times['serial'][1]:.2f} ms host to queue), batched "
          f"{times['batched'][0]:.2f} ms ({times['batched'][1]:.2f}); aux_losses "
          f"{tuple(aux.shape)}, mean {float(aux.mean()):.5f}", flush=True)
    if launches["mc_head_sep"] != T or dy > SERIAL_TOL_Y or da > SERIAL_TOL_A:
        raise RuntimeError("serial MC did not launch K1 once per sample or disagrees with "
                           "mc_inference")
    if aux.shape != (T,) or not bool(torch.isfinite(aux).all()):
        raise RuntimeError("serial MC's auxiliary losses are not 50 finite values")


def check_counterfactuals(pred, bag, main) -> None:
    """(c) ``causal_counterfactual_dropout`` at T=50 on the shipped model
    and (a)'s bag: importance in (0, 1), drop rates beside their
    expectation, counterfactual attention mass at most 1."""
    from montecarlo_gated_mil_tpu_torch.models.causal import causal_counterfactual_dropout

    T = 50
    causal_counterfactual_dropout(pred.model, bag.patches, bag.mask, T, 3)  # warm
    ev = _events(2)

    def run():
        torch.cuda.synchronize()
        ev[0].record()
        got = causal_counterfactual_dropout(pred.model, bag.patches, bag.mask, T, 3)
        ev[1].record()
        torch.cuda.synchronize()
        return got

    out, launches = main(run)
    mask = bag.mask
    n, N = int(mask.sum()), mask.shape[0]
    imp = out.importance.double()
    expect = (imp * mask).sum(-1) / N  # mean importance over valid slots x valid / N
    se = (imp * (1 - imp) * mask).sum(-1).sqrt() / N / T**0.5
    rates = out.drop_rates.double()
    mass = float(out.counterfactual_attention.sum(-1).max())
    inside = bool(((imp > 0) & (imp < 1)).all())
    print(f"  (c) counterfactual dropout, T={T}: {ev[0].elapsed_time(ev[1]):.2f} ms (embed "
          f"included); importance in (0, 1) {inside} (range {float(imp.min()):.4f}-"
          f"{float(imp.max()):.4f}); drop_rates {[round(float(r), 5) for r in rates]} beside "
          f"mean importance over valid x {n}/{N} "
          f"{[round(float(e), 5) for e in expect]} (standard error "
          f"{[round(float(s), 5) for s in se]}); counterfactual attention mass max {mass:.6f}; "
          f"K1 launches {launches['mc_head_sep']}", flush=True)
    if not (inside and mass <= 1 + 1e-5 and bool(((rates - expect).abs() <= 5 * se).all())
            and launches["mc_head_sep"] == 1):
        raise RuntimeError("counterfactual dropout's importance, drop rates or mass are wrong")


def check_train_epoch_plain(main, tb) -> None:
    """(d) ``train_epoch_plain``: 4 SGD steps of the single-head model on 4
    full-size synthetic training bags at bucket 1024, metrics to a memory
    sink and ``tb`` (a TensorBoard sink, or None)."""
    from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.pipeline import BagLoader
    from montecarlo_gated_mil_tpu_torch.data.synthetic import (
        make_synthetic_reader,
        synthetic_records,
    )
    from montecarlo_gated_mil_tpu_torch.experiment import _pipeline_cfgs
    from montecarlo_gated_mil_tpu_torch.models.gamil import GatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.train.loops import train_epoch_plain
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState
    from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics

    cfg = Config()
    train_cfg, _ = _pipeline_cfgs(cfg)
    loader = BagLoader(
        synthetic_records(12, seed=cfg.seed), make_synthetic_reader(cfg.data.H, cfg.data.W),
        train_cfg, seed=cfg.seed, bucket_spec=BucketSpec(cfg.tpu.buckets), device="cuda",
    )

    def first_bags():
        items = loader.epoch(1)
        got = list(itertools.islice(((b, r) for b, r in items
                                     if b.mask.shape[0] == train_cfg.bucket), 4))
        items.close()  # stops the producer
        return got

    bags, bag_launches = main(first_bags)
    if len(bags) < 4 or train_cfg.bucket != 1024:
        raise RuntimeError(f"fewer than 4 training bags at bucket 1024 ({train_cfg.bucket})")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = GatedAttentionMIL(backbone=cfg.model).cuda()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=cfg.training_plan.parameters.lr)
    sink = MemorySink()
    metrics = Metrics([sink] + ([tb] if tb is not None else []))
    marks = []

    def timed(items):
        for item in items:
            marks.append(_events(1)[0])
            marks[-1].record()
            yield item
        marks.append(_events(1)[0])
        marks[-1].record()

    (state, peak), _ = main(lambda: peak_gib(lambda: train_epoch_plain(
        model, TrainState(model, opt), timed(bags), opt, epoch=1, key=cfg.seed, metrics=metrics)))
    metrics.close()
    torch.cuda.synchronize()
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(len(marks) - 1)]
    after = model.state_dict()
    moved = {part: any(not torch.equal(before[k], after[k]) for k in before
                       if k.startswith("feature_extractor.") == (part == "backbone"))
             for part in ("backbone", "head")}
    loss, acc = sink.values("train/epoch_loss"), sink.values("train/epoch_acc")
    print(f"  (d) train_epoch_plain: 4 bags at bucket {train_cfg.bucket} "
          f"({[int(b.mask.sum()) for b, _ in bags]} valid), SGD lr "
          f"{cfg.training_plan.parameters.lr:g}; ms per step "
          f"{[round(m, 1) for m in step_ms]} (CUDA events); peak {peak:.3f} GiB; epoch loss "
          f"{loss}, acc {acc}; step {state.step}; weights moved {moved}; K3 launches for the "
          f"bags {bag_launches['gather_tiles']}", flush=True)
    if not (state.step == 4 and len(loss) == 1 and np.isfinite(loss[0]) and all(moved.values())):
        raise RuntimeError("train_epoch_plain: step count, loss or weight update is wrong")
    del bags, model, opt, state
    torch.cuda.empty_cache()


# The acceptance's seed sweep: seeds 0-11, each held to all five criteria,
# and the least number of them that must meet all five: as many as meet them
# in the JAX package's own harness on the same seeds, by
# tests/uncertainty_seeds.py on an x86 CPU with XLA's default threading (6;
# 4 with one Eigen thread, seed 0 among the misses).
SWEEP_SEEDS = tuple(range(12))
SWEEP_MIN_PASSES = 6


def check_uncertainty_acceptance(main) -> None:
    """(e) The uncertainty acceptance (``evaluation/uncertainty.py``, the
    port of the JAX package's ``tests/test_uncertainty.py``) trained on the
    card at seed 0 and checked with its thresholds.  The fit and the two
    uncertainty ratios must hold at seed 0.  Whether the class-1 attention
    settles on the lesion tiles depends on the training trajectory, in the
    JAX package as in the port (ROADMAP.md queue 3), so a seed-0 miss of the
    attention criteria is printed as the open fault it is, and then every
    seed of ``SWEEP_SEEDS`` is held to all five criteria: the phase fails
    if fewer than ``SWEEP_MIN_PASSES`` of them meet all five."""
    from montecarlo_gated_mil_tpu_torch.evaluation import uncertainty as u

    def run(seed: int):
        t0 = time.perf_counter()
        model, accs = u.train_toy_model(seed=seed, device="cuda")
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        values, oks = u.criteria(accs, (*u.uncertainty_ratios(model), *u.attention_ratios(model)))
        return accs, values, oks, train_s, time.perf_counter() - t0

    (accs, values, oks, train_s, eval_s), launches = main(lambda: run(0))
    print(f"  (e) uncertainty acceptance, seed 0: trained 24 bags x 14 epochs in {train_s:.1f} s "
          f"(accuracy per epoch {[round(a, 4) for a in accs]}), evaluated 24 bags x T={u.T} in "
          f"{eval_s:.1f} s; {u.describe(values, oks)}; launches K2 "
          f"{launches['mc_head_shared']}, K4 {launches['mc_head_bwd_shared']}", flush=True)
    if not all(oks[:3]):
        raise RuntimeError("the uncertainty acceptance failed on the card: the fit or the "
                           "predictive-uncertainty ratios")
    if not all(oks[3:]):
        print("      seed 0 misses the attention criteria: open fault, ROADMAP.md queue 3",
              flush=True)
    passed = [0] if all(oks) else []
    for seed in SWEEP_SEEDS[1:]:  # seed 0's is the acceptance's, above
        _, values, oks, train_s, _ = run(seed)
        print(f"      seed {seed} ({train_s:.1f} s): {u.describe(values, oks)}", flush=True)
        if all(oks):
            passed.append(seed)
    print(f"      all five criteria met at {len(passed)} of {len(SWEEP_SEEDS)} seeds "
          f"({', '.join(map(str, passed))}); at least {SWEEP_MIN_PASSES} required", flush=True)
    if len(passed) < SWEEP_MIN_PASSES:
        raise RuntimeError(f"the uncertainty acceptance met all five criteria at {len(passed)} "
                           f"of {len(SWEEP_SEEDS)} seeds, fewer than {SWEEP_MIN_PASSES}")


# Phase 13: (bucket, valid instances) of (b)'s synthetic bags at 224 px, one
# of them oversized (above the registry's 1024, divisible by the mesh), and
# the limits that hold the sharded request to the whole-bag one (K1's).
DP_BAGS = ((64, 40), (256, 200), (128, 100), (64, 50), (512, 400), (2048, 1500), (256, 180),
           (128, 90), (64, 33), (512, 300))
SHARD_STATS_TOL, SHARD_ATTN_TOL, ENSEMBLE_TOL = 1e-4, 1e-5, 2e-5


def phase10_members(cv_cfg):
    """Phase 10's fold models as ensemble members (host state dicts) and its
    first test bag's patches and mask on the card, for phase 13 (d)."""
    from montecarlo_gated_mil_tpu_torch.experiment import get_fold_dataloaders
    from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import load_fold_ensemble

    manifest = json.loads(Path(cv_cfg.model_path, "cv_manifest.json").read_text())
    bag, _ = next(iter(get_fold_dataloaders(cv_cfg, 0, device="cuda").test.epoch(0)))
    return load_fold_ensemble(cv_cfg, manifest), (bag.patches, bag.mask)


def check_parallel_paths(pred, weights, requests, d, members, member_bag) -> dict:
    """Phase 13: the parallel paths at ``Config()``'s widths on meshes of
    repeated ``cuda:0`` entries: (a) phase 4's full-size requests through a
    predictor with an ``inst`` mesh of 2 and of 4, each result against the
    whole-bag ``predict`` of the same seed; (b) ``mc_test_dp`` on a ``data``
    mesh of 4 over ``DP_BAGS`` in f32 and int8, against the sequential
    ``mc_test`` with the same ``shard_over`` and mesh, bag for bag; (c)
    ``predict_many(dp=True)`` on a ``data`` mesh of 2 over phase 4b's four
    requests, each against ``predict``; (d) the member-sharded ensemble of
    phase 10's two fold models on a ``data`` mesh of 2 against the
    sequential one.  Returns the launch counts of the parallel runs, each
    zeroed just before the run and read just after."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.evaluation.dp_eval import _mc_test_dp_outputs
    from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import (
        ensemble_mc_inference,
        ensemble_mc_inference_sharded,
    )
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.parallel.mesh import make_mesh
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor
    from montecarlo_gated_mil_tpu_torch.train.loops import _mc_test_outputs

    t_phase = time.perf_counter()
    cfg = Config()
    totals = {k: 0 for k in cuda_build.KERNELS}
    cuda0 = torch.device("cuda", 0)

    def main(fn):
        cuda_build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        for k, v in got.items():
            totals[k] += v
        return out, got

    def image(kind, img_seed):
        img = synthetic_image(d.H, d.W, positive=bool(img_seed % 2), seed=img_seed)
        return np.round(img * 65535).astype(np.uint16) if kind == "uint16" else img

    def timed(p, img, lat, seed):
        t0 = time.perf_counter()
        r, peak = peak_gib(lambda: p.predict(img, lat, seed=seed))
        return r, (time.perf_counter() - t0) * 1e3, peak

    def stats_err(a, b) -> float:
        return max(float((getattr(a.stats, f) - getattr(b.stats, f)).abs().max())
                   for f in vars(a.stats))

    def attn_err(a, b) -> float:
        return max(float((a.attention.mean - b.attention.mean).abs().max()),
                   float((a.attention.std - b.attention.std).abs().max()))

    # (a) instance-sharded requests against the whole bag.
    reqs = [(image(kind, s), lat, seed) for kind, lat, s, seed in requests[:4]]
    whole = [timed(pred, *r) for r in reqs]
    print("  (a) phase 4's requests whole (phase 4's predictor): "
          + "; ".join(f"bucket {r.bucket} {ms:.1f} ms {gib:.3f} GiB" for r, ms, gib in whole),
          flush=True)
    for inst in (2, 4):
        mesh = make_mesh(data=1, inst=inst, devices=[cuda0] * inst)
        sp = MCDOPredictor.from_config(cfg, weights, mesh=mesh)
        sp.predict(*reqs[0][:2], seed=reqs[0][2])  # warm: cuDNN at the shard shapes
        runs, got = main(lambda: [timed(sp, *r) for r in reqs])
        for (w, _, _), (r, _, _) in zip(whole, runs):
            se, ae = stats_err(w, r), attn_err(w, r)
            if (r.bucket != w.bucket or r.num_instances != w.num_instances
                    or r.prediction != w.prediction or not se <= SHARD_STATS_TOL
                    or not ae <= SHARD_ATTN_TOL):
                raise RuntimeError(f"(a) inst={inst}: bucket {r.bucket}/{w.bucket}, instances "
                                   f"{r.num_instances}/{w.num_instances}, prediction "
                                   f"{r.prediction}/{w.prediction}, stats {se}, attention {ae}")
        print(f"  (a) inst mesh of {inst}: "
              + "; ".join(f"{ms:.1f} ms {gib:.3f} GiB" for _, ms, gib in runs)
              + f"; max |d stats| {max(stats_err(w[0], r[0]) for w, r in zip(whole, runs)):.3e}"
              f" (<= {SHARD_STATS_TOL}), max |d attention| "
              f"{max(attn_err(w[0], r[0]) for w, r in zip(whole, runs)):.3e} "
              f"(<= {SHARD_ATTN_TOL}); launches K3 {got['gather_tiles']} K1 "
              f"{got['mc_head_sep']}", flush=True)
        if got["gather_tiles"] < len(reqs):
            raise RuntimeError(f"(a) inst={inst}: the requests did not go through K3: {got}")
        del sp
    torch.cuda.empty_cache()

    # (b) mc_test_dp against the sequential mc_test, bag for bag.
    g = torch.Generator(device="cuda").manual_seed(13)
    bags = []
    for i, (bucket, n) in enumerate(DP_BAGS):
        mask = torch.arange(bucket, device="cuda") < n
        patches = torch.rand((bucket, d.patch_size, d.patch_size, 3), generator=g,
                             device="cuda") * mask[:, None, None, None]
        bags.append((Bag(patches, mask, torch.tensor(i % 2, device="cuda"),
                         torch.where(mask, torch.arange(bucket, device="cuda"), 0)), None))
    shard_over = max(cfg.tpu.buckets)
    mesh4 = make_mesh(data=4, devices=[cuda0] * 4)
    model = pred.model
    for quantized in (False, True):
        kw = dict(num_samples=cfg.N, seed=7, quantized=quantized, shard_over=shard_over)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            seq = _mc_test_outputs(model, bags, mesh=mesh4, **kw)
            seq_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dp, got = main(lambda: _mc_test_dp_outputs(model, bags, mesh=mesh4, **kw))
            dp_s = time.perf_counter() - t0
        dy = [float((a - b).abs().max()) for a, b in zip(seq[2], dp[2])]
        warned = sum("mixes evaluation regimes" in str(w.message) for w in caught)
        label = "int8" if quantized else "f32"
        print(f"  (b) mc_test_dp {label}, data mesh of 4, {len(bags)} bags (buckets "
              f"{sorted({b for b, _ in DP_BAGS})}, one oversized): labels {dp[1]} (sequential "
              f"{seq[1]}); largest per-bag |dY| {max(dy):.3e}; {dp_s:.1f} s (sequential "
              f"{seq_s:.1f} s); launches K1 {got['mc_head_sep']} K6 {got['qconv_i8']} K7 "
              f"{got['bn_stats']} K8 {got['bn_relu_quant']}; mixed-regime warnings {warned}",
              flush=True)
        need_k1 = len(bags) - 1  # every bag but the oversized one, padding aside
        if (dp[1] != seq[1] or dp[0] != seq[0] or got["mc_head_sep"] < need_k1
                or (quantized and min(got["qconv_i8"], got["bn_stats"], got["bn_relu_quant"]) < 1)
                or (quantized and warned < 2) or max(dy) != 0.0):
            raise RuntimeError(f"(b) mc_test_dp {label}: labels {dp[1]} vs {seq[1]}, |dY| "
                               f"{max(dy)}, launches {got}, warnings {warned}")
    del bags
    torch.cuda.empty_cache()

    # (c) predict_many(dp=True) against predict: a registry reaching 3072, so
    # that the full-size requests ride the batch instead of leaving it.
    ccfg = replace(cfg, tpu=replace(cfg.tpu, buckets=cfg.tpu.buckets + (2048, 3072)))
    mesh2 = make_mesh(data=2, devices=[cuda0] * 2)
    cp = MCDOPredictor.from_config(ccfg, weights, mesh=mesh2)
    imgs, lats, seeds = zip(*[(image(kind, s), lat, seed) for kind, lat, s, seed in (
        ("float", "L", 10, 200), ("uint16", "R", 11, 201), ("float", "R", 12, 202),
        ("uint16", "L", 13, 203))])
    want = [cp.predict(img, lat, seed=seed) for img, lat, seed in zip(imgs, lats, seeds)]
    t0 = time.perf_counter()
    (many, peak), got = main(lambda: peak_gib(
        lambda: cp.predict_many(list(imgs), list(lats), seeds=list(seeds), dp=True)))
    many_s = time.perf_counter() - t0
    same = [torch.equal(w.stats.mean_probs, m.stats.mean_probs)
            and all(torch.equal(getattr(w.stats, f), getattr(m.stats, f)) for f in vars(w.stats))
            and torch.equal(w.attention.mean, m.attention.mean)
            and torch.equal(w.attention.std, m.attention.std)
            and (w.bucket, w.num_instances) == (m.bucket, m.num_instances)
            for w, m in zip(want, many)]
    print(f"  (c) predict_many(dp=True), data mesh of 2, buckets {[m.bucket for m in many]}: "
          f"{many_s * 1e3 / len(imgs):.1f} ms per request, peak {peak:.3f} GiB; equal to "
          f"predict bit for bit {same}; launches K3 {got['gather_tiles']} K1 "
          f"{got['mc_head_sep']}", flush=True)
    if not all(same) or got["mc_head_sep"] < len(imgs) or got["gather_tiles"] < len(imgs):
        raise RuntimeError(f"(c) predict_many(dp=True): equal {same}, launches {got}")
    del cp, want, many
    torch.cuda.empty_cache()

    # (d) the member-sharded ensemble against the sequential one.
    patches, mask = member_bag
    ref, ref_peak = peak_gib(lambda: ensemble_mc_inference(model, members, patches, mask,
                                                            cfg.N, 1))
    (out, peak), got = main(lambda: peak_gib(lambda: ensemble_mc_inference_sharded(
        model, members, patches, mask, cfg.N, 1, mesh2)))
    err = max(float((out.predictions - ref.predictions).abs().max()),
              float((out.attention - ref.attention).abs().max()))
    print(f"  (d) ensemble_mc_inference_sharded, {len(members)} members on a data mesh of 2 "
          f"(bucket {mask.shape[0]}): max |d| {err:.3e} (<= {ENSEMBLE_TOL}); peak {peak:.3f} GiB "
          f"(sequential {ref_peak:.3f} GiB); launches K1 {got['mc_head_sep']}", flush=True)
    if not err <= ENSEMBLE_TOL or got["mc_head_sep"] != len(members):
        raise RuntimeError(f"(d) sharded ensemble: |d| {err}, launches {got}")
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{ {k: n for k, n in totals.items() if n} }", flush=True)
    return totals


# Phase 14 (a): (bucket, valid tiles) of the five training bags: two groups
# of two, one partial group of one, on a data mesh of 2.
TRAIN_DP_BAGS = ((256, 200), (1024, 900), (512, 400), (256, 180), (1024, 700))
DP_TRAIN_TOL = 2e-5  # final weights, data-parallel against sequential (JAX's bar)
SHARD_LOSS_RTOL, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL = 1e-4, 2e-3, 2e-5
FANOUT_TIMEOUT = 600  # seconds, each fold process of (e)


def _excess(got: dict, want: dict, rtol: float, atol: float) -> float:
    """The largest amount by which ``|got - want|`` exceeds ``atol + rtol *
    |want|`` over every entry (<= 0: all within)."""
    return max(float(((got[k] - want[k]).abs() - atol - rtol * want[k].abs()).max())
               for k in want)


def _grads(model) -> dict:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def check_parallel_training(cv_cfg, cv_accuracies: dict) -> dict:
    """Phase 14: the training half of ``parallel/`` at ``Config()``'s widths
    on meshes of repeated ``cuda:0``, cuDNN deterministic and TF32 off:
    (a) ``train_epoch_dp`` on a data mesh of 2 over ``TRAIN_DP_BAGS``
    against ``train_epoch`` of the same bags and seeds; (b) one oversized
    bag at bucket 2048 through ``make_train_step_sharded`` at inst 2 and 4
    against the whole-bag ``make_train_step``; (c) the memory guard; (d)
    phase 7's ``run_training`` with ``tpu.async_checkpointing``, its
    checkpoints against a synchronous run's and a resume from them; (e)
    ``cli cv`` with phase 10's config fanned out over two processes.
    Returns the launch counts of these runs, each zeroed just before the run
    and read just after (the fold processes report their own)."""
    import copy

    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.data.pipeline import image_to_bag
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.experiment import (
        _pipeline_cfgs,
        build_criterion,
        build_model,
        build_optimizer,
    )
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.parallel.dp import make_dp_train_step
    from montecarlo_gated_mil_tpu_torch.parallel.mesh import make_mesh
    from montecarlo_gated_mil_tpu_torch.train import loops
    from montecarlo_gated_mil_tpu_torch.train.state import (
        TrainState,
        make_train_step,
        make_train_step_sharded,
    )

    t_phase = time.perf_counter()
    cfg = Config()
    d = cfg.data
    totals = {k: 0 for k in cuda_build.KERNELS}
    cuda0 = torch.device("cuda", 0)
    crit = build_criterion(cfg)

    def main(fn):
        cuda_build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        for k, v in got.items():
            totals[k] += v
        return out, got

    def trainer(model):
        opt, sched = build_optimizer(cfg, model)
        return opt, TrainState(model, opt, sched)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, peak = peak_gib(fn)
        return out, (time.perf_counter() - t0) * 1e3, peak

    flags = torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                       allow_tf32=False)
    with flags:
        # (a) the data-parallel epoch against the sequential one.
        g = torch.Generator(device="cuda").manual_seed(14)
        items = []
        for i, (bucket, n) in enumerate(TRAIN_DP_BAGS):
            mask = torch.arange(bucket, device="cuda") < n
            patches = torch.rand((bucket, d.patch_size, d.patch_size, 3), generator=g,
                                 device="cuda") * mask[:, None, None, None]
            items.append((Bag(patches, mask, torch.tensor(i % 2, device="cuda"),
                              torch.where(mask, torch.arange(bucket, device="cuda"), 0)), None))
        k = len(items)  # one update, at epoch end: the two epochs apply one gradient
        base = build_model(cfg, seed=21).cuda()
        seq_model, dp_model = copy.deepcopy(base), copy.deepcopy(base)
        opt, state = trainer(seq_model)
        seq_step = make_train_step(seq_model, crit, opt, k)
        kw = dict(epoch=1, accumulation_steps=k, key=5)
        with _Capture():
            (state, seq_ms, seq_peak), got_seq = main(lambda: timed(
                lambda: loops.train_epoch(seq_step, state, items, **kw)))
        mesh2 = make_mesh(data=2, devices=[cuda0] * 2)
        opt2, state2 = trainer(dp_model)
        dp_step, dp_apply = make_dp_train_step(dp_model, crit, opt2, mesh2)
        with _Capture():
            (state2, dp_ms, dp_peak), got_dp = main(lambda: timed(
                lambda: loops.train_epoch_dp(dp_step, dp_apply, state2, items, mesh2, **kw)))
        err = max(float((a - b).abs().max()) for a, b in zip(
            seq_model.state_dict().values(), dp_model.state_dict().values()))
        moved = max(float((a - b).abs().max()) for a, b in zip(
            base.state_dict().values(), dp_model.state_dict().values()))
        print(f"  (a) train_epoch_dp, data mesh of 2, {k} bags (buckets "
              f"{[b for b, _ in TRAIN_DP_BAGS]}; groups of 2, 2 and a padded 1), k={k}: "
              f"{dp_ms / k:.1f} ms per bag, peak {dp_peak:.3f} GiB (sequential train_epoch "
              f"{seq_ms / k:.1f} ms per bag, {seq_peak:.3f} GiB); steps {state2.step}/"
              f"{state.step}; max |d weights| {err:.3e} (<= {DP_TRAIN_TOL}), moved "
              f"{moved:.3e}; launches K1 {got_dp['mc_head_sep']} K5 "
              f"{got_dp['mc_head_bwd_sep']} (sequential {got_seq['mc_head_sep']}, "
              f"{got_seq['mc_head_bwd_sep']})", flush=True)
        if (not err <= DP_TRAIN_TOL or moved == 0.0 or state.step != 1 or state2.step != 1
                or got_dp["mc_head_sep"] != k or got_dp["mc_head_bwd_sep"] != k):
            raise RuntimeError(f"(a) train_epoch_dp: |d| {err}, steps {state2.step}, "
                               f"launches {got_dp}")
        del items, seq_model, dp_model, state, state2, opt, opt2, seq_step, dp_step, dp_apply
        torch.cuda.empty_cache()

        # (b) one oversized bag at bucket 2048: sharded steps against the whole bag.
        _, eval_cfg = _pipeline_cfgs(cfg)
        starts = torch.from_numpy(eval_cfg.grid().tiles_array()[:, :2]).long()
        img = synthetic_image(d.H, d.W, positive=False, seed=0)  # phase 4's first request
        (bag, _), got_bag = main(lambda: (image_to_bag(
            img, False, 1, starts, replace(eval_cfg, bucket=2048), device="cuda"), 0))
        n_valid = int(bag.mask.sum())
        whole_model = build_model(cfg, seed=22).cuda()
        opt, state = trainer(whole_model)
        whole_step = make_train_step(whole_model, crit, opt, 1)
        ((_, out), whole_ms, _), got_whole = main(lambda: timed(
            lambda: whole_step(state, bag, 3, False)))
        whole_abs = torch.cuda.max_memory_allocated() / 2**30  # since timed's reset
        want, loss = _grads(whole_model), float(out["loss"])
        print(f"  (b) oversized training bag: bucket 2048, {n_valid} valid tiles (phase 4's "
              f"first mammogram, eval grid); whole-bag make_train_step {whole_ms:.1f} ms, peak "
              f"{whole_abs:.3f} GiB allocated in all; loss {loss:.6f}; launches K1 "
              f"{got_whole['mc_head_sep']} K5 {got_whole['mc_head_bwd_sep']}", flush=True)
        base_sd = copy.deepcopy(whole_model.state_dict())
        del state, opt, whole_step
        whole_model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        shard_ok = got_whole["mc_head_sep"] == 1 and got_whole["mc_head_bwd_sep"] == 1
        for inst in (2, 4):
            model = build_model(cfg, seed=22).cuda()
            model.load_state_dict(base_sd)
            opt, state = trainer(model)
            step = make_train_step_sharded(model, crit, opt, 1,
                                           make_mesh(data=1, inst=inst, devices=[cuda0] * inst))
            ((_, out), ms, peak), got = main(lambda: timed(lambda: step(state, bag, 3, False)))
            in_all = torch.cuda.max_memory_allocated() / 2**30  # since timed's reset
            lerr = abs(float(out["loss"]) - loss) / abs(loss)
            gex = _excess(_grads(model), want, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL)
            print(f"  (b) make_train_step_sharded inst {inst}: {ms:.1f} ms, peak {in_all:.3f} GiB "
                  f"allocated in all ({peak:.3f} above its start); loss rel. error {lerr:.3e} (<= {SHARD_LOSS_RTOL}); "
                  f"gradients' largest excess over rtol {SHARD_GRAD_RTOL} / atol "
                  f"{SHARD_GRAD_ATOL}: {gex:.3e} (<= 0); launches K1 {got['mc_head_sep']} K5 "
                  f"{got['mc_head_bwd_sep']}", flush=True)
            shard_ok = (shard_ok and lerr <= SHARD_LOSS_RTOL and gex <= 0.0
                        and got["mc_head_sep"] == 1 and got["mc_head_bwd_sep"] == 1)
            del model, opt, state, step
            torch.cuda.empty_cache()
        if not shard_ok:
            raise RuntimeError("(b) the sharded training steps disagree with the whole bag or "
                               "missed K1/K5")
        # (b) the same bag and seed through the plain head: make_train_step(use_pallas=False).
        model = build_model(cfg, seed=22).cuda()
        model.load_state_dict(base_sd)
        opt, state = trainer(model)
        step = make_train_step(model, crit, opt, 1, use_pallas=False)
        ((_, out), ms, _), got = main(lambda: timed(lambda: step(state, bag, 3, False)))
        lerr = abs(float(out["loss"]) - loss) / abs(loss)
        gex = _excess(_grads(model), want, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL)
        heads = {k: got[k] for k in ("mc_head_sep", "mc_head_bwd_sep", "mc_head_shared",
                                     "mc_head_bwd_shared")}
        print(f"  (b) make_train_step(use_pallas=False), the plain head: {ms:.1f} ms; loss rel. "
              f"error {lerr:.3e} (<= {SHARD_LOSS_RTOL}); gradients' largest excess over rtol "
              f"{SHARD_GRAD_RTOL} / atol {SHARD_GRAD_ATOL} against the kernel step: {gex:.3e} "
              f"(<= 0); launches K1/K5/K2/K4 {heads}", flush=True)
        if any(heads.values()) or not lerr <= SHARD_LOSS_RTOL or not gex <= 0.0:
            raise RuntimeError(f"(b) the plain-head step: launches {heads}, loss {lerr}, "
                               f"gradients {gex}")
        del model, opt, state, step, whole_model, want
        torch.cuda.empty_cache()

        # (c) the guard: the card's estimate against (b)'s measured peak.
        shipped = build_model(cfg)  # on the CPU: what the guard reads of the model trained
        est = loops._train_step_bytes(bag, shipped) / 2**30
        loops._check_unrouted_train_bag(bag, max(cfg.tpu.buckets), shipped)  # 2048 fits
        big = Bag(torch.zeros((3072, d.patch_size, d.patch_size, 3), device="cuda"),
                  torch.ones(3072, dtype=torch.bool, device="cuda"),
                  torch.tensor(1, device="cuda"), torch.arange(3072, device="cuda"))
        ran = []
        try:
            loops.train_epoch(lambda *a: ran.append(a), TrainState(shipped, None),
                              [(big, None)], epoch=1, accumulation_steps=1, key=0,
                              shard_over=max(cfg.tpu.buckets))
            raised = ""
        except ValueError as e:
            raised = str(e)
        limit = torch.cuda.get_device_properties(0).total_memory / 2**30
        print(f"  (c) guard: card {limit:.2f} GiB; bucket 2048 estimate {est:.2f} GiB (no raise; "
              f"(b)'s whole-bag peak {whole_abs:.3f} GiB in all); bucket 3072 estimate "
              f"{loops._train_step_bytes(big, shipped) / 2**30:.2f} GiB: raised before the step "
              f"{bool(raised) and not ran}: {raised[:90]}...", flush=True)
        if not raised or ran or not whole_abs < est:
            raise RuntimeError(f"(c) guard: raised {bool(raised)}, step ran {bool(ran)}, peak "
                               f"{whole_abs} GiB against the estimate {est} GiB")
        del big, bag, shipped
        torch.cuda.empty_cache()
        check_guard_pairs()

        # (d) run_training with asynchronous checkpoints.
        check_async_checkpoints(main)
    torch.cuda.empty_cache()

    # (e) cli cv fanned out over two processes, against phase 10's manifest.
    check_fold_fanout(cv_cfg, cv_accuracies, totals)
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{ {k: n for k, n in totals.items() if n} }", flush=True)
    return totals


# Phase 14 (c): the training step's peak beside the guard's estimate at every
# backbone and compute dtype the config accepts, at these buckets of 224 px
# patches; the first two must run, the third runs where the smaller ones'
# bytes per input element put it within 90 % of the card.  float64 at two
# smaller ones: its r50 step at 512 would not fit the card, and its steps are
# the slowest of the phase.
GUARD_PAIRS = tuple(itertools.product(("r18", "r34", "r50"),
                                      ("float32", "bfloat16", "float64")))
GUARD_BUCKETS = {"float32": (256, 512, 1024), "bfloat16": (256, 512, 1024),
                 "float64": (128, 256)}


def check_guard_pairs() -> dict:
    """Phase 14 (c): ``tools/measure_hbm.py::train_peaks`` for each of
    ``GUARD_PAIRS`` (``Config()`` with that backbone and compute dtype:
    ``make_train_step``, K1/K5, the shipped optimizer; cuDNN's default
    algorithm choice, as the main path runs), each peak beside the guard's
    estimate and its bytes per input element.  Raises where an estimate lies
    below a measured peak, or where one of a pair's first two buckets did
    not run.  Returns ``{(backbone, dtype): rows}``."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.tools import _common, measure_hbm

    t0 = time.perf_counter()
    gib = 1 / 2**30
    out, bad = {}, []
    for backbone, dtype in GUARD_PAIRS:
        base = Config()
        cfg = replace(base, model=backbone, tpu=replace(base.tpu, compute_dtype=dtype))
        with _common.main_path_settings():
            rows = measure_hbm.train_peaks(cfg, GUARD_BUCKETS[dtype])
        out[(backbone, dtype)] = rows
        cells = []
        for b, row in rows.items():
            if row["train"] is None:
                cells.append(f"{b}: not run ({row['skipped']}; estimate "
                             f"{row['guard'] * gib:.2f} GiB)")
                if b in GUARD_BUCKETS[dtype][:2]:
                    bad.append((backbone, dtype, b, row))
                continue
            per = row["train"] / (b * 224 * 224 * 3)
            cells.append(f"{b}: peak {row['train'] * gib:.3f} GiB ({per:.1f} B an input element) "
                         f"against the estimate {row['guard'] * gib:.3f}")
            if row["guard"] < row["train"]:
                bad.append((backbone, dtype, b, row))
        print(f"  (c) guard, {backbone} {dtype}: " + "; ".join(cells), flush=True)
    print(f"  (c) guard at {len(GUARD_PAIRS)} (backbone, dtype) pairs: "
          f"{time.perf_counter() - t0:.1f} s; {device_line('cuda')}", flush=True)
    if bad:
        raise RuntimeError(f"(c) the guard's estimate lies below a measured peak, or a bucket "
                           f"did not run: {bad}")
    return out


def _load_steps(directory: str) -> dict:
    return {int(f.stem.split("_")[1]): torch.load(f, map_location="cpu", weights_only=True)
            for f in sorted(Path(directory).glob("step_*.pt"))}


def _same(a, b) -> bool:
    """Loaded checkpoints equal: every tensor bit for bit, every other value."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def check_async_checkpoints(main) -> None:
    """Phase 14 (d): phase 7's ``run_training`` (8 synthetic records,
    ``Config()`` widths) for 2 epochs with ``tpu.async_checkpointing`` and
    ``checkpoint_every: 1``; 1 epoch synchronously, whose checkpoint must
    load equal to the async run's; then the async run's epoch-2 checkpoint
    removed and the run resumed, which must write it again equal."""
    import os

    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.runners import run_training

    base = Config()
    tp = base.training_plan
    with tempfile.TemporaryDirectory() as tmp:
        def cfg(name: str, epochs: int, async_save: bool):
            return replace(
                base, model_path=os.path.join(tmp, name),
                data=replace(base.data, synthetic_count=8),
                training_plan=replace(tp, parameters=replace(tp.parameters, epochs=epochs)),
                tpu=replace(base.tpu, checkpoint_every=1, async_checkpointing=async_save),
            )

        def run(c, resume=False):
            t0 = time.perf_counter()
            with _Capture():
                (_, got) = main(lambda: run_training(c, resume=resume, device="cuda"))
            return time.perf_counter() - t0, got

        a_s, got_a = run(cfg("async", 2, True))
        b_s, got_b = run(cfg("sync", 1, False))
        a = _load_steps(os.path.join(tmp, "async", "train_state"))
        b = _load_steps(os.path.join(tmp, "sync", "train_state"))
        equal = sorted(a) == [1, 2] and sorted(b) == [1] and _same(a[1], b[1])
        os.remove(os.path.join(tmp, "async", "train_state", "step_00000002.pt"))
        r_s, got_r = run(cfg("async", 2, True), resume=True)
        resumed = _load_steps(os.path.join(tmp, "async", "train_state"))
        again = sorted(resumed) == [1, 2] and _same(resumed[2], a[2])
    print(f"  (d) run_training, async checkpoints, 2 epochs: {a_s:.1f} s (launches K1 "
          f"{got_a['mc_head_sep']} K3 {got_a['gather_tiles']} K5 {got_a['mc_head_bwd_sep']}); "
          f"synchronous, 1 epoch: {b_s:.1f} s; epoch 1's checkpoints load equal {equal}; "
          f"resumed from epoch 1: {r_s:.1f} s, epoch 2's checkpoint written again equal "
          f"{again}", flush=True)
    if not (equal and again and got_a["mc_head_bwd_sep"] > 0 and got_r["mc_head_bwd_sep"] > 0):
        raise RuntimeError(f"(d) async checkpoints: equal {equal}, resumed equal {again}")


# One fold process of phase 14 (e): cli cv with TF32 off, as phase 10 runs
# it, then its kernel launch counts and peak memory on a line of their own.
# Both processes share the one card, so each caps its allocator at 45 % of
# the card's memory: an allocator frees its own cache when it reaches its cap,
# never the other process's (a training step at bucket 1024 peaks at 26 GiB,
# an evaluation bag at 3072 at 20 GiB).
_FOLD_PROCESS = """
import json, sys
import torch
from montecarlo_gated_mil_tpu_torch import cli
from montecarlo_gated_mil_tpu_torch.ops import cuda_build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cuda.set_per_process_memory_fraction(0.45)
rc = cli.main(["cv", "--config", sys.argv[1]])
got = {k.name: k.launches for k in cuda_build.KERNELS.values()}
got["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
print("LAUNCHES " + json.dumps(got))
sys.exit(rc)
"""


def check_fold_fanout(cv_cfg, cv_accuracies: dict, totals: dict) -> None:
    """Phase 14 (e): ``cli cv`` with phase 10's config fanned out over two
    processes on the one card (``coordinator_address`` on a free local port,
    ``num_processes`` 2, ``process_id`` 0 and 1; a ``gloo`` group); each
    process's manifest must hold every fold's accuracy, equal to phase 10's
    single-process manifest."""
    import os
    import socket

    import yaml

    from montecarlo_gated_mil_tpu_torch.core.config import config_to_dict

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    with tempfile.TemporaryDirectory() as tmp:
        ymls = []
        for r in range(2):
            c = replace(cv_cfg, model_path=os.path.join(tmp, "models"), tpu=replace(
                cv_cfg.tpu, coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                process_id=r))
            ymls.append(os.path.join(tmp, f"p{r}.yml"))
            Path(ymls[-1]).write_text(yaml.safe_dump(config_to_dict(c)))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", _FOLD_PROCESS, y], cwd=root, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for y in ymls]
        ends = []
        try:
            for p in procs:
                ends.append(p.communicate(timeout=FANOUT_TIMEOUT))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("(e) fold processes exited " + "; ".join(
                f"{p.returncode}: {err[-2500:]}" for p, (_, err) in zip(procs, ends)))
        outs = [out for out, _ in ends]
        manifests = [json.loads(Path(tmp, "models", f"cv_manifest_p{r}.json").read_text())
                     for r in range(2)]
    launches = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("LAUNCHES "))[9:])
                for out in outs]
    peaks = [got.pop("peak_gib") for got in launches]
    for got in launches:
        for k, v in got.items():
            totals[k] += v
    accs = [m["all_fold_accuracies"] for m in manifests]
    print(f"  (e) cli cv over 2 processes (gloo, 127.0.0.1:{port}): {wall:.1f} s wall; folds "
          f"{[[f['fold'] for f in m['folds']] for m in manifests]}; all_fold_accuracies "
          f"{accs} (phase 10's single process: {cv_accuracies}); per process: "
          + "; ".join(f"peak {peak:.3f} GiB, launches K1 {g['mc_head_sep']} K3 "
                      f"{g['gather_tiles']} K5 {g['mc_head_bwd_sep']}"
                      for g, peak in zip(launches, peaks)), flush=True)
    if (any(a != cv_accuracies for a in accs)
            or [[f["fold"] for f in m["folds"]] for m in manifests] != [[1], [2]]
            or any(g["mc_head_bwd_sep"] == 0 for g in launches)):
        raise RuntimeError(f"(e) fold fan-out: accuracies {accs} against {cv_accuracies}")


SLOPE_VS_EVENTS = 0.10  # slope_time of K1 (a) against phase 3's event time
STAGES_VS_EMBED = 0.15  # the f32 embed's stages summed against the whole embed


def check_tools(k1_event_ms: float) -> dict:
    """Phase 15: each tool of ``montecarlo_gated_mil_tpu_torch/tools`` once at
    full width, as a user runs it (``main(argv)``), with launches counted
    around them.  Raises when ``slope_time`` of K1 (a) differs from phase
    3's sleep-ahead event time by more than 10 %; when the f32 embed's
    stages do not sum to within 15 % of the whole embed's slope time; when
    a kernel table reads 0 ms for a hand-written kernel its call launched;
    or when the memory guard's estimate lies below a measured training-step
    peak.  Returns the tools' launch counts."""
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import mc_gated_attention
    from montecarlo_gated_mil_tpu_torch.tools import (
        measure_fullscale,
        measure_hbm,
        measure_serving,
        measure_train,
        probe_build_phases,
        profile_embed,
        profile_int8_attrib,
        profile_train,
    )

    t_phase = time.perf_counter()
    # The slope timer against the event timer on K1 (a); the carry's own
    # slope beside it, and K1 (c), where the carry is a larger share.
    slope = {}
    for label, _, shared, n, n_valid, layout, T, seed in HEAD_SHAPES[:3:2]:
        _, params, H, mask, _ = _head_inputs(shared, n, n_valid, layout, seed)
        slope[label] = profiling.slope_time(
            lambda h: mc_gated_attention(h, mask, params, T, 17, 0.1, 0.1)[0], H,
            what=label) * 1e3
        carry = profiling.slope_time(lambda h: h[:1], H, what=f"{label}'s carry") * 1e3
        table = kernel_table(lambda: mc_gated_attention(H, mask, params, T, 17, 0.1, 0.1))
        table.check_launched()
        print(f"  slope_time {label}: {slope[label]:.4f} ms (the carry alone {carry:.4f} ms); "
              f"kernel table {sum(table.functions('mc_head.cu').values()):.4f} ms", flush=True)
    err = abs(slope["K1 (a)"] - k1_event_ms) / k1_event_ms
    print(f"  K1 (a): slope {slope['K1 (a)']:.4f} ms against phase 3's event time "
          f"{k1_event_ms:.4f} ms: {err:.1%} apart (limit {SLOPE_VS_EVENTS:.0%})", flush=True)
    if err > SLOPE_VS_EVENTS:
        raise RuntimeError(f"slope_time of K1 (a) is {err:.1%} from the event time")

    cuda_build.reset_launch_counts()
    times = {}

    def run(name, fn):
        t0 = time.perf_counter()
        print(f"  -- {name}", flush=True)
        out = fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        times[name] = time.perf_counter() - t0
        return out

    emb = run("profile_embed", lambda: profile_embed.main(["--reps", "2"]))
    f32 = emb["float32"]
    staged, whole = sum(f32["stages"].values()), f32["embed"]
    print(f"  f32 embed: stages sum {staged * 1e3:.3f} ms against the whole {whole * 1e3:.3f} ms "
          f"({abs(staged - whole) / whole:.1%} apart, limit {STAGES_VS_EMBED:.0%})", flush=True)
    if abs(staged - whole) > STAGES_VS_EMBED * whole:
        raise RuntimeError("profile_embed: the f32 stages do not sum to the whole embed")
    run("profile_train", lambda: profile_train.main(
        ["--ks", "1,2,3", "--reps", "1", "--steps", "2"]))
    run("measure_train", lambda: measure_train.main(["--reps", "2"]))
    run("measure_fullscale", lambda: measure_fullscale.main(["--reps", "1"]))
    serving = run("measure_serving", lambda: measure_serving.main(
        ["--requests", "10", "--concurrency", "1,4", "--duration", "10"]))
    if any(r["errors"] or not r["ok"] for r in serving["soak"].values()):
        raise RuntimeError(f"measure_serving: the HTTP soak failed requests: {serving['soak']}")
    hbm = run("measure_hbm", lambda: measure_hbm.main(["256", "1024", "2048"]))
    for bucket, row in hbm.items():
        if row["train"] is None or row["guard"] < row["train"]:
            raise RuntimeError(f"measure_hbm: at bucket {bucket} the guard's estimate "
                               f"{row['guard'] / 2**30:.3f} GiB lies below the training step's "
                               f"peak {row['train']} or the step did not run")
    run("profile_int8_attrib", lambda: profile_int8_attrib.main(["--rounds", "1", "--reps", "2"]))
    run("probe_build_phases", lambda: probe_build_phases.main([]))
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()) + f"); launches {launches}",
          flush=True)
    for name in ("mc_head_sep", "mc_head_shared", "mc_head_bwd_sep", "mc_head_bwd_shared",
                 "gather_tiles", "qconv_i8", "bn_stats", "bn_relu_quant"):
        if not launches[name]:
            raise RuntimeError(f"phase 15: the tools never launched {name}")
    return launches


EXACT_STEP_TIMEOUT = 900  # seconds, phase 16 (a)'s process
_EXACT_STEP_PROCESS = """
import json
import chip_smoke
print("EXACT_STEP " + json.dumps([chip_smoke.default_flags_step(),
                                  chip_smoke.default_flags_step(64, 0.75, 64, 1)]))
"""


# Pre-ReLU signs of the 64 px step (valid instances) that the f32 forward
# may set apart from the free f64 forward's, which the f64 step then
# follows: 3 measured on an H100 (1 before the float BN kernels); a forward
# that drifts moves many more.
RELU_FLIPS_64PX = 6


@contextlib.contextmanager
def _relu_pattern(record: list | None = None, pin: list | None = None):
    """Inside: each call of ``F.relu`` appends its sign pattern (``x > 0``)
    to ``record``, or, with ``pin``, keeps the entries that the same call
    of a recorded run kept (``torch.where``, whose gradient passes there
    alone) instead of its own."""
    relu = F.relu
    pinned = iter(pin or ())

    def patched(x, inplace=False):
        if pin is not None:
            return torch.where(next(pinned), x, torch.zeros((), dtype=x.dtype, device=x.device))
        record.append(x.detach() > 0)
        return relu(x, inplace=inplace)

    F.relu = patched
    try:
        yield
    finally:
        F.relu = relu


def default_flags_step(bucket: int = 1024, valid: float = 650 / 1024, patch: int = 224,
                       steps: int = 3) -> dict:
    """One f32 training step of the shipped model (``tools/profile_train.py::
    shipped_step``: seeded weights, a seeded bag at ``bucket`` with that
    share of valid tiles, dropout seed 5) with TF32 left at PyTorch's
    defaults (cuDNN's on, the matrix products' off), which it checks first.

    Gradients, with cuDNN deterministic so that one computation gives one
    set of bits: ``exact``, the step (``make_train_step``: K1 forward, K5
    backward, the backward inside ``exact_float_grads``); ``off``, the same
    step with both TF32 flags off for the whole process, as phase 7 runs;
    ``tf32``, the same loss back-propagated outside ``exact_float_grads``,
    as the port's steps did before it; ``plain head``, the step with the
    plain head.  Each is held against an f64 step of the same weights, bag
    and dropout (the plain head in f64) on the f32 forward's ReLU pattern
    (:func:`_relu_pattern`; the four share one forward): an activation that
    lies within f32 rounding of 0 may fall on the other side in f64, and the
    gradient through it is then another function, not a rounding of the same
    one (a seeded r18 at 64 px has such activations, 1.1e-7 from 0).  The
    excess against the free f64 step (``excess_free``) and the count of
    activations whose sign differs between the two forwards (``relu_flips``)
    are reported beside it.  Then ``exact`` and ``tf32`` are
    timed by CUDA events with cuDNN's default algorithm choice, the
    optimizer included (mean of ``steps`` after one).  Returns, per
    variant, whether its gradients equal ``off``'s bit for bit, its excess
    over phase 14's gradient limits against f64 (<= 0: within), its worst
    ``max|d| / max|f64|``, its norm-wise error over all weights and the
    weights of the largest excess; the losses, ms per step, the peak GiB,
    and the launches of the ``exact`` step alone."""
    import copy

    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.tools.profile_train import shipped_step
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if flags != (True, False):
        raise RuntimeError(f"TF32 flags (cuDNN, matmul) {flags}, not PyTorch's defaults")
    state, step, bag, crit = shipped_step(bucket, patch, "cuda", valid)
    model, seed = state.model, 5

    def grads(m, run) -> dict:
        m.zero_grad(set_to_none=True)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=torch.backends.cudnn.allow_tf32):
            loss = run()
        torch.cuda.synchronize()
        out = {k: p.grad.detach().to("cpu", torch.float64) for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return out, float(loss)

    def tf32_step(apply: bool):
        """``make_train_step``'s body as it was: no ``exact_float_grads``."""
        y, _, aux = model(bag.patches, bag.mask, bag.label, train=True, seed=seed)
        loss = crit(y[None, :], bag.label[None]) + aux
        loss.backward()
        if apply:
            state.apply_update()
        return loss.detach()

    def all_off():
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return step(state, bag, seed, False)[1]["loss"]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    pattern, pattern64 = [], []
    with _relu_pattern(record=pattern):
        grads(model, lambda: step(state, bag, seed, False)[1]["loss"])
    m64 = copy.deepcopy(model).to(torch.float64)
    m64.dtype = m64.feature_extractor.dtype = torch.float64
    bag64 = Bag(bag.patches.double(), bag.mask, bag.label, bag.tile_indices)
    opt64 = torch.optim.SGD(m64.parameters(), lr=0.0)
    step64 = make_train_step(m64, crit, opt64, 1, use_pallas=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _relu_pattern(pin=pattern):
        want, loss64 = grads(m64, lambda: step64(TrainState(m64, opt64), bag64, seed,
                                                 False)[1]["loss"])
    out = {"flags": flags, "f64_seconds": time.perf_counter() - t0, "bucket": bucket,
           "f64_peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loss_f64": loss64,
           "valid": int(bag.mask.sum())}
    with _relu_pattern(record=pattern64):
        want_free, _ = grads(m64, lambda: step64(TrainState(m64, opt64), bag64, seed,
                                                 False)[1]["loss"])
    keep = bag.mask.to(pattern[0].device)
    out["relu_flips"] = sum(int((a[keep] != b[keep]).sum()) for a, b in zip(pattern, pattern64))
    del m64, bag64, opt64, step64, pattern, pattern64
    torch.cuda.empty_cache()
    cuda_build.reset_launch_counts()
    got = {"exact": grads(model, lambda: step(state, bag, seed, False)[1]["loss"])}
    out["launches"] = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    got["off"] = grads(model, all_off)
    got["tf32"] = grads(model, lambda: tf32_step(False))
    plain_step = make_train_step(model, crit, state.optimizer, 1, use_pallas=False)
    got["plain head"] = grads(model, lambda: plain_step(state, bag, seed, False)[1]["loss"])
    for name, (g, loss) in got.items():
        excess = {k: _excess({k: g[k]}, {k: want[k]}, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL)
                  for k in want}
        excess_free = _excess(g, want_free, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL)
        rel = {k: float((g[k] - want[k]).abs().max() / max(float(want[k].abs().max()), 1e-30))
               for k in want}
        out[name] = dict(
            loss=loss, equal_to_off=all(torch.equal(g[k], got["off"][0][k]) for k in g),
            excess=max(excess.values()), excess_free=excess_free, rel=max(rel.values()),
            norm=sum(float((g[k] - want[k]).square().sum()) for k in want) ** 0.5
            / sum(float(want[k].square().sum()) for k in want) ** 0.5,
            worst=[(k, excess[k], rel[k], float((g[k] - want[k]).abs().max()),
                    float(want[k].abs().max())) for k in sorted(want, key=lambda k: -excess[k])[:3]])
    torch.cuda.reset_peak_memory_stats()
    for name, run in (("exact", lambda i: step(state, bag, 100 + i, True)),
                      ("tf32", lambda i: tf32_step(True))):
        run(0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for i in range(steps):
            run(1 + i)
        ev[1].record()
        torch.cuda.synchronize()
        out[name]["ms"] = ev[0].elapsed_time(ev[1]) / steps
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def check_exact_step(phase7_ms: float) -> dict:
    """Phase 16 (a): :func:`default_flags_step` in a process of its own,
    since this one runs with TF32 off throughout: at bucket 1024 of 224 px,
    and at the card test's 64 instances of 64 px.  Raises when the process
    fails; when at either size the step's gradients under the default flags
    differ by one bit from the TF32-off step's, or the TF32 backward's do
    not; or when at 64 px the step's gradients exceed phase 14's limits
    against f64 on the f32 step's ReLU pattern, or more than
    ``RELU_FLIPS_64PX`` of its pre-ReLU signs differ from the free f64
    forward's.  At bucket 1024 the
    comparison is printed: against the free f64 step no f32 step meets those
    limits at the stem conv's weights, TF32 or not, for 746 activations
    there round to the other side of 0; on the f32 step's pattern the exact
    step does (PERF.md).  Returns the launches of both steps."""
    import os

    root = Path(__file__).resolve().parent
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-c", _EXACT_STEP_PROCESS], cwd=root,
                          env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
                          text=True, timeout=EXACT_STEP_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"(a) the default-flags step's process exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    runs = json.loads(next(ln for ln in proc.stdout.splitlines()
                           if ln.startswith("EXACT_STEP "))[len("EXACT_STEP "):])
    launches = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    for r in runs:
        print(f"  (a) one f32 step at bucket {r['bucket']} ({r['valid']} valid), TF32 flags at "
              f"PyTorch's defaults (cuDNN {r['flags'][0]}, matmul {r['flags'][1]}); f64 step "
              f"{r['f64_seconds']:.1f} s, peak {r['f64_peak_gib']:.2f} GiB; loss f64 "
              f"{r['loss_f64']:.9f}; pre-ReLU signs differing between the f32 and the free "
              f"f64 forward: {r['relu_flips']} (the f64 step follows the f32 one's)", flush=True)
        for name, what in (("exact", "the step (exact_float_grads)"),
                           ("off", "the step with TF32 off in the whole process (phase 7's)"),
                           ("tf32", "the same loss back-propagated outside exact_float_grads, "
                                    "as before the repair"),
                           ("plain head", "the step with the plain head")):
            x = r[name]
            print(f"  (a) {what}: loss {x['loss']:.9f}; gradients bit for bit equal to the "
                  f"TF32-off step's: {x['equal_to_off']}; against f64: excess over rtol "
                  f"{SHARD_GRAD_RTOL:g} / atol {SHARD_GRAD_ATOL:g} {x['excess']:.3e} "
                  f"({'within' if x['excess'] <= 0 else 'over'}; against the free f64 step "
                  f"{x['excess_free']:.3e}), worst max|d|/max|f64| "
                  f"{x['rel']:.3e}, over all weights ||d|| / ||f64|| {x['norm']:.3e}"
                  + (f"; {x['ms']:.1f} ms per step (CUDA events, optimizer included)"
                     if "ms" in x else ""), flush=True)
            print("      largest excess (weight: excess, max|d|/max|f64|, max|d|, max|f64|): "
                  + "; ".join(f"{k}: {e:.2e}, {q:.2e}, {dm:.2e}, {wm:.2e}"
                              for k, e, q, dm, wm in x["worst"]), flush=True)
        if not r["exact"]["equal_to_off"] or r["tf32"]["equal_to_off"]:
            raise RuntimeError(f"(a) at bucket {r['bucket']}: the default-flags step equals the "
                               f"TF32-off step {r['exact']['equal_to_off']}, the TF32 backward "
                               f"does {r['tf32']['equal_to_off']}")
    full, small = runs
    print(f"  (a) step time under the default flags {full['exact']['ms']:.1f} ms against phase "
          f"7's {phase7_ms:.1f} ms (run_training, TF32 off throughout) and "
          f"{full['tf32']['ms']:.1f} ms with a TF32 backward; peak {full['peak_gib']:.2f} GiB; "
          f"launches {launches}", flush=True)
    if small["exact"]["excess"] > 0:
        raise RuntimeError(f"(a) at 64 px the step's gradients are {small['exact']['excess']:.3e}"
                           " over phase 14's limits against f64")
    if small["relu_flips"] > RELU_FLIPS_64PX:
        raise RuntimeError(f"(a) at 64 px {small['relu_flips']} pre-ReLU signs differ between the "
                           f"f32 and the f64 forward (at most {RELU_FLIPS_64PX})")
    if not (launches["mc_head_sep"] and launches["mc_head_bwd_sep"]):
        raise RuntimeError(f"(a) the steps did not launch K1 and K5: {launches}")
    return launches


def _library_line(label: str, kernel_ms: float, library: str, library_ms: float | None,
                  bound_ms: float) -> None:
    if library_ms is None:
        print(f"  {label}: kernel {kernel_ms:.4f} ms, bound {bound_ms:.4f} ms; library call: "
              f"none: {library}", flush=True)
        return
    verdict = "the kernel wins" if kernel_ms <= library_ms else "the kernel LOSES to it"
    print(f"  {label}: kernel {kernel_ms:.4f} ms, {library} {library_ms:.4f} ms ({verdict}, "
          f"{library_ms / kernel_ms:.2f}x), bound {bound_ms:.4f} ms (kernel at "
          f"{bound_ms / kernel_ms:.1%}, library call at {bound_ms / library_ms:.1%})", flush=True)


NO_LIBRARY_CALL = {
    "mc_head_sep": "no PyTorch call computes the gated-attention score (tanh(H V) * "
                   "sigmoid(H U)) w per class with Philox dropout, its masked softmax and the "
                   "pooling; scaled_dot_product_attention takes queries and keys, not a gate",
    "mc_head_shared": "the same head at one shared gate: no single call",
    "mc_head_bwd_sep": "the backward of K1's function replaying its dropout masks: no single call",
    "mc_head_bwd_shared": "the backward of K2's function: no single call",
    "bn_relu_quant": "no call normalizes with a per-channel affine, adds a residual, applies "
                     "ReLU and rounds to int8 codes in one (torch.quantize_per_channel takes no "
                     "shift before a ReLU and returns a quantized tensor type); the stem mode "
                     "pools besides",
}


def check_library_calls(rows: dict, d) -> None:
    """Phase 16 (b): each kernel of the ``kernels`` line beside the one
    PyTorch call that computes the same function on the same inputs, timed
    by ``time_ms`` with the kernel again, or the reason no call does:
    K3 against an index of the image's unfolded windows (the starts are all
    inside the image, where the zero tile of an outside start is never
    needed); K6 against cuDNN's bf16 conv at each 3x3 shape (the row is
    layer 1's) and ``torch._int_mm`` of the subsampled pixels at each 1x1/2
    shape (int32 sums, without K6's store epilogue); K7 against
    ``torch.var_mean`` over (h, w) at every shape of a request's BN sums (the
    statistics as moments, in bf16; the row is the stem's, where K7 still
    runs), and beside them, at every shape but the stem's, what the sums cost
    in K6's epilogue (K6 with them, the fold included, less K6 alone,
    averaged over the shape's convs by their launches); the fold against
    ``part.sum(dim=1)`` at FOLD_ROW.  Fills the rows' ``library_ms``."""
    import torch.nn.functional as F

    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk
    from montecarlo_gated_mil_tpu_torch.ops.patching import compute_tile_grid, gather_selected

    for name, why in NO_LIBRARY_CALL.items():
        _library_line(name, rows[name]["ms"], why, None, rows[name]["bound_ms"])
    # K3 at phase 3's 3072 starts.
    grid = compute_tile_grid(d.H, d.W, d.patch_size, d.overlap_val_test)
    g = torch.Generator().manual_seed(3)
    image = torch.from_numpy(synthetic_image(d.H, d.W, positive=True, seed=0)).cuda()
    starts = torch.from_numpy(grid.tiles_array()[:, :2]).long()
    starts = starts[torch.randperm(grid.num_tiles, generator=g)[:3072]].cuda()
    p = d.patch_size
    windows = image.unfold(0, p, 1).unfold(1, p, 1)  # a view: (H-p+1, W-p+1, p, p)

    def index():
        return windows[starts[:, 0], starts[:, 1]]

    if not torch.equal(index(), gather_selected(image, starts, p)):
        raise RuntimeError("(b) the unfolded windows' index differs from K3")
    kernel = time_ms(lambda: gather_selected(image, starts, p), iters=20, what="K3").ms
    rows["gather_tiles"]["library_ms"] = time_ms(index, iters=20, what="K3's library call").ms
    _library_line("gather_tiles (K3, 3072 starts)", kernel,
                  "image.unfold(0, p, 1).unfold(1, p, 1)[starts[:, 0], starts[:, 1]]",
                  rows["gather_tiles"]["library_ms"], rows["gather_tiles"]["bound_ms"])
    # K3 at phase 3's 6144 starts (the extended bucket; drawn with repeats).
    all_starts = torch.from_numpy(grid.tiles_array()[:, :2]).long()
    starts = all_starts[torch.randint(grid.num_tiles, (6144,), generator=g)].cuda()
    if not torch.equal(index(), gather_selected(image, starts, p)):
        raise RuntimeError("(b) the unfolded windows' index differs from K3 at 6144 starts")
    kernel = time_ms(lambda: gather_selected(image, starts, p), iters=20, what="K3 6144").ms
    lib_ms = time_ms(index, iters=20, what="K3's library call at 6144").ms
    _library_line("gather_tiles (K3, 6144 starts)", kernel,
                  "image.unfold(0, p, 1).unfold(1, p, 1)[starts[:, 0], starts[:, 1]]", lib_ms,
                  _bound(2 * 6144 * p * p * 4 + 6144 * 2 * 8)[0])
    del image, starts, windows
    # K6 at every r18 conv shape of a request, bf16 store.
    gq = torch.Generator(device="cuda").manual_seed(16)
    n = QUANT_N
    sums = [0.0, 0.0]
    fused = {}  # output (h, w, C) -> [launches, launch-weighted ms of the sums in K6]
    for label, h, w, cin, cout, k, stride, pad, per_request in QCONV_SHAPES:
        if not per_request:
            continue
        a = _int8((n, h, w, cin), gq)
        wt = _int8((cout, k, k, cin), gq)
        scale = torch.rand(cout, generator=gq, device="cuda") * 1e-3
        oh, ow = qk.conv_out_hw(h, w, k, k, stride, pad)
        m, K = n * oh * ow, k * k * cin
        t_ops = 2.0 * m * cout * K / PEAK_INT8_OPS * 1e3
        t_bytes = (n * _pixels_read(h, w, k, stride, pad) * cin + wt.numel() + m * cout * 2
                   + 4 * cout) / PEAK_BYTES * 1e3
        kernel = time_ms(lambda: qk.qconv(a, wt, scale, stride, pad, "bf16"), iters=5,
                         what=f"K6 {label}").ms
        with_sums = time_ms(lambda: qk.qconv_stats(a, wt, scale, stride, pad, "bf16"), iters=5,
                            what=f"K6 with sums {label}").ms
        cost = fused.setdefault((oh, ow, cout), [0, 0.0])
        cost[0] += per_request
        cost[1] += per_request * (with_sums - kernel)
        if label == FOLD_ROW:
            _, part, run, _, _ = qk._qconv_cuda(a, wt, scale, stride, pad, "bf16", sums=True)
            if run != 1:
                raise RuntimeError(f"(b) the fold's row needs runs of one tile at {label}")
            folded = qk.bn_stats_fold(part, run)
            if _rel(part.sum(dim=1)[..., 0].float(), folded[0]) > SUMS_LIMIT:
                raise RuntimeError("(b) part.sum(dim=1) differs from the fold")
            fold = time_ms(lambda: qk.bn_stats_fold(part, run), iters=10, what="fold").ms
            rows["bn_stats_fold"]["library_ms"] = time_ms(
                lambda: part.sum(dim=1), iters=10, what="the fold's library call").ms
            _library_line(f"bn_stats_fold (K7's fold) {label} {tuple(part.shape)}", fold,
                          "part.sum(dim=1) (float64)", rows["bn_stats_fold"]["library_ms"],
                          rows["bn_stats_fold"]["bound_ms"])
            del part, folded
        if k == 1:
            A = a[:, ::stride, ::stride].reshape(m, cin).contiguous()
            B = wt.reshape(cout, cin).t()
            lib_ms = time_ms(lambda: torch._int_mm(A, B), iters=5, what="torch._int_mm").ms
            lib = f"torch._int_mm ({m} x {K}) @ ({K} x {cout}), int32 sums"
            del A, B
        else:
            x = a.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last storage
            wb = wt.to(torch.bfloat16).permute(0, 3, 1, 2)
            lib_ms = time_ms(lambda: F.conv2d(x, wb, stride=stride, padding=pad[0]), iters=5,
                             what="cuDNN bf16").ms
            lib = "cuDNN bf16 conv2d, channels_last"
            del x, wb
        _library_line(f"qconv_i8 (K6) {label}, N={n}", kernel, lib, lib_ms, max(t_ops, t_bytes))
        if label == QCONV_SHAPES[0][0]:
            rows["qconv_i8"]["library_ms"] = lib_ms
        sums[0] += per_request * kernel
        sums[1] += per_request * lib_ms
        del a, wt
    print(f"  K6 per request (launch-weighted): kernel {sums[0]:.4f} ms, the library calls "
          f"{sums[1]:.4f} ms", flush=True)
    # K7 at every launch shape of a request, and the fused sums beside it.
    sums = [0.0, 0.0, 0.0]
    for label, hwc, per_request in K7_SHAPES:
        t = _bn_stored((n, *hwc), gq)
        s1, _ = qk.bn_stats(t)
        var, mean = torch.var_mean(t, dim=(1, 2), correction=0)
        hw = hwc[0] * hwc[1]
        err = float((mean.float() * hw - s1).abs().max() / s1.abs().max())
        kernel = time_ms(lambda: qk.bn_stats(t), iters=5, what=f"K7 {label}").ms
        lib_ms = time_ms(lambda: torch.var_mean(t, dim=(1, 2), correction=0), iters=5,
                         what="torch.var_mean").ms
        bound, _ = _bound(t.numel() * 2 + 2 * n * hwc[-1] * 4)
        _library_line(f"bn_stats (K7) {label} {tuple(t.shape)}", kernel,
                      f"torch.var_mean(t, dim=(1, 2), correction=0) (bf16 moments; its mean "
                      f"x hw against K7's sums {err:.1e} of max)", lib_ms, bound)
        if label == "stem":
            rows["bn_stats"]["library_ms"] = lib_ms
        else:
            runs, cost = fused[hwc]
            print(f"    the same sums in K6's epilogue: {cost / runs:.4f} ms a launch ({runs} "
                  f"per request), against K7 {kernel:.4f} and torch.var_mean {lib_ms:.4f}",
                  flush=True)
            sums[2] += cost
        sums[0] += per_request * kernel
        sums[1] += per_request * lib_ms
        del t, s1, var, mean
    print(f"  K7 per request (launch-weighted, every shape): kernel {sums[0]:.4f} ms, "
          f"torch.var_mean {sums[1]:.4f} ms; the stem's K7 and the sums in K6's epilogue "
          f"(folds included) {rows['bn_stats']['ms'] + sums[2]:.4f} ms", flush=True)
    torch.cuda.empty_cache()


def check_new_tools(tmp: str) -> dict:
    """Phase 16 (c)-(e): ``validate_uncertainty`` at seed 0 (the figure
    where matplotlib imports), ``profile_int8 all`` at the JAX tool's bag
    (256 patches at 224 px) and ``fuzz_dicom`` with 100 trials a seed
    (its refusal, where the compiler has no sanitizers, printed on a line
    of its own).  Raises when the acceptance's fit or an uncertainty ratio
    fails at seed 0, when the two stems' codes differ, or when the fuzzer
    finds a fault.  Returns the launches of (c) and (d)."""
    import importlib.util

    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.tools import fuzz_dicom, profile_int8, validate_uncertainty

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    figure = importlib.util.find_spec("matplotlib") is not None
    if not figure:
        print("  (c) matplotlib is not installed here: validate_uncertainty runs with "
              "--no-figure", flush=True)
    out = str(Path(tmp, "uncertainty_validation.png"))
    res = validate_uncertainty.main(["--seeds", "0", "--out", out]
                                    + ([] if figure else ["--no-figure"]))[0]
    if figure and not Path(out).stat().st_size:
        raise RuntimeError("(c) validate_uncertainty wrote no figure")
    if not all(res["oks"][:3]):
        raise RuntimeError(f"(c) the acceptance's fit or an uncertainty ratio failed at seed 0: "
                           f"{res['values']}")
    print(f"  (c) validate_uncertainty: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    res = profile_int8.main(["all", "--reps", "2"])
    if res["stem"]["agreement"] != 1.0:
        raise RuntimeError(f"(d) the two stems' codes agree at {res['stem']['agreement']}")
    torch.cuda.empty_cache()
    print(f"  (d) profile_int8 all: {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    t0 = time.perf_counter()
    try:
        res = fuzz_dicom.main(["--trials-per-seed", "100", "--out", str(Path(tmp, "fuzz"))])
    except SystemExit as e:
        if not str(e.code).startswith("fuzz_dicom: cannot build the reader with sanitizers"):
            raise
        print(f"  (e) {e.code}", flush=True)
    else:
        if res["faults"] or res["missing"]:
            raise RuntimeError(f"(e) fuzz_dicom: faults {res['faults']}, seeds missing "
                               f"{res['missing']}")
    print(f"  (e) fuzz_dicom: {time.perf_counter() - t0:.1f} s; launches of (c) and (d) "
          f"{launches}", flush=True)
    for name in ("mc_head_shared", "mc_head_bwd_shared", "qconv_i8", "bn_stats",
                 "bn_relu_quant"):
        if not launches[name]:
            raise RuntimeError(f"phase 16: the tools never launched {name}")
    return launches


def time_heads(root: str) -> int:
    """Times the MC head kernels of the port under ``root`` at the shapes
    and inputs of phases 3 and 6 with this script's timer, hashes (SHA-256)
    every output of the backward kernels there, and prints one JSON line; a
    shape whose backward the port refuses (``ValueError``) is listed as
    refused.  It calls only what the port has had since it trained:
    ``mc_gated_attention``, ``_mc_head_cuda`` and ``_mc_head_bwd_cuda``."""
    import hashlib

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
    sys.path.insert(0, str(Path(root).resolve()))
    import montecarlo_gated_mil_tpu_torch as port
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
        _mc_head_bwd_cuda,
        _mc_head_cuda,
        mc_gated_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {device_line("cuda")}; port {Path(port.__file__).parent}", flush=True)
    cuda_build.build_all()
    times, digests, refused = {}, {}, []
    for label, _, shared, n, n_valid, layout, T, seed in HEAD_SHAPES:
        _, params, H, mask, _ = _head_inputs(shared, n, n_valid, layout, seed)
        times[label] = time_ms(lambda: mc_gated_attention(H, mask, params, T, 17, 0.1, 0.1),
                                iters=10, what=label)
    for label, _, shared, n, n_valid, layout, T, seed, classes in BWD_SHAPES:
        model, params, H, mask, g = _head_inputs(shared, n, n_valid, layout, seed, classes)
        _, dA, dM = _cotangents(model, params, n, T, g)
        _, A = _mc_head_cuda(H, mask, params, T, 17, 0.1, 0.1)
        try:
            out = _mc_head_bwd_cuda(H, params, T, 17, 0.1, 0.1, A, dM, dA)
        except ValueError as e:
            refused.append(label)
            print(f"  {label}: refused ({e})", flush=True)
            continue
        digests[label] = hashlib.sha256(b"".join(
            x.contiguous().cpu().numpy().tobytes() for x in (A, *out))).hexdigest()
        times[label] = time_ms(lambda: _mc_head_bwd_cuda(H, params, T, 17, 0.1, 0.1, A, dM, dA),
                                iters=10, what=label)
    for label, t in times.items():
        print(f"  {label}: {t}" + (f"; sha256 {digests[label]}" if label in digests else ""),
              flush=True)
    print(json.dumps({"port": str(Path(port.__file__).parent),
                      "heads": {k: asdict(t) for k, t in times.items()},
                      "bwd_sha256": digests, "refused": refused}))
    return 0


EMBED_N = 64  # instances of the bag whose int8 embed is hashed by --kernels-from


def time_int8_kernels(root: str) -> int:
    """Times the int8 embed's kernels of the port under ``root`` on seeded
    inputs with this script's timer, and prints one JSON line: K6 at every
    ``QCONV_SHAPES`` shape and K7/K8 at every ``K7_SHAPES``/``K8_SHAPES``
    launch, at N=QUANT_N with the bf16 store; ms per shape, each kernel's
    sum over a request weighted by launches, a SHA-256 of each output (K6's
    on QUANT_CHECK_N instances), and a SHA-256 of the bytes of the int8
    embed (``quantized_embed_static``) of one seeded 64-instance bag at 224
    px under a plan from seeded r18 weights.  It calls only what the port
    has had since the int8 path began: ``qconv``, ``bn_stats``,
    ``bn_relu_quant`` and the plan and embed of ``ops/quantized.py``; where
    the port has ``qconv_stats`` (K7's sums in K6's epilogue) it also
    times that at every conv shape, hashes its store (equal to ``qconv``'s)
    and times the fold alone, and the per-request line adds K6 + K7 (+ fold)
    as each tree's int8 path runs them: K6 alone and K7 at every shape, or
    K6 with the sums and K7 at the stem."""
    import hashlib

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
    sys.path.insert(0, str(Path(root).resolve()))
    import montecarlo_gated_mil_tpu_torch as port
    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk
    from montecarlo_gated_mil_tpu_torch.ops.quantized import (
        quantize_backbone_static,
        quantized_embed_static,
    )

    def sha(x: torch.Tensor) -> str:
        return hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the bf16 stem conv, for the embed's digest
    print(f"card: {device_line("cuda")}; port {Path(port.__file__).parent}", flush=True)
    cuda_build.build_all()
    g = torch.Generator(device="cuda").manual_seed(21)
    times, digests, per_request = {}, {}, {"K6": 0.0, "K7": 0.0, "K8": 0.0}
    fused = hasattr(qk, "qconv_stats")
    if fused:
        per_request.update({"K6 with sums": 0.0, "fold": 0.0})
    for label, h, w, cin, cout, k, stride, pad, launches in QCONV_SHAPES:
        a = _int8((QUANT_N, h, w, cin), g)
        wt = _int8((cout, k, k, cin), g)
        scale = (torch.rand(cout, generator=g, device="cuda") + 0.5) * (
            2.0 / ((k * k * cin) ** 0.5 * 127**2 / 3))
        digests[f"K6 {label}"] = sha(qk.qconv(a[:QUANT_CHECK_N], wt, scale, stride, pad, "bf16"))
        t = time_ms(lambda: qk.qconv(a, wt, scale, stride, pad, "bf16"), iters=10, what=label)
        times[f"K6 {label}"] = t.ms
        per_request["K6"] += launches * t.ms
        print(f"  K6 {label}: {t}", flush=True)
        if fused and qk._wgmma_takes(cin, k, k, stride, h, w):
            store = qk.qconv_stats(a[:QUANT_CHECK_N], wt, scale, stride, pad, "bf16")[0]
            digests[f"K6 with sums {label}"] = sha(store)
            t = time_ms(lambda: qk.qconv_stats(a, wt, scale, stride, pad, "bf16"), iters=10,
                        what=f"{label} with sums")
            times[f"K6 with sums {label}"] = t.ms
            per_request["K6 with sums"] += launches * t.ms
            _, part, run, _, _ = qk._qconv_cuda(a, wt, scale, stride, pad, "bf16", sums=True)
            fold = None
            if part is not None:
                fold = time_ms(lambda: qk.bn_stats_fold(part, run), iters=10,
                               what=f"fold {label}").ms
                times[f"fold {label}"] = fold
                per_request["fold"] += launches * fold
            print(f"  K6 with sums {label}: {t}; the fold alone "
                  + ("none (one tile a map)" if fold is None else f"{fold:.4f} ms"), flush=True)
            del store, part
        del a, wt
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(22)
    for label, hwc, launches in K7_SHAPES:
        x = _bn_stored((QUANT_N, *hwc), g)
        digests[f"K7 {label}"] = sha(torch.cat(qk.bn_stats(x)))
        t = time_ms(lambda: qk.bn_stats(x), iters=10, what=f"K7 {label}")
        times[f"K7 {label}"] = t.ms
        per_request["K7"] += launches * t.ms
        if label == "stem":
            per_request["K7 stem"] = launches * t.ms
        print(f"  K7 {label}: {t}", flush=True)
        del x
    for label, hwc, mode, res, launches in K8_SHAPES:
        x, A, B, residual, _ = _k8_inputs((QUANT_N, *hwc), res, g)
        digests[f"K8 {label}"] = sha(qk.bn_relu_quant(x, None, A, B, residual, mode=mode))
        t = time_ms(lambda: qk.bn_relu_quant(x, None, A, B, residual, mode=mode), iters=10,
                     what=f"K8 {label}")
        times[f"K8 {label}"] = t.ms
        per_request["K8"] += launches * t.ms
        print(f"  K8 {label}: {t}", flush=True)
        del x, residual
        torch.cuda.empty_cache()
    torch.manual_seed(0)
    backbone = make_backbone("r18").to("cuda")
    plan = quantize_backbone_static(backbone, "r18")
    rng = np.random.default_rng(3)
    patches = torch.from_numpy(rng.uniform(-2.0, 2.5, (EMBED_N, 224, 224, 3)).astype(np.float32))
    with torch.inference_mode():
        h = quantized_embed_static(plan, patches.to("cuda"))
    embed = hashlib.sha256(h.cpu().numpy().tobytes()).hexdigest()
    per_request["K6 + K7 (+ fold)"] = (
        per_request["K6 with sums"] + per_request["K7 stem"] if fused
        else per_request["K6"] + per_request["K7"])
    print("  per request (launch-weighted): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in per_request.items())
        + f"; int8 embed of {EMBED_N} instances: sha256 {embed}", flush=True)
    print(json.dumps({"port": str(Path(port.__file__).parent), "ms": times,
                      "per_request_ms": per_request, "sha256": digests,
                      "embed_sha256": embed}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads-from", metavar="DIR",
                    help="only time the MC head kernels of the port under DIR")
    ap.add_argument("--kernels-from", metavar="DIR",
                    help="only time K6-K8 (the int8 embed's kernels) of the port under DIR and "
                    "hash their outputs and its int8 embed")
    args = ap.parse_args()
    if args.heads_from:
        sys.exit(time_heads(args.heads_from))
    sys.exit(time_int8_kernels(args.kernels_from) if args.kernels_from else main())
