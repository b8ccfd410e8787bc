"""The arithmetic of the metrics: percentiles, latencies from the due
time, the model's operations, kernel bounds, and the trace's reduction."""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import counts, readers, serving, trace
from benchmark.serving import Request


def test_percentile_is_over_every_request_with_failures_as_missing():
    reqs = [Request(i, 0, 0, due=0.0, end=0.1 * (i + 1), ok=True) for i in range(19)]
    reqs.append(Request(19, 0, 0, due=0.0, end=0.05, ok=False))
    lat = serving.latencies_from_due(reqs)
    assert math.isinf(max(lat))
    # nearest rank: the 19th of 20 sorted values
    assert serving.percentile(lat, 95) == pytest.approx(1.9)
    reqs[0].ok = False
    assert serving.percentile(serving.latencies_from_due(reqs), 95) == math.inf


def test_open_loop_latency_counts_from_the_due_time():
    """A request that waits behind a stall is late by the stall: its
    latency runs from when it was due, not from when it was sent."""
    pool = [SimpleNamespace(pixels=None, laterality="L")]

    class Slow:
        def predict(self, *a, **k):
            time.sleep(0.2)
            raise RuntimeError("no result")

    reqs, t0, t1 = serving.open_loop(Slow(), pool, {"rate_per_s": 20.0, "max_threads": 1,
                                                    "schedule_seed": 5},
                                     seed=3, seconds=0.5, pixel_max=1.0, C=2)
    assert len(reqs) == 10
    # one thread: request k starts only when the k before it are done
    starts = sorted(r.start - r.due for r in reqs)
    assert starts[-1] > 1.0
    assert all(r.end - r.due >= r.end - r.start for r in reqs)


def test_every_seed_sends_the_same_arrivals_and_images_in_another_order():
    (g1, i1), (g2, i2) = (serving.schedule(400, 8.0, 16, 99, s) for s in (1, 2))
    assert np.array_equal(np.roll(g1, -1), g2) and np.array_equal(np.roll(i1, -1), i2)
    assert g1.mean() == pytest.approx(1 / 8.0, rel=0.02)
    assert np.bincount(i1).tolist() == [25] * 16


@pytest.mark.parametrize("backbone, rest_flops, convs, gflops", [
    ("r18", 3_391_094_784, 19, 3.63),  # 1.82 GMAC
    ("r34", 7_090_470_912, 35, 7.33),  # 3.66 GMAC
    ("r50", 7_938_244_608, 52, 8.17),  # 4.09 GMAC
])
def test_resnet_operations(backbone, rest_flops, convs, gflops):
    """A tile's forward operations, walked from the backbone's file."""
    stem, rest = counts.embed_flops(backbone, 224)
    assert stem == 2 * 64 * 3 * 49 * 112 * 112 == 236_027_904
    assert rest == rest_flops
    assert (stem + rest) / 1e9 == pytest.approx(gflops, abs=0.01)
    assert len(counts.block_convs(backbone)) == convs


def test_k1_bound_matches_the_kernel_table():
    """chip_smoke.py's K1 (a): N=3072, 2400 valid, T=50 -> 0.386 ms."""
    ms = counts.k1_bound_s(3072, 2400, 50, 512, 128, 2, 2) * 1e3
    assert ms == pytest.approx(0.386, abs=0.001)


@pytest.mark.parametrize("index, bound_ms", [(0, 0.552), (4, 0.368), (6, 0.230)])
def test_k6_bounds_match_the_kernel_table(index, bound_ms):
    """PERF.md's K6 rows at N=3072 (layer 1 3x3, layer 2 3x3/2, layer 2
    1x1/2), plus the per-instance sums this count adds."""
    ms = counts.k6_bounds_s(3072)[index] * 1e3
    assert ms == pytest.approx(bound_ms, rel=0.01)


def test_serve_mfu_is_least_time_over_the_window():
    cfg = {"backbone": "r18", "patch": 224, "shared_att": False, "T": 50, "L": 512, "D": 128,
           "C": 2, "embed": "float32"}
    reqs = [Request(i, 0, 0, 0.0, ok=True, n_valid=2400) for i in range(3)]
    ctx = SimpleNamespace(requests=reqs, config=cfg, window_s=1.5)
    least = 3 * (2400 * 3.63e9 / 67e12)
    assert readers.serve_mfu_pct(ctx) == pytest.approx(100 * least / 1.5, rel=0.02)


def test_k1_roofline_needs_one_launch_a_request():
    cfg = {"T": 50, "L": 512, "D": 128, "C": 2, "shared_att": False}
    reqs = [Request(i, 0, 0, 0.0, ok=True, bucket=3072, n_valid=2400) for i in range(2)]
    kern = [("void mc_fwd_wgmma_kernel<2>(...)", 0.0, 1.0e-3),
            ("mc_fwd_finalize_kernel", 0.0, 0.2e-3)] * 2
    tl = trace.Timeline(1.0, 0.5, kern)
    ctx = SimpleNamespace(requests=reqs, config=cfg, timeline=tl)
    bound = 2 * counts.k1_bound_s(3072, 2400, 50, 512, 128, 2, 2)
    assert readers.k1_roofline(ctx) == pytest.approx(100 * bound / 2.4e-3)
    ctx.timeline = trace.Timeline(1.0, 0.5, kern[:2])
    assert readers.k1_roofline(ctx) is None


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction_between_the_marks():
    ev = [_x("spin_kernel", "kernel", 0, 1), _x("spin_kernel", "kernel", 10, 100),
          _x("a", "kernel", 120, 30), _x("b", "kernel", 140, 20), _x("copy", "gpu_memcpy", 200, 10),
          _x("spin_kernel", "kernel", 400, 100),
          _x("aten::copy_", "cpu_op", 150, 100), _x("bench.request", "user_annotation", 0, 500)]
    tl = trace.reduce_events(ev)
    assert tl.window_s == pytest.approx(290e-6)
    assert tl.busy_s == pytest.approx(50e-6)
    assert tl.device_s("a") == pytest.approx(30e-6)
    assert [k for k, _, _ in tl.kernels] == ["a", "b"]
    # gaps: 110-120 (annotation only), 160-200 (copy_ covers 180), 210-400 (mid 305: annotation)
    assert tl.gaps_by_host["aten::copy_"] == pytest.approx(40e-6)
    assert tl.gaps_by_host["bench.request"] == pytest.approx(200e-6)
    assert readers.idle_pct(SimpleNamespace(timeline=tl)) == pytest.approx(100 * (1 - 50 / 290))
