"""A serving cell: the port's predictor under a closed or an open loop.

Every request is one full-size 12-bit mammogram of the traffic's pool
through ``MCDOPredictor.predict`` in this process (upload, bag, embed, T
head samples, statistics, fetch), its MC seed drawn from the run's seed.
The predictor's own gate (``max_inflight``) serializes the device work.

- ``closed``: ``clients`` threads, each sending its next request when the
  last returns, until the window's time is up; the window closes when the
  last request returns.  Requests take the pool's images in turn, from
  one the seed picks.
- ``open``: ``rate_per_s * seconds`` requests due at the arrival times of
  a Poisson process (exponential gaps at stratified quantiles; gaps and
  images in one fixed order, rotated by the seed), each handed to a thread
  at its due time; a latency counts from the due time.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import images
from benchmark.device import sync


@dataclass
class Request:
    index: int
    image: int  # index into the pool
    seed: int
    due: float  # host clock, s
    start: float = math.nan
    end: float = math.nan
    ok: bool = False
    error: str = ""
    result: object = None
    bucket: int = 0
    n_valid: int = 0


def request_seed(seed: int, i: int) -> int:
    return (seed * 1_000_003 + i * 7_919) % (1 << 31)


def build(config: dict, seed: int, device="cuda"):
    """The predictor with seeded weights made on the card; returns it and
    the weights (which the reference gets as well)."""
    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    from benchmark.reference.model import make_weights

    if device == "cuda":
        cuda_build.build_all()
    cfg = config_from_dict(config["port_config"])  # the port's own YAML schema
    weights = make_weights(config["backbone"], config["L"], config["D"], config["C"],
                           seed, device)
    pred = MCDOPredictor.from_config(cfg, weights, device=device,
                                     max_inflight=int(config["max_inflight"]))
    return pred, weights


def _sane(res, C: int) -> str:
    s = res.stats
    vals = torch.cat([s.mean_probs.reshape(-1), s.mean.reshape(1), s.std.reshape(1),
                      s.mean_entropy.reshape(1)])
    if not bool(torch.isfinite(vals).all()):
        return "non-finite statistics"
    if res.attention.mean.shape != (C, res.bucket) or res.num_instances <= 0:
        return f"malformed attention {tuple(res.attention.mean.shape)} or no instances"
    if not bool(torch.isfinite(res.attention.mean).all()):
        return "non-finite attention"
    return ""


def run_request(pred, pool, r: Request, pixel_max: float, C: int) -> None:
    img = pool[r.image]
    r.start = time.perf_counter()
    try:
        with torch.profiler.record_function("bench.request"):
            res = pred.predict(img.pixels, img.laterality, seed=r.seed, pixel_max=pixel_max)
        r.end = time.perf_counter()
        r.error = _sane(res, C)
        r.ok = not r.error
        r.result, r.bucket, r.n_valid = res, res.bucket, res.num_instances
    except Exception as e:  # a failed request counts against the run
        r.end = time.perf_counter()
        r.error = f"{type(e).__name__}: {e}"


def warm(pred, pool, pixel_max: float) -> None:
    """One request per pool image: every bucket this traffic reaches, and
    the allocator grown to its size."""
    for i, img in enumerate(pool):
        pred.predict(img.pixels, img.laterality, seed=i, pixel_max=pixel_max)
    sync()


def closed_loop(pred, pool, traffic: dict, seed: int, seconds: float, pixel_max: float,
                C: int) -> tuple[list[Request], float, float]:
    lock = threading.Lock()
    reqs: list[Request] = []
    offset = seed % len(pool)
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def client() -> None:
        while True:
            with lock:
                now = time.perf_counter()
                if now >= deadline:
                    return
                i = len(reqs)
                r = Request(i, (i + offset) % len(pool), request_seed(seed, i), now)
                reqs.append(r)
            run_request(pred, pool, r, pixel_max, C)

    threads = [threading.Thread(target=client, name=f"client{c}")
               for c in range(int(traffic["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sync()
    return reqs, t0, time.perf_counter()


def schedule(n: int, rate: float, n_images: int, schedule_seed: int,
             seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(gaps, images)`` of ``n`` arrivals: exponential gaps at the
    quantiles ``(k + 0.5) / n`` and the pool's images in turn, both shuffled
    once by the traffic's ``schedule_seed``, then rotated by the run's seed,
    so that every seed sends the same arrivals and images in another order."""
    q = (np.arange(n) + 0.5) / n
    rng = np.random.default_rng(schedule_seed)
    gaps = rng.permutation(-np.log1p(-q) / rate)
    images = rng.permutation(np.arange(n) % n_images)
    k = seed % n
    return np.roll(gaps, -k), np.roll(images, -k)


def open_loop(pred, pool, traffic: dict, seed: int, seconds: float, pixel_max: float,
              C: int) -> tuple[list[Request], float, float]:
    rate = float(traffic["rate_per_s"])
    n = max(1, round(rate * seconds))
    gaps, order = schedule(n, rate, len(pool), int(traffic["schedule_seed"]), seed)
    late = []
    with ThreadPoolExecutor(max_workers=int(traffic["max_threads"])) as ex:
        t0 = time.perf_counter()
        due = t0 + np.cumsum(gaps)
        reqs = [Request(i, int(order[i]), request_seed(seed, i), float(due[i])) for i in range(n)]
        futs = []
        for r in reqs:
            wait = r.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - r.due)
            futs.append(ex.submit(run_request, pred, pool, r, pixel_max, C))
        for f in futs:
            f.result()
    sync()
    lat = np.sort(np.asarray(late)) * 1e3
    print(f"generator lateness over {n} requests: median {np.median(lat):.3f} ms, "
          f"p95 {lat[min(n - 1, math.ceil(0.95 * n) - 1)]:.3f} ms, max {lat[-1]:.3f} ms",
          file=sys.stderr, flush=True)
    return reqs, t0, time.perf_counter()


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile over every value (inf for a failure)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def latencies_from_due(reqs: list[Request]) -> list[float]:
    return [(r.end - r.due) if r.ok else math.inf for r in reqs]


def make_pool(config: dict, traffic: dict, seed: int, device="cuda"):
    return images.pool(config["H"], config["W"], traffic, seed, device)


def serve_cell(cell, args, t_start: float, device: str = "cuda") -> dict:
    """Set-up, the window under the cell's loop, and the check."""
    import gc

    from benchmark import trace
    from benchmark.check import sample_requests, serve_check, verdict
    from benchmark.readers import Context

    cfg, traffic = cell.config, cell.traffic
    cuda = device == "cuda"
    pixel_max = float((1 << int(traffic["pixel_bits"])) - 1)
    marks = [("start", time.perf_counter())]
    pred, weights = build(cfg, args.seed, device)
    marks.append(("build", time.perf_counter()))
    pool = make_pool(cfg, traffic, args.seed, device)
    marks.append(("pool", time.perf_counter()))
    warm(pred, pool, pixel_max)
    marks.append(("warm", time.perf_counter()))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    loop = closed_loop if traffic["loop"] == "closed" else open_loop
    with trace.traced(bool(args.trace)) as tr:
        reqs, t0, t1 = loop(pred, pool, traffic, args.seed, args.seconds, pixel_max, cfg["C"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = t1 - t0
    ok = [r for r in reqs if r.ok]
    for r in reqs:
        if not r.ok:
            print(f"request {r.index} failed: {r.error}", file=sys.stderr)
    e2e = {
        "serve_req_per_s": len(ok) / window,
        "serve_p95_ms": percentile(latencies_from_due(reqs), 95) * 1e3,
        "peak_gib": peak / 2**30,
        "setup_s": setup_s,
    }
    print(f"window {window:.3f} s: {len(reqs)} requests, {len(reqs) - len(ok)} failed, buckets "
          f"{sorted({r.bucket for r in ok})}, valid tiles {min((r.n_valid for r in ok), default=0)}"
          f"-{max((r.n_valid for r in ok), default=0)}", file=sys.stderr, flush=True)
    del pred
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = sample_requests(reqs, int(traffic["check_requests"]), args.seed)
    t_check = time.perf_counter()
    prog, ctrl = serve_check(sample, pool, weights, cfg, pixel_max, bool(args.control), device)
    print(f"check of {len(sample)} requests: {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr, flush=True)
    if ctrl is not None:
        print(f"control (reference at the lower precision) against the reference: {ctrl}",
              file=sys.stderr)
    correct, checks = verdict(prog, cfg["limits"])
    return {"correct": correct and len(ok) == len(reqs), "attempted": len(reqs),
            "failed": len(reqs) - len(ok), "e2e": e2e,
            "ctx": Context(cell, tr.timeline, requests=reqs, window_s=window),
            "peak": peak, "checks": checks, "marks": marks}
