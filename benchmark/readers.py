"""The arithmetic of the per-layer metrics, shared by their readers in
``metrics/``.  Each returns None where the run gives it nothing to read."""

from __future__ import annotations

import statistics

from benchmark import counts, layers


def _head_dims(cfg: dict) -> tuple[int, int, int, int, int]:
    gates = 1 if cfg["shared_att"] else cfg["C"]
    return cfg["T"], cfg["L"], cfg["D"], cfg["C"], gates


def idle_pct(ctx):
    """Share of the traced window in which no device operation ran, in %."""
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def _done(ctx):
    return [r for r in ctx.requests if r.ok]


def serve_mfu_pct(ctx):
    """The least time of the model work of the window's requests (ResNet on
    the valid tiles, T head samples; each part at its precision's peak) over
    the window, in %."""
    done = _done(ctx)
    if not done or ctx.window_s <= 0:
        return None
    least = sum(counts.request_least_s(r.n_valid, ctx.config) for r in done)
    return 100.0 * least / ctx.window_s


def train_mfu_pct(ctx):
    """The least time of the window's training steps (forward and backward
    at f32) over the window, in %."""
    if not ctx.steps or ctx.window_s <= 0:
        return None
    least = sum(counts.train_step_least_s(s.n_valid, ctx.config) for s in ctx.steps)
    return 100.0 * least / ctx.window_s


def library_device_ms(ctx, units: int):
    """Device ms per request or step in kernels that are not the port's."""
    tl = ctx.timeline
    if tl is None or units <= 0:
        return None
    ms = sum(d for n, _, d in tl.kernels if layers.kernel_of(n) is None) * 1e3
    return ms / units


def k1_roofline(ctx):
    """K1's least time over its device time, summed over the window's
    launches (one per request), in %."""
    tl, done = ctx.timeline, _done(ctx)
    if tl is None or not done or tl.launches(*layers.K1_WGMMA_OR_TILE) != len(done):
        return None
    T, L, D, C, G = _head_dims(ctx.config)
    bound = sum(counts.k1_bound_s(r.bucket, r.n_valid, T, L, D, C, G) for r in done)
    spent = tl.device_s(*layers.PORT_KERNELS["K1"])
    return 100.0 * bound / spent if spent > 0 else None


def k6_roofline(ctx):
    """K6's least time over its device time, summed over every int8
    convolution of the window's requests, in %."""
    tl, done = ctx.timeline, _done(ctx)
    if tl is None or not done:
        return None
    per = {r.bucket: counts.k6_bounds_s(r.bucket, ctx.config["backbone"], ctx.config["patch"])
           for r in done}
    if tl.launches(*layers.K6_CONV) != sum(len(per[r.bucket]) for r in done):
        return None
    spent = tl.device_s(*layers.K6_CONV)
    return 100.0 * sum(sum(per[r.bucket]) for r in done) / spent if spent > 0 else None


def predict_p50_ms(ctx):
    """Median wall time of a request from its call of ``predict``, in ms."""
    done = _done(ctx)
    if not done:
        return None
    return statistics.median((r.end - r.start) * 1e3 for r in done)


class Context:
    """What a per-layer metric's reader sees: the traced timeline (None
    without ``--trace 1``), the window's requests or training steps, the
    window's length on the host clock, the configuration and the traffic."""

    def __init__(self, cell, timeline, requests=None, steps=None, window_s=0.0):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.timeline = timeline
        self.requests = requests or []
        self.steps = steps or []
        self.window_s = window_s
