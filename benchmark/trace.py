"""A traced window: the device timeline from ``torch.profiler`` and its
reduction to busy time, kernel time by name and idle gaps by host activity.

The window is bracketed by two long spin kernels (marks); a run of short
spin kernels goes first, because a trace can lose its first records.
Device operations are kernels, copies and memsets; the busy time is the
length of their union between the marks.  An idle gap is named by the
innermost host operation or annotation that covers its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

_HEAD_SPINS = 64
_SHORT_SPIN, _MARK_SPIN = 1_000, 200_000  # cycles: about 1 and 100 us
_MARK_US = 20.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


@dataclass
class Timeline:
    window_s: float
    busy_s: float
    kernels: list[tuple[str, float, float]]  # (name, start s, duration s), device kernels only
    gaps_by_host: dict[str, float] = field(default_factory=dict)

    def device_s(self, *names: str) -> float:
        return sum(d for n, _, d in self.kernels if any(x in n for x in names))

    def launches(self, *names: str) -> int:
        return sum(1 for n, _, _ in self.kernels if any(x in n for x in names))

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for n, _, d in self.kernels:
            out[n] += d
        return dict(out)

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps_by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: list[dict]) -> Timeline:
    """A Chrome-trace event list (``ts``/``dur`` in us) -> the timeline
    between the two outermost marks."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    dev.sort(key=lambda e: e["ts"])
    marks = [i for i, e in enumerate(dev)
             if "spin" in e.get("name", "") and float(e["dur"]) >= _MARK_US]
    if len(marks) < 2:
        raise RuntimeError(f"trace lost a mark: {len(marks)} of 2 in {len(dev)} records")
    lo = float(dev[marks[0]]["ts"]) + float(dev[marks[0]]["dur"])
    hi = float(dev[marks[-1]]["ts"])
    inside = [e for e in dev[marks[0] + 1:marks[-1]]]
    spans = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in inside])
    busy = sum(min(b, hi) - max(a, lo) for a, b in spans if b > lo and a < hi)
    kernels = [(e["name"], float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
               for e in inside if e["cat"] == "kernel"]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), float(e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS))
    gaps: dict[str, float] = defaultdict(float)
    prev, j, active = lo, 0, []
    for a, b in [s for s in spans if s[1] > lo] + [(hi, hi)]:
        if a > prev:
            mid = 0.5 * (prev + min(a, hi))
            while j < len(host) and host[j][0] <= mid:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[1] >= mid]
            label = min(active, key=lambda h: h[2])[3] if active else "no host op"
            gaps[label] += (min(a, hi) - prev) * 1e-6
        prev = max(prev, b)
        if prev >= hi:
            break
    return Timeline((hi - lo) * 1e-6, busy * 1e-6, kernels, dict(gaps))


@contextmanager
def traced(enabled: bool):
    """Trace the body on the card when ``enabled``; yields a holder whose
    ``timeline`` is set on exit."""
    holder = type("Holder", (), {"timeline": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(_HEAD_SPINS):
            torch.cuda._sleep(_SHORT_SPIN)
        torch.cuda.synchronize()
        torch.cuda._sleep(_MARK_SPIN)
        yield holder
        torch.cuda._sleep(_MARK_SPIN)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    holder.timeline = reduce_events(events)
