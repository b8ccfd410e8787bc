"""The readers of the port's own spans and counters (``program_spans.py``
and its nine metrics): their arithmetic on spans made by hand, None where
spans were dropped or do not match the window, and a number from each in
a CPU run of a cell cut to a test's size."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import pytest

from benchmark import program_spans, run, spec, trace
from benchmark.tests._tiny import args, tiny_cell

SERVE_METRICS = ("host_prep_ms.rps", "upload_ms.rps", "gate_held_ms.rps", "launch_ms.rps",
                 "bucket_roundup_pct.rps")
TRAIN_METRICS = ("loader_wait_ms.train", "loader_read_ms.train", "loader_build_ms.train",
                 "exact_count_pct.train")


def _span(name, ms, sid, parent, root, counts=None):
    from montecarlo_gated_mil_tpu_torch.utils.profiling import Span

    return Span(name, 0, int(ms * 1e6), 1, sid, parent, root, {}, counts or {})


def _request(root, prep, upload, execute, stages, rounded):
    """The spans of one request under ``root`` (ids root .. root + 10)."""
    e = root + 5
    out = [_span("serve.request", 999, root, None, root),
           _span("serve.prep", prep, root + 1, root, root,
                 {"serve.bucket_rounded_up": 1} if rounded else {}),
           _span("serve.upload_wait", 7, root + 2, root, root),
           _span("serve.upload", upload, root + 3, root, root),
           _span("serve.gate_wait", 50, root + 4, root, root),
           _span("serve.execute", execute, e, root, root)]
    names = ("serve.bag", "serve.embed", "serve.head", "serve.stats")
    out += [_span(n, ms, e + 1 + k, e, root) for k, (n, ms) in enumerate(zip(names, stages))]
    return out + [_span("serve.fetch", 30, e + 5, e, root)]


def _serve_ctx(n_done, n_failed=0):
    return SimpleNamespace(requests=[SimpleNamespace(ok=True)] * n_done
                           + [SimpleNamespace(ok=False)] * n_failed, steps=[])


def _read(name, ctx):
    return spec.load_metric_reader(name)(ctx)


def _use(monkeypatch, spans):
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)


def test_serving_readers_take_means_a_request(monkeypatch):
    spans = (_request(100, 20.0, 3.0, 70.0, (1.0, 10.0, 2.0, 1.0), True)
             + _request(200, 30.0, 5.0, 80.0, (2.0, 12.0, 3.0, 2.0), False))
    _use(monkeypatch, spans)
    ctx = _serve_ctx(2)
    assert _read("host_prep_ms.rps", ctx) == pytest.approx(25.0)
    assert _read("upload_ms.rps", ctx) == pytest.approx(4.0)
    assert _read("gate_held_ms.rps", ctx) == pytest.approx(75.0)
    # bag + embed + head; the statistics' span (the wait on the device) left out
    assert _read("launch_ms.rps", ctx) == pytest.approx((13.0 + 17.0) / 2)
    assert _read("bucket_roundup_pct.rps", ctx) == pytest.approx(50.0)


def test_serving_readers_leave_out_spans_of_no_request(monkeypatch):
    """A warm-up's spans (no ``serve.request`` root) count for nothing."""
    stray = [_span("serve.upload", 500.0, 900, None, 900),
             _span("serve.execute", 500.0, 901, None, 901)]
    _use(monkeypatch, _request(100, 20.0, 3.0, 70.0, (1.0, 10.0, 2.0, 1.0), False) + stray)
    assert _read("upload_ms.rps", _serve_ctx(1)) == pytest.approx(3.0)
    assert _read("gate_held_ms.rps", _serve_ctx(1)) == pytest.approx(70.0)
    assert _read("bucket_roundup_pct.rps", _serve_ctx(1)) == 0.0


@pytest.mark.parametrize("name", SERVE_METRICS)
def test_serving_readers_refuse_what_does_not_match(monkeypatch, name):
    one = _request(100, 20.0, 3.0, 70.0, (1.0, 10.0, 2.0, 1.0), True)
    _use(monkeypatch, one)
    assert _read(name, _serve_ctx(2)) is None  # two requests done, one root
    assert _read(name, _serve_ctx(1, n_failed=1)) is not None
    _use(monkeypatch, [s for s in one if s.name == "serve.request"])
    assert _read(name, _serve_ctx(1)) is None  # no span of its kind
    _use(monkeypatch, None)
    assert _read(name, _serve_ctx(1)) is None  # dropped, or no recorder
    _use(monkeypatch, [])
    assert _read(name, _serve_ctx(0)) is None


def _bag(root, read, build, wait, exact):
    return [_span("loader.read", read, root, None, root),
            _span("loader.build", build, root + 1, None, root,
                  {"loader.exact_count": 1} if exact else {}),
            _span("loader.wait", wait, root + 2, None, root)]


def test_training_readers_take_means_a_bag(monkeypatch):
    spans = _bag(10, 4.0, 30.0, 20.0, True) + _bag(20, 6.0, 34.0, 0.5, False) + _bag(
        30, 5.0, 32.0, 2.0, False)
    extra_build = [_span("loader.read", 5.0, 40, None, 40),
                   _span("loader.build", 36.0, 41, None, 40, {"loader.exact_count": 1})]
    _use(monkeypatch, spans + extra_build)  # a bag built ahead, never taken
    ctx = SimpleNamespace(requests=[], steps=[1, 2, 3])
    assert _read("loader_wait_ms.train", ctx) == pytest.approx(22.5 / 3)
    assert _read("loader_read_ms.train", ctx) == pytest.approx(5.0)
    assert _read("loader_build_ms.train", ctx) == pytest.approx(33.0)
    assert _read("exact_count_pct.train", ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("name", TRAIN_METRICS)
def test_training_readers_refuse_what_does_not_match(monkeypatch, name):
    spans = _bag(10, 4.0, 30.0, 20.0, True) + _bag(20, 6.0, 34.0, 0.5, False)
    _use(monkeypatch, spans)
    assert _read(name, SimpleNamespace(requests=[], steps=[1, 2])) is not None
    assert _read(name, SimpleNamespace(requests=[], steps=[1, 2, 3])) is None  # fewer waits
    assert _read(name, SimpleNamespace(requests=[], steps=[])) is None
    _use(monkeypatch, None)
    assert _read(name, SimpleNamespace(requests=[], steps=[1])) is None


def test_recorded_is_none_after_a_drop_or_without_the_recorder(monkeypatch):
    from montecarlo_gated_mil_tpu_torch.utils import profiling

    profiling.clear()
    try:
        with profiling.recording():
            with profiling.span("serve.request"):
                pass
        assert [s.name for s in program_spans.recorded()] == ["serve.request"]
        monkeypatch.setattr(profiling, "dropped", lambda: 1)
        assert program_spans.recorded() is None
        monkeypatch.delattr(profiling, "spans")  # a port from before the recorder
        assert program_spans.recorded() is None
    finally:
        profiling.clear()


@contextlib.contextmanager
def _window_recorded(enabled):
    """``trace.traced`` on the CPU: no device timeline, the port's spans
    recorded over the window as the profiler would have them."""
    from montecarlo_gated_mil_tpu_torch.utils import profiling

    with profiling.recording():
        yield SimpleNamespace(timeline=None)


@pytest.mark.parametrize("workload, cell_traffic, metrics", [
    ("r18-int8-serve-closed4", dict(pool=2, clients=2, check_requests=2), SERVE_METRICS),
    ("r18-f32-train", dict(records=4, setup_bags=4, check_steps=2), TRAIN_METRICS),
])
def test_every_metric_reads_a_number_in_a_cpu_run(monkeypatch, workload, cell_traffic, metrics):
    from montecarlo_gated_mil_tpu_torch.utils import profiling

    monkeypatch.setattr(trace, "traced", _window_recorded)
    profiling.clear()
    try:
        out = run.run_cell(tiny_cell(workload, **cell_traffic), args(seconds=1.0),
                           run.T_START, device="cpu")
        got = {m: _read(m, out["ctx"]) for m in metrics}
    finally:
        profiling.clear()
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
