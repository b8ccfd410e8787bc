"""The port's spans and counters (``utils/profiling.py``): the recorder, the
span tree of a request and of a loader's bag, the counters, and the cost
of a span while recording is off.

These import no JAX, so the card's twin runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py
"""

import glob
import json
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch

from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.data import pipeline as tpl
from montecarlo_gated_mil_tpu_torch.data import synthetic as tsyn
from montecarlo_gated_mil_tpu_torch.experiment import build_model
from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor
from montecarlo_gated_mil_tpu_torch.utils import profiling as prof

# test_torch_serve.py's geometry, with buckets
PIPE = dict(height=128, width=128, patch_size=64, overlap=0.0, empty_threshold=0.05, bucket=8)
LOADER_CFG = dict(height=128, width=128, patch_size=64, overlap=0.5, empty_threshold=0.5,
                  bucket=16)

REQUEST_TREE = [
    ("serve.request", None),
    ("serve.prep", "serve.request"),
    ("serve.upload_wait", "serve.request"),
    ("serve.upload", "serve.request"),
    ("serve.gate_wait", "serve.request"),
    ("serve.execute", "serve.request"),
    ("serve.bag", "serve.execute"),
    ("serve.embed", "serve.execute"),
    ("serve.head", "serve.execute"),
    ("serve.stats", "serve.execute"),
    ("serve.fetch", "serve.execute"),
]


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """One intra-op thread (the suite runs several workers at once) and an
    empty buffer for every test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prof.clear()
    yield
    prof.clear()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def predictor():
    model = build_model(Config(shared_att=False), seed=0)
    return MCDOPredictor(model, tpl.PipelineConfig(**PIPE), num_samples=2,
                         bucket_spec=BucketSpec((2, 4, 8)), device="cpu")


def _tree(spans, root):
    """``(name, parent's name)`` of the spans of one root, in opening order."""
    mine = sorted((s for s in spans if s.root == root), key=lambda s: s.id)
    names = {s.id: s.name for s in mine}
    return [(s.name, names.get(s.parent)) for s in mine]


def _image(tiles: int, sparse: bool) -> np.ndarray:
    """``tiles`` (1 or 2) filled tiles of the top row and, with ``sparse``, a
    tile below them with two pixels lit: its estimated fill (2 of 256
    subsampled pixels) lies inside the estimator's band."""
    img = np.zeros((128, 128), np.float32)
    img[:64, : 64 * tiles] = 0.8
    if sparse:
        img[64, 20] = img[68, 24] = 0.8
    return img


def test_off_by_default_nothing_is_recorded():
    with prof.span("a", k=1) as root:
        prof.count("c")
        prof.adopt(7)
        with prof.span("b"):
            pass
    assert root is None
    assert prof.spans() == [] and prof.dropped() == 0


def test_nesting_gives_parent_and_root_ids():
    with prof.recording():
        with prof.span("a", k=1) as ra:
            with prof.span("b") as rb:
                prof.count("hits")
                prof.count("hits", 2)
                with prof.span("c"):
                    pass
            with prof.span("d"):
                prof.count("other")
        with prof.span("e", root=ra):
            pass
        with prof.span("f"):
            with prof.span("g"):
                prof.adopt(ra)
    got = {s.name: s for s in prof.spans()}
    a, b, c, d, e, f, g = (got[n] for n in "abcdefg")
    assert ra == rb == a.id and a.parent is None and a.root == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert b.root == c.root == d.root == a.id
    assert e.parent is None and e.root == a.id  # a tree continued by its root id
    assert f.root == f.id and g.parent == f.id and g.root == a.id  # adopted
    assert b.counts == {"hits": 3} and d.counts == {"other": 1} and a.counts == {}
    assert a.attrs == {"k": 1}
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= a.end_ns
    assert c.ms >= 0 and {s.thread for s in got.values()} == {threading.get_native_id()}
    # outside any span a count goes nowhere
    with prof.recording():
        prof.count("lost")
    assert len(prof.spans()) == 7


def test_span_tree_of_one_predict(predictor):
    with prof.recording():
        res = predictor.predict(_image(2, False), seed=3)
    spans = prof.spans()
    root, = [s for s in spans if s.parent is None]
    assert root.name == "serve.request" and _tree(spans, root.id) == REQUEST_TREE
    assert len(spans) == len(REQUEST_TREE)
    by = {s.id: s for s in spans}
    for s in spans:  # every child inside its parent
        if s.parent is not None:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert res.bucket == 2


def test_four_threads_predicting_at_once_keep_one_root_per_request(predictor):
    images = [_image(1 + i % 2, i % 3 == 0) for i in range(8)]
    errors = []

    def client(k):
        try:
            for i in (k, k + 4):
                predictor.predict(images[i], seed=i)
        except Exception as e:  # reported below
            errors.append(e)

    with prof.recording():
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = prof.spans()
    roots = [s for s in spans if s.name == "serve.request"]
    assert len(roots) == 8 and all(r.parent is None and r.root == r.id for r in roots)
    assert len(spans) == 8 * len(REQUEST_TREE)
    for r in roots:
        assert _tree(spans, r.id) == REQUEST_TREE
        assert {s.thread for s in spans if s.root == r.id} == {r.thread}
    assert len({r.thread for r in roots}) == 4


def test_bucket_rounded_up_counts_the_estimates_verdict(predictor):
    images = [_image(2, True), _image(2, False), _image(1, True)]
    verdicts = []
    for img in images:
        n, n_hi = tpl.estimate_valid_tiles(img, False, predictor._starts_np, predictor.pipeline,
                                           margin_hi=tpl.ESTIMATE_MARGIN_HI)
        lo, hi = (predictor._decide_bucket(m, False)[0] for m in (n, n_hi))
        verdicts.append(hi > lo)
    assert verdicts == [True, False, False]
    with prof.recording():
        buckets = [predictor.predict(img, seed=1).bucket for img in images]
    spans = prof.spans()
    prep = sorted((s for s in spans if s.name == "serve.prep"), key=lambda s: s.id)
    assert [s.counts.get("serve.bucket_rounded_up", 0) for s in prep] == [1, 0, 0]
    assert sum(s.counts.get("serve.bucket_rounded_up", 0) for s in spans) == 1
    assert buckets == [4, 2, 2]


def _offsize_odd_reader():
    at_size = tsyn.make_synthetic_reader(128, 128)

    def read(rec):
        img = at_size(rec)
        idx = int(rec.paths[0].rsplit("//", 1)[1])
        return img[:120, :100] if idx % 2 else img  # off-size: no estimate

    return read


@pytest.mark.parametrize("io_workers", [1, 4])
def test_loader_spans_per_bag(io_workers):
    records = tsyn.synthetic_records(6, seed=2)
    loader = tpl.BagLoader(records, _offsize_odd_reader(), tpl.PipelineConfig(**LOADER_CFG),
                           seed=3, bucket_spec=BucketSpec((8, 16)), io_workers=io_workers,
                           device="cpu")
    cfg = loader.cfg
    may_overflow = loader._num_candidates > cfg.bucket and not 0 < cfg.bag_size <= cfg.bucket
    verdicts = []
    for rec in records:
        img = _offsize_odd_reader()(rec)
        est = tpl.estimate_valid_tiles(img, rec.laterality == "R", loader._starts_np, cfg,
                                       margin_hi=tpl.ESTIMATE_MARGIN_HI)
        verdicts.append(est is None or loader._decide(est[0], may_overflow)
                        != loader._decide(est[1], may_overflow))
    with prof.recording():
        bags = list(loader.epoch(2))
    assert len(bags) == 6
    spans = prof.spans()
    reads = sorted((s for s in spans if s.name == "loader.read"), key=lambda s: s.attrs["position"])
    assert [s.attrs for s in reads] == [{"epoch": 2, "position": k} for k in range(6)]
    assert all(s.parent is None and s.root == s.id for s in reads)
    builds = {s.root: s for s in spans if s.name == "loader.build"}
    waits = [s for s in spans if s.name == "loader.wait"]
    assert len(builds) == 6 and len(waits) == 6 + 1  # the last wait: the epoch's end
    for r in reads:
        b = builds[r.root]
        assert b.parent is None and r.end_ns <= b.start_ns
        assert [w.root for w in waits].count(r.root) == 1
    assert [builds[r.root].counts.get("loader.exact_count", 0) for r in reads] == [
        int(v) for v in verdicts]
    assert 0 < sum(verdicts) < 6
    producer = {s.thread for s in spans if s.name in ("loader.read", "loader.build")}
    assert len(producer) == 1 and {w.thread for w in waits} == {threading.get_native_id()}


def test_buffer_keeps_the_newest_and_counts_the_dropped():
    extra = 5
    with prof.recording():
        for i in range(prof.SPAN_CAPACITY + extra):
            with prof.span("s", i=i):
                pass
    kept = prof.spans()
    assert len(kept) == prof.SPAN_CAPACITY and prof.dropped() == extra
    assert kept[0].attrs == {"i": extra} and kept[-1].attrs == {"i": prof.SPAN_CAPACITY + extra - 1}
    prof.clear()
    assert prof.spans() == [] and prof.dropped() == 0


def test_many_threads_lose_no_span():
    """More threads than cores, switching as often as the interpreter
    allows: every span is kept, under its own thread's parent."""
    n_threads, per = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with prof.span("outer"):
                    with prof.span("inner"):
                        prof.count("n")

        with prof.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = prof.spans()
    assert len(spans) == 2 * n_threads * per and prof.dropped() == 0
    by = {s.id: s for s in spans}
    inner = [s for s in spans if s.name == "inner"]
    assert all(by[s.parent].name == "outer" and by[s.parent].thread == s.thread
               and s.root == s.parent and s.counts == {"n": 1} for s in inner)


def test_off_path_costs_under_a_microsecond():
    """While recording is off, a span costs under 1 us: 10,000 spans in
    batches of 100, the median batch less an empty loop's median batch, and
    the least of five such rounds, so that other processes on the machine
    can slow a round but not the verdict."""
    clock = time.perf_counter_ns
    batch = range(100)

    def round_ns() -> float:
        bare, timed = [], []
        for _ in range(100):
            t0 = clock()
            for _ in batch:
                pass
            bare.append(clock() - t0)
            t0 = clock()
            for _ in batch:
                with prof.span("serve.prep"):
                    pass
            timed.append(clock() - t0)
        return (statistics.median(timed) - statistics.median(bare)) / len(batch)

    cost_ns = min(round_ns() for _ in range(5))
    assert cost_ns < 1000, cost_ns
    assert prof.spans() == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_around_a_kernel_launch_is_on_the_traces_clock(cuda, tmp_path):
    """A span opened in a thread started inside ``trace()`` around a matmul
    on the card: the exported trace holds it by name within 1 ms of the
    recorder's start, and the kernel starts after the span opened."""
    x = torch.ones(2048, 2048, device=cuda)
    (x @ x).sum().item()  # cuBLAS's set-up outside the trace

    def work():
        with prof.span("mcgmil-card-span"):
            x @ x
        torch.cuda.synchronize()

    with prof.trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=120)
    assert not t.is_alive()
    rec, = [s for s in prof.spans() if s.name == "mcgmil-card-span"]
    doc = json.load(open(glob.glob(str(tmp_path / "*.pt.trace.json"))[0]))
    base = int(doc["baseTimeNanoseconds"])
    ev, = [e for e in doc["traceEvents"] if e.get("name") == "mcgmil-card-span"]
    assert abs(float(ev["ts"]) * 1000 + base - rec.start_ns) < 1e6
    kernels = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"]
    assert kernels and min(float(e["ts"]) for e in kernels) > float(ev["ts"])
