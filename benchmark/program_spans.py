"""The port's own spans and counters, for the readers of the ``program_span``
and ``program_counter`` metrics.

The port's recorder (``montecarlo_gated_mil_tpu_torch/utils/profiling.py``:
``span``, ``count``, ``spans``) keeps spans while a ``torch.profiler``
session runs, so after a ``--trace 1`` run it holds the traced window's
spans and nothing else.  Serving spans hang under one ``serve.request``
root per request; a loader's bag is a tree begun by ``loader.read``.  Each
reader returns None where there is nothing sound to read: a port without
the recorder, spans dropped from its buffer, no span of the kind asked
for, or a count of roots or waits that does not match the window's
requests or steps.
"""

from __future__ import annotations


def recorded():
    """The recorder's spans, or None where the port has no recorder or its
    buffer dropped spans."""
    try:
        from montecarlo_gated_mil_tpu_torch.utils.profiling import dropped, spans
    except ImportError:
        return None
    if dropped():
        return None
    return spans()


def _request_spans(ctx):
    """``(spans of the window's requests, number of requests)``, or None
    where the ``serve.request`` roots are not the window's completed
    requests one for one."""
    spans = recorded()
    if spans is None:
        return None
    roots = {s.id for s in spans if s.name == "serve.request" and s.parent is None}
    done = sum(1 for r in ctx.requests if r.ok)
    if not roots or len(roots) != done:
        return None
    return [s for s in spans if s.root in roots], done


def request_ms(ctx, *names: str):
    """Mean ms a request in the spans named ``names``, summed."""
    got = _request_spans(ctx)
    if got is None:
        return None
    spans, n = got
    mine = [s.ms for s in spans if s.name in names]
    return sum(mine) / n if mine else None


def request_count_pct(ctx, counter: str, where: str):
    """100 x the requests' sum of ``counter`` (counted in their ``where``
    spans) over the requests."""
    got = _request_spans(ctx)
    if got is None:
        return None
    spans, n = got
    mine = [s.counts.get(counter, 0) for s in spans if s.name == where]
    return 100.0 * sum(mine) / n if mine else None


def _loader_spans(ctx):
    """The loader's spans, or None where the consumer waited fewer times
    than the window took steps."""
    spans = recorded()
    if spans is None or not ctx.steps:
        return None
    if sum(1 for s in spans if s.name == "loader.wait") < len(ctx.steps):
        return None
    return [s for s in spans if s.name.startswith("loader.")]


def bag_ms(ctx, name: str):
    """Mean ms of a ``name`` span: one a bag."""
    spans = _loader_spans(ctx)
    if spans is None:
        return None
    mine = [s.ms for s in spans if s.name == name]
    return sum(mine) / len(mine) if mine else None


def bag_count_pct(ctx, counter: str, where: str):
    """100 x the sum of ``counter`` (counted in ``where`` spans) over those
    spans: one a bag."""
    spans = _loader_spans(ctx)
    if spans is None:
        return None
    mine = [s.counts.get(counter, 0) for s in spans if s.name == where]
    return 100.0 * sum(mine) / len(mine) if mine else None
