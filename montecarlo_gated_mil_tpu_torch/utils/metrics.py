"""Metrics front-end with pluggable sinks.

Counterpart of ``montecarlo_gated_mil_tpu/utils/metrics.py``: one thin
``Metrics`` fans out to stdout, JSONL, in-memory, TensorBoard and Neptune
sinks, with the reference's metric names (``train/epoch_loss``,
``val/epoch_acc``, ``test/accuracy``, fold-prefixed ``{fold}/train/...``).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Protocol


class MetricsSink(Protocol):
    def log(self, name: str, value: Any, step: int | None = None) -> None: ...

    def close(self) -> None: ...


class StdoutSink:
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def log(self, name, value, step=None):
        step_s = f" step={step}" if step is not None else ""
        if isinstance(value, float):
            value = f"{value:.6g}"
        print(f"[metrics] {name}={value}{step_s}", file=self.stream)

    def close(self):
        pass


class JsonlSink:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, name, value, step=None):
        rec = {"ts": time.time(), "name": name, "value": value}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class MemorySink:
    def __init__(self):
        self.records: list[tuple[str, Any, int | None]] = []

    def log(self, name, value, step=None):
        self.records.append((name, value, step))

    def values(self, name: str) -> list[Any]:
        return [v for n, v, _ in self.records if n == name]

    def close(self):
        pass


class TensorBoardSink:
    """TensorBoard event files via ``torch.utils.tensorboard`` (imported
    here, so the module imports without tensorboard).  Scalars go to
    ``add_scalar``, with a per-name step counted here when none is given;
    everything else (classification reports, paths) to ``add_text``."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)
        self._auto_step: dict[str, int] = {}

    def log(self, name, value, step=None):
        if step is None:
            step = self._auto_step.get(name, 0)
            self._auto_step[name] = step + 1
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            self.writer.add_scalar(name, value, global_step=step)
        else:
            self.writer.add_text(name, str(value), global_step=step)

    def close(self):
        self.writer.close()


class NeptuneSink:
    """Passthrough to a Neptune run object (reference
    ``neptune_run[k].log(v)``); imports nothing."""

    def __init__(self, run):
        self.run = run

    def log(self, name, value, step=None):
        if step is None:
            self.run[name].log(value)
        else:
            self.run[name].log(value, step=step)

    def close(self):
        try:
            self.run.stop()
        except Exception:
            pass


class Metrics:
    """Fan-out logger with an optional fold prefix (reference fold-prefixed
    names, ``net_utils.py:72-76``).  Tensors are logged as Python floats."""

    def __init__(self, sinks: list[MetricsSink] | None = None, fold: int | None = None):
        self.sinks = sinks if sinks is not None else [StdoutSink()]
        self.fold = fold

    def scoped(self, fold: int | None) -> "Metrics":
        return Metrics(self.sinks, fold)

    def log(self, name: str, value, step: int | None = None):
        if self.fold is not None:
            name = f"{self.fold}/{name}"
        v = float(value) if hasattr(value, "item") else value
        for s in self.sinks:
            s.log(name, v, step)

    def close(self):
        for s in self.sinks:
            s.close()
