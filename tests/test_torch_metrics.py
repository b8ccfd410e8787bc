"""The port's TensorBoard and Neptune sinks and their CLI wiring (CPU).

- ``TensorBoardSink``: the same log calls through the port's sink and the
  JAX package's write event files that tensorboard's ``EventAccumulator``
  reads back to the same scalars (tag, step and value, exactly) and the same
  text;
- ``NeptuneSink`` on a fake run object makes exactly the calls JAX's makes,
  ``stop`` included;
- ``cli.main(["train", "--tensorboard", DIR, ...], device="cpu")`` at the
  JAX tests' 128x128 geometry writes the run's epoch metrics as events;
  ``neptune: true`` prints the JAX package's message where ``neptune`` does
  not import, and logs to its run where it does.
"""

import sys
import types

import pytest
import torch
import yaml
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from montecarlo_gated_mil_tpu.utils import metrics as jm
from montecarlo_gated_mil_tpu_torch.cli import main
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict, config_to_dict
from montecarlo_gated_mil_tpu_torch.utils import metrics as tm

CALLS = [
    ("train/epoch_loss", 0.5, 1),
    ("train/epoch_loss", 0.25, 2),
    ("test/accuracy", 0.875, None),  # step-less scalars are auto-stepped
    ("test/accuracy", 0.75, None),
    ("test/count", 3, None),
    ("best_model_path", "/models/best", None),  # not a number: text
    ("test/classification_report", {"0": {"precision": 1.0}}, 4),
    ("debug/flag", True, None),  # a bool is text, not a scalar
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_events(log_dir) -> tuple[dict, dict]:
    """``({tag: [(step, value)]}, {tag: [(step, text)]})`` of a log dir."""
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "tensors": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]}
    texts = {t: [(e.step, e.tensor_proto.string_val[0].decode()) for e in acc.Tensors(t)]
             for t in tags["tensors"]}
    return scalars, texts


def test_tensorboard_sink_events_equal_jax(tmp_path):
    for module, name in ((tm, "port"), (jm, "jax")):
        sink = module.TensorBoardSink(str(tmp_path / name))
        for n, v, s in CALLS:
            sink.log(n, v, s)
        sink.close()
    got, want = _read_events(tmp_path / "port"), _read_events(tmp_path / "jax")
    assert got == want
    scalars, texts = got
    assert scalars["train/epoch_loss"] == [(1, 0.5), (2, 0.25)]
    assert scalars["test/accuracy"] == [(0, 0.875), (1, 0.75)]
    assert texts["best_model_path/text_summary"] == [(0, "/models/best")]
    assert "debug/flag/text_summary" in texts


class _FakeSeries:
    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def log(self, value, step=None):
        self.calls.append(("log", self.name, value, step))


class _FakeRun:
    def __init__(self):
        self.calls = []

    def __getitem__(self, name):
        return _FakeSeries(self.calls, name)

    def __setitem__(self, name, value):
        self.calls.append(("set", name, value))

    def stop(self):
        self.calls.append(("stop",))


def test_neptune_sink_calls_equal_jax():
    runs = []
    for module in (tm, jm):
        run = _FakeRun()
        sink = module.NeptuneSink(run)
        for n, v, s in CALLS:
            sink.log(n, v, s)
        sink.close()
        runs.append(run.calls)
    assert runs[0] == runs[1]
    assert runs[0][0] == ("log", "train/epoch_loss", 0.5, 1)
    assert runs[0][2] == ("log", "test/accuracy", 0.875, None) and runs[0][-1] == ("stop",)


def test_neptune_sink_close_survives_a_failing_stop():
    class Broken(_FakeRun):
        def stop(self):
            raise RuntimeError("connection lost")

    tm.NeptuneSink(Broken()).close()


def _train_config(tmp_path, **extra) -> str:
    """The JAX tests' 128x128 geometry: 6 synthetic records, 1 epoch."""
    raw = {
        "data": {"H": 128, "W": 128, "size": [128, 128], "patch_size": 32, "synthetic_count": 6,
                 "bag_size_train": 8, "bag_size_val_test": 8},
        "training_plan": {"parameters": {"epochs": 1}},
        "tpu": {"buckets": [8, 16]},
        "model_path": str(tmp_path / "models"),
        **extra,
    }
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(config_to_dict(config_from_dict(raw))))
    return str(path)


def test_cli_train_tensorboard_writes_events(tmp_path, capsys):
    tb = tmp_path / "tb"
    assert main(["train", "--config", _train_config(tmp_path), "--tensorboard", str(tb)],
                device="cpu") == 0
    assert "Test Accuracy" in capsys.readouterr().out
    scalars, texts = _read_events(tb)
    for tag in ("train/epoch_loss", "train/epoch_acc", "val/epoch_loss", "test/accuracy"):
        assert tag in scalars, tag
    assert [s for s, _ in scalars["train/epoch_loss"]] == [1]
    assert "test/classification_report/text_summary" in texts


def test_cli_neptune_missing_prints_the_jax_message(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "neptune", None)  # import neptune -> ImportError
    assert main(["train", "--config", _train_config(tmp_path, neptune=True)], device="cpu") == 0
    out = capsys.readouterr().out
    assert "neptune not installed; continuing with stdout metrics" in out
    assert "[metrics] train/epoch_loss=" in out


def test_cli_neptune_logs_to_its_run(tmp_path, monkeypatch):
    """Where ``neptune`` imports, ``init_run()``'s run gets the config path
    and every metric, and is stopped at the end, as in the JAX package."""
    run = _FakeRun()
    fake = types.ModuleType("neptune")
    fake.init_run = lambda: run
    monkeypatch.setitem(sys.modules, "neptune", fake)
    path = _train_config(tmp_path, neptune=True)
    assert main(["train", "--config", path], device="cpu") == 0
    assert run.calls[0] == ("set", "config", {"yml": path})
    logged = {c[1] for c in run.calls if c[0] == "log"}
    assert {"train/epoch_loss", "val/epoch_loss", "test/accuracy"} <= logged
    assert run.calls[-1] == ("stop",)
