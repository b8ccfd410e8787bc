"""Multi-process runs of the port (``parallel/distributed.py``) on the CPU:
``initialize`` on a ``gloo`` group, the float64 gather of fold accuracies,
and cross-validation fanned out over two processes, against the JAX
package's single-process behaviour and the port's single-process run.

Every test that starts processes binds a free port, gives each process its
own timeout, kills what is left when one fails, and leaves its group with
``destroy_process_group``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import yaml

from montecarlo_gated_mil_tpu.parallel import distributed as jdist
from montecarlo_gated_mil_tpu_torch import runners
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict, config_to_dict
from montecarlo_gated_mil_tpu_torch.parallel import distributed as tdist

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds, per process


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(code: str, argvs, envs=None) -> list[str]:
    """Run ``python -c code`` once per entry of ``argvs``, all at once, each
    with its own timeout; returns their standard outputs and fails on a
    non-zero exit."""
    base = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    base.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    envs = envs or [{}] * len(argvs)
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv], cwd=REPO,
                              env={**base, **env}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_single_process_passthrough_as_jax():
    """Unconfigured, ``initialize`` starts nothing and the gather is the
    identity merge, as in the JAX package (``test_parallel.py:431``)."""
    assert tdist.initialize() is False and jdist.initialize() is False
    assert not dist.is_initialized()
    args = ([0, 2], [0.5, 0.75], 3)
    assert tdist.allgather_fold_accuracies(*args) == jdist.allgather_fold_accuracies(*args) == {
        0: 0.5, 2: 0.75}


def test_initialize_says_what_is_missing(monkeypatch):
    """-1 takes ``WORLD_SIZE`` / ``RANK`` from a launcher; with neither
    there it raises before starting a group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="num_processes.*WORLD_SIZE"):
        tdist.initialize("127.0.0.1:1", -1, 0)
    with pytest.raises(ValueError, match="process_id.*RANK"):
        tdist.initialize("127.0.0.1:1", 2, -1)
    assert not dist.is_initialized()


_INIT_ONE = """
import sys
import torch.distributed as dist
from montecarlo_gated_mil_tpu_torch.parallel import distributed as d
ok = d.initialize(sys.argv[1], 1, 0)
assert ok is False and dist.is_initialized() and d.process_count() == 1, ok
assert d.initialize(sys.argv[1], 1, 0) is False  # an initialized group is success
dist.destroy_process_group()
print("INIT-OK")
"""


def test_initialize_with_a_one_process_coordinator():
    """A configured 1-process run initializes its group and reports one
    process, in a fresh process (``test_parallel.py:404``)."""
    (out,) = _run_processes(_INIT_ONE, [[f"127.0.0.1:{_free_port()}"]])
    assert "INIT-OK" in out


_GATHER = """
import sys
import torch.distributed as dist
from montecarlo_gated_mil_tpu_torch.parallel import distributed as d
rank = int(sys.argv[2])
if rank == 0:
    ok = d.initialize(sys.argv[1], 2, 0)
else:  # as a launcher starts it: WORLD_SIZE and RANK in the environment
    ok = d.initialize(sys.argv[1], -1, -1)
got = d.allgather_fold_accuracies([rank], [2 / 3 if rank == 0 else 0.25], 3)
print("GATHERED", repr(got), ok, d.process_index(), d.process_count())
dist.destroy_process_group()
"""


def test_two_process_gather_keeps_float64():
    """Two ``gloo`` processes (the second configured from ``WORLD_SIZE`` /
    ``RANK``) each gather both folds' accuracies; 2/3 stays
    0.6666666666666666 (the JAX package's f64 fix)."""
    addr = f"127.0.0.1:{_free_port()}"
    outs = _run_processes(_GATHER, [[addr, "0"], [addr, "1"]],
                          [{}, {"WORLD_SIZE": "2", "RANK": "1"}])
    for rank, out in enumerate(outs):
        assert f"GATHERED {{0: 0.6666666666666666, 1: 0.25}} True {rank} 2" in out


# tests/test_runners.py's geometry: 128x128, patch 64, buckets (8, 16), 10
# records, 2 folds; one epoch.
RAW = {
    "seed": 7, "N": 3, "is_MCDO-val": False, "is_MCDO-test": True, "shared_att": True,
    "data": {
        "H": 128, "W": 128, "patch_size": 64, "overlap_train": 0.0, "overlap_val_test": 0.0,
        "empty_threshold": 0.05, "cv_folds": 2, "fraction_test": 0.3,
        "fraction_train_rest": 0.6, "fraction_val_test": 0.5, "synthetic_count": 10,
    },
    "training_plan": {"optimizer": "sgd",
                      "parameters": {"lr": 0.001, "epochs": 1, "grad_acc_steps": 2}},
    "tpu": {"buckets": [8, 16], "data_parallel_eval": False},
}

_CV = """
import sys
import torch
torch.set_num_threads(1)
from montecarlo_gated_mil_tpu_torch import cli
sys.exit(cli.main(["cv", "--config", sys.argv[1]], device="cpu"))
"""


def _yaml(path: Path, raw: dict) -> str:
    path.write_text(yaml.safe_dump(config_to_dict(config_from_dict(raw))))
    return str(path)


def test_cross_validation_fans_out_over_two_processes(tmp_path):
    """``cli cv`` with ``coordinator_address`` in two processes sharing one
    model path: each trains one fold, keeps its own progress and manifest
    (``cv_manifest_p{index}.json``), and holds both folds' accuracies,
    equal in float64 to a single-process run's."""
    single = runners.run_cross_validation(
        config_from_dict({**RAW, "model_path": str(tmp_path / "single")}), device="cpu")
    addr = f"127.0.0.1:{_free_port()}"
    shared = tmp_path / "fanout"
    ymls = [_yaml(tmp_path / f"p{r}.yml", {
        **RAW, "model_path": str(shared),
        "tpu": {**RAW["tpu"], "coordinator_address": addr, "num_processes": 2,
                "process_id": r}}) for r in range(2)]
    _run_processes(_CV, [[y] for y in ymls])
    assert not dist.is_initialized()
    for r in range(2):
        m = json.loads((shared / f"cv_manifest_p{r}.json").read_text())
        assert [f["fold"] for f in m["folds"]] == [r + 1]
        assert m["all_fold_accuracies"] == single["all_fold_accuracies"]
        assert m["all_fold_accuracies"].keys() == {"1", "2"}
    assert not list(shared.glob("cv_progress*.json"))
    merged = runners.load_cv_manifest(str(shared))
    assert [f["fold"] for f in merged["folds"]] == [1, 2]
