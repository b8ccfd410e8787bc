"""The port's command line (cli.py) on the CPU: ``serve`` over JSONL,
``train`` on a tiny geometry, and what is not ported exiting non-zero with
its ROADMAP item."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from montecarlo_gated_mil_tpu_torch.cli import main
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict, config_to_dict, load_config
from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
from montecarlo_gated_mil_tpu_torch.server import build_predictor, result_to_dict

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_config(tmp_path, raw) -> tuple[str, object]:
    cfg = config_from_dict(raw)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(config_to_dict(cfg)))
    return str(path), cfg


SERVE_RAW = {
    "N": 3,
    "seed": 3,
    "data": {"H": 128, "W": 128, "patch_size": 64, "overlap_val_test": 0.0,
             "empty_threshold": 0.05},
    "tpu": {"buckets": [8]},
}


def test_config_to_dict_round_trips_through_yaml(tmp_path):
    raw = {"seed": 9, "N": 7, "model": "r34", "data": {"view": ["CC"], "size": [64, 80]},
           "training_plan": {"scheduler": {"name": "cosine"}}, "tpu": {"buckets": [8, 24]}}
    path, cfg = _write_config(tmp_path, raw)
    assert load_config(path) == cfg
    d = config_to_dict(cfg)
    assert d["seed"] == 9 and d["tpu"]["buckets"] == (8, 24) and d["data"]["size"] == (64, 80)


def test_cli_serve_jsonl(tmp_path, capsys):
    """``serve --input``: each result line equals the record of
    ``build_predictor(cfg).predict`` for its request, to a file or stdout."""
    path, cfg = _write_config(tmp_path, SERVE_RAW)
    reqs = []
    for i in range(2):
        img = tmp_path / f"img_{i}.npy"
        np.save(img, synthetic_image(128, 128, positive=bool(i), seed=40 + i))
        reqs.append({"image": str(img), "seed": i, "laterality": "LR"[i]})
    in_path = tmp_path / "requests.jsonl"
    in_path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    out_path = tmp_path / "results.jsonl"
    argv = ["serve", "--config", path, "--input", str(in_path)]
    assert main(argv + ["--output", str(out_path)], device="cpu") == 0
    lines = [json.loads(line) for line in out_path.read_text().splitlines()]
    pred = build_predictor(cfg, device="cpu")
    want = [result_to_dict(pred.predict(np.load(r["image"]), r["laterality"], seed=r["seed"]))
            for r in reqs]
    assert lines == want
    capsys.readouterr()
    assert main(argv + ["--no-warmup"], device="cpu") == 0
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == want


def test_cli_serve_neptune_missing_continues(tmp_path, capsys, monkeypatch):
    """``neptune: true`` without the package: a notice, then the run goes
    on with stdout metrics, as in the JAX package."""
    monkeypatch.setitem(sys.modules, "neptune", None)  # import neptune -> ImportError
    path, _ = _write_config(tmp_path, {**SERVE_RAW, "neptune": True})
    (tmp_path / "empty.jsonl").write_text("")
    assert main(["serve", "--config", path, "--input", str(tmp_path / "empty.jsonl"),
                 "--no-warmup"], device="cpu") == 0
    assert "neptune not installed" in capsys.readouterr().out


def test_cli_train(tmp_path, capsys):
    """``train`` runs ``run_training`` on the tiny geometry of
    test_torch_runner.py and saves the best model under its id."""
    raw = {
        "data": {"H": 128, "W": 128, "size": [128, 128], "patch_size": 32, "synthetic_count": 6,
                 "bag_size_train": 8, "bag_size_val_test": 8},
        "training_plan": {"parameters": {"epochs": 1}},
        "tpu": {"buckets": [8, 16]},
        "model_path": str(tmp_path / "models"),
        "model_id": "best",
    }
    path, _ = _write_config(tmp_path, raw)
    assert main(["train", "--config", path], device="cpu") == 0
    out = capsys.readouterr().out
    assert "Test Accuracy" in out and "[metrics] train/epoch_loss=" in out
    assert (tmp_path / "models" / "best").is_file()


_COORDINATOR = {"tpu": {"coordinator_address": "localhost:1234"}}


@pytest.mark.parametrize("argv, raw, item", [
    (["cv"], _COORDINATOR, "queue 1, item 1"),
    (["cv-eval", "--manifest", "m.json"], _COORDINATOR, "queue 1, item 1"),
    (["infer", "--out", "figs"], _COORDINATOR, "queue 1, item 1"),
    (["bench"], _COORDINATOR, "queue 1, item 1"),
    (["serve", "--aot-cache", "cache"], {}, "'Never to be ported'"),
    (["serve", "--input", "r.jsonl"], _COORDINATOR, "queue 1, item 1"),
    (["train"], _COORDINATOR, "queue 1, item 1"),
])
def test_unported_exits_nonzero_naming_roadmap(tmp_path, argv, raw, item):
    """Each refusal names its item in ROADMAP.md's current numbering:
    multi-process runs on every subcommand, and ``--aot-cache``."""
    path, _ = _write_config(tmp_path, raw)
    with pytest.raises(SystemExit) as exc:
        main([argv[0], "--config", path, *argv[1:]], device="cpu")
    assert isinstance(exc.value.code, str)  # exit status 1, the message on stderr
    assert "not ported yet" in exc.value.code and "ROADMAP.md" in exc.value.code
    assert item in exc.value.code


def test_module_entry_point(tmp_path):
    """``python -m montecarlo_gated_mil_tpu_torch.cli`` runs ``main``."""
    path, _ = _write_config(tmp_path, _COORDINATOR)
    proc = subprocess.run(
        [sys.executable, "-m", "montecarlo_gated_mil_tpu_torch.cli", "cv", "--config", path],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1 and "ROADMAP.md" in proc.stderr and proc.stdout == ""
