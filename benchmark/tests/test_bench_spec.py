"""The harness finds every piece of a cell by name, from files alone."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import guard, spec

ROOT = Path(__file__).resolve().parents[2]


def test_benchmark_json_is_valid_and_every_file_exists():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec.validate(doc)
    for w in doc["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert {m.name for m in cell.end_to_end} >= {"setup_s", "peak_gib"}
        for m in cell.per_layer:
            assert callable(spec.load_metric_reader(m.name))
            assert m.moves in {e.name for e in cell.end_to_end}
    for c in doc["configs"]:
        assert (ROOT / c["file"]).exists()


def test_config_files_state_what_the_port_runs():
    for name in ("r18-gamil", "r18-gamil-int8"):
        cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
        pc = cfg["port_config"]
        assert pc["model"] == cfg["backbone"] and pc["N"] == cfg["T"]
        assert pc["shared_att"] == cfg["shared_att"]
        assert pc["tpu"]["buckets"] == cfg["buckets"]
        assert pc["tpu"]["quantized_inference"] == (cfg["embed"] == "int8")
        assert pc["data"]["overlap_val_test"] == cfg["overlap_serve"]
        assert (pc["data"]["H"], pc["data"]["W"], pc["data"]["patch_size"]) == (
            cfg["H"], cfg["W"], cfg["patch"])


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "", "x" * 65, ".dot", "µs"])
def test_bad_names_are_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name(bad, "metric")


@pytest.mark.parametrize("bad", ["tokens per second", "", "x" * 17, "µs", "a,b"])
def test_bad_units_are_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_unit(bad, "metric")


@pytest.mark.parametrize("good", ["req/s", "%", "GiB", "bags/s", "ms"])
def test_units_in_use_pass(good):
    assert spec.check_unit(good, "metric") == good


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """Copy the benchmark, add configurations (one of them a ResNet-50), a
    traffic mix and a metric as new files plus entries, and load the new
    cells: no file that was there is edited."""
    from benchmark.reference.model import make_weights, schema

    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "r18-gamil.json").read_text())
    cfg["port_config"]["tpu"]["buckets"] = [256, 512, 1024]
    (bench / "configs" / "r18-gamil-small.json").write_text(json.dumps(cfg))
    r50 = json.loads((bench / "configs" / "r18-gamil.json").read_text())
    r50.update(backbone="r50", L=2048)
    r50["port_config"]["model"] = "r50"
    (bench / "configs" / "r50-gamil.json").write_text(json.dumps(r50))
    traffic = json.loads((bench / "traffic" / "closed4.json").read_text())
    traffic["clients"] = 2
    (bench / "traffic" / "closed2.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "requests_done.rps.py").write_text(
        "def read(ctx):\n    return float(len(ctx.requests))\n")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("r18-gamil-small", "r50-gamil"):
        doc["configs"].append({"name": name, "source": "test",
                               "file": f"benchmark/configs/{name}.json", "reduced": [],
                               "why": "test"})
    doc["workloads"].append({"name": "new-cell", "config": "r18-gamil-small",
                             "traffic": "closed2", "chips": 1, "why": "test"})
    doc["workloads"].append({"name": "r50-cell", "config": "r50-gamil",
                             "traffic": "closed4", "chips": 1, "why": "test"})
    doc["end_to_end"][0].setdefault("workloads", []).extend(["new-cell", "r50-cell"])
    doc["per_layer"].append({"name": "requests_done.rps", "unit": "req", "better": "higher",
                             "source": "program_counter", "layer": "request",
                             "moves": doc["end_to_end"][0]["name"], "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    old = spec.BENCH_DIR
    try:
        spec.BENCH_DIR = bench
        spec.validate(doc)
        cell = spec.load_cell("new-cell", tmp_path / "BENCHMARK.json")
        assert cell.traffic["clients"] == 2
        assert cell.config["port_config"]["tpu"]["buckets"] == [256, 512, 1024]
        assert [m.name for m in cell.per_layer] == ["requests_done.rps"]
        read = spec.load_metric_reader("requests_done.rps")
        assert read(type("Ctx", (), {"requests": [1, 2, 3]})()) == 3.0
        cell = spec.load_cell("r50-cell", tmp_path / "BENCHMARK.json")
        assert (cell.config["backbone"], cell.config["L"]) == ("r50", 2048)
        w = make_weights("r50", 2048, 128, 2, 2**31 + 7, "cpu")
        assert {k: tuple(v.shape) for k, v in w.items()} == schema("r50", 2048, 128, 2)
        assert w["feature_extractor.layer4.2.conv3.weight"].shape == (2048, 512, 1, 1)
        assert w["classifiers.1.weight"].shape == (1, 2048)
    finally:
        spec.BENCH_DIR = old
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("change, says", [
    ({"backbone": "r101"}, "missing file .*r101.json"),
    ({"L": 2048}, "yields 512 features, L is 2048"),
    ({"port_config": "r34"}, "port_config.model"),
    ({"backbone": "r18-broken"}, "without a downsample"),
])
def test_a_configuration_must_match_its_backbone(tmp_path, change, says):
    """``validate`` refuses a configuration whose backbone has no file,
    whose L is not the backbone's features, whose port model is another, or
    whose backbone file does not chain its channels (``r18-broken``: layer
    2's first block widens 64 to 128 channels with no downsample)."""
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    raw = json.loads((bench / "backbones" / "r18.json").read_text())
    raw["blocks"][2]["downsample"] = None
    (bench / "backbones" / "r18-broken.json").write_text(json.dumps(raw))
    cfg = json.loads((bench / "configs" / "r18-gamil.json").read_text())
    change = dict(change)
    model = change.pop("port_config", None)
    cfg.update(change)
    cfg["port_config"]["model"] = model or cfg["backbone"]
    (bench / "configs" / "r18-gamil.json").write_text(json.dumps(cfg))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    old = spec.BENCH_DIR
    try:
        spec.BENCH_DIR = bench
        with pytest.raises(spec.SpecError, match=says):
            spec.validate(doc)
    finally:
        spec.BENCH_DIR = old


@pytest.mark.parametrize("names, bad", [
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["montecarlo_gated_mil_tpu.serve"], ["montecarlo_gated_mil_tpu"]),
    (["montecarlo_gated_mil_tpu_torch.serve", "jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert guard.forbidden_loaded(names) == bad


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "r18-f32-serve-closed4", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_a_run_without_the_port_fails(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "r18-f32-serve-closed4", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
