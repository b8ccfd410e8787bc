"""The port's bench (``bench.py``) on the CPU: its JSON record against the
JAX package's, in f32, bf16 and int8, through ``cli bench`` and the module
entry; and the bf16 float embed it times against the JAX package's.

The workload is cut to a bag of 8 patches at 32 px, T=3 and 3 bags a run
(the CLI's defaults are patched down to that size).  Tolerances: record keys
exactly, against the keys the JAX package's bench writes; values finite and
positive.  bf16 embed parity: per instance,
the cosine between the port's and JAX's bf16 features of the same weights
is at least 0.999 (bf16 rounds every activation to 8 bits of mantissa,
in another order in each package; f32 parity is held to 1e-4 in
tests/test_torch_resnet.py).
"""

import ast
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu import bench as jbench
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu_torch import bench, cli
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict, config_to_dict
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

SMALL = dict(bag_size=8, patch=32, num_samples=3, repeats=3)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_keys():
    """The keys of the JAX package's ``run_bench`` record and of its
    ``run_bench_both`` record, read from its source: the string keys of the
    dict ``run_bench`` returns, and those ``run_bench_both`` adds by item
    assignment.  (Its timer compiles three chained scans of the workload and
    its train step runs at the full workload only, too long for a CPU test.)"""
    tree = ast.parse(Path(jbench.__file__).read_text())
    fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    one = {k.value for node in ast.walk(fns["run_bench"])
           if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict)
           for k in node.value.keys}
    added = {t.slice.value for node in ast.walk(fns["run_bench_both"])
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant)}
    assert one == {"metric", "value", "unit", "vs_baseline"}  # the parse found them
    return one, one | added


def _check_record(rec: dict, keys: set) -> None:
    assert set(rec) == keys | {"device"}
    assert rec["device"] == "cpu" and rec["unit"] == "mammograms/sec/card"
    json.dumps(rec)  # one JSON line
    for k, v in rec.items():
        if k not in ("metric", "unit", "device"):
            assert isinstance(v, float) and math.isfinite(v) and v > 0, (k, v)


@pytest.mark.parametrize("dtype, quantized", [("float32", False), ("bfloat16", False),
                                              ("float32", True)])
def test_run_bench_record(jax_keys, dtype, quantized):
    """``run_bench`` in f32, in bf16 and through the int8 embed: the JAX
    record's keys plus ``device``, positive finite numbers, the mode named."""
    cfg = config_from_dict({"tpu": {"compute_dtype": dtype, "quantized_inference": quantized}})
    rec = bench.run_bench(cfg, device="cpu", **SMALL)
    _check_record(rec, jax_keys[0])
    assert rec["metric"] == ("MCDO inference throughput, T=3, bag=8x32px, r18, CPU"
                             + (", int8 PTQ embed" if quantized else ""))
    assert rec["vs_baseline"] == round(rec["value"] / bench.load_baseline()["bags_per_second"], 1)


def test_run_bench_both_record(jax_keys, monkeypatch):
    """No config: the int8 headline, the float (bf16) value beside it and
    the train step's ms, with the JAX record's keys plus ``device`` (one
    train step a timed run here, TRAIN_STEPS on the card)."""
    monkeypatch.setattr(bench, "TRAIN_STEPS", 1)
    rec = bench.run_bench_both(device="cpu", **SMALL)
    _check_record(rec, jax_keys[1])
    assert rec["metric"].endswith(", int8 PTQ embed")


def test_cli_bench_prints_one_json_line(tmp_path, capsys, monkeypatch):
    """``cli bench --samples 3`` on a config: one JSON line of ``run_bench``
    for that config (the workload's size patched down for the CPU)."""
    monkeypatch.setattr(bench, "run_bench",
                        functools.partial(bench.run_bench, bag_size=8, patch=32, repeats=3))
    cfg = config_from_dict({"tpu": {"compute_dtype": "bfloat16"}})
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(config_to_dict(cfg)))
    assert cli.main(["bench", "--config", str(path), "--samples", "3"], device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "MCDO inference throughput, T=3, bag=8x32px, r18, CPU"
    assert rec["device"] == "cpu" and rec["value"] > 0


def test_module_entry_needs_the_card():
    """``python -m montecarlo_gated_mil_tpu_torch.bench`` runs the full
    workload on the card; without one it fails and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the module would run the full workload")
    proc = subprocess.run([sys.executable, "-m", "montecarlo_gated_mil_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_bf16_embed_matches_jax():
    """The bf16 float embed the bench times (``value_exact_bf16``) against the
    JAX package's bf16 embed of the same weights and patches: per-instance
    feature cosine >= 0.999."""
    n, hw = 8, 64
    jm = JaxMIL(dtype=jnp.bfloat16)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, hw, hw, 3)),
                                 jnp.ones(2, bool))
    params = jax.tree.map(np.asarray, variables["params"])
    mask = np.arange(n) < 6
    x = np.random.default_rng(1).standard_normal((n, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(mask), method="embed"), np.float64)
    model = MultiHeadGatedAttentionMIL(dtype=torch.bfloat16)
    model.load_state_dict(from_jax_params(params))
    with torch.inference_mode():
        got = model.embed(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    got = got.double().numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos[mask].min() >= 0.999, cos
