"""Cross-validation of the port on the CPU against the JAX package's: the fold
loaders, the fold aggregates, ``run_cross_validation`` end to end with its
manifest, resume and progress files, and ``run_cv_eval`` with the fold
ensemble.

The geometry is tests/test_runners.py's (128x128 images, 64 px patches,
buckets (8, 16), 10 synthetic records, 2 folds, T=3).  Both packages run
with ``tpu.data_parallel_eval`` off: on the conftest's 8 CPU devices the JAX
package would otherwise evaluate data-parallel, a path of ROADMAP.md queue
1, item 5 that the port does not have.

Tolerances: fold splits, sampler weights and orders, the aggregates, the
fold assignment, manifest keys and metric names are compared exactly; the
per-fold MC and deterministic accuracies and the ensemble's accuracy of the
two packages' ``run_cv_eval`` on the same weights at dropout 0 are equal,
and their fold-averaged reports agree within 1e-12; a resumed CV run equals
an uninterrupted one exactly, down to the bits of the fold's best weights.
"""

import dataclasses
import inspect
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from montecarlo_gated_mil_tpu import experiment as jexp
from montecarlo_gated_mil_tpu import runners as jrun
from montecarlo_gated_mil_tpu.core.config import config_from_dict as jax_config
from montecarlo_gated_mil_tpu.evaluation import report as jreport
from montecarlo_gated_mil_tpu.parallel import distributed as jdist
from montecarlo_gated_mil_tpu.train.state import Checkpointer as JaxCheckpointer
from montecarlo_gated_mil_tpu.utils.metrics import MemorySink as JaxMemorySink
from montecarlo_gated_mil_tpu.utils.metrics import Metrics as JaxMetrics
from montecarlo_gated_mil_tpu_torch import cli
from montecarlo_gated_mil_tpu_torch import experiment as texp
from montecarlo_gated_mil_tpu_torch import runners as trun
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict, config_to_dict
from montecarlo_gated_mil_tpu_torch.evaluation import report as treport
from montecarlo_gated_mil_tpu_torch.parallel import distributed as tdist
from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer
from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

# tests/test_runners.py::_tiny_config, data-parallel evaluation off.
RAW = {
    "seed": 7,
    "model": "r18",
    "is_MCDO-val": False,
    "is_MCDO-test": True,
    "N": 3,
    "feature_dropout": 0.1,
    "attention_dropout": 0.1,
    "shared_att": True,
    "data": {
        "H": 128, "W": 128, "patch_size": 64, "overlap_train": 0.0, "overlap_val_test": 0.0,
        "empty_threshold": 0.05, "cv_folds": 2, "fraction_test": 0.3,
        "fraction_train_rest": 0.6, "fraction_val_test": 0.5, "synthetic_count": 10,
    },
    "training_plan": {
        "weighted_sampler": True, "criterion": "ce", "optimizer": "sgd",
        "parameters": {"lr": 0.001, "wd": 0.0, "epochs": 2, "patience": 3, "grad_acc_steps": 2},
    },
    "tpu": {"buckets": [8, 16], "compute_dtype": "float32", "data_parallel_eval": False},
}
# The port logs each training step's time as ``train/step`` (runners.py),
# a metric the JAX package does not have; every other name is shared.
PORT_ONLY_METRIC = "train/step"


def _raw(model_path, **over) -> dict:
    raw = json.loads(json.dumps(RAW))
    raw["model_path"] = str(model_path)
    for k, v in over.items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) else v
    os.makedirs(model_path, exist_ok=True)
    return raw


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(records) -> set:
    return {n for n, _, _ in records}


@pytest.fixture(scope="module")
def jax_cv(tmp_path_factory):
    """The JAX package's CV run: its manifest, metric names and config.  One
    epoch (the port's run takes two, for the resume test): the names and
    keys compared do not depend on the epoch count."""
    cfg = jax_config(_raw(tmp_path_factory.mktemp("jax_cv"),
                          training_plan={"parameters": {**RAW["training_plan"]["parameters"],
                                                        "epochs": 1}}))
    sink = JaxMemorySink()
    manifest = jrun.run_cross_validation(cfg, JaxMetrics([sink]))
    return cfg, manifest, _names(sink.records)


@pytest.fixture(scope="module")
def port_cv(tmp_path_factory):
    """The port's uninterrupted CV run: its config, manifest and metrics."""
    torch.set_num_threads(1)
    cfg = config_from_dict(_raw(tmp_path_factory.mktemp("port_cv")))
    sink = MemorySink()
    manifest = trun.run_cross_validation(cfg, Metrics([sink]), device="cpu")
    return cfg, manifest, sink


@pytest.mark.parametrize("weighted", [True, False])
def test_fold_loaders_equal_jax(tmp_path, weighted):
    """Each fold's train, val and test records, the train loader's sample
    weights and its epoch orders equal the JAX package's exactly; the test
    split is the same for every fold."""
    raw = _raw(tmp_path, training_plan={"weighted_sampler": weighted})
    jcfg, pcfg = jax_config(raw), config_from_dict(raw)
    tests = []
    for fold in range(2):
        j = jexp.get_fold_dataloaders(jcfg, fold)
        p = texp.get_fold_dataloaders(pcfg, fold, device="cpu")
        for part in ("train", "val", "test"):
            assert [r.paths for r in getattr(p, part).records] == [
                r.paths for r in getattr(j, part).records]
        assert p.train.sample_weights == j.train.sample_weights
        assert (p.train.sample_weights is None) == (not weighted)
        for epoch in range(3):
            np.testing.assert_array_equal(p.train._epoch_order(epoch),
                                          j.train._epoch_order(epoch))
        tests.append([r.paths for r in p.test.records])
    assert tests[0] == tests[1]


def test_fold_aggregates_equal_jax():
    """``aggregate_fold_accuracies`` (f64, ddof=0) and
    ``aggregate_classification_reports`` equal the JAX package's exactly."""
    rng = np.random.default_rng(0)
    for accs in ([], [2 / 3], [0.5, 2 / 3, 1 / 3, 0.75], rng.random(5).tolist()):
        got, want = treport.aggregate_fold_accuracies(accs), jreport.aggregate_fold_accuracies(accs)
        assert got.keys() == want.keys()
        assert got["per_fold"] == want["per_fold"]
        for k in ("mean", "std"):
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))
    reports = []
    for i in range(3):
        y = rng.integers(0, 2, 9)
        reports.append(treport.classification_report(y, np.where(rng.random(9) < 0.3, 1 - y, y)).data)
    assert treport.aggregate_classification_reports(reports) == \
        jreport.aggregate_classification_reports(reports)
    assert treport.aggregate_classification_reports([]) == {}


def test_fold_assignment_and_gather_equal_jax():
    """The round-robin fold assignment over a grid of (folds, index, count)
    and its refusals; the single-process gather passes accuracies through in
    float64."""
    for k in range(1, 7):
        for count in range(1, 5):
            for index in range(count):
                assert tdist.fold_assignment(k, index, count) == jdist.fold_assignment(
                    k, index, count)
    for index, count in ((0, 0), (-1, 2), (2, 2)):
        for mod in (tdist, jdist):
            with pytest.raises(ValueError):
                mod.fold_assignment(5, index, count)
    assert tdist.process_index() == 0 and tdist.process_count() == 1
    args = ([0, 2, 3], [2 / 3, 0.5, 1 / 3], 5)
    got = tdist.allgather_fold_accuracies(*args)
    assert got == jdist.allgather_fold_accuracies(*args) == {0: 2 / 3, 2: 0.5, 3: 1 / 3}
    assert repr(got[0]) == "0.6666666666666666"


def test_run_cross_validation_end_to_end(port_cv, jax_cv):
    """Two folds with existing checkpoints; ``cv_manifest.json`` with the JAX
    package's keys, at the top, in each fold entry and through the config;
    fold-prefixed metric names equal to JAX's; no progress file left."""
    cfg, manifest, sink = port_cv
    jcfg, jmanifest, jnames = jax_cv
    path = os.path.join(cfg.model_path, "cv_manifest.json")
    with open(path) as f:
        loaded = json.load(f)
    with open(os.path.join(jcfg.model_path, "cv_manifest.json")) as f:
        jloaded = json.load(f)
    assert loaded["folds"] == manifest["folds"]
    assert [e["fold"] for e in manifest["folds"]] == [1, 2]
    for e in manifest["folds"]:
        assert os.path.exists(e["checkpoint"]) and 0.0 <= e["accuracy"] <= 1.0
        assert os.path.basename(e["checkpoint"]).startswith(f"fold_{e['fold']}_")
    assert loaded.keys() == jloaded.keys() == manifest.keys()
    assert [e.keys() for e in loaded["folds"]] == [e.keys() for e in jloaded["folds"]]
    assert loaded["accuracy"].keys() == jloaded["accuracy"].keys()
    assert loaded["all_fold_accuracies"].keys() == jloaded["all_fold_accuracies"].keys()

    def keys(d, prefix=""):
        return {prefix + k for k in d} | {x for k, v in d.items() if isinstance(v, dict)
                                          for x in keys(v, f"{prefix}{k}.")}

    assert keys(loaded["config"]) == keys(jloaded["config"])
    names = _names(sink.records)
    assert names - {f"{k}/{PORT_ONLY_METRIC}" for k in (1, 2)} == jnames
    assert len(sink.values("1/train/epoch_loss")) == 2
    assert len(sink.values("2/val/epoch_loss")) == 2
    assert sink.values("test/accuracy_fold2") == [manifest["folds"][1]["accuracy"]]
    assert manifest["accuracy"]["per_fold"] == [e["accuracy"] for e in manifest["folds"]]
    assert not any(f.startswith("cv_progress") for f in os.listdir(cfg.model_path))


def test_run_cv_eval_equals_jax_at_dropout_zero(jax_cv, tmp_path):
    """Both packages re-evaluate the same fold weights (the JAX run's
    checkpoints, carried over by ``weights.from_jax_params``) at dropout 0:
    the per-fold MC and deterministic accuracies and the fold ensemble's
    accuracy are equal, the fold-averaged reports agree, and the result
    has the JAX package's keys."""
    jcfg, jmanifest, _ = jax_cv
    jcfg0 = dataclasses.replace(jcfg, feature_dropout=0.0, attention_dropout=0.0)
    jck = JaxCheckpointer(jcfg.model_path)
    like = jrun.init_params(jexp.build_model(jcfg), jax.random.key(0))
    pck = Checkpointer(str(tmp_path))
    folds = []
    for e in jmanifest["folds"]:
        params = jax.tree.map(np.asarray, jck.restore_params(e["checkpoint"], like))
        path = pck.save_params(f"fold_{e['fold']}_carried", from_jax_params(params))
        folds.append({**e, "checkpoint": path})
    manifest_path = tmp_path / "cv_manifest.json"
    manifest_path.write_text(json.dumps({"folds": folds}))
    pcfg0 = config_from_dict(_raw(tmp_path, feature_dropout=0.0, attention_dropout=0.0))

    want = jrun.run_cv_eval(jcfg0, None, JaxMetrics([JaxMemorySink()]), ensemble=True)
    sink = MemorySink()
    got = trun.run_cv_eval(pcfg0, None, Metrics([sink]), ensemble=True, device="cpu")
    assert got.keys() == want.keys()
    for k in ("mc", "deterministic"):
        assert got[k] == want[k]
    assert got["ensemble"] == want["ensemble"]
    for k in ("mc_report", "deterministic_report", "ensemble_report"):
        assert got[k].keys() == want[k].keys()
        for cls, v in want[k].items():
            if isinstance(v, dict):
                assert got[k][cls].keys() == v.keys()
                np.testing.assert_allclose([got[k][cls][m] for m in v], list(v.values()),
                                           rtol=0, atol=1e-12)
            else:
                assert got[k][cls] == pytest.approx(v, abs=1e-12)
    assert sink.values("ensemble_test/accuracy") == [got["ensemble"]["accuracy"]]
    assert sink.values("test/accuracy_fold1") == [got["mc"]["per_fold"][0]] * 2


def test_cv_resume_equals_uninterrupted_run(port_cv, tmp_path, capsys):
    """``cli cv --resume`` after a crash in fold 2's second epoch: fold 1's
    checkpoint and accuracy are reused, fold 2 continues from its epoch-1
    checkpoint, and the manifest equals the uninterrupted run's, fold 2's
    best weights bit for bit.  A progress entry whose checkpoint vanished is
    retrained, not trusted."""
    cfg, full, _ = port_cv
    crashed = tmp_path / "crashed"
    shutil.copytree(cfg.model_path, crashed)
    os.remove(crashed / "cv_manifest.json")
    os.remove(crashed / "fold_2" / "train_state" / "step_00000002.pt")
    progress = [full["folds"][0]]
    (crashed / "cv_progress.json").write_text(json.dumps(progress))
    yml = tmp_path / "config.yml"
    yml.write_text(json.dumps(config_to_dict(dataclasses.replace(cfg, model_path=str(crashed)))))
    assert cli.main(["cv", "--config", str(yml), "--resume"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "Resuming CV: folds [1] already done" in out
    assert "[metrics] 2/train/epoch_loss=" in out and "1/train/epoch_loss" not in out
    assert "Resumed from epoch 1 (next: 2)" in out
    resumed = json.loads((crashed / "cv_manifest.json").read_text())
    assert resumed["folds"][0] == progress[0]
    assert resumed["folds"][1]["fold"] == 2
    assert resumed["folds"][1]["checkpoint"] != full["folds"][1]["checkpoint"]
    assert [f["accuracy"] for f in resumed["folds"]] == [f["accuracy"] for f in full["folds"]]
    assert resumed["accuracy"] == full["accuracy"]
    a = torch.load(resumed["folds"][1]["checkpoint"], weights_only=True)
    b = torch.load(full["folds"][1]["checkpoint"], weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not os.path.exists(crashed / "cv_progress.json")

    (crashed / "cv_progress.json").write_text(
        json.dumps([{"fold": 1, "checkpoint": "/nope/gone", "accuracy": 0.1}]))
    again = trun.run_cross_validation(dataclasses.replace(cfg, model_path=str(crashed)),
                                      Metrics([]), resume=True, device="cpu")
    assert again["folds"][0]["checkpoint"] not in ("/nope/gone", full["folds"][0]["checkpoint"])
    assert [f["accuracy"] for f in again["folds"]] == [f["accuracy"] for f in full["folds"]]


def test_cli_cv_eval_ensemble(port_cv, capsys):
    """``cli cv-eval --ensemble`` on the uninterrupted run's manifest."""
    cfg, _, _ = port_cv
    yml = os.path.join(cfg.model_path, "eval_config.yml")
    with open(yml, "w") as f:
        json.dump(config_to_dict(cfg), f)
    assert cli.main(["cv-eval", "--config", yml, "--ensemble"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "fold 1: MC-ACC" in out and "fold 2: MC-ACC" in out
    assert "ENS-ACC (2 folds x T=3)" in out and "[metrics] ensemble_test/accuracy=" in out


def test_cv_progress_load_is_validated(tmp_path):
    """Resume survives the crash it exists for, as in the JAX package: a
    truncated progress file is skipped, entries outside the fold assignment,
    with a vanished checkpoint or malformed are dropped, per-process files
    merge with the first (sorted) file winning a duplicate, and the rewrite
    leaves no temporary file.  Both packages read each state alike."""
    ck, ck2 = tmp_path / "ck1", tmp_path / "ck2"
    ck.write_text("x")
    ck2.write_text("y")
    good = {"fold": 1, "checkpoint": str(ck), "accuracy": 0.5}
    path = str(tmp_path / "cv_progress.json")
    trun._write_cv_progress(path, [good])
    assert not os.path.exists(path + ".tmp")

    def load(folds):
        got = trun._load_cv_progress(str(tmp_path), folds)
        assert got == jrun._load_cv_progress(str(tmp_path), folds)
        return got

    assert load({0, 1}) == [good]
    with open(tmp_path / "cv_progress_p1.json", "w") as f:
        f.write('[{"fold": 2, "check')
    assert load({0, 1}) == [good]
    bad = [
        {"fold": 9, "checkpoint": str(ck), "accuracy": 0.5},
        {"fold": 2, "checkpoint": "/nope", "accuracy": 0.5},
        {"fold": "x", "checkpoint": str(ck), "accuracy": 0.5},
        {"fold": 2, "checkpoint": str(ck)},
    ]
    trun._write_cv_progress(str(tmp_path / "cv_progress_p1.json"), bad)
    assert load({0, 1, 2}) == [good]
    other = {"fold": 2, "checkpoint": str(ck2), "accuracy": 0.7}
    trun._write_cv_progress(str(tmp_path / "cv_progress_p1.json"),
                            [{"fold": 1, "checkpoint": str(ck), "accuracy": 0.9}, other])
    assert load({0, 1}) == [good, other]
    (tmp_path / "cv_progress_p2.json").write_text('{"fold": 1}')  # not a list
    assert load({0, 1}) == [good, other]


def test_load_cv_manifest_merges_per_process_files(tmp_path):
    """Per-process manifests merge in fold order, an explicit path is read
    as it is, the newer generation of single and per-process files wins,
    and duplicate folds across per-process files raise: the port and the
    JAX package return the same at each step."""
    def load(*args):
        got = trun.load_cv_manifest(str(tmp_path), *args)
        assert got == jrun.load_cv_manifest(str(tmp_path), *args)
        return got

    p0 = {"config": {"seed": 1}, "folds": [
        {"fold": 1, "checkpoint": "/tmp/f1", "accuracy": 0.5},
        {"fold": 3, "checkpoint": "/tmp/f3", "accuracy": 0.7}],
        "all_fold_accuracies": {"1": 0.5, "3": 0.7}}
    p1 = {"config": {"seed": 1}, "folds": [{"fold": 2, "checkpoint": "/tmp/f2", "accuracy": 0.6}],
          "all_fold_accuracies": {"2": 0.6}}
    (tmp_path / "cv_manifest_p0.json").write_text(json.dumps(p0))
    (tmp_path / "cv_manifest_p1.json").write_text(json.dumps(p1))
    merged = load()
    assert [e["fold"] for e in merged["folds"]] == [1, 2, 3]
    assert merged["all_fold_accuracies"] == {"1": 0.5, "2": 0.6, "3": 0.7}
    assert [e["fold"] for e in load(str(tmp_path / "cv_manifest_p1.json"))["folds"]] == [2]
    with pytest.raises(FileNotFoundError):
        trun.load_cv_manifest(str(tmp_path / "nope"))
    fresh = {"config": {"seed": 2}, "folds": [
        {"fold": 1, "checkpoint": "/tmp/new_f1", "accuracy": 0.9}],
        "all_fold_accuracies": {"1": 0.9}}
    (tmp_path / "cv_manifest.json").write_text(json.dumps(fresh))
    assert [e["checkpoint"] for e in load()["folds"]] == ["/tmp/new_f1"]
    os.utime(tmp_path / "cv_manifest.json", (1, 1))
    assert [e["fold"] for e in load()["folds"]] == [1, 2, 3]
    os.remove(tmp_path / "cv_manifest.json")
    (tmp_path / "cv_manifest_p2.json").write_text(json.dumps(p1))
    for mod in (trun, jrun):
        with pytest.raises(ValueError, match="duplicate fold"):
            mod.load_cv_manifest(str(tmp_path))


def test_entry_points_default_to_the_card():
    """CV, its re-evaluation, the fold loaders and the bench run on the card
    unless the caller passes ``device="cpu"``."""
    from montecarlo_gated_mil_tpu_torch import bench

    for fn in (trun.run_cross_validation, trun.run_cv_eval, texp.get_fold_dataloaders,
               bench.run_bench, bench.measure_train_step_ms, cli.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("flag", ["debug_nans", "debug_infs"])
def test_debug_flags_raise_on_a_poisoned_loss(tmp_path, monkeypatch, flag):
    """``tpu.debug_nans`` / ``debug_infs`` mean what the JAX ``_fit`` turns
    on: a NaN / an Inf in a step's loss raises ``FloatingPointError`` before
    the optimizer steps; with the flag off the same run goes on."""
    poison = float("nan") if flag == "debug_nans" else float("inf")

    def poisoned(logits, target):
        return torch.nn.functional.cross_entropy(logits, target) * poison

    monkeypatch.setattr(trun, "build_criterion", lambda cfg: poisoned)
    raw = _raw(tmp_path, data={"synthetic_count": 6},
               training_plan={"parameters": {"epochs": 1, "grad_acc_steps": 1}})
    on = config_from_dict({**raw, "tpu": {**raw["tpu"], flag: True}})
    model = trun.initial_model(on)
    data = texp.get_dataloaders(on, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(FloatingPointError, match=flag):
        trun._fit(on, model, data, Metrics([]))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    off = config_from_dict(raw)
    state, _ = trun._fit(off, trun.initial_model(off), data, Metrics([]))
    assert state.step > 0
