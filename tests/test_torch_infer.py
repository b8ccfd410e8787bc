"""``infer`` of the port on the CPU against the JAX package's: figure
inference per fold and with the fold ensemble, the display image of a
DICOM-backed item, the five-panel figure itself and ``cli infer``.

The geometry is tests/test_runners.py's (128x128 images, 64 px patches,
buckets (8, 16), 10 synthetic records, 2 folds, T=3); the port runs the
JAX CV run's weights, carried over by ``weights.from_jax_params``.  Only
``test_figure_png_equals_jax`` renders (at 50 dpi): elsewhere both
packages' ``plot_attention_and_density`` is replaced by one that keeps what
it is handed, or writes empty files where the file list is compared.

Tolerances, at dropout 0: predictive statistics 1e-4, attention maps
5e-5 (the bar of the serving path's maps, ROADMAP.md queue 3), the display
image 1e-5; file names, sample counts and titles equal; the PNGs equal
pixel for pixel.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu import cli as jcli
from montecarlo_gated_mil_tpu import experiment as jexp
from montecarlo_gated_mil_tpu import runners as jrun
from montecarlo_gated_mil_tpu.core.config import config_from_dict as jax_config
from montecarlo_gated_mil_tpu.data.pipeline import canonicalize_image as jax_canonicalize
from montecarlo_gated_mil_tpu.mcdo.sampling import MCOutputs as JaxMCOutputs
from montecarlo_gated_mil_tpu.mcdo.sampling import predictive_stats as jax_predictive_stats
from montecarlo_gated_mil_tpu.train.state import Checkpointer as JaxCheckpointer
from montecarlo_gated_mil_tpu.utils.metrics import Metrics as JaxMetrics
from montecarlo_gated_mil_tpu.viz import figures as jfig
from montecarlo_gated_mil_tpu.viz import infer as jinfer
from montecarlo_gated_mil_tpu_torch import cli
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
from montecarlo_gated_mil_tpu_torch.data import pipeline as tpipe
from montecarlo_gated_mil_tpu_torch.data.dicom import DicomMeta
from montecarlo_gated_mil_tpu_torch.data.records import BagRecord, PixelData
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import MCOutputs, predictive_stats
from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer
from montecarlo_gated_mil_tpu_torch.viz import figures as tfig
from montecarlo_gated_mil_tpu_torch.viz import infer as tinfer
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
        "parameters": {"lr": 0.001, "wd": 0.0, "epochs": 1, "patience": 3, "grad_acc_steps": 2},
    },
    "tpu": {"buckets": [8, 16], "compute_dtype": "float32", "data_parallel_eval": False},
}
STAT_FIELDS = ("mean_probs", "prediction", "mean", "std", "median", "iqr", "low", "high",
               "mean_entropy")
MAP_ARGS = ("pos_att", "pos_std", "neg_att", "neg_std")


def _raw(model_path, **over) -> dict:
    raw = json.loads(json.dumps(RAW))
    raw["model_path"] = str(model_path)
    raw.update(over)
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


class Recorder:
    """Stands in for ``plot_attention_and_density``: keeps the host arrays,
    statistics and labels it is handed; with ``touch`` writes the two empty
    files the figure would."""

    def __init__(self, out_dir: str, touch: bool = False):
        self.out_dir, self.touch, self.calls = str(out_dir), touch, []

    def __call__(self, image, pos_att, pos_std, neg_att, neg_std, stats, *, title_class,
                 num_samples, save_path, dpi=500):
        self.calls.append(dict(
            image=np.asarray(image), pos_att=np.asarray(pos_att), pos_std=np.asarray(pos_std),
            neg_att=np.asarray(neg_att), neg_std=np.asarray(neg_std),
            stats={f: np.asarray(getattr(stats, f)) for f in STAT_FIELDS},
            title_class=title_class, num_samples=num_samples,
            name=os.path.relpath(save_path, self.out_dir),
        ))
        if self.touch:
            for ext in (".pdf", ".png"):
                open(save_path + ext, "w").close()
        return save_path


@pytest.fixture(scope="module")
def cv_runs(tmp_path_factory):
    """The JAX package's CV run (1 epoch) and the port's manifest over the
    same fold weights, carried over into the port's checkpoints."""
    torch.set_num_threads(1)
    jroot = tmp_path_factory.mktemp("jax_cv")
    raw = _raw(jroot)
    manifest = jrun.run_cross_validation(jax_config(raw), JaxMetrics([]))
    like = jrun.init_params(jexp.build_model(jax_config(raw)), jax.random.key(0))
    jck = JaxCheckpointer(str(jroot))
    proot = tmp_path_factory.mktemp("port_cv")
    pck = Checkpointer(str(proot))
    folds = []
    for e in manifest["folds"]:
        params = jax.tree.map(np.asarray, jck.restore_params(e["checkpoint"], like))
        folds.append({**e, "checkpoint": pck.save_params(f"fold_{e['fold']}_carried",
                                                         from_jax_params(params))})
    (proot / "cv_manifest.json").write_text(json.dumps({"folds": folds}))
    return raw, _raw(proot)


def _infer_both(cv_runs, tmp_path, monkeypatch, *, ensemble: bool, **over):
    """Both packages' ``run_inference`` (2 items) on the same weights;
    returns their saved paths and what each handed the figure."""
    jraw, praw = cv_runs
    jraw, praw = {**jraw, **over}, {**praw, **over}
    rec_j, rec_p = Recorder(tmp_path / "jax"), Recorder(tmp_path / "port")
    monkeypatch.setattr(jinfer, "plot_attention_and_density", rec_j)
    monkeypatch.setattr(tinfer, "plot_attention_and_density", rec_p)
    jpaths = jinfer.run_inference(jax_config(jraw), out_dir=str(tmp_path / "jax"), max_items=2,
                                  ensemble=ensemble)
    ppaths = tinfer.run_inference(config_from_dict(praw), out_dir=str(tmp_path / "port"),
                                  max_items=2, ensemble=ensemble, device="cpu")
    return (jpaths, rec_j.calls), (ppaths, rec_p.calls)


def _assert_figures_equal(got: list, want: list) -> None:
    assert [c["name"] for c in got] == [c["name"] for c in want]
    for g, w in zip(got, want, strict=True):
        assert g["title_class"] == w["title_class"] and g["num_samples"] == w["num_samples"]
        for f in STAT_FIELDS:
            np.testing.assert_allclose(g["stats"][f], w["stats"][f], rtol=0, atol=1e-4,
                                       err_msg=f)
        for a in MAP_ARGS:
            assert g[a].shape == w[a].shape == (128, 128) and g[a].dtype == np.float32
            np.testing.assert_allclose(g[a], w[a], rtol=0, atol=5e-5, err_msg=a)
        assert g["image"].shape == w["image"].shape
        np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("ensemble", [False, True])
def test_run_inference_equals_jax_at_dropout_zero(cv_runs, tmp_path, monkeypatch, ensemble):
    """Per fold (``figures_f0``, ``figures_f1``, two items each) and the
    fold ensemble (``figures_ensemble``, M*T samples): the display image,
    the four maps and the statistics handed to the figure equal JAX's, as
    do the saved paths."""
    (jpaths, want), (ppaths, got) = _infer_both(cv_runs, tmp_path, monkeypatch,
                                                ensemble=ensemble, feature_dropout=0.0,
                                                attention_dropout=0.0)
    _assert_figures_equal(got, want)
    assert [os.path.relpath(p, tmp_path / "port") for p in ppaths] == [
        os.path.relpath(p, tmp_path / "jax") for p in jpaths]
    if ensemble:
        assert [c["name"] for c in got] == ["figures_ensemble/1_" + got[0]["title_class"],
                                            "figures_ensemble/2_" + got[1]["title_class"]]
        assert {c["num_samples"] for c in got} == {2 * 3}
    else:
        assert [c["name"].split("/")[0] for c in got] == ["figures_f0"] * 2 + ["figures_f1"] * 2
        assert {c["num_samples"] for c in got} == {3}


def test_run_inference_with_dropout_is_reproducible(cv_runs, tmp_path, monkeypatch):
    """With dropout on, the port's draws are its own: shapes as at dropout
    0, the attention spread over samples nonzero, and a second run with the
    same seed hands the figure the same arrays bit for bit."""
    _, praw = cv_runs
    runs = []
    for k in range(2):
        rec = Recorder(tmp_path / f"r{k}")
        monkeypatch.setattr(tinfer, "plot_attention_and_density", rec)
        tinfer.run_inference(config_from_dict(praw), out_dir=str(tmp_path / f"r{k}"),
                             max_items=1, device="cpu")
        runs.append(rec.calls)
    assert len(runs[0]) == 2  # one item of each fold
    for a, b in zip(*runs, strict=True):
        for key in ("image", *MAP_ARGS):
            assert a[key].shape == (128, 128) and np.array_equal(a[key], b[key])
        assert all(np.array_equal(a["stats"][f], b["stats"][f]) for f in STAT_FIELDS)
        assert a["pos_std"].max() > 0 and 0.0 <= a["pos_att"].min() <= a["pos_att"].max() <= 1.0
    assert inspect.signature(tinfer.run_inference).parameters["device"].default == "cuda"


def _dicom_item(pair: bool):
    """A record, its reader's ``PixelData`` and the bag the loader would
    build from it (one 64x64 view, or a 32x64 CC+MLO pair)."""
    rng = np.random.default_rng(3)
    h = 32 if pair else 64
    views = tuple(np.where(rng.random((h, 64)) < 0.9, rng.random((h, 64)), 0).astype(np.float32)
                  for _ in range(2 if pair else 1))
    raw = PixelData(views, DicomMeta("P1", 55, "R"))
    rec = BagRecord(paths=("x_R_CC.dcm", "x_R_MLO.dcm")[: len(views)], class_name="Malignant",
                    view="Right", laterality="R")
    cfg = tpipe.PipelineConfig(height=64, width=64, patch_size=32, overlap=0.0,
                               empty_threshold=0.05, bucket=8)
    loader = tpipe.BagLoader([rec], lambda r: raw, cfg, multimodal=pair, device="cpu")
    (bag, out_rec), = list(loader.epoch(0))
    return raw, out_rec, bag, cfg.grid()


@pytest.mark.parametrize("pair", [False, True])
def test_render_item_unwraps_pixel_data(tmp_path, monkeypatch, pair):
    """A DICOM reader's ``PixelData`` reaches the figure as the image the
    bag was built from: one view, or a pair stacked MLO over CC, mirrored
    by the header's laterality; JAX's canonicalization of the same stacked
    pixels agrees within 1e-5.  JAX's ``_render_item`` unwraps only a tuple
    and fails on ``PixelData`` (ROADMAP.md queue 3)."""
    raw, rec, bag, grid = _dicom_item(pair)
    g = torch.Generator().manual_seed(0)
    att = torch.softmax(torch.randn(3, 2, 8, generator=g), -1) * bag.mask
    out = MCOutputs(predictions=torch.randn(3, 2, generator=g), attention=att)
    capture = Recorder(tmp_path)
    monkeypatch.setattr(tinfer, "plot_attention_and_density", capture)
    path = tinfer._render_item(out, bag, rec, grid, lambda r: raw, str(tmp_path), 0, 3)
    assert path == str(tmp_path / "1_Malignant")
    (call,) = capture.calls
    stacked = np.concatenate(raw.images[::-1], axis=0)  # MLO over CC
    assert rec.laterality == "R" and stacked.shape == (64, 64)
    want = np.asarray(jax_canonicalize(jnp.asarray(stacked), jnp.asarray(True), (64, 64)))
    np.testing.assert_allclose(call["image"], want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(call["image"][:, :-20], stacked[:, ::-1][:, 20:])

    monkeypatch.setattr(jinfer, "plot_attention_and_density", Recorder(tmp_path))
    jout = JaxMCOutputs(predictions=jnp.asarray(out.predictions.numpy()),
                        attention=jnp.asarray(out.attention.numpy()))
    jbag = type("JaxBag", (), {"tile_indices": jnp.asarray(bag.tile_indices.numpy()),
                               "mask": jnp.asarray(bag.mask.numpy())})
    with pytest.raises(TypeError):
        jinfer._render_item(jout, jbag, rec, grid, lambda r: raw, str(tmp_path), 0, 3)


def test_figure_png_equals_jax(tmp_path):
    """The port's and JAX's ``plot_attention_and_density`` given the same
    arrays and statistics at 50 dpi write PNGs equal pixel for pixel, and
    both write the PDF."""
    import matplotlib.image as mpimg

    rng = np.random.default_rng(2)
    arrays = [rng.random((64, 48)).astype(np.float32) * s for s in (1, 1, 0.1, 1, 0.1)]
    logits = rng.normal(size=(10, 2)).astype(np.float32)
    kw = dict(title_class="Malignant", num_samples=10, dpi=50)
    tfig.plot_attention_and_density(*arrays, predictive_stats(torch.from_numpy(logits)),
                                    save_path=str(tmp_path / "port"), **kw)
    jfig.plot_attention_and_density(*arrays, jax_predictive_stats(jnp.asarray(logits)),
                                    save_path=str(tmp_path / "jax"), **kw)
    got, want = mpimg.imread(tmp_path / "port.png"), mpimg.imread(tmp_path / "jax.png")
    assert got.shape == want.shape and got.shape[0] > 100
    assert np.array_equal(got, want)
    assert (tmp_path / "port.pdf").stat().st_size > 0 and (tmp_path / "jax.pdf").exists()


@pytest.mark.parametrize("ensemble", [False, True])
def test_cli_infer_writes_jax_file_list(cv_runs, tmp_path, monkeypatch, ensemble):
    """``cli.main(["infer", ...], device="cpu")`` writes the files the JAX
    package's ``cli infer`` writes, per fold or with ``--ensemble``."""
    jraw, praw = cv_runs
    monkeypatch.setattr(jinfer, "plot_attention_and_density", Recorder(tmp_path, touch=True))
    monkeypatch.setattr(tinfer, "plot_attention_and_density", Recorder(tmp_path, touch=True))
    flag = ["--ensemble"] if ensemble else []
    listings = []
    for name, raw, main, kw in (("jax", jraw, jcli.main, {}), ("port", praw, cli.main,
                                                               {"device": "cpu"})):
        yml = tmp_path / f"{name}.yml"
        yml.write_text(json.dumps(raw))
        out = tmp_path / f"{name}_figs"
        assert main(["infer", "--config", str(yml), "--out", str(out), "--max-items", "2",
                     *flag], **kw) == 0
        listings.append(sorted(os.path.relpath(os.path.join(d, f), out)
                               for d, _, files in os.walk(out) for f in files))
    assert listings[0] == listings[1]
    assert len(listings[1]) == (2 if ensemble else 4) * 2
    assert all(n.endswith((".pdf", ".png")) for n in listings[1])


def test_ensemble_holds_one_member_at_a_time(cv_runs, tmp_path, monkeypatch):
    """``--ensemble`` loads the members in turn into one module: the
    ensemble's samples per item are M*T and the module ends with its own
    weights."""
    _, praw = cv_runs
    seen = []
    real = tinfer.ensemble_mc_inference

    def spy(model, members, *args):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        out = real(model, members, *args)
        seen.append((len(members), tuple(out.predictions.shape),
                     all(torch.equal(before[k], v) for k, v in model.state_dict().items())))
        return out

    monkeypatch.setattr(tinfer, "ensemble_mc_inference", spy)
    monkeypatch.setattr(tinfer, "plot_attention_and_density", Recorder(tmp_path))
    tinfer.run_inference(config_from_dict(praw), out_dir=str(tmp_path), max_items=2,
                         ensemble=True, device="cpu")
    assert seen == [(2, (6, 2), True)] * 2
