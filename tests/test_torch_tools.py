"""The port's measurement tools (``montecarlo_gated_mil_tpu_torch/tools``)
and quickstart on the CPU at test size: each ``main([...], device="cpu")``
prints its rows (``validate_uncertainty`` after a toy training of 2 bags
and 1 epoch, ``fuzz_dicom`` a few trials a seed in a subprocess with its
own timeout); the embed's FLOP count equals the JAX tool's closed form;
the stage splits compose to the whole embeds; and no module of the port,
nor ``chip_smoke.py``, imports JAX or the JAX package.  A slope on a busy
CPU can come out at or below 0 (the median pairwise slope of host-clock
totals), so the slope figures are held finite, not positive."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlo_gated_mil_tpu_torch.tools import (
    dicom_encoders,
    measure_fullscale,
    measure_hbm,
    measure_serving,
    measure_train,
    probe_build_phases,
    profile_embed,
    profile_int8,
    profile_int8_attrib,
    profile_train,
    validate_uncertainty,
)

ROOT = Path(__file__).resolve().parents[1]
QUICK = ["--ks", "1,2,3", "--reps", "1"]
SMALL_YAML = """\
seed: 0
N: 4
model: r18
data: {H: 128, W: 128, patch_size: 64, overlap_train: 0.25, overlap_val_test: 0.25,
       empty_threshold: 0.05, synthetic_count: 4}
tpu: {buckets: [8, 16]}
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_config(tmp_path):
    path = tmp_path / "small.yml"
    path.write_text(SMALL_YAML)
    return str(path)


def _lines(capsys) -> list[str]:
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"  # the device line comes first
    return out


def test_profile_embed_rows(capsys):
    res = profile_embed.main(["--patches", "8", "--patch", "32", *QUICK], device="cpu")
    out = _lines(capsys)
    for dtype in ("float32", "bfloat16"):
        assert set(res[dtype]["stages"]) == {"stem", "l1", "l2", "l3", "l4"}
        assert np.isfinite(res[dtype]["embed"]) and res[dtype]["splits"] == {}
    assert sum("GFLOP" in ln for ln in out) == 12 and len(res["isolated"]) == 6


def test_profile_embed_flops_equal_the_jax_closed_form():
    """r18 at N=256, 224 px: the port counts each stage's FLOP from the
    model's Conv2d modules; JAX's tool writes them in closed form from its
    ``stage_flops`` (loaded from ``tools/profile_embed.py``)."""
    spec = importlib.util.spec_from_file_location("jax_profile_embed",
                                                  ROOT / "tools" / "profile_embed.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    N, sf = jtool.N, jtool.stage_flops
    assert N == 256
    want = {
        "stem": 2 * N * 112 * 112 * 7 * 7 * 3 * 64 / 1e9,
        "l1": sf(56, 64, 64, 4),
        "l2": sf(28, 64, 128, 1) + sf(28, 128, 128, 3) + 2 * N * 28 * 28 * 64 * 128 / 1e9,
        "l3": sf(14, 128, 256, 1) + sf(14, 256, 256, 3) + 2 * N * 14 * 14 * 128 * 256 / 1e9,
        "l4": sf(7, 256, 512, 1) + sf(7, 512, 512, 3) + 2 * N * 7 * 7 * 256 * 512 / 1e9,
    }
    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone

    got = profile_embed.conv_flops(make_backbone("r18"), N, 224)
    assert {k: v / 1e9 for k, v in got.items()} == pytest.approx(want, rel=1e-12)


def _float_embed_one_loop(net, x, mask):
    """The float embed written as one loop over the model's pieces, apart
    from ``ResNetFeatures.stages`` and ``_walk``."""
    from montecarlo_gated_mil_tpu_torch.models import resnet

    norm = resnet._whole_norm(mask)
    with resnet._exact_float_convs(net.dtype):
        y = norm([net.bn1], [net._stem(x.to(net.dtype))], True)[0]
        xs = [torch.nn.functional.max_pool2d(y, kernel_size=3, stride=2, padding=1)]
        for i in range(1, net.num_stages + 1):
            for block in getattr(net, f"layer{i}"):
                xs = resnet._walk_block([block], xs, norm)
    return xs[0].to(resnet._stats_dtype(xs[0].dtype)).mean(dim=(2, 3))


def _int8_embed_one_loop(plan, x, mask, backbone):
    """The int8 embed written as one loop over its blocks, the dequant scale
    carried from block to block, apart from ``quantized_stages``."""
    from montecarlo_gated_mil_tpu_torch.ops.quantized import STAGES, _block, _stem_quant

    m = mask.to(torch.float32)
    x_q = _stem_quant(plan, x, m)
    x_scale = plan["layer1_0"]["in_scale"]
    stages, bottleneck = STAGES[backbone]
    for stage, blocks in enumerate(stages, start=1):
        for blk_i in range(blocks):
            q = plan[f"layer{stage}_{blk_i}"]
            x_q = _block(q, x_q, x_scale, m, stride=2 if stage > 1 and blk_i == 0 else 1,
                         store=plan["conv_store"], bottleneck=bottleneck,
                         last=stage == len(stages) and blk_i == blocks - 1)
            x_scale = q["out_scale"]
    return x_q


@pytest.mark.parametrize("backbone", ["r18", "r50"])
def test_stages_compose_to_the_embeds(backbone):
    """``ResNetFeatures.stages`` applied in order equals the float embed
    written as one loop, and ``quantized_stages`` the int8 embed written as
    one loop, bit for bit; so do ``forward`` and ``quantized_embed_static``."""
    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone
    from montecarlo_gated_mil_tpu_torch.ops.quantized import (
        quantize_backbone_static,
        quantized_embed_static,
        quantized_stages,
    )

    torch.manual_seed(0)
    net = make_backbone(backbone)
    x = torch.randn(6, 32, 32, 3)
    mask = torch.arange(6) < 5
    plan = quantize_backbone_static(net, backbone)
    for stages, whole, ref in (
        (net.stages(mask), net(x, mask), _float_embed_one_loop(net, x, mask)),
        (quantized_stages(plan, mask, backbone=backbone),
         quantized_embed_static(plan, x, mask, backbone=backbone),
         _int8_embed_one_loop(plan, x, mask, backbone)),
    ):
        y = x
        for _, run in stages:
            y = run(y)
        assert [s for s, _ in stages] == ["stem", "l1", "l2", "l3", "l4"]
        assert torch.equal(y, ref) and torch.equal(whole, ref)


def test_profile_train_rows(capsys):
    res = profile_train.main(["--patches", "8", "--patch", "32", "--bucket", "0", "--steps", "1",
                              *QUICK], device="cpu")
    out = _lines(capsys)
    assert set(res) == {"bench"} and set(res["bench"]) == {"kernels", "plain"}
    for row in res["bench"].values():
        assert np.isfinite(row["full"]) and set(row["phases"]) == set(profile_train.PHASES)
    assert sum(ln.startswith("bench step") for ln in out) == 2


def test_measure_train_rows(capsys):
    t = measure_train.main(["--patches", "8", "--patch", "32", *QUICK], device="cpu")
    assert np.isfinite(t) and "ms/step" in _lines(capsys)[-1]


def test_measure_fullscale_rows(capsys):
    res = measure_fullscale.main(["--height", "128", "--width", "128", "--patch", "32",
                                  "--bucket", "8", "--samples", "4", *QUICK], device="cpu")
    out = _lines(capsys)
    assert list(res) == ["float f32", "float bf16", "int8, conv_store=bf16",
                         "int8, conv_store=f8"]
    assert sum("ms/mammogram" in ln for ln in out) == 4


def test_measure_serving_rows_and_soak(capsys, small_config):
    res = measure_serving.main(["--config", small_config, "--requests", "2", "--concurrency",
                                "1,2", "--duration", "0.5"], device="cpu")
    out = _lines(capsys)
    assert res["float32 in"]["requests_per_s"] > 0 and res["uint16 in"]["p50"] > 0
    assert set(res["soak"]) == {1, 2}
    assert all(r["ok"] > 0 and r["errors"] == 0 for r in res["soak"].values())
    assert sum(ln.startswith("soak concurrency=") for ln in out) == 2


def test_measure_hbm_rows_without_peaks(capsys):
    rows = measure_hbm.main(["8", "--patch", "32"], device="cpu")
    out = _lines(capsys)
    assert rows[8]["int8"] is rows[8]["float"] is rows[8]["train"] is None
    assert rows[8]["guard"] == 8 * 32 * 32 * 3 * 192.0 + 2**29
    assert "not measured on the CPU" in out[1] and out[-1].split("|")[0].strip() == "8"


def test_profile_int8_attrib_rows(capsys):
    res = profile_int8_attrib.main(["--patches", "8", "--patch", "32", "--rounds", "1", *QUICK],
                                   device="cpu")
    out = _lines(capsys)
    assert {"total int8", "total bf16", "head", "stem conv", "l4 conv int8"} <= set(res["median"])
    assert any("stage sums" in ln for ln in out)


def test_probe_build_phases_rows(capsys, small_config):
    res = probe_build_phases.main(["--config", small_config], device="cpu")
    assert list(res) == ["config", "init", "predictor", "int8 plan", "kernel build", "warm-up"]
    assert _lines(capsys)[-1].startswith("TOTAL:")


def test_quickstart_runs_on_the_cpu(tmp_path, monkeypatch):
    """train -> CV -> re-evaluate -> figures -> serve at the quickstart's
    128x128 geometry; the figures' drawing is replaced (500 dpi costs
    seconds here; ``test_torch_viz.py`` draws them)."""
    from montecarlo_gated_mil_tpu_torch.examples import quickstart
    from montecarlo_gated_mil_tpu_torch.viz import infer

    drawn = []
    monkeypatch.setattr(infer, "plot_attention_and_density", lambda *a, **k: drawn.append(a))
    res = quickstart.main(["--device", "cpu", "--out", str(tmp_path)])
    assert len(res["manifest"]["folds"]) == 2 and np.isfinite(res["cv_eval"]["mc"]["mean"])
    assert res["serving"]["attention_map_shape"] == [2, 32, 32]
    assert 0.0 <= res["serving"]["p_cancer_mean"] <= 1.0
    assert len(drawn) == len(res["figures"]) == 2


TOY = ["--bags", "2", "--epochs", "1"]  # the acceptance's training cut to 2 bags, 1 epoch


@pytest.fixture(scope="module")
def uncertainty_run(tmp_path_factory):
    """``validate_uncertainty`` at seed 0 on a briefly trained toy model: its
    results, printed lines and figure."""
    import contextlib
    import io

    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("uncertainty") / "figure.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = validate_uncertainty.main(["--seeds", "0", "--out", str(out), *TOY], device="cpu")
    return res, buf.getvalue().splitlines(), out


def test_validate_uncertainty_writes_the_figure_and_the_criteria(uncertainty_run):
    res, out, png = uncertainty_run
    assert out[0] == "cpu" and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"figure: wrote {png}" in out
    line = next(ln for ln in out if ln.startswith("seed 0: fit accuracy"))
    assert all(name in line for name, _ in validate_uncertainty.u.CRITERIA)
    assert all(np.isfinite(v) for v in res[0]["values"]) and len(res[0]["values"]) == 5
    panels = res[0]["panels"]
    assert panels["clear"].shape == panels["ambig"].shape == (8, 3)
    assert panels["mass"].shape == panels["lesion_std"].shape == (8,)


def test_validate_uncertainty_ratios_equal_the_harness(uncertainty_run):
    """At one seed the tool's four ratios are those of
    ``evaluation/uncertainty.py`` called directly on the same training."""
    from montecarlo_gated_mil_tpu_torch.evaluation import uncertainty as u

    model, accs = u.train_toy_model(2, 1, seed=0, device="cpu")
    assert list(uncertainty_run[0][0]["accuracies"]) == accs
    assert uncertainty_run[0][0]["values"][1:] == (*u.uncertainty_ratios(model),
                                                   *u.attention_ratios(model))


def test_validate_uncertainty_seed_table_without_the_figure(capsys):
    res = validate_uncertainty.main(["--seeds", "0-1", "--no-figure", *TOY], device="cpu")
    out = _lines(capsys)
    assert list(res) == [0, 1] and "figure: not drawn (--no-figure)" in out
    assert out[-1].startswith("  all five criteria met at ") and "of 2 seeds" in out[-1]
    assert validate_uncertainty.seeds("0-2,5") == [0, 1, 2, 5]


@pytest.mark.parametrize("which", ["stem", "blocks"])
def test_profile_int8_rows_on_the_cpu(capsys, which):
    """The plain versions of K6-K8 at 4 patches of 32 px: every row a finite
    slope; the two stems agree code for code."""
    res = profile_int8.main([which, "--patches", "4", "--patch", "32", *QUICK], device="cpu")
    out = _lines(capsys)
    rows = {k: v for k, v in res[which].items() if k != "agreement"}
    assert rows and all(np.isfinite(r["slope"]) and "events" not in r for r in rows.values())
    assert sum("events not measured (CPU)" in ln for ln in out) == len(rows)
    if which == "stem":
        assert res["stem"]["agreement"] == 1.0 and len(rows) == 5
    else:
        assert set(rows) == {(s, t) for s in ("l1", "l2") for t in profile_int8.STORES}


def test_fuzz_dicom_few_trials_finds_no_fault(tmp_path):
    """A few mutations of every seed through the reader built with ASan and
    UBSan: no fault; where this host's compiler cannot link sanitizers, a
    non-zero exit that says so."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "montecarlo_gated_mil_tpu_torch.tools.fuzz_dicom",
         "--trials-per-seed", "3", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=400)
    if proc.returncode != 0:
        assert "cannot build the reader with sanitizers" in proc.stderr, proc.stderr[-2000:]
        return
    assert "12 seeds read cleanly" in proc.stdout and ", 0 faults" in proc.stdout, proc.stdout
    assert len(list((tmp_path / "seeds").glob("*.dcm"))) == 12


def _fixture_encoders():
    """The JAX package's test fixtures the encoders were copied from."""
    from tests import test_dicom_native as t

    px = np.random.default_rng(5).integers(0, 2**12, size=(24, 20), dtype=np.uint16)
    return {
        "rle": (dicom_encoders.rle_frame(px), t._rle_frame(px)),
        "jpeg_lossless": (dicom_encoders.jpeg_lossless_frame(px, 12, predictor=4, restart=7),
                          t._jpeg_lossless_frame(px, 12, predictor=4, restart=7)),
        "jpeg_ls": (dicom_encoders.jls_frame(px, 12, near=1), t._jls_frame(px, 12, near=1)),
        "jpeg_dct": (dicom_encoders.dct_frame(px, 12, restart=3)[0],
                     t._dct_frame(px, 12, restart=3)[0]),
    }


@pytest.mark.parametrize("codec", ["rle", "jpeg_lossless", "jpeg_ls", "jpeg_dct"])
def test_dicom_encoders_equal_the_jax_fixtures(codec):
    ours, theirs = _fixture_encoders()[codec]
    assert ours == theirs


@pytest.mark.parametrize("name", ["explicit", "implicit", "deflated", "rle", "jpeg_lossless",
                                  "jpeg_ls", "j2k_basic", "j2k_jp2"])
def test_fuzz_seeds_read_back_through_the_port_reader(tmp_path, name):
    """Each lossless seed ``fuzz_dicom`` writes reads back through the port's
    reader (``data/dicom_native.py``) as its pixels."""
    from PIL import features

    from montecarlo_gated_mil_tpu_torch.data.dicom_native import read_dicom_native
    from montecarlo_gated_mil_tpu_torch.tools.fuzz_dicom import make_seeds

    if name.startswith("j2k") and not features.check_codec("jpg_2000"):
        pytest.skip("Pillow lacks the OpenJPEG codec")
    seeds, _ = make_seeds(tmp_path, np.random.default_rng(0))
    px = np.random.default_rng(0).integers(0, 2**12, size=(24, 20), dtype=np.uint16)
    img, _ = read_dicom_native(next(p for p in seeds if p.stem == name))
    np.testing.assert_array_equal(np.round(img * 4095).astype(np.uint16), px)


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|montecarlo_gated_mil_tpu)\b", re.M)


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port (tools and examples included) and not
    ``chip_smoke.py`` imports JAX, its libraries or the JAX package."""
    files = sorted((ROOT / "montecarlo_gated_mil_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [str(f.relative_to(ROOT)) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad
