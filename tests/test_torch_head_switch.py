"""The head switch ``use_pallas`` / ``tpu.use_pallas_attention`` against the
JAX package's (CPU).

The JAX package's seven public functions that take ``use_pallas=`` take it
in the port too.  On the CPU every value runs the plain head, as the JAX
package's off a TPU: ``None``, ``True`` and ``False`` give the same result,
equal to JAX's with ``use_pallas=False`` within the bars of the files that
hold each function to JAX (the training step 1e-8 and MC validation 1e-9
relative in f64, as in tests/test_torch_train.py and test_torch_runner.py;
the MC test's accuracy and report exactly; the predictor's statistics and
attention 1e-4, as in test_torch_serve.py; the bench's record keys).  With
dropout on, the three values are equal bit for bit.  The bags are 8
instances of 64 px patches, one intra-op thread.
"""

import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from montecarlo_gated_mil_tpu.serve import MCDOPredictor as JaxPredictor
from montecarlo_gated_mil_tpu.train import criteria as jcrit
from montecarlo_gated_mil_tpu.train import loops as jloops
from montecarlo_gated_mil_tpu.train import optim as joptim
from montecarlo_gated_mil_tpu.train import state as jstate
from montecarlo_gated_mil_tpu.utils.metrics import MemorySink as JaxMemorySink
from montecarlo_gated_mil_tpu.utils.metrics import Metrics as JaxMetrics
from montecarlo_gated_mil_tpu_torch import bench
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
from montecarlo_gated_mil_tpu_torch.data.pipeline import PipelineConfig
from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
from montecarlo_gated_mil_tpu_torch.experiment import build_model
from montecarlo_gated_mil_tpu_torch.mcdo import sampling
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.ops import gated_attention as ga
from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor
from montecarlo_gated_mil_tpu_torch.train import criteria as tcrit
from montecarlo_gated_mil_tpu_torch.train import loops as tloops
from montecarlo_gated_mil_tpu_torch.train import optim as toptim
from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step
from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params
from test_torch_train import _assert_params_close, _bag_pair, _models, _plans, _x64

SWITCH = [None, True, False]
HW, N = 64, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bags(dtype, count, valid=6, seed=1):
    """``count`` (JAX bag, port bag) pairs of the same seeded patches,
    ``valid`` of N valid, labels alternating."""
    rng = np.random.default_rng(seed)
    mask = np.arange(N) < valid
    x = rng.standard_normal((count, N, HW, HW, 3)).clip(-2.2, 2.7) * mask[:, None, None, None]
    return [_bag_pair(x[i].astype(dtype), mask, i % 2) for i in range(count)]


@pytest.fixture(scope="module")
def jax_step():
    """One SGD step of the JAX package (f64, dropout 0, separate gates) with
    ``use_pallas=False``: its parameters, loss and aux loss, and the bag."""
    jplan, _ = _plans("sgd", lr=0.05)
    with _x64():
        jm, jp, _ = _models(False, np.float64, HW, n=N)
        (jbag, tbag), = _bags(np.float64, 1)
        jopt = joptim.make_optimizer(jplan)
        step = jstate.make_train_step(jm, jcrit.cross_entropy, jopt, 1, use_pallas=False)
        js, jout = step(jstate.TrainState.create(jp, jopt), jbag, jax.random.key(2),
                        jnp.asarray(True))
        return (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js.params),
                float(jout["loss"]), float(jout["aux_loss"]), tbag)


@pytest.mark.parametrize("use_pallas", SWITCH)
def test_train_step_takes_the_switch(jax_step, use_pallas):
    """``make_train_step(use_pallas=...)``: loss, aux loss and every updated
    weight equal the JAX step's within 1e-8 (f64)."""
    params, want, loss, aux, bag = jax_step
    _, tplan = _plans("sgd", lr=0.05)
    tm = MultiHeadGatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                                    shared_attention=False, dtype=torch.float64).double()
    tm.load_state_dict(from_jax_params(params))
    opt, sched = toptim.make_optimizer(tplan, tm.parameters())
    step = make_train_step(tm, tcrit.cross_entropy, opt, 1, use_pallas=use_pallas)
    _, out = step(TrainState(tm, opt, sched), bag, 2, True)
    assert abs(float(out["loss"]) - loss) < 1e-8 and abs(float(out["aux_loss"]) - aux) < 1e-8
    _assert_params_close(tm, want, atol=1e-8)


def test_train_step_switch_with_dropout_on():
    """Dropout on: the three values draw the same Philox masks and give the
    same loss and gradients bit for bit on the CPU."""
    (_, bag), = _bags(np.float32, 1, seed=3)
    got = []
    for use_pallas in SWITCH:
        tm = build_model(config_from_dict({}), seed=4)
        assert tm.feature_dropout > 0 and tm.attention_dropout > 0
        opt = torch.optim.SGD(tm.parameters(), lr=0.0)
        _, out = make_train_step(tm, tcrit.cross_entropy, opt, 1, use_pallas=use_pallas)(
            TrainState(tm, opt), bag, 5, False)
        got.append((float(out["loss"]), [p.grad.clone() for p in tm.parameters()]))
    for loss, grads in got[1:]:
        assert loss == got[0][0]
        assert all(torch.equal(a, b) for a, b in zip(grads, got[0][1]))


@pytest.fixture(scope="module")
def jax_mc_validate():
    """The JAX package's ``mc_validate`` (f64, dropout 0, T=3,
    ``use_pallas=False``) on two bags, with its parameters and the port's
    bags."""
    with _x64():
        jm, jp, _ = _models(False, np.float64, HW, n=N)
        pairs = _bags(np.float64, 2, seed=2)
        want = jloops.mc_validate(jm, jp, [(j, None) for j, _ in pairs], jcrit.cross_entropy,
                                  epoch=1, num_samples=3, key=jax.random.key(1),
                                  use_pallas=False)
        return jax.tree.map(np.asarray, jp), want, [(t, None) for _, t in pairs]


@pytest.mark.parametrize("use_pallas", SWITCH)
def test_mc_validate_takes_the_switch(jax_mc_validate, use_pallas):
    """``mc_validate(use_pallas=...)``: the loss equals JAX's within 1e-9
    relative (f64)."""
    params, want, items = jax_mc_validate
    tm = MultiHeadGatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                                    shared_attention=False, dtype=torch.float64).double()
    tm.load_state_dict(from_jax_params(params))
    got = tloops.mc_validate(tm, items, tcrit.cross_entropy, epoch=1, num_samples=3, key=1,
                             use_pallas=use_pallas)
    assert got == pytest.approx(want, rel=1e-9)


@pytest.fixture(scope="module")
def jax_mc_test():
    """The JAX package's ``mc_test`` (f32, dropout 0, T=3,
    ``use_pallas=False``) on five bags: accuracy and report, its parameters
    and the port's bags."""
    jm, jp, _ = _models(False, np.float32, HW, n=N)
    pairs = _bags(np.float32, 5, seed=5)
    want = jloops.mc_test(jm, jp, [(j, None) for j, _ in pairs], num_samples=3,
                          key=jax.random.key(4), metrics=JaxMetrics([JaxMemorySink()]),
                          use_pallas=False)
    return jax.tree.map(np.asarray, jp), want, [(t, None) for _, t in pairs]


@pytest.mark.parametrize("use_pallas", SWITCH)
def test_mc_test_takes_the_switch(jax_mc_test, use_pallas):
    """``mc_test(use_pallas=...)``: the accuracy and the report equal JAX's."""
    params, want, items = jax_mc_test
    tm = MultiHeadGatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                                    shared_attention=False)
    tm.load_state_dict(from_jax_params(params))
    sink = MemorySink()
    got = tloops.mc_test(tm, items, num_samples=3, seed=4, metrics=Metrics([sink]),
                         use_pallas=use_pallas)
    assert got[0] == want[0] and got[1] == want[1]
    assert sink.values("test/accuracy") == [got[0]]


def test_eval_loops_switch_with_dropout_on():
    """Dropout on: ``mc_validate`` and ``mc_test`` give the same loss and
    MC logits bit for bit under the three values."""
    items = [(t, None) for _, t in _bags(np.float32, 2, seed=6)]
    tm = build_model(config_from_dict({}), seed=7)
    losses = {tloops.mc_validate(tm, items, tcrit.cross_entropy, epoch=1, num_samples=3,
                                 key=2, use_pallas=u) for u in SWITCH}
    assert len(losses) == 1
    ys = [tloops._mc_test_outputs(tm, items, num_samples=3, seed=3, use_pallas=u)[2]
          for u in SWITCH]
    assert all(torch.equal(a, b) for y in ys[1:] for a, b in zip(y, ys[0]))


@pytest.mark.parametrize("quantized, use_pallas, names", [
    (False, True, ["fused-kernel"]),
    (True, False, ["int8"]),
    (True, True, ["int8 + fused-kernel"]),
])
def test_warn_float_shard_names_the_variant(quantized, use_pallas, names):
    """``warn_float_shard`` names each single-device variant that does not
    apply on the sharded path, joined as the JAX package's are (which calls
    the kernel ``fused-Pallas``)."""
    for fn in (tloops.warn_float_shard, jloops.warn_float_shard):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(quantized=quantized, use_pallas=use_pallas)
        (w,) = caught
        text = str(w.message)
        assert "mixes evaluation regimes" in text
        want = [n.replace("fused-kernel", "fused-Pallas") for n in names] \
            if fn is jloops.warn_float_shard else names
        assert all(f"the {n} single" in text for n in want), text


# test_serve.py's geometry
PIPE = dict(height=128, width=128, patch_size=64, overlap=0.0, empty_threshold=0.05, bucket=8)


@pytest.fixture(scope="module")
def jax_prediction():
    """The JAX predictor (``use_pallas=False``, dropout 0, T=4) on one
    image, with its parameters."""
    from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL

    jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=False)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0), jnp.zeros((2, 64, 64, 3)), jnp.ones(2, bool))["params"])
    jpred = JaxPredictor(jm, params, JaxPipelineConfig(**PIPE), num_samples=4,
                         use_pallas=False)
    img = synthetic_image(128, 128, positive=True, seed=1)
    return params, img, jpred.predict(img, "R", seed=3)


@pytest.mark.parametrize("use_pallas", SWITCH)
def test_predictor_takes_the_switch(jax_prediction, use_pallas):
    """``MCDOPredictor(use_pallas=...)``: statistics and attention within
    1e-4 of the JAX predictor's."""
    params, img, want = jax_prediction
    tm = MultiHeadGatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                                    shared_attention=False)
    tm.load_state_dict(from_jax_params(params))
    pred = MCDOPredictor(tm, PipelineConfig(**PIPE), num_samples=4, use_pallas=use_pallas,
                         device="cpu")
    assert pred.use_pallas is use_pallas
    got = pred.predict(img, "R", seed=3)
    assert got.num_instances == want.num_instances > 0 and got.prediction == want.prediction
    for f in ("mean_probs", "mean", "std", "median", "iqr", "low", "high", "mean_entropy"):
        np.testing.assert_allclose(np.asarray(getattr(got.stats, f)),
                                   np.asarray(getattr(want.stats, f)), atol=1e-4, err_msg=f)
    for f in ("mean", "std", "var"):
        np.testing.assert_allclose(np.asarray(getattr(got.attention, f)),
                                   np.asarray(getattr(want.attention, f)), atol=1e-4, err_msg=f)


def test_predictor_switch_with_dropout_on():
    """Dropout on: the three values give the same request bit for bit."""
    cfg = config_from_dict({})
    sd = build_model(cfg, seed=2).state_dict()
    img = synthetic_image(128, 128, positive=False, seed=2)
    got = []
    for use_pallas in SWITCH:
        tm = MultiHeadGatedAttentionMIL(feature_dropout=0.1, attention_dropout=0.1,
                                        shared_attention=False)
        tm.load_state_dict(sd)
        pred = MCDOPredictor(tm, PipelineConfig(**PIPE), num_samples=3, use_pallas=use_pallas,
                             device="cpu")
        got.append(pred.predict(img, "L", seed=11))
    for r in got[1:]:
        assert torch.equal(r.stats.mean_probs, got[0].stats.mean_probs)
        assert torch.equal(r.attention.mean, got[0].attention.mean)


@pytest.mark.parametrize("knob, want", [(True, None), (False, False)])
def test_config_maps_use_pallas_attention(knob, want):
    """``tpu.use_pallas_attention``: ``true`` gives ``None`` (the kernels on
    the card), ``false`` gives ``False``, in ``MCDOPredictor.from_config``
    (as JAX's ``serve.py`` maps it) and ``use_pallas_from``, which the
    runners pass on; a switch the caller gives wins over the config's."""
    cfg = config_from_dict({"tpu": {"buckets": [64, 128], "use_pallas_attention": knob}})
    pred = MCDOPredictor.from_config(cfg, build_model(cfg, seed=0).state_dict(), device="cpu")
    assert pred.use_pallas is want and ga.use_pallas_from(cfg) is want
    assert ga.use_pallas_from(cfg, True) is True and ga.use_pallas_from(None) is None
    assert MCDOPredictor.from_config(cfg, pred.model.state_dict(), device="cpu",
                                     use_pallas=True).use_pallas is True


SMALL = dict(bag_size=8, patch=32, num_samples=3, repeats=1)


def _spy_heads(monkeypatch, real):
    """Record the ``kernel`` flag and the predictions of every call the
    bench makes to ``mc_head`` (``real``)."""
    calls = []

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw.get("kernel", True), out.predictions.clone()))
        return out

    monkeypatch.setattr(sampling, "mc_head", spy)
    return calls


@pytest.mark.parametrize("knob", [True, False])
@pytest.mark.parametrize("use_pallas", SWITCH)
def test_run_bench_takes_the_switch(monkeypatch, use_pallas, knob):
    """``run_bench(use_pallas=...)``: ``None`` reads the config's
    ``tpu.use_pallas_attention``; the head's outputs are the same bit for
    bit either way on the CPU; the record has the JAX bench's keys."""
    monkeypatch.setattr(bench, "TRIALS", 1)
    real = sampling.mc_head
    calls = _spy_heads(monkeypatch, real)
    cfg = config_from_dict({"tpu": {"compute_dtype": "float32", "use_pallas_attention": knob}})
    rec = bench.run_bench(cfg, use_pallas=use_pallas, device="cpu", **SMALL)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    kernel = knob if use_pallas is None else use_pallas
    assert calls and all(k is kernel for k, _ in calls)
    ref = _spy_heads(monkeypatch, real)
    bench.run_bench(cfg, use_pallas=not kernel, device="cpu", **SMALL)
    assert len(ref) == len(calls) and all(k is not kernel for k, _ in ref)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(calls, ref))


@pytest.mark.parametrize("use_pallas", SWITCH)
def test_measure_train_step_ms_takes_the_switch(monkeypatch, use_pallas):
    """``measure_train_step_ms(use_pallas=...)`` reaches ``make_train_step``,
    and ``run_bench_both`` passes the switch (or the config's) on to it."""
    import montecarlo_gated_mil_tpu_torch.train.state as tstate

    seen = []
    real = tstate.make_train_step
    monkeypatch.setattr(tstate, "make_train_step",
                        lambda *a, **kw: seen.append(kw.get("use_pallas")) or real(*a, **kw))
    monkeypatch.setattr(bench, "TRAIN_STEPS", 1)
    monkeypatch.setattr(bench, "TRIALS", 1)
    ms = bench.measure_train_step_ms(bag_size=8, patch=32, use_pallas=use_pallas, device="cpu")
    assert ms > 0 and seen == [use_pallas]
    seen.clear()
    cfg = config_from_dict({"tpu": {"compute_dtype": "float32",
                                    "use_pallas_attention": use_pallas is not False}})
    bench.run_bench_both(cfg, device="cpu", **SMALL)
    assert seen == [None if use_pallas is not False else False]


def test_train_workload_losses_equal_under_the_switch():
    """The bench's training step (bf16, dropout 0.25) gives the same loss
    under the three values on the CPU."""
    losses = set()
    for use_pallas in SWITCH:
        state, step, bag = bench.train_workload(bag_size=8, patch=32, device="cpu",
                                                use_pallas=use_pallas)
        losses.add(float(step(state, bag, 1, False)[1]["loss"]))
    assert len(losses) == 1


@pytest.mark.parametrize("backbone", ["r18", "r34", "r50"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_guard_reads_the_model_it_trains(monkeypatch, backbone, dtype):
    """The training-memory guard's estimate is the table's entry for the
    backbone and compute dtype of the model the loop trains: a limit just
    above a model's estimate passes its bag, and just below it raises."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag

    model = types.SimpleNamespace(backbone=backbone, dtype=dtype)
    big = Bag(torch.zeros(64, 16, 16, 3), torch.ones(64, dtype=torch.bool), torch.tensor(1),
              torch.arange(64))
    est = tloops._train_step_bytes(big, model)
    per = tloops._TRAIN_BYTES_PER_INPUT_ELEM[(backbone, dtype)]
    assert est == big.patches.numel() * per + (1 << 29)
    state = types.SimpleNamespace(model=model)
    monkeypatch.setenv("MCGMIL_HBM_LIMIT_BYTES", str(int(est / 0.95) + 1))
    tloops.train_epoch(lambda s, *a: (s, {"loss": torch.tensor(0.0),
                                          "aux_loss": torch.tensor(0.0),
                                          "correct": torch.tensor(0.0)}),
                       state, [(big, None)], epoch=1, accumulation_steps=1, key=0,
                       shard_over=16)
    monkeypatch.setenv("MCGMIL_HBM_LIMIT_BYTES", str(int(est / 0.95) - 1))
    with pytest.raises(ValueError, match="instance-shard"):
        tloops.train_epoch(None, state, [(big, None)], epoch=1, accumulation_steps=1, key=0,
                           shard_over=16)


def test_train_peaks_skips_a_bucket_the_loops_refuse(monkeypatch):
    """``tools/measure_hbm.py::train_peaks`` runs no step for a bucket the
    training loops' guard refuses, and says so."""
    from montecarlo_gated_mil_tpu_torch.tools import measure_hbm

    monkeypatch.setenv("MCGMIL_HBM_LIMIT_BYTES", str(10 * 1024**2))
    rows = measure_hbm.train_peaks(buckets=(8,), patch=32, device="cpu")
    assert rows[8]["train"] is None and rows[8]["skipped"] == "the training loops refuse it"
    assert rows[8]["guard"] > 0.95 * 10 * 1024**2
