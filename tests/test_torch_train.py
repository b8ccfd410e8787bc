"""The training slice: the port's train step, loops, optimizer, schedules,
report, checkpointer and runner against the JAX package's (CPU, plain
versions of the kernels)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core import config as jcfg
from montecarlo_gated_mil_tpu.core import rng as jrng
from montecarlo_gated_mil_tpu.core.bag import Bag as JaxBag
from montecarlo_gated_mil_tpu.evaluation.report import classification_report as jax_report
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.train import criteria as jcrit
from montecarlo_gated_mil_tpu.train import loops as jloops
from montecarlo_gated_mil_tpu.train import optim as joptim
from montecarlo_gated_mil_tpu.train import state as jstate
from montecarlo_gated_mil_tpu.utils.metrics import MemorySink as JaxMemorySink
from montecarlo_gated_mil_tpu.utils.metrics import Metrics as JaxMetrics
from montecarlo_gated_mil_tpu_torch.core import config as tcfg
from montecarlo_gated_mil_tpu_torch.core import rng as trng
from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.evaluation.report import classification_report
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.train import criteria as tcrit
from montecarlo_gated_mil_tpu_torch.train import loops as tloops
from montecarlo_gated_mil_tpu_torch.train import optim as toptim
from montecarlo_gated_mil_tpu_torch.train.state import (
    EarlyStopping,
    TrainState,
    make_train_step,
)
from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once, and oversubscribed OpenMP threads slow these many
    small CPU ops down tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(optimizer="sgd", lr=0.05, wd=0.0, k=1, sched=None):
    """The same training plan in both packages' config classes."""
    sched = sched or {}
    return tuple(
        c.TrainingPlan(
            parameters=c.TrainingParameters(lr=lr, wd=wd, grad_acc_steps=k),
            optimizer=optimizer,
            scheduler=c.SchedulerConfig(**sched),
        )
        for c in (jcfg, tcfg)
    )


def _models(shared, dtype, hw, n=8):
    """A JAX model with fresh parameters and the port's model loaded with
    the same weights (dropout 0)."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=shared, dtype=jdt)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((n, hw, hw, 3), jdt),
                              jnp.ones(n, bool))["params"]
    params = jax.tree.map(lambda a: np.asarray(a, dtype), params)
    tm = MultiHeadGatedAttentionMIL(
        feature_dropout=0.0, attention_dropout=0.0, shared_attention=shared, dtype=tdt
    ).to(tdt)
    tm.load_state_dict(from_jax_params(params))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _bag_pair(x: np.ndarray, mask: np.ndarray, label: int):
    jbag = JaxBag(patches=jnp.asarray(x), mask=jnp.asarray(mask),
                  label=jnp.asarray(label, jnp.int32), tile_indices=jnp.arange(len(mask)))
    tbag = Bag(patches=torch.from_numpy(x), mask=torch.from_numpy(mask),
               label=torch.tensor(label), tile_indices=torch.arange(len(mask)))
    return jbag, tbag


class _x64:
    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _assert_params_close(tmodel, jparams, atol, rtol=0.0):
    want = from_jax_params(jax.tree.map(np.asarray, jparams))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


@pytest.mark.parametrize("shared", [True, False])
def test_train_step_matches_jax_f64(shared):
    """One SGD step, dropout 0, r18 at 32x32, 8 instances (6 valid), f64:
    loss, aux loss and every updated weight equal the JAX step
    (``use_pallas=False``) within 1e-8."""
    rng = np.random.default_rng(1)
    mask = np.arange(8) < 6
    x = rng.standard_normal((8, 32, 32, 3)) * mask[:, None, None, None]
    jplan, tplan = _plans("sgd", lr=0.05)
    with _x64():
        jm, jp, tm = _models(shared, np.float64, 32)
        jbag, tbag = _bag_pair(x, mask, 1)
        jopt = joptim.make_optimizer(jplan)
        js, jout = jstate.make_train_step(jm, jcrit.cross_entropy, jopt, 1)(
            jstate.TrainState.create(jp, jopt), jbag, jax.random.key(2), jnp.asarray(True)
        )
        jloss, jaux = float(jout["loss"]), float(jout["aux_loss"])
    opt, sched = toptim.make_optimizer(tplan, tm.parameters())
    state, out = make_train_step(tm, tcrit.cross_entropy, opt, 1)(
        TrainState(tm, opt, sched), tbag, 2, True
    )
    assert state.step == 1 and state.acc_count == 0
    assert abs(float(out["loss"]) - jloss) < 1e-8
    assert abs(float(out["aux_loss"]) - jaux) < 1e-8
    _assert_params_close(tm, js.params, atol=1e-8)


@pytest.mark.parametrize("opt_name,lr,wd", [("adam", 1e-3, 1e-4), ("sgd", 5e-2, 1e-4)])
def test_two_epoch_trajectory_matches_jax(opt_name, lr, wd):
    """Two epochs of 3 train bags (k=2: an update after bag 2 and the
    epoch-end flush after bag 3) and 2 val bags, f64: the per-epoch train
    and val losses of the port's ``train_epoch``/``validate`` equal the JAX
    package's within rtol 1e-4, atol 1e-6 (``test_parity.py``'s bound: conv
    reduction order drifts the two by about 1e-6 relative over epochs)."""
    K, N_INST, HW = 2, 4, 32
    rng = np.random.default_rng(7)
    mask = np.ones(N_INST, bool)
    train = [(rng.standard_normal((N_INST, HW, HW, 3)), i % 2) for i in range(3)]
    val = [(rng.standard_normal((N_INST, HW, HW, 3)), (i + 1) % 2) for i in range(2)]
    jplan, tplan = _plans(opt_name, lr=lr, wd=wd, k=K)
    with _x64():
        jm, jp, tm = _models(False, np.float64, HW, n=N_INST)
        jtrain = [(_bag_pair(x, mask, y)[0], None) for x, y in train]
        jval = [(_bag_pair(x, mask, y)[0], None) for x, y in val]
        jopt = joptim.make_optimizer(jplan)
        jstep = jstate.make_train_step(jm, jcrit.cross_entropy, jopt, K)
        js = jstate.TrainState.create(jp, jopt)
        jsink = JaxMemorySink()
        want_train, want_val = [], []
        for epoch in (1, 2):
            js = jloops.train_epoch(jstep, js, jtrain, epoch=epoch, accumulation_steps=K,
                                    key=jax.random.key(0), metrics=JaxMetrics([jsink]))
            want_val.append(jloops.validate(jm, js.params, jval, jcrit.cross_entropy,
                                            epoch=epoch))
        want_train = jsink.values("train/epoch_loss")
    ttrain = [(_bag_pair(x, mask, y)[1], None) for x, y in train]
    tval = [(_bag_pair(x, mask, y)[1], None) for x, y in val]
    opt, sched = toptim.make_optimizer(tplan, tm.parameters())
    state = TrainState(tm, opt, sched)
    step = make_train_step(tm, tcrit.cross_entropy, opt, K)
    sink = MemorySink()
    got_val = []
    for epoch in (1, 2):
        state = tloops.train_epoch(step, state, ttrain, epoch=epoch, accumulation_steps=K,
                                   key=0, metrics=Metrics([sink]))
        got_val.append(tloops.validate(tm, tval, tcrit.cross_entropy, epoch=epoch))
    assert state.step == 4 and state.acc_count == 0
    np.testing.assert_allclose(sink.values("train/epoch_loss"), want_train, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_val, want_val, rtol=1e-4, atol=1e-6)
    assert [s["bucket"] for s in sink.values("train/step")] == [N_INST] * 6


SCHEDULES = [
    dict(name="step", step_size=3, gamma=0.5),
    dict(name="step", step_size=3, gamma=0.5, unit="step"),
    dict(name="cosine", step_size=3),
    dict(name="lin", step_size=3, gamma=0.1),
    dict(name="lin", step_size=2, gamma=0.1, unit="step"),
    dict(name="none"),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: "-".join(map(str, s.values())))
def test_schedules_match_optax(sched):
    """For the first 2 * step_size * steps_per_epoch updates (and past the
    end of the decay) the port's schedule equals optax's, and the
    ``LambdaLR`` hands the optimizer that rate at each update."""
    spe = 2
    jplan, tplan = _plans(lr=0.1, sched=sched)
    want = joptim.make_schedule(jplan, steps_per_epoch=spe)
    got = toptim.make_schedule(tplan, steps_per_epoch=spe)
    n = 2 * sched.get("step_size", 3) * spe + 3
    np.testing.assert_allclose([got(s) for s in range(n)], [float(want(s)) for s in range(n)],
                               rtol=1e-6)
    opt, lr_sched = toptim.make_optimizer(tplan, [torch.nn.Parameter(torch.zeros(1))], spe)
    for s in range(n):
        assert opt.param_groups[0]["lr"] == pytest.approx(got(s), rel=1e-12)
        opt.step()
        lr_sched.step()


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_optimizer_matches_optax(opt_name):
    """Weight decay as L2 in the gradient and a step schedule: six updates
    on a quadratic equal the JAX package's optax chain (f32; the JAX
    package's own tolerance against torch, 1e-5)."""
    jplan, tplan = _plans(opt_name, lr=0.1, wd=0.01,
                          sched=dict(name="step", step_size=2, gamma=0.5, unit="step"))
    w0 = np.array([1.0, -2.0, 3.0], np.float32)
    tw = torch.nn.Parameter(torch.tensor(w0))
    opt, sched = toptim.make_optimizer(tplan, [tw])
    jopt = joptim.make_optimizer(jplan)
    jw = jnp.asarray(w0)
    jst = jopt.init(jw)
    for _ in range(6):
        opt.zero_grad()
        (tw**2).sum().backward()
        opt.step()
        sched.step()
        upd, jst = jopt.update(jax.grad(lambda w: jnp.sum(w**2))(jw), jst, jw)
        jw = jw + upd
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), atol=1e-5)


def test_criteria_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 2)).astype(np.float32)
    targets = np.array([0, 1, 1, 0])
    for name in ("ce", "bce"):
        want = float(jcrit.make_criterion(name)(jnp.asarray(logits[:, 1] if name == "bce" else
                                                            logits), jnp.asarray(targets)))
        got = float(tcrit.make_criterion(name)(
            torch.from_numpy(logits[:, 1] if name == "bce" else logits), torch.from_numpy(targets)
        ))
        assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_classification_report_equals_jax(seed):
    """Text and dict equal the JAX package's (scikit-learn's), including a
    one-class set and a set with no right prediction."""
    rng = np.random.default_rng(seed)
    cases = [(rng.integers(0, 2, n).tolist(), rng.integers(0, 2, n).tolist()) for n in (1, 7, 30)]
    cases += [([0, 0, 0], [1, 1, 1]), ([1, 1], [1, 1])]
    for y, p in cases:
        want, got = jax_report(y, p), classification_report(y, p)
        assert str(got) == str(want)
        assert got.data == want.data


def test_rng_names_and_folds():
    """FNV-1a names equal the JAX package's; seeds are stable and distinct
    per stream, epoch and batch."""
    for name in ("params", "train-dropout", "mc-val", "augment"):
        assert trng.name_to_int(name) == jrng._name_to_int(name)
    s = trng.derive_seed(42, "train-dropout", 1, 0)
    assert s == trng.fold_in(trng.fold_in(trng.named_seed(42, "train-dropout"), 1), 0)
    seeds = {trng.derive_seed(42, "train-dropout", e, i) for e in range(4) for i in range(50)}
    assert len(seeds) == 200 and all(0 <= x < 2**32 for x in seeds)
    assert trng.named_seed(42, "a") != trng.named_seed(43, "a") != trng.named_seed(42, "b")
    g1, g2 = trng.generator(1, "augment", 2, 3), trng.generator(1, "augment", 2, 3)
    assert torch.equal(torch.rand(5, generator=g1), torch.rand(5, generator=g2))


def test_all_masked_bag_keeps_gradients_finite():
    """A fully padded bag (zero valid instances), dropout on: masked BN, the
    all-masked softmax and the aux loss keep every gradient finite."""
    model = MultiHeadGatedAttentionMIL(shared_attention=False)
    x = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    y, a, aux = model(x, torch.zeros(8, dtype=torch.bool), torch.tensor(1), train=True, seed=5)
    loss = tcrit.cross_entropy(y[None], torch.tensor([1])) + aux
    loss.backward()
    assert torch.isfinite(loss)
    assert torch.all(a == 0)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.all(torch.isfinite(p.grad)), name


def test_early_stopping_semantics_and_copy():
    es = EarlyStopping(patience=2)
    w = torch.nn.Linear(2, 2)
    assert not es(1.0, w)
    assert es.counter == 2 and torch.equal(es.best_params["weight"], w.weight)
    with torch.no_grad():
        w.weight.add_(1.0)
    assert not torch.equal(es.best_params["weight"], w.weight)  # a copy, not the live weight
    assert not es(1.5, w) and es.counter == 1
    assert es(1.5, w)
    es2 = EarlyStopping(patience=9)
    es2.load_state_dict(es.state_dict())
    assert es2.patience == 2 and es2.best_loss == 1.0 and es2.counter == 0


def test_training_imports_no_jax():
    """The training slice's modules pull in none of JAX, flax, optax, orbax,
    scikit-learn, pandas or the JAX package."""
    code = (
        "import sys\n"
        "import montecarlo_gated_mil_tpu_torch.runners, montecarlo_gated_mil_tpu_torch.train.loops\n"
        "import montecarlo_gated_mil_tpu_torch.train.state, montecarlo_gated_mil_tpu_torch.train.optim\n"
        "import montecarlo_gated_mil_tpu_torch.evaluation.report, montecarlo_gated_mil_tpu_torch.data.splits\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn', 'pandas', 'montecarlo_gated_mil_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_mc_test_quantized_matches_jax():
    """``mc_test`` through the int8 embed against the JAX package's at
    dropout 0 (every MC sample the same): equal accuracy and report on five
    bags of 6 valid 64x64 tiles; the float path's too."""
    jm, jp, tm = _models(False, np.float32, 64)
    rng = np.random.default_rng(2)
    jitems, titems = [], []
    for i in range(5):
        x = np.zeros((8, 64, 64, 3), np.float32)
        x[:6] = np.clip(rng.normal(0.0, 0.8, size=(6, 64, 64, 3)), -2.2, 2.7)
        jbag, tbag = _bag_pair(x, np.arange(8) < 6, i % 2)
        jitems.append((jbag, None))
        titems.append((tbag, None))
    want = jloops.mc_test(jm, jp, jitems, num_samples=3, key=jax.random.key(4),
                          metrics=JaxMetrics([JaxMemorySink()]), quantized=True)
    sink = MemorySink()
    got = tloops.mc_test(tm, titems, num_samples=3, seed=4, metrics=Metrics([sink]),
                         quantized=True)
    assert got[0] == want[0] and got[1] == want[1]
    assert sink.values("test/accuracy") == [got[0]]
    float_acc, _ = tloops.mc_test(tm, titems, num_samples=3, seed=4)
    assert abs(float_acc - got[0]) <= 0.2  # at most one of five flips
