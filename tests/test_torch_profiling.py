"""The port's ``utils/profiling.py`` against the JAX package's (CPU): the
phase timer and the slope arithmetic under one fake clock, the slope
timer's perturbation, the train-step chain against sequential steps and
against JAX's chain in f64, and the profiler trace."""

import glob
import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.train import criteria as jcrit
from montecarlo_gated_mil_tpu.train import state as jstate
from montecarlo_gated_mil_tpu.utils import profiling as jprof
from montecarlo_gated_mil_tpu_torch import utils as tutils
from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.train import criteria as tcrit
from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step
from montecarlo_gated_mil_tpu_torch.utils import profiling as tprof
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeClock:
    """``time.perf_counter`` stand-in: each read moves on by the next step."""

    def __init__(self, steps):
        self.t, self.steps, self.i = 100.0, list(steps), 0

    def __call__(self) -> float:
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


def test_utils_exports_the_jax_names():
    assert {"PhaseTimer", "annotate", "slope_time", "trace"} <= set(vars(tutils))
    assert tutils.PhaseTimer is tprof.PhaseTimer


def test_phase_timer_report_and_dict_equal_jax(monkeypatch):
    """The same phases under one fake clock give JAX's ``report`` text and
    ``as_dict`` keys and values."""
    out = {}
    for name, cls in (("jax", jprof.PhaseTimer), ("port", tprof.PhaseTimer)):
        monkeypatch.setattr(time, "perf_counter", _FakeClock([0.25, 0.0125, 1.5, 0.003]))
        timer = cls()
        for phase in ("embed", "head", "embed", "stats", "embed"):
            with timer.phase(phase):
                pass
        out[name] = (timer.report(), timer.as_dict(), timer.seconds("embed"),
                     timer.mean_seconds("head"))
    assert out["port"] == out["jax"]
    assert "embed: total" in out["port"][0] and set(out["port"][1]["embed"]) == {
        "total_s", "calls", "mean_ms"}


def test_phase_timer_without_a_card_reads_the_host_clock_only(monkeypatch):
    """``device=None`` and a CPU device read the clock twice a phase and
    synchronize nothing."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronized"))
    for device in (None, "cpu"):
        clock = _FakeClock([1.0])
        monkeypatch.setattr(time, "perf_counter", clock)
        timer = tprof.PhaseTimer(device=device)
        with timer.phase("a"):
            pass
        assert clock.i == 2 and timer.seconds("a") == 1.0


@pytest.mark.parametrize("ks, reps", [((2, 5, 10), 4), ((1, 3, 6), 2)])
def test_slope_of_chain_equals_jax(monkeypatch, ks, reps):
    """A fake chain whose calls take 3 ms a step plus an offset that varies
    call to call: the port's median pairwise slope is JAX's, to the bit."""
    def build_chain(clock):
        def build(k):
            def g():
                clock.t += 0.003 * k + 0.0005 * (clock.i % 3)
                return 0.0
            return g
        return build

    got = []
    for fn in (jprof.slope_of_chain, tprof.slope_of_chain):
        clock = _FakeClock([0.001, 0.0002, 0.0007])
        monkeypatch.setattr(time, "perf_counter", clock)
        got.append(fn(build_chain(clock), ks=ks, reps=reps))
    assert got[0] == got[1]
    assert 0.002 < got[1] < 0.004


def test_slope_time_perturbs_each_call():
    """The first argument of call i comes from the carry of call i-1: an
    ``fn`` whose output follows its input sees k distinct float arguments in
    a chain; an integer argument toggles its low bit every other call, a
    fresh tensor each time; the other arguments pass through untouched."""
    seen = []

    def fn(a, b):
        seen.append((a.clone(), a.data_ptr(), b))
        return a * 1e12 + b

    x = torch.zeros(3, dtype=torch.float64)
    t = tprof.slope_time(fn, x, torch.ones(3, dtype=torch.float64), ks=(1, 2, 4), reps=1)
    assert np.isfinite(t)
    last = [a for a, _, _ in seen[-4:]]  # the last chain: k = 4
    assert all(not torch.equal(last[i], last[j]) for i in range(4) for j in range(i))
    assert all(torch.equal(b, torch.ones(3, dtype=torch.float64)) for _, _, b in seen)

    seen.clear()
    xi = torch.arange(6, dtype=torch.int32)
    tprof.slope_time(fn, xi, torch.ones(6), ks=(1, 2, 4), reps=1)
    last = seen[-4:]
    assert [torch.equal(a, xi ^ (i % 2)) for i, (a, _, _) in enumerate(last)] == [True] * 4
    assert all(ptr != xi.data_ptr() for _, ptr, _ in last)


def _tiny_bag(n=8, hw=32, valid=6, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mask = np.arange(n) < valid
    x = (rng.standard_normal((n, hw, hw, 3)) * mask[:, None, None, None]).astype(dtype)
    return x, mask


def test_train_step_chain_equals_sequential_steps():
    """k=3 chained steps leave the state bitwise equal to three calls of
    the step with seeds ``seed, seed + 1, seed + 2``, each with an update."""
    x, mask = _tiny_bag()
    bag = Bag(torch.from_numpy(x), torch.from_numpy(mask), torch.tensor(1),
              torch.arange(len(mask)))
    states = []
    for _ in range(2):
        torch.manual_seed(0)
        model = MultiHeadGatedAttentionMIL(feature_dropout=0.1, attention_dropout=0.1)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        states.append((TrainState(model, opt), make_train_step(model, tcrit.cross_entropy,
                                                                opt, 1)))
    (chained, step_a), (seq, step_b) = states
    total = tprof.train_step_chain(step_a, chained, bag, 5)(3)()
    losses = [float(step_b(seq, bag, 5 + i, True)[1]["loss"]) for i in range(3)]
    assert chained.step == seq.step == 3
    assert total == pytest.approx(sum(losses), rel=1e-6)
    for (k, a), b in zip(chained.model.state_dict().items(), seq.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_step_chain_summed_loss_matches_jax_f64():
    """JAX weights, f64, dropout 0, 8 patches of 32 px, SGD: the summed loss
    of k=2 chained steps is within 1e-8 of JAX's ``train_step_chain``."""
    import optax

    x, mask = _tiny_bag(dtype=np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=False,
                    dtype=jnp.float64)
        params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((8, 32, 32, 3), jnp.float64),
                                  jnp.ones(8, bool))["params"]
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        jopt = optax.sgd(0.05)
        jstep = jstate.make_train_step(jm, jcrit.cross_entropy, jopt, 1)
        jbuild = jprof.train_step_chain(
            jstep, jstate.TrainState.create(jax.tree.map(jnp.asarray, params), jopt),
            jnp.asarray(x), jnp.asarray(mask), jnp.asarray(1, jnp.int32),
            jnp.arange(8, dtype=jnp.int32), jax.random.key(3))
        want = jbuild(2)()
    finally:
        jax.config.update("jax_enable_x64", False)
    tm = MultiHeadGatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                                    shared_attention=False, dtype=torch.float64).double()
    tm.load_state_dict(from_jax_params(params))
    opt = torch.optim.SGD(tm.parameters(), lr=0.05)
    bag = Bag(torch.from_numpy(x), torch.from_numpy(mask), torch.tensor(1), torch.arange(8))
    got = tprof.train_step_chain(make_train_step(tm, tcrit.cross_entropy, opt, 1),
                                 TrainState(tm, opt), bag, 3)(2)()
    assert abs(got - want) < 1e-8


def test_trace_holds_the_annotated_region(tmp_path):
    """``trace`` writes a Chrome trace (``*.pt.trace.json``) under its
    directory, and a region under ``annotate`` appears in it by name."""
    with tprof.trace(str(tmp_path)):
        with tutils.annotate("mcgmil-annotated-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "mcgmil-annotated-region" for e in events)


def test_card_only_readers_refuse_without_a_card():
    """The event timer and the kernel table need a card; the device line
    names the CPU."""
    assert tprof.device_line("cpu") == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for reader in (tprof.kernel_table, tprof.time_ms):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            reader(lambda: None)
