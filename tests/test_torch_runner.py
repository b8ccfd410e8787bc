"""The training runner on the CPU: ``run_training`` end to end with resume,
the checkpointer, and ``mc_validate`` against the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core.bag import Bag as JaxBag
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.train import criteria as jcrit
from montecarlo_gated_mil_tpu.train import loops as jloops
from montecarlo_gated_mil_tpu_torch.core import config as tcfg
from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.train import criteria as tcrit
from montecarlo_gated_mil_tpu_torch.train import loops as tloops
from montecarlo_gated_mil_tpu_torch.train import optim as toptim
from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer, TrainState
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


def _plan(**params):
    return tcfg.TrainingPlan(
        parameters=tcfg.TrainingParameters(**params), optimizer="adam",
        scheduler=tcfg.SchedulerConfig(name="step", step_size=1, gamma=0.5, unit="step"),
    )


def test_checkpointer_refuses_purges_and_resumes(tmp_path):
    model = torch.nn.Linear(3, 2)
    tplan = _plan(lr=0.1)
    opt, sched = toptim.make_optimizer(tplan, model.parameters())
    state = TrainState(model, opt, sched)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    sched.step()
    state.step = 1
    ck = Checkpointer(str(tmp_path / "ck"))
    best = {k: v + 5.0 for k, v in model.state_dict().items()}
    ck.save(1, state, epoch=1, early_stop={"patience": 3, "counter": 2, "best_loss": 0.5},
            best_params=best)
    with pytest.raises(RuntimeError, match="already exists"):
        ck.save(1, state, epoch=1)
    ck.save(2, state, epoch=2)
    assert ck.all_steps() == [1, 2] and ck.latest_step() == 2

    fresh = torch.nn.Linear(3, 2)
    fopt, fsched = toptim.make_optimizer(tplan, fresh.parameters())
    restored, meta, rbest = ck.restore(TrainState(fresh, fopt, fsched), step=1)
    assert meta["epoch"] == 1 and meta["early_stop"]["counter"] == 2 and meta["has_best"]
    assert restored.step == 1
    assert all(torch.equal(rbest[k], best[k]) for k in best)
    assert all(torch.equal(fresh.state_dict()[k], model.state_dict()[k]) for k in best)
    assert fopt.param_groups[0]["lr"] == opt.param_groups[0]["lr"] == 0.05
    assert torch.equal(fopt.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    assert ck.restore(TrainState(fresh, fopt, fsched))[2] is None  # step 2 saved no best

    ck.purge_steps()
    assert ck.latest_step() is None
    ck.save(1, state, epoch=1)
    path = ck.save_params("best_abc", model)
    back = ck.restore_params("best_abc")
    assert path.endswith("best_abc") and all(torch.equal(back[k], v)
                                             for k, v in model.state_dict().items())


def _tiny_cfg(tmp_path, **over):
    raw = {
        "data": {"H": 128, "W": 128, "size": [128, 128], "patch_size": 32, "synthetic_count": 6,
                 "bag_size_train": 8, "bag_size_val_test": 8},
        "training_plan": {"parameters": {"epochs": 1}},
        "tpu": {"buckets": [8, 16]},
        "model_path": str(tmp_path),
        "model_id": "best",
    }
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v} if isinstance(v, dict) else v
    return tcfg.config_from_dict(raw)


def test_run_training_saves_reloads_and_resumes(tmp_path):
    """``run_training`` on the CPU at a tiny geometry: trains, saves the best
    weights, reloads and tests them; a resumed run continues after the
    checkpointed epoch."""
    from montecarlo_gated_mil_tpu_torch.runners import run_training

    sink = MemorySink()
    r = run_training(_tiny_cfg(tmp_path), Metrics([sink]), device="cpu")
    assert 0.0 <= r["test_accuracy"] <= 1.0 and "Negative" in r["report"]
    saved = torch.load(r["best_model_path"], weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in r["best_params"].items())
    assert all(torch.equal(v, saved[k]) for k, v in r["model"].state_dict().items())
    assert len(sink.values("train/epoch_loss")) == 1
    assert Checkpointer(str(tmp_path / "train_state")).latest_step() == 1

    sink2 = MemorySink()
    run_training(_tiny_cfg(tmp_path, training_plan={"parameters": {"epochs": 2}}),
                 Metrics([sink2]), resume=True, device="cpu")
    assert [s for n, _, s in sink2.records if n == "train/epoch_loss"] == [2]


@pytest.mark.parametrize("shared", [True, False])
def test_mc_validate_matches_jax(shared):
    """MC validation (dropout 0, T=3, f64): the loss, mean over T of CE +
    aux, equals the JAX package's ``mc_validate``; the deterministic
    ``validate`` loss (CE alone) differs from it by the aux term."""
    rng = np.random.default_rng(2)
    mask = np.arange(6) < 5
    bags = [(rng.standard_normal((6, 32, 32, 3)) * mask[:, None, None, None], i % 2)
            for i in range(2)]
    jax.config.update("jax_enable_x64", True)
    try:
        jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=shared,
                    dtype=jnp.float64)
        params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((6, 32, 32, 3)),
                                  jnp.ones(6, bool))["params"]
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        jbags = [(JaxBag(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(y, jnp.int32),
                         jnp.arange(6)), None) for x, y in bags]
        want = jloops.mc_validate(jm, params, jbags, jcrit.cross_entropy, epoch=1,
                                  num_samples=3, key=jax.random.key(1))
    finally:
        jax.config.update("jax_enable_x64", False)
    tm = MultiHeadGatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                                    shared_attention=shared, dtype=torch.float64).double()
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    tbags = [(Bag(torch.from_numpy(x), torch.from_numpy(mask), torch.tensor(y),
                  torch.arange(6)), None) for x, y in bags]
    sink = MemorySink()
    got = tloops.mc_validate(tm, tbags, tcrit.cross_entropy, epoch=1, num_samples=3, key=1,
                             metrics=Metrics([sink]))
    assert got == pytest.approx(want, rel=1e-9)
    ce = tloops.validate(tm, tbags, tcrit.cross_entropy, epoch=1)
    assert got == pytest.approx(ce + sink.values("val/aux_loss")[0], rel=1e-9)


def test_initial_model_loads_backbone_weights(tmp_path):
    """``cfg.backbone_weights``: a torchvision-named state_dict under the
    reference's ``feature_extractor.`` prefix, running statistics and all,
    initializes the backbone; the heads keep their seeded init."""
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.runners import initial_model

    src = build_model(tcfg.Config(), seed=123).feature_extractor.state_dict()
    sd = {f"feature_extractor.{k}": v for k, v in src.items()}
    sd["feature_extractor.bn1.running_mean"] = torch.zeros(64)
    sd["fc.weight"] = torch.zeros(1000, 512)
    path = tmp_path / "backbone.pth"
    torch.save(sd, path)
    model = initial_model(tcfg.Config(backbone_weights=str(path)))
    plain = initial_model(tcfg.Config())
    got = model.feature_extractor.state_dict()
    assert all(torch.equal(got[k], v) for k, v in src.items())
    assert torch.equal(model.classifiers[0].weight, plain.classifiers[0].weight)
