"""The training half of the port's parallel paths against the JAX package's
and against the port's sequential training (CPU), and the asynchronous
checkpointer.

A mesh of repeated ``torch.device("cpu")`` entries stands in for several
devices, as in ``test_torch_parallel.py``.  Tolerances:
- the data-parallel epoch against the sequential one (one update at epoch
  end, dropout on): 2e-5 in f32 (JAX's ``test_parallel.py`` bar), 1e-10 in
  f64; only the order of the gradient sums differs;
- the data-parallel step and epoch against JAX's, dropout 0, f64: 1e-8, the
  port's train-step bar against JAX (``test_torch_train.py``);
- the instance-sharded step against the whole-bag step, dropout on: loss and
  gradients within 1e-10 in f64 at 32 px; in f32 at 64 px, loss rtol 1e-4,
  gradients rtol 2e-3 / atol 2e-5 (JAX's ``test_oversized.py`` bar); against
  JAX's sharded step, dropout 0, shared gates, f32 at 64 px: the same bar;
- the sharded embed's gradients against the whole embed's, f64: 1e-10.
JAX's sharded head takes shared gates only, so its comparisons use them.
"""

import copy
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core.bag import Bag as JaxBag
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.parallel import dp as jdp
from montecarlo_gated_mil_tpu.parallel.mesh import make_mesh as jax_make_mesh
from montecarlo_gated_mil_tpu.train import criteria as jcrit
from montecarlo_gated_mil_tpu.train import loops as jloops
from montecarlo_gated_mil_tpu.train import state as jstate
from montecarlo_gated_mil_tpu_torch.core import config as tcfg
from montecarlo_gated_mil_tpu_torch.core.bag import Bag, stack_bags
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.parallel import make_dp_train_step, make_mesh, shard_batch
from montecarlo_gated_mil_tpu_torch.parallel import sharded_embed_grad
from montecarlo_gated_mil_tpu_torch.parallel.dp import pad_group_to_batch
from montecarlo_gated_mil_tpu_torch.train import loops, state as tstate
from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy
from montecarlo_gated_mil_tpu_torch.train.state import (
    Checkpointer,
    TrainState,
    make_train_step,
    make_train_step_sharded,
)
from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

CPU = torch.device("cpu")
LR = 0.05


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(data: int = 1, inst: int = 1):
    return make_mesh(data=data, inst=inst, devices=[CPU] * (data * inst))


def _model(shared: bool, dtype=torch.float32, p: float = 0.1, seed: int = 0):
    torch.manual_seed(seed)
    return MultiHeadGatedAttentionMIL(feature_dropout=p, attention_dropout=p,
                                      shared_attention=shared, dtype=dtype).to(dtype)


def _bag(n: int, hw: int, n_valid: int, label: int, seed: int, dtype=np.float32) -> Bag:
    g = np.random.default_rng(seed)
    mask = np.arange(n) < n_valid
    x = (g.standard_normal((n, hw, hw, 3)) * mask[:, None, None, None]).astype(dtype)
    return Bag(torch.from_numpy(x), torch.from_numpy(mask), torch.tensor(label),
               torch.from_numpy(np.where(mask, np.arange(n), 0)))


def _jax_bag(bag: Bag) -> JaxBag:
    return JaxBag(jnp.asarray(bag.patches.numpy()), jnp.asarray(bag.mask.numpy()),
                  jnp.asarray(int(bag.label), jnp.int32), jnp.asarray(bag.tile_indices.numpy()))


def _trainer(model):
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    return opt, TrainState(model, opt)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_params_close(tmodel, jparams, atol, rtol=0.0):
    want = from_jax_params(jax.tree.map(np.asarray, jparams))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


class _x64:
    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


# -------------------------------------------------------- the data-parallel step


@pytest.fixture(scope="module")
def dp_jax():
    """JAX's data-parallel step on a ``data`` mesh of 2, dropout 0, f64,
    r18 at 32 px: one padded group held then flushed by ``apply_pending``,
    and ``train_epoch_dp`` over three bags with k=3.  Returns the initial
    parameters, the bags and JAX's results."""
    bags = [_bag(8, 32, 6 + i % 2, i % 2, seed=20 + i, dtype=np.float64) for i in range(3)]
    with _x64():
        jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, dtype=jnp.float64)
        params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((8, 32, 32, 3), jnp.float64),
                                  jnp.ones(8, bool))["params"]
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        opt = optax.sgd(LR)
        mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
        step, apply_pending = jdp.make_dp_train_step(jm, jcrit.cross_entropy, opt, mesh,
                                                     donate=False)
        fresh = lambda: jstate.TrainState.create(jax.tree.map(jnp.asarray, params), opt)  # noqa: E731
        sharded, keys, n_real = jdp.pad_group_to_batch(
            mesh, [_jax_bag(bags[0])], [jax.random.key(1)])
        held, out = step(fresh(), sharded, keys, jnp.asarray([1.0, 0.0]), jnp.asarray(False))
        hold = {"acc_count": int(held.acc_count), "step": int(held.step),
                "loss": float(out["loss_sum"]) / float(out["count"]),
                "count": float(out["count"])}
        applied = apply_pending(held)
        hold["applied_step"] = int(applied.step)
        hold["applied"] = jax.tree.map(np.asarray, applied.params)
        epoch = jloops.train_epoch_dp(step, apply_pending, fresh(),
                                      [(_jax_bag(b), None) for b in bags], mesh, epoch=1,
                                      accumulation_steps=3, key=jax.random.key(5))
        return params, bags, hold, int(epoch.step), jax.tree.map(np.asarray, epoch.params)


def _port_f64(params):
    tm = _model(True, torch.float64, p=0.0)
    tm.load_state_dict(from_jax_params(params))
    return tm


def test_dp_step_accumulates_then_applies_pending_as_jax(dp_jax):
    """A group of one real bag and one padding slot (weight 0) held, then
    flushed by ``apply_pending``: the loss, count, ``acc_count`` and step as
    JAX's, the weights unchanged while held, and the applied weights within
    1e-8 (``test_parallel.py:40,74``)."""
    params, bags, want, _, _ = dp_jax
    tm = _port_f64(params)
    before = _params(tm)
    opt, state = _trainer(tm)
    mesh = cpu_mesh(data=2)
    step, apply_pending = make_dp_train_step(tm, cross_entropy, opt, mesh)
    shards, seeds, n_real = pad_group_to_batch(mesh, [bags[0]], [1])
    assert n_real == 1 and len(shards) == 2
    state, out = step(state, shards, seeds, [1.0, 0.0], False)
    assert state.acc_count == want["acc_count"] == 1 and state.step == want["step"] == 0
    assert float(out["count"]) == want["count"] == 1.0
    assert abs(float(out["loss_sum"]) / float(out["count"]) - want["loss"]) < 1e-8
    assert _max_diff(_params(tm), before) == 0.0
    state = apply_pending(state)
    assert state.step == want["applied_step"] == 1 and state.acc_count == 0
    _assert_params_close(tm, want["applied"], atol=1e-8)
    assert apply_pending(state).step == 1  # nothing pending: a no-op


def test_train_epoch_dp_matches_jax_f64(dp_jax):
    """``train_epoch_dp`` over three bags on a data mesh of 2 (a full group,
    then a padded partial one), k=3, dropout 0, f64: the weights equal
    JAX's ``train_epoch_dp`` within 1e-8."""
    params, bags, _, jsteps, jparams = dp_jax
    tm = _port_f64(params)
    opt, state = _trainer(tm)
    mesh = cpu_mesh(data=2)
    step, apply_pending = make_dp_train_step(tm, cross_entropy, opt, mesh)
    state = loops.train_epoch_dp(step, apply_pending, state, [(b, None) for b in bags], mesh,
                                 epoch=1, accumulation_steps=3, key=5)
    assert state.step == jsteps == 1
    _assert_params_close(tm, jparams, atol=1e-8)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("n_bags", [3, 4])
def test_train_epoch_dp_equals_sequential_with_dropout(dtype, atol, n_bags):
    """With k equal to the number of bags (one update, at epoch end) the
    data-parallel epoch on a data mesh of 2 applies the sequential epoch's
    gradient, dropout on: bag ``i`` draws the same seed in both.  3 bags: a
    padded partial group; 4: full groups.  Per-epoch metrics agree too."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    items = [(_bag(8, 32, 5 + i % 3, i % 2, seed=40 + i, dtype=npdt), None)
             for i in range(n_bags)]
    base = _model(False, dtype)
    seq, dp = copy.deepcopy(base), copy.deepcopy(base)
    opt, state = _trainer(seq)
    sinks = MemorySink(), MemorySink()
    state = loops.train_epoch(make_train_step(seq, cross_entropy, opt, n_bags), state, items,
                              epoch=2, accumulation_steps=n_bags, key=9,
                              metrics=Metrics([sinks[0]]))
    opt2, state2 = _trainer(dp)
    mesh = cpu_mesh(data=2)
    step, apply_pending = make_dp_train_step(dp, cross_entropy, opt2, mesh)
    state2 = loops.train_epoch_dp(step, apply_pending, state2, items, mesh, epoch=2,
                                  accumulation_steps=n_bags, key=9, metrics=Metrics([sinks[1]]))
    assert state.step == state2.step == 1 and state2.acc_count == 0
    assert _max_diff(_params(seq), _params(dp)) <= atol
    assert _max_diff(_params(seq), _params(base)) > 1e-4  # the update happened
    for name in ("train/epoch_loss", "train/epoch_acc", "train/aux_loss"):
        assert sinks[0].values(name) == pytest.approx(sinks[1].values(name), rel=1e-6)


# -------------------------------------------------------- the instance-sharded step


@pytest.fixture(scope="module")
def whole_steps():
    """The whole-bag step's loss and gradients (k=2, no update) for one bag
    of 8 instances, 7 valid, dropout on, computed once per (gates, dtype,
    size)."""
    cache = {}

    def get(shared: bool, dtype, hw: int):
        key = (shared, dtype, hw)
        if key not in cache:
            npdt = np.float32 if dtype == torch.float32 else np.float64
            bag = _bag(8, hw, 7, 1, seed=3, dtype=npdt)
            model = _model(shared, dtype)
            base = _params(model)
            opt, state = _trainer(model)
            _, out = make_train_step(model, cross_entropy, opt, 2)(state, bag, 11, False)
            grads = {k: q.grad.clone() for k, q in model.named_parameters()}
            cache[key] = (bag, base, float(out["loss"]), grads)
        return cache[key]

    return get


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("mean_scaling", [False, True])
@pytest.mark.parametrize("inst", [2, 4])
@pytest.mark.parametrize("dtype,hw", [(torch.float64, 32), (torch.float32, 64)])
def test_sharded_step_equals_whole_bag_step(whole_steps, shared, mean_scaling, inst, dtype,
                                            hw):
    """One bag of 8 instances (7 valid), dropout on, k=2: the instance-
    sharded step's loss equals the whole-bag step's and its gradients are
    the whole-bag step's ``loss / k`` gradients (``mean_scaling=False``) or
    the raw ones (``True``)."""
    bag, base, loss, grads = whole_steps(shared, dtype, hw)
    model = _model(shared, dtype)
    model.load_state_dict(base)
    opt, state = _trainer(model)
    step = make_train_step_sharded(model, cross_entropy, opt, 2, cpu_mesh(inst=inst),
                                   mean_scaling=mean_scaling)
    state, out = step(state, bag, 11, False)
    assert state.acc_count == 1 and state.step == 0
    scale = 2.0 if mean_scaling else 1.0
    got = {k: q.grad for k, q in model.named_parameters()}
    if dtype == torch.float64:
        assert abs(float(out["loss"]) - loss) < 1e-10
        assert max(float((got[k] - scale * grads[k]).abs().max()) for k in grads) < 1e-10
    else:
        np.testing.assert_allclose(float(out["loss"]), loss, rtol=1e-4)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), scale * grads[k].numpy(), rtol=2e-3,
                                       atol=2e-5, err_msg=k)


def test_sharded_step_matches_jax():
    """An oversized bag's sharded step in both packages (inst 2, k=1, one
    SGD update at ``test_oversized.py:467``'s learning rate 1e-2), dropout
    0, shared gates, f32 at 64 px: loss rtol 1e-4, updated weights rtol
    2e-3 / atol 2e-5.  (The port's whole-bag step sits as far from JAX's:
    the two packages' f32 embeds differ by their rounding, which a BN over
    seven instances amplifies.)"""
    lr = 1e-2
    jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((8, 64, 64, 3)),
                              jnp.ones(8, bool))["params"]
    bag = _bag(8, 64, 7, 1, seed=4)
    opt = optax.sgd(lr)
    mesh = jax_make_mesh(data=1, inst=2, devices=jax.devices()[:2])
    jstep = jstate.make_train_step_sharded(jm, jcrit.cross_entropy, opt, 1, mesh)
    jst, jout = jstep(jstate.TrainState.create(params, opt), _jax_bag(bag), jax.random.key(1),
                      jnp.asarray(True))
    tm = _model(True, p=0.0)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    topt = torch.optim.SGD(tm.parameters(), lr=lr)
    state = TrainState(tm, topt)
    state, out = make_train_step_sharded(tm, cross_entropy, topt, 1, cpu_mesh(inst=2))(
        state, bag, 1, True)
    assert state.step == int(jst.step) == 1
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-4)
    _assert_params_close(tm, jst.params, atol=2e-5, rtol=2e-3)


@pytest.mark.parametrize("distinct", [False, True])
def test_sharded_embed_grad_equals_whole_embed(distinct):
    """The sharded embed's weight gradients (inst 4, f64, 32 px) equal the
    whole embed's within 1e-10, whether the shards share the model or run on
    copies of it; the copies' gradients are summed into the model's."""
    model = _model(False, torch.float64)
    bag = _bag(8, 32, 6, 0, seed=5, dtype=np.float64)
    r = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 512)))
    (model.embed(bag.patches, bag.mask) * r).sum().backward()
    want = {k: q.grad.clone() for k, q in model.feature_extractor.named_parameters()}
    model.zero_grad(set_to_none=True)
    mesh = cpu_mesh(inst=4)
    replicas = [copy.deepcopy(model) for _ in range(4)] if distinct else None
    H = sharded_embed_grad(model, bag.patches, bag.mask, mesh, replicas=replicas)
    (H * r).sum().backward()
    got = {k: q.grad for k, q in model.feature_extractor.named_parameters()}
    assert max(float((got[k] - want[k]).abs().max()) for k in want) < 1e-10
    if distinct:
        assert all(q.grad is None for q in replicas[1].parameters())


def _two_updates(kind: str, replicas):
    """Two SGD updates of the dp step (data 2) or the sharded step (inst 2)
    on one model, with ``replicas`` as given (None: the model itself)."""
    model = _model(False, seed=7)
    opt, state = _trainer(model)
    bags = [_bag(8, 32, 6, i % 2, seed=60 + i) for i in range(2)]
    if kind == "dp":
        mesh = cpu_mesh(data=2)
        step, _ = make_dp_train_step(model, cross_entropy, opt, mesh,
                                     replicas=replicas and replicas(model))
        for i in range(2):
            state, _ = step(state, shard_batch(mesh, stack_bags(bags)), [2 * i, 2 * i + 1],
                            [1.0, 1.0], True)
    else:
        step = make_train_step_sharded(model, cross_entropy, opt, 1, cpu_mesh(inst=2),
                                       replicas=replicas and replicas(model))
        for i in range(2):
            state, _ = step(state, bags[i], i, True)
    assert state.step == 2
    return _params(model)


@pytest.mark.parametrize("kind", ["dp", "sharded"])
def test_distinct_replicas_take_every_update(kind):
    """Replicas that are copies of the model (as on distinct cards) take its
    weights before every step: two updates through deep-copied replicas end
    where the shared-module run ends."""
    shared = _two_updates(kind, None)
    copies = _two_updates(kind, lambda m: [copy.deepcopy(m) for _ in range(2)])
    assert _max_diff(shared, copies) < 1e-7


# ------------------------------------------------------------ oversized routing


@pytest.mark.parametrize("loop", ["train_epoch", "train_epoch_dp"])
def test_training_loops_route_oversized_bags(loop):
    """A mixed stream (bucket 16, an oversized 64, bucket 16) with
    ``shard_over=16`` and a mesh of 8: only the oversized bag takes the
    sharded step (``test_oversized.py:560,613``), the others the one-bag or
    the data-parallel step, on one accumulator.  With k=3 (one update at
    epoch end), f64 and dropout on, both loops end where the sequential
    epoch that runs every bag whole ends (1e-10)."""
    items = [(_bag(16, 16, 12, 0, seed=9, dtype=np.float64), None),
             (_bag(64, 16, 49, 1, seed=5, dtype=np.float64), None),
             (_bag(16, 16, 11, 1, seed=7, dtype=np.float64), None)]
    base = _model(True, torch.float64)
    ref = copy.deepcopy(base)
    opt, state = _trainer(ref)
    loops.train_epoch(make_train_step(ref, cross_entropy, opt, 3), state, items, epoch=1,
                      accumulation_steps=3, key=4)

    model = copy.deepcopy(base)
    opt, state = _trainer(model)
    mesh = cpu_mesh(data=8)
    sharded = make_train_step_sharded(model, cross_entropy, opt, 3, mesh.flat("inst"),
                                      mean_scaling=loop == "train_epoch_dp")
    routed = []

    def spy(state, bag, seed, do_update):
        routed.append(bag.bucket)
        return sharded(state, bag, seed, do_update)

    if loop == "train_epoch":
        state = loops.train_epoch(make_train_step(model, cross_entropy, opt, 3), state, items,
                                  epoch=1, accumulation_steps=3, key=4, sharded_step_fn=spy,
                                  shard_over=16, mesh=mesh)
    else:
        step, apply_pending = make_dp_train_step(model, cross_entropy, opt, mesh)
        state = loops.train_epoch_dp(step, apply_pending, state, items, mesh, epoch=1,
                                     accumulation_steps=3, key=4, sharded_step_fn=spy,
                                     shard_over=16)
    assert routed == [64] and state.step == 1
    assert _max_diff(_params(model), _params(ref)) < 1e-10


def test_unrouted_oversized_train_bag_guard(monkeypatch):
    """``_check_unrouted_train_bag`` (``test_oversized.py:674``): silent on
    the CPU with no limit set; with ``MCGMIL_HBM_LIMIT_BYTES`` below the card
    estimate of a bag it raises saying what to do -- for an oversized bag
    that could not instance-shard, and for one within the buckets or with
    routing off, whose whole-bag step would not fit either -- and above it
    not."""
    big = _bag(64, 16, 49, 1, seed=5)
    monkeypatch.delenv("MCGMIL_HBM_LIMIT_BYTES", raising=False)
    for shard_over in (None, 64, 16):
        loops._check_unrouted_train_bag(big, shard_over)
    est = loops._train_step_bytes(big)  # no model: the table's largest entry
    assert est == big.patches.numel() * max(loops._TRAIN_BYTES_PER_INPUT_ELEM.values()) + (1 << 29)
    monkeypatch.setenv("MCGMIL_HBM_LIMIT_BYTES", str(int(est / 0.95) - 1))
    with pytest.raises(ValueError, match="instance-shard.*truncate"):
        loops._check_unrouted_train_bag(big, 16)
    for shard_over in (None, 64):
        with pytest.raises(ValueError, match="whole-bag step does not fit.*tpu.buckets.*truncate"):
            loops._check_unrouted_train_bag(big, shard_over)
    monkeypatch.setenv("MCGMIL_HBM_LIMIT_BYTES", str(int(est / 0.95) + 1))
    for shard_over in (None, 64, 16):
        loops._check_unrouted_train_bag(big, shard_over)


@pytest.mark.parametrize("loop", ["train_epoch", "train_epoch_dp"])
def test_training_loops_raise_before_an_in_range_bag_that_would_not_fit(monkeypatch, loop):
    """A bag within the buckets trains whole, so the guard holds it too: with
    a limit that an r18 f32 step of the bag fits and an r50 f32 one does not
    (the table's entries), both loops train the r18 bag and raise before
    any step of the r50 one, naming the backbone and dtype."""
    import types

    bag = _bag(16, 16, 12, 1, seed=5)
    r18, r50 = (types.SimpleNamespace(backbone=b, dtype=torch.float32) for b in ("r18", "r50"))
    limit = (loops._train_step_bytes(bag, r18) + loops._train_step_bytes(bag, r50)) / 2 / 0.95
    assert loops._train_step_bytes(bag, r18) < 0.95 * limit < loops._train_step_bytes(bag, r50)
    monkeypatch.setenv("MCGMIL_HBM_LIMIT_BYTES", str(int(limit)))
    out = {"loss": torch.tensor(0.0), "aux_loss": torch.tensor(0.0),
           "correct": torch.tensor(0.0)}
    calls = []

    def step(state, *args):
        calls.append(state.model.backbone)
        return state, out

    def dp_step(state, *args):
        calls.append(state.model.backbone)
        return state, {"loss_sum": out["loss"], "aux_sum": out["aux_loss"],
                       "correct_sum": out["correct"], "count": 1}

    def run(model):
        state = types.SimpleNamespace(model=model)
        if loop == "train_epoch":
            loops.train_epoch(step, state, [(bag, None)], epoch=1, accumulation_steps=1, key=0,
                              shard_over=64)
        else:
            loops.train_epoch_dp(dp_step, lambda s: s, state, [(bag, None)], cpu_mesh(data=1),
                                 epoch=1, accumulation_steps=1, key=0, shard_over=64)

    run(r18)
    assert calls == ["r18"]
    with pytest.raises(ValueError, match="whole-bag step of r50 in float32 does not fit"):
        run(r50)
    assert calls == ["r18"]


@pytest.mark.parametrize("loop", ["train_epoch", "train_epoch_dp"])
def test_training_loops_raise_before_an_unrouted_oversized_bag(monkeypatch, loop):
    """With no sharded step and a limit the bag does not fit, both loops
    raise before any step runs (``test_oversized.py:693``)."""
    monkeypatch.setenv("MCGMIL_HBM_LIMIT_BYTES", str(10 * 1024**2))
    calls = []

    def step(*args):
        calls.append(args)
        raise AssertionError("the step ran")

    items = [(_bag(64, 16, 49, 1, seed=5), None)]
    with pytest.raises(ValueError, match="oversized training bag"):
        if loop == "train_epoch":
            loops.train_epoch(step, None, items, epoch=1, accumulation_steps=1, key=0,
                              shard_over=16)
        else:
            loops.train_epoch_dp(step, step, None, items, cpu_mesh(data=2), epoch=1,
                                 accumulation_steps=1, key=0, shard_over=16)
    assert calls == []


# ----------------------------------------------------------- async checkpoints


def _ckpt_state(seed: int = 0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    return TrainState(model, opt, step=1)


def _loaded_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_loaded_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_loaded_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_checkpoint_round_trip_equals_sync(tmp_path):
    """Async saves return before the file is written and snapshot the state
    when called: changing the weights after ``save`` does not reach the
    file.  ``latest_step`` and ``restore`` wait; every file loads equal to a
    synchronous save's (``test_train.py:248``)."""
    state = _ckpt_state()
    sync = Checkpointer(str(tmp_path / "sync"))
    ck = Checkpointer(str(tmp_path / "async"), async_save=True)
    best = {k: v + 1.0 for k, v in state.model.state_dict().items()}
    first = state.model.weight.detach().clone()
    for step in (1, 2):
        for c in (sync, ck):
            c.save(step, state, epoch=step, early_stop={"counter": step}, best_params=best)
        with torch.no_grad():
            state.model.weight.add_(1.0)
    with pytest.raises(RuntimeError, match="already exists"):
        ck.save(2, state, epoch=2)
    assert ck.latest_step() == 2 and ck.all_steps() == [1, 2]
    for step in (1, 2):
        a = torch.load(ck._step_path(step), weights_only=True)
        b = torch.load(sync._step_path(step), weights_only=True)
        assert _loaded_equal(a, b)
    fresh = _ckpt_state(seed=1)
    restored, meta, rbest = ck.restore(fresh, step=1)
    assert meta["epoch"] == 1 and meta["early_stop"] == {"counter": 1}
    assert torch.equal(restored.model.weight, first)
    assert all(torch.equal(rbest[k], best[k]) for k in best)
    ck.close()


def test_async_checkpoint_error_surfaces_at_wait(tmp_path, monkeypatch):
    """An error of the background write is raised by ``wait()``, not lost."""

    def fail(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(tstate, "_atomic_save", fail)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, _ckpt_state(), epoch=1)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once
    monkeypatch.undo()
    ck.save(2, _ckpt_state(), epoch=2)
    assert ck.latest_step() == 2
    ck.close()


def _tiny_cfg(model_path, **tpu):
    return tcfg.config_from_dict({
        "data": {"H": 128, "W": 128, "size": [128, 128], "patch_size": 32, "synthetic_count": 6,
                 "bag_size_train": 8, "bag_size_val_test": 8},
        "training_plan": {"parameters": {"epochs": 2}},
        "tpu": {"buckets": [8, 16], "checkpoint_every": 1, **tpu},
        "model_path": str(model_path),
        "model_id": "best",
    })


def test_run_training_async_checkpoints_and_resume(tmp_path):
    """``run_training`` with ``tpu.async_checkpointing`` writes the same
    epoch checkpoints as a synchronous run; after losing epoch 2's, a
    resumed run continues from epoch 1's and writes epoch 2's again, equal
    to the uninterrupted run's."""
    from montecarlo_gated_mil_tpu_torch.runners import run_training

    run_training(_tiny_cfg(tmp_path / "sync"), device="cpu")
    run_training(_tiny_cfg(tmp_path / "async", async_checkpointing=True), device="cpu")
    sync, ck = (Checkpointer(str(tmp_path / d / "train_state")) for d in ("sync", "async"))
    assert sync.all_steps() == ck.all_steps() == [1, 2]

    def load(c, step):
        return torch.load(c._step_path(step), weights_only=True)

    for step in (1, 2):
        assert _loaded_equal(load(ck, step), load(sync, step))
    want = load(ck, 2)
    os.remove(ck._step_path(2))
    run_training(_tiny_cfg(tmp_path / "async", async_checkpointing=True), resume=True,
                 device="cpu")
    assert _loaded_equal(load(ck, 2), want)
