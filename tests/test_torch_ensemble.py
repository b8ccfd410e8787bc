"""The fold ensemble (``mcdo/ensemble.py``) on the CPU against the JAX
package's.

Tolerances: at dropout 0, two members' JAX parameters carried over by
``weights.from_jax_params`` give the port's pooled predictions and
attention within 1e-4 of JAX's ``ensemble_mc_inference`` (an f32 r18 embed
of 64 px patches in each package; tests/test_torch_resnet.py holds the
embeds at that size).  With dropout, member m's samples equal the port's own
``mc_head`` seeded with ``fold_in(seed, m)`` exactly (the same code path).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.mcdo import ensemble as jens
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.mcdo import ensemble as tens
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_head
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.train.loops import ensemble_mc_test
from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

N, HW, VALID, T = 8, 64, 6, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def members():
    """Two members' JAX parameters (separate gates) and a bag with padding."""
    jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=False)
    x = jnp.zeros((2, HW, HW, 3))
    init = jax.jit(jm.init)
    params = [jax.tree.map(np.asarray, init(jax.random.key(s), x, jnp.ones(2, bool))["params"])
              for s in (0, 1)]
    g = np.random.default_rng(4)
    mask = np.arange(N) < VALID
    patches = (g.standard_normal((N, HW, HW, 3)) * mask[:, None, None, None]).astype(np.float32)
    return jm, params, patches, mask


def _port_model(p: float) -> MultiHeadGatedAttentionMIL:
    return MultiHeadGatedAttentionMIL(feature_dropout=p, attention_dropout=p,
                                      shared_attention=False)


def test_ensemble_matches_jax_at_dropout_zero(members):
    """Dropout 0: the port's pooled (M*T, C) logits and (M*T, C, N) attention,
    member-major, equal JAX's within 1e-4, and the module's own weights are
    back in place afterwards."""
    jm, params, patches, mask = members
    want = jens.ensemble_mc_inference(jm, jens.stack_params(params), jnp.asarray(patches),
                                      jnp.asarray(mask), T, jax.random.key(5))
    model = _port_model(0.0)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    stacked = tens.stack_params([from_jax_params(p) for p in params])
    got = tens.ensemble_mc_inference(model, stacked, torch.from_numpy(patches),
                                     torch.from_numpy(mask), T, 5)
    assert got.predictions.shape == (2 * T, 2) and got.attention.shape == (2 * T, 2, N)
    np.testing.assert_allclose(got.predictions.numpy(), np.asarray(want.predictions),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention),
                               rtol=0, atol=1e-4)
    # member-major: the members differ, and each member's T samples agree at dropout 0
    y = got.predictions.reshape(2, T, 2)
    assert not torch.allclose(y[0], y[1]) and torch.equal(y[0, 0].expand(T, 2), y[0])
    assert all(torch.equal(own[k], v) for k, v in model.state_dict().items())


def test_member_samples_are_mc_head_seeded_per_member(members):
    """With dropout, member m's block of samples is ``mc_head`` of that
    member's weights seeded with ``fold_in(seed, m)``."""
    _, params, patches, mask = members
    sds = [from_jax_params(p) for p in params]
    model = _port_model(0.25)
    x, m = torch.from_numpy(patches), torch.from_numpy(mask)
    got = tens.ensemble_mc_inference(model, tens.stack_params(sds), x, m, T, 11)
    for i, sd in enumerate(sds):
        one = _port_model(0.25)
        one.load_state_dict(sd)
        with torch.inference_mode():
            want = mc_head(one, one.embed(x, m), m, T, rng.fold_in(11, i))
        assert torch.equal(got.predictions[i * T:(i + 1) * T], want.predictions)
        assert torch.equal(got.attention[i * T:(i + 1) * T], want.attention)
    assert not torch.equal(got.predictions[:T], got.predictions[T:])


def test_stack_params_refusals():
    """An empty list and members whose keys or shapes differ are refused."""
    a = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    assert tens.stack_params([a, {k: v + 1 for k, v in a.items()}])[1]["b"][0] == 1
    with pytest.raises(ValueError, match="at least one member"):
        tens.stack_params([])
    with pytest.raises(ValueError, match="other keys"):
        tens.stack_params([a, {"w": a["w"]}])
    with pytest.raises(ValueError, match="shape"):
        tens.stack_params([a, {"w": torch.zeros(3, 2), "b": a["b"]}])


def test_load_fold_ensemble_and_ensemble_test(tmp_path, members):
    """``load_fold_ensemble`` restores a manifest's fold checkpoints in fold
    order; ``ensemble_mc_test`` scores bags by the pooled softmax mean and
    logs ``ensemble_test/accuracy``."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics

    _, params, patches, mask = members
    sds = [from_jax_params(p) for p in params]
    ck = Checkpointer(str(tmp_path))
    folds = [{"fold": k + 1, "checkpoint": ck.save_params(f"fold_{k + 1}", sd), "accuracy": 0.5}
             for k, sd in enumerate(sds)]
    manifest = json.loads(json.dumps({"folds": folds[::-1]}))
    stacked = tens.load_fold_ensemble(Config(model_path=str(tmp_path)), manifest)
    assert [torch.equal(s["classifiers.0.weight"], sd["classifiers.0.weight"])
            for s, sd in zip(stacked, sds)] == [True, True]

    model = _port_model(0.1)
    x, m = torch.from_numpy(patches), torch.from_numpy(mask)
    bags = [(Bag(x, m, torch.tensor(label), torch.arange(N)), None) for label in (0, 1)]
    sink = MemorySink()
    acc, report = ensemble_mc_test(model, stacked, bags, num_samples=T, seed=3,
                                   metrics=Metrics([sink]))
    preds = []
    for i in range(2):
        out = tens.ensemble_mc_inference(model, stacked, x, m, T, rng.fold_in(3, i))
        preds.append(int(torch.argmax(torch.softmax(out.predictions, -1).mean(0))))
    assert acc == np.mean(np.asarray(preds) == np.array([0, 1]))
    assert sink.values("ensemble_test/accuracy") == [acc] and "Negative" in report
