"""The port's single-controller mesh and its parallel paths against the JAX
package's (CPU).

A mesh of repeated ``torch.device("cpu")`` entries stands in for several
devices, as JAX's eight virtual CPU devices do (``tests/conftest.py``).
Tolerances:
- the instance-sharded head against the port's whole-bag head, dropout on:
  1e-5 on Y, 1e-6 on A (the same Philox elements; only the order of the
  cross-shard sums differs); against JAX's sharded head, whose dropout keys
  fold per shard: the statistics (per-class std within rtol 0.35, means
  within 6 standard errors), as JAX's own test holds its head;
- the deterministic sharded head against JAX's: 1e-5 on Y, 1e-6 on A;
- the sharded embed against the port's whole-bag embed: 1e-5 in f32 and
  1e-10 in f64 at 32 px; against JAX's sharded embed 1e-4 in f32 at 64 px
  (``tests/test_torch_resnet.py``'s bar for the two packages' embeds);
- data-parallel MC test against the sequential one: labels and MC logits
  equal bag for bag; against JAX's at dropout 0: accuracy and report;
- the member-sharded ensemble against the sequential one: 2e-5 (JAX's
  ``test_ensemble_sharded_matches_unsharded`` bar).
JAX's own sharded head takes shared gates only, so the JAX comparisons use
shared gates; the port's cases cover both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core import bag as jbag
from montecarlo_gated_mil_tpu.evaluation.dp_eval import mc_test_dp as jax_mc_test_dp
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.ops.gated_attention import GatedAttentionParams as JaxParams
from montecarlo_gated_mil_tpu.parallel import dp as jdp
from montecarlo_gated_mil_tpu.parallel import instance as jinst
from montecarlo_gated_mil_tpu.parallel.mesh import make_mesh as jax_make_mesh
from montecarlo_gated_mil_tpu_torch.core.bag import pad_to_bucket, stack_bags
from montecarlo_gated_mil_tpu_torch.evaluation.dp_eval import _mc_test_dp_outputs, mc_test_dp
from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import (
    ensemble_mc_inference,
    ensemble_mc_inference_sharded,
)
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
    GatedAttentionParams,
    dropout_uniform,
    dropout_uniforms,
    mc_head_reference,
)
from montecarlo_gated_mil_tpu_torch.parallel import (
    BucketBatcher,
    data_sharded,
    make_dp_mc_eval,
    make_mesh,
    mc_inference_sharded,
    replicated,
    shard_batch,
    sharded_embed,
    sharded_gated_attention,
    sharded_mc_gated_attention,
)
from montecarlo_gated_mil_tpu_torch.parallel.dp import pad_group_to_batch
from montecarlo_gated_mil_tpu_torch.train.loops import _mc_test_outputs, mc_test
from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

CPU = torch.device("cpu")
N, L, D, C = 64, 128, 32, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(data: int = -1, inst: int = 1, k: int | None = None):
    """A mesh of ``k`` CPU entries (default ``data * inst``, or 8)."""
    k = k or (8 if data == -1 else data * inst)
    return make_mesh(data=data, inst=inst, devices=[CPU] * k)


# ------------------------------------------------------------------ the mesh


def test_mesh_construction():
    """Shapes and refusals as JAX's ``make_mesh`` (``test_mesh_construction``)."""
    mesh = cpu_mesh()
    assert mesh.size == 8
    assert mesh.shape == {"data": 8, "inst": 1}
    mesh42 = cpu_mesh(data=4, inst=2)
    assert mesh42.shape == {"data": 4, "inst": 2} == dict(jax_make_mesh(data=4, inst=2).shape)
    assert mesh42.axis_devices("inst") == [CPU] * 2 and mesh42.axis_devices("data") == [CPU] * 4
    assert mesh42.flat("inst").shape == {"data": 1, "inst": 8}
    for kw in ({"data": 3}, {"inst": 3}, {"inst": 0}):
        with pytest.raises(ValueError):
            cpu_mesh(k=8, **kw)
        with pytest.raises(ValueError):
            jax_make_mesh(**kw)
    with pytest.raises(ValueError):
        make_mesh(devices=[])


def test_make_mesh_without_devices_uses_cuda_only(monkeypatch):
    """``make_mesh()`` means every visible CUDA device: with none it raises
    instead of building a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_placement_helpers():
    """``data_sharded`` splits the leading axis over ``data``;
    ``shard_batch`` does so for each field of a stacked bag; ``replicated``
    gives the module itself on its own device."""
    mesh = cpu_mesh(data=4, inst=2)
    x = torch.arange(8 * 3).reshape(8, 3)
    parts = data_sharded(mesh, x)
    assert [p.tolist() for p in parts] == [x[2 * i:2 * i + 2].tolist() for i in range(4)]
    with pytest.raises(ValueError, match="not divisible"):
        data_sharded(mesh, x[:6])
    bags = [pad_to_bucket(np.full((3, 4, 4, 3), i, np.float32), np.arange(3), i % 2, 4)
            for i in range(4)]
    shards = shard_batch(mesh, stack_bags(bags))
    assert len(shards) == 4 and all(s.patches.shape == (1, 4, 4, 4, 3) for s in shards)
    assert [int(s.label[0]) for s in shards] == [0, 1, 0, 1]
    model = torch.nn.Linear(2, 2)
    assert replicated(mesh, model) == [model] * 4


# ------------------------------------------------------------------- the bag


def test_pad_to_bucket_and_stack_match_jax():
    """``Bag.bucket``, ``pad_to_bucket`` (padding and truncation to the first
    ``bucket``) and ``stack_bags`` (mixed buckets refused) as JAX's
    (``tests/test_core.py::test_pad_to_bucket_and_stack``)."""
    patches = np.random.default_rng(0).random((5, 4, 4, 3)).astype(np.float32)
    for bucket, label in ((8, 1), (3, 0)):
        got = pad_to_bucket(patches, np.arange(5), label, bucket)
        want = jbag.pad_to_bucket(patches, np.arange(5), label, bucket)
        assert got.bucket == want.bucket == bucket
        assert int(got.num_instances) == int(want.num_instances) == min(5, bucket)
        for f in ("patches", "mask", "label", "tile_indices"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    bag = pad_to_bucket(patches, np.arange(5), 1, 8)
    big = pad_to_bucket(patches, np.arange(5), 0, 3)
    stacked = stack_bags([bag, bag])
    assert stacked.patches.shape == (2, 8, 4, 4, 3) and stacked.bucket == 8
    assert torch.equal(stacked.mask[1], bag.mask)
    with pytest.raises(ValueError, match="different buckets"):
        stack_bags([bag, big])


# ------------------------------------------------------ the dropout stream


@pytest.mark.parametrize("start", [0, 1, 2, 3, 5, 6, 13])
def test_dropout_uniforms_from_an_element_offset(start):
    """Elements ``start..start+n-1`` of a draw are the whole draw's, at any
    start (unaligned starts skip words); T keys in one call give each key's
    draw."""
    whole = dropout_uniform(9, 1, 64, CPU)
    assert torch.equal(dropout_uniforms(9, [(1, 11, start)], CPU)[0], whole[start:start + 11])
    keys = torch.tensor([9, 10, 2**32 - 1])
    feat, att = dropout_uniforms(keys, [(0, 7, start), (1, 5, start)], CPU)
    assert feat.shape == (3, 7) and att.shape == (3, 5)
    for t, k in enumerate(keys.tolist()):
        assert torch.equal(feat[t], dropout_uniform(k, 0, start + 7, CPU)[start:])
        assert torch.equal(att[t], dropout_uniform(k, 1, start + 5, CPU)[start:])


# ------------------------------------------------------------- the sharded head


def _head_params(separate: bool, seed: int = 0):
    """Numpy head weights in the kernel layout, and the features."""
    g = np.random.default_rng(seed)

    def r(*shape):
        return (g.standard_normal(shape) * 0.05).astype(np.float32)

    if separate:
        p = dict(w_V=r(C, L, D), b_V=r(C, D), w_U=r(C, L, D), b_U=r(C, D), w_att=r(C, D),
                 b_att=r(C), w_cls=r(C, L))
    else:
        p = dict(w_V=r(L, D), b_V=r(D), w_U=r(L, D), b_U=r(D), w_att=r(D, C), b_att=r(C),
                 w_cls=r(C, L))
    H = g.standard_normal((N, L)).astype(np.float32)
    return p, H


def _port_params(p) -> GatedAttentionParams:
    return GatedAttentionParams(**{k: torch.from_numpy(v) for k, v in p.items()})


def test_sharded_gated_attention_matches_jax():
    """Dropout off, ``inst`` 8: the two-pass softmax equals JAX's
    ``sharded_gated_attention``; both refuse a bag that does not divide."""
    p, H = _head_params(separate=False)
    mask = np.arange(N) < 50
    y, a = sharded_gated_attention(torch.from_numpy(H), torch.from_numpy(mask), _port_params(p),
                                   cpu_mesh(data=1, inst=8))
    jmesh = jax_make_mesh(data=1, inst=8)
    jy, ja = jinst.sharded_gated_attention(jnp.asarray(H), jnp.asarray(mask),
                                           JaxParams(**{k: jnp.asarray(v) for k, v in p.items()}),
                                           jmesh)
    assert y.shape == (C,) and a.shape == (C, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-6, rtol=0)
    assert float(a[:, 50:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="not divisible"):
        sharded_gated_attention(torch.from_numpy(H[:60]), torch.from_numpy(mask[:60]),
                                _port_params(p), cpu_mesh(data=1, inst=8))


@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("n,inst", [(64, 2), (64, 4), (64, 8), (12, 4), (24, 8)])
def test_sharded_mc_head_equals_whole_bag_head(separate, n, inst):
    """Dropout 0.1: shard s draws the whole bag's Philox elements for its
    rows, so each sample equals the port's whole-bag head (1e-5 on Y, 1e-6
    on A).  ``n / inst = 3`` puts shard starts at ``3 C = 6``, not a
    multiple of 4: the unaligned start."""
    p, H = _head_params(separate)
    H = torch.from_numpy(H[:n])
    mask = torch.arange(n) < n - 3
    mask[1] = False
    params = _port_params(p)
    y, a = sharded_mc_gated_attention(H, mask, params, 5, 41, cpu_mesh(data=1, inst=inst),
                                      feature_dropout=0.1, attention_dropout=0.1)
    y_ref, a_ref = mc_head_reference(H, mask, params, 5, 41, 0.1, 0.1)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(a, a_ref, atol=1e-6, rtol=0)
    assert float(a[:, :, ~mask].abs().max()) == 0.0
    torch.testing.assert_close(a.sum(-1), torch.ones(5, C), atol=1e-5, rtol=0)


def test_sharded_mc_head_all_masked_shard_and_bag():
    """A shard with no valid row (and a bag with none) gives finite zeros
    there, as JAX's ``gmax <= _MASK_FILL`` branch does."""
    p, H = _head_params(separate=True)
    params = _port_params(p)
    mesh = cpu_mesh(data=1, inst=4)
    mask = torch.arange(N) >= N // 4  # shard 0 all padding
    y, a = sharded_mc_gated_attention(torch.from_numpy(H), mask, params, 3, 2, mesh)
    y_ref, a_ref = mc_head_reference(torch.from_numpy(H), mask, params, 3, 2, 0.1, 0.1)
    torch.testing.assert_close(a, a_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=0)
    y0, a0 = sharded_mc_gated_attention(torch.from_numpy(H), torch.zeros(N, dtype=torch.bool),
                                        params, 3, 2, mesh)
    assert torch.isfinite(y0).all() and float(a0.abs().max()) == 0.0


def test_sharded_mc_head_statistically_matches_jax():
    """T=512 at dropout 0.2 on ``inst`` 8: JAX folds its keys per shard, so
    only the statistics compare (JAX's
    ``test_sharded_mc_statistically_equivalent_to_single_chip``)."""
    p, H = _head_params(separate=False, seed=3)
    mask = np.arange(N) < 50
    T = 512
    y, a = sharded_mc_gated_attention(torch.from_numpy(H), torch.from_numpy(mask),
                                      _port_params(p), T, 1, cpu_mesh(data=1, inst=8),
                                      feature_dropout=0.2, attention_dropout=0.2)
    jy, ja = jax.jit(lambda h, m, k: jinst.sharded_mc_gated_attention(
        h, m, JaxParams(**{k2: jnp.asarray(v) for k2, v in p.items()}), T, k,
        jax_make_mesh(data=1, inst=8), feature_dropout=0.2, attention_dropout=0.2,
    ))(jnp.asarray(H), jnp.asarray(mask), jax.random.key(2))
    y, a, jy, ja = y.double().numpy(), a.double().numpy(), np.asarray(jy, np.float64), np.asarray(
        ja, np.float64)
    se = np.sqrt(y.var(0) / T + jy.var(0) / T)
    assert np.all(np.abs(y.mean(0) - jy.mean(0)) < 6 * se + 1e-6)
    np.testing.assert_allclose(y.std(0), jy.std(0), rtol=0.35)
    se_a = np.sqrt(a.var(0) / T + ja.var(0) / T)
    assert np.all(np.abs(a.mean(0) - ja.mean(0)) < 6 * se_a + 1e-6)


# ------------------------------------------------------------ the sharded embed


@pytest.fixture(scope="module")
def jax_model():
    """JAX's default model (shared gates, r18) and parameters, with the
    port's model holding the same weights."""
    jm = JaxMIL()
    x = jnp.zeros((2, 64, 64, 3))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), x,
                                                        jnp.ones(2, bool))["params"])
    return jm, params


def _port_model(params, p: float = 0.1, dtype=torch.float32) -> MultiHeadGatedAttentionMIL:
    model = MultiHeadGatedAttentionMIL(feature_dropout=p, attention_dropout=p, dtype=dtype)
    model.load_state_dict(from_jax_params(params))
    return model.eval()


def _bag_arrays(n: int, hw: int, n_valid: int, seed: int = 0):
    g = np.random.default_rng(seed)
    mask = np.arange(n) < n_valid
    patches = (g.standard_normal((n, hw, hw, 3)) * mask[:, None, None, None]).astype(np.float32)
    return patches, mask


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
def test_sharded_embed_equals_whole_bag_embed(jax_model, dtype, atol):
    """16 instances at 32 px, the last shard padded: every BN takes the
    whole bag's masked moments from the gathered per-instance sums."""
    model = _port_model(jax_model[1], dtype=dtype)
    patches, mask = _bag_arrays(16, 32, 13)
    x, m = torch.from_numpy(patches).to(dtype), torch.from_numpy(mask)
    with torch.inference_mode():
        whole = model.embed(x, m)
        for inst in (2, 8):
            got = sharded_embed(model, x, m, cpu_mesh(data=1, inst=inst))
            assert got.shape == whole.shape and got.dtype == whole.dtype
            torch.testing.assert_close(got, whole, atol=atol, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_embed(model, x[:10], m[:10], cpu_mesh(data=1, inst=8))


def test_sharded_embed_runs_the_given_replicas(jax_model):
    """Each shard convolves with its own device's copy of the model
    (``replicas``), not with the weights of the model passed in."""
    model = _port_model(jax_model[1])
    other = _port_model(jax_model[1])
    with torch.no_grad():
        for p in other.feature_extractor.parameters():
            p.mul_(1.5)
    patches, mask = _bag_arrays(8, 32, 7, seed=3)
    x, m = torch.from_numpy(patches), torch.from_numpy(mask)
    with torch.inference_mode():
        got = sharded_embed(model, x, m, cpu_mesh(data=1, inst=4), replicas=[other] * 4)
        want = other.embed(x, m)
        assert (got - model.embed(x, m)).abs().max() > 1e-2
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_sharded_embed_matches_jax(jax_model):
    """64 px, ``inst`` 8 in both packages: within 1e-4."""
    jm, params = jax_model
    patches, mask = _bag_arrays(16, 64, 13, seed=1)
    want = jax.jit(lambda x, m: jinst.sharded_embed(
        jm, params, x, m, jax_make_mesh(data=1, inst=8)))(jnp.asarray(patches), jnp.asarray(mask))
    with torch.inference_mode():
        got = sharded_embed(_port_model(params), torch.from_numpy(patches),
                            torch.from_numpy(mask), cpu_mesh(data=1, inst=8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_mc_inference_sharded_equals_whole_bag(jax_model):
    """The composition, dropout on: the sharded embed and head equal
    ``mc_inference`` on the whole bag (1e-5 on Y, 1e-6 on A)."""
    model = _port_model(jax_model[1], p=0.1)
    patches, mask = _bag_arrays(12, 32, 10, seed=2)
    x, m = torch.from_numpy(patches), torch.from_numpy(mask)
    with torch.inference_mode():
        y, a = mc_inference_sharded(model, x, m, 4, 17, cpu_mesh(data=1, inst=4))
    want = mc_inference(model, x, m, 4, 17, device="cpu")
    torch.testing.assert_close(y, want.predictions, atol=1e-5, rtol=0)
    torch.testing.assert_close(a, want.attention, atol=1e-6, rtol=0)


# ------------------------------------------------------ data-parallel MC test


def test_dp_mc_eval_shapes_and_padding(jax_model):
    """Eight bags over a ``data`` mesh of 8 (JAX's ``test_dp_mc_eval_sharded``):
    per-bag (T, C) logits and (T, C, N) attention, rows normalized, padded
    slots zero, each bag equal to its own ``mc_inference``."""
    model = _port_model(jax_model[1], p=0.1)
    g = np.random.default_rng(5)
    bags = [pad_to_bucket(g.standard_normal((6, 32, 32, 3)).astype(np.float32), np.arange(6),
                          b % 2, 8) for b in range(8)]
    mesh = cpu_mesh()
    step = make_dp_mc_eval(model, mesh, num_samples=3)
    shards, seeds, n_real = pad_group_to_batch(mesh, bags[:5], [10 + b for b in range(5)])
    assert n_real == 5 and len(shards) == 8 and seeds == [10, 11, 12, 13, 14, 10, 10, 10]
    preds, atts = step(shards, seeds)
    assert preds.shape == (8, 3, 2) and atts.shape == (8, 3, 2, 8)
    torch.testing.assert_close(atts.sum(-1), torch.ones(8, 3, 2), atol=1e-5, rtol=0)
    assert float(atts[..., 6:].abs().max()) == 0.0
    for b in range(5):
        want = mc_inference(model, bags[b].patches, bags[b].mask, 3, 10 + b, device="cpu")
        assert torch.equal(preds[b], want.predictions) and torch.equal(atts[b], want.attention)
    assert torch.equal(preds[5], preds[0])
    with pytest.raises(ValueError, match="group size"):
        pad_group_to_batch(mesh, bags + bags[:1], list(range(9)))


class _Sized:
    """What ``BucketBatcher`` reads of a bag: its bucket and patch bytes."""

    def __init__(self, bucket: int, nbytes: int):
        self.bucket = bucket
        self.patches = np.zeros(nbytes, np.uint8)


@pytest.mark.parametrize("budget", [1 << 31, 1, 300])
def test_bucket_batcher_policy_matches_jax(budget):
    """Full groups flush, the byte-heaviest partial group flushes past the
    budget, and the drain keeps first-seen bucket order, as JAX's
    ``BucketBatcher`` decides on the same stream."""
    stream = [_Sized(*x) for x in [(8, 10), (16, 40), (8, 10), (24, 90), (16, 40), (8, 10),
                                   (24, 90), (8, 10), (16, 40), (24, 90), (8, 10)]]
    ours, theirs = BucketBatcher(3, budget), jdp.BucketBatcher(3, budget)
    got, want = [], []
    for i, b in enumerate(stream):
        got += [[j for _, j in g] for g in ours.add(b, i)]
        want += [[j for _, j in g] for g in theirs.add(b, i)]
    got += [[j for _, j in g] for g in ours.drain()]
    want += [[j for _, j in g] for g in theirs.drain()]
    assert got == want and sorted(sum(got, [])) == list(range(len(stream)))


def _mixed_items(spec, hw: int, seed: int):
    """Bags padded to mixed buckets, as port and JAX bags of the same
    arrays: ``spec`` holds ``(n, bucket, label)`` per bag."""
    g = np.random.default_rng(seed)
    ours, theirs = [], []
    for n, bucket, label in spec:
        patches = g.standard_normal((n, hw, hw, 3)).astype(np.float32)
        ours.append((pad_to_bucket(patches, np.arange(n), label, bucket), None))
        theirs.append((jbag.pad_to_bucket(patches, np.arange(n), label, bucket), None))
    return ours, theirs


@pytest.fixture(scope="module")
def mixed_items():
    # buckets 8 and 16 interleaved, both groups partial on a mesh of 8
    return _mixed_items([(5, 8, int(i % 3 == 0)) if i % 2 else (12, 16, int(i % 3 == 0))
                         for i in range(11)], 32, seed=0)


def test_mc_test_dp_mixed_buckets_equals_sequential(jax_model, mixed_items):
    """Dropout on, a ``data`` mesh of 8: bag ``i`` keeps seed
    ``fold_in(seed, i)``, so labels and MC logits equal the sequential
    ``mc_test``'s bag for bag, and so do accuracy and report."""
    model = _port_model(jax_model[1], p=0.25)
    items, _ = mixed_items
    mesh = cpu_mesh()
    seq = _mc_test_outputs(model, items, num_samples=3, seed=9)
    dp = _mc_test_dp_outputs(model, items, num_samples=3, seed=9, mesh=mesh)
    assert dp[0] == seq[0] and dp[1] == seq[1]
    assert all(torch.equal(a, b) for a, b in zip(dp[2], seq[2]))
    acc_dp, rep_dp = mc_test_dp(model, items, num_samples=3, seed=9, mesh=mesh,
                                metrics=Metrics([MemorySink()]))
    acc_seq, rep_seq = mc_test(model, items, num_samples=3, seed=9,
                               metrics=Metrics([MemorySink()]))
    assert acc_dp == acc_seq and rep_dp.data == rep_seq.data


def test_mc_test_dp_matches_jax_at_dropout_zero(jax_model, mixed_items):
    """Dropout 0, so the two packages' MC samples agree up to the embeds'
    rounding: the same accuracy and report as JAX's ``mc_test_dp`` on its
    8-device mesh."""
    jm, params = jax_model
    jm0 = JaxMIL(feature_dropout=0.0, attention_dropout=0.0)
    items, jitems = mixed_items
    want_acc, want_rep = jax_mc_test_dp(jm0, params, jitems, num_samples=2,
                                        key=jax.random.key(9), mesh=jax_make_mesh(),
                                        metrics=Metrics([MemorySink()]))
    acc, rep = mc_test_dp(_port_model(params, p=0.0), items, num_samples=2, seed=9,
                          mesh=cpu_mesh(), metrics=Metrics([MemorySink()]))
    assert acc == want_acc and rep.data == want_rep.data


def test_mc_test_dp_pending_cap_flushes_early_and_equals_sequential(jax_model):
    """Three buckets of seven bags, none reaching the mesh batch, and a
    budget of one byte: partial groups flush early (the cap floors at one
    mesh batch of the largest bag), and labels still equal the sequential
    path's bag for bag (JAX's ``test_mc_test_dp_pending_cap...``)."""
    model = _port_model(jax_model[1], p=0.25)
    items, _ = _mixed_items([[(4, 8, i % 2), (10, 16, i % 2), (18, 24, i % 2)][i % 3]
                             for i in range(21)], 16, seed=1)
    flushed = []
    real = BucketBatcher.add

    def spy(self, bag, index):
        out = real(self, bag, index)
        flushed.extend(len(g) for g in out)
        return out

    seq = _mc_test_outputs(model, items, num_samples=2, seed=4)
    try:
        BucketBatcher.add = spy
        dp = _mc_test_dp_outputs(model, items, num_samples=2, seed=4, mesh=cpu_mesh(),
                                 pending_budget_bytes=1)
    finally:
        BucketBatcher.add = real
    assert flushed and max(flushed) < 8  # early, partial flushes
    assert dp[1] == seq[1] and all(torch.equal(a, b) for a, b in zip(dp[2], seq[2]))


# ---------------------------------------------------- the member-sharded ensemble


def test_ensemble_sharded_equals_sequential(jax_model):
    """Four members on ``data`` meshes of 4 and 2 and a (2, 2) mesh: global
    member indices seed the samples, so the pooled result is the sequential
    one within 2e-5; a member count the axis does not divide is refused."""
    model = _port_model(jax_model[1], p=0.1)
    members = []
    for s in range(4):
        m = MultiHeadGatedAttentionMIL()
        torch.manual_seed(100 + s)
        for prm in m.parameters():
            prm.data.normal_(0, 0.05)
        members.append(m.state_dict())
    patches, mask = _bag_arrays(8, 32, 6, seed=3)
    x, m = torch.from_numpy(patches), torch.from_numpy(mask)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    ref = ensemble_mc_inference(model, members, x, m, 3, 5)
    for mesh in (cpu_mesh(k=4), cpu_mesh(k=2), cpu_mesh(data=2, inst=2, k=4)):
        got = ensemble_mc_inference_sharded(model, members, x, m, 3, 5, mesh)
        torch.testing.assert_close(got.predictions, ref.predictions, atol=2e-5, rtol=0)
        torch.testing.assert_close(got.attention, ref.attention, atol=2e-5, rtol=0)
    assert all(torch.equal(own[k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="not divisible"):
        ensemble_mc_inference_sharded(model, members[:3], x, m, 3, 5, cpu_mesh(k=2))

