"""Oversized bags and requests: the routing of the port's evaluation loops,
data-parallel MC test and predictor against the JAX package's (CPU).

A bag padded past ``shard_over`` evaluates with its instances sharded over
every device of the mesh it is given (here ``[torch.device("cpu")] * 8``, as
JAX's eight virtual CPU devices in ``tests/conftest.py``); with one device,
or a bucket that does not divide over the devices, it runs whole.  JAX's
cases are ``tests/test_oversized.py:194-296`` and ``:413``.

Tolerances: at dropout 0 the port's loops equal JAX's in accuracy and
within 1e-4 in loss (an f32 r18 embed at 16 px in each package); a routed
bag's sharded result equals the whole bag's within 1e-5 (logits, losses)
and 1e-6 (attention), dropout on, since the shards draw the whole bag's
Philox elements; ``predict_many(dp=True)`` equals ``predict`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core.bag import Bag as JaxBag
from montecarlo_gated_mil_tpu.core.bag import BucketSpec as JaxBucketSpec
from montecarlo_gated_mil_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.serve import MCDOPredictor as JaxPredictor
from montecarlo_gated_mil_tpu.train import criteria as jcrit
from montecarlo_gated_mil_tpu.train import loops as jloops
from montecarlo_gated_mil_tpu_torch import runners
from montecarlo_gated_mil_tpu_torch.core.bag import Bag, BucketSpec
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.data.pipeline import PipelineConfig
from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
from montecarlo_gated_mil_tpu_torch.evaluation import dp_eval
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.parallel.mesh import make_mesh, shard_mesh_for
from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor
from montecarlo_gated_mil_tpu_torch.train import loops
from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

PATCH = 16
CPU = torch.device("cpu")
MESH8 = make_mesh(data=1, inst=8, devices=[CPU] * 8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's r18 model (shared gates, its default) and parameters."""
    jm = JaxMIL(backbone="r18")
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((8, PATCH, PATCH, 3)),
                                 jnp.ones((8,), bool))
    return jax.tree.map(np.asarray, variables["params"])


def _models(params, p: float):
    jm = JaxMIL(backbone="r18", feature_dropout=p, attention_dropout=p)
    tm = MultiHeadGatedAttentionMIL(feature_dropout=p, attention_dropout=p)
    tm.load_state_dict(from_jax_params(params))
    return jm, tm.eval()


def _bags(bucket=64, n_valid=49, label=1, seed=5):
    """One bag as the port's and as JAX's, from the same numpy arrays."""
    g = np.random.default_rng(seed)
    mask = np.arange(bucket) < n_valid
    patches = (g.standard_normal((bucket, PATCH, PATCH, 3)) * mask[:, None, None, None]).astype(
        np.float32)
    idx = np.where(mask, np.arange(bucket), 0)
    ours = Bag(torch.from_numpy(patches), torch.from_numpy(mask), torch.tensor(label),
               torch.from_numpy(idx))
    theirs = JaxBag(jnp.asarray(patches), jnp.asarray(mask), jnp.asarray(label, jnp.int32),
                    jnp.asarray(idx, jnp.int32))
    return ours, theirs


@pytest.fixture(scope="module")
def streams():
    """A mixed stream: two regular bags (bucket 16) around an oversized one
    (bucket 64), as port and JAX items."""
    pairs = [_bags(16, 10, 0, 7), _bags(64, 49, 1, 5), _bags(16, 12, 1, 9)]
    return [(a, None) for a, _ in pairs], [(b, None) for _, b in pairs]


def test_shard_mesh_routing_rules():
    """``shard_mesh_for`` as JAX's ``_shard_mesh_for``: not oversized,
    routing off, a bucket that does not divide over the devices, one device
    (or, on the CPU, no CUDA device for the default mesh) all run whole."""
    assert shard_mesh_for(16, 16, MESH8) is None
    assert shard_mesh_for(64, None, MESH8) is None
    mesh = shard_mesh_for(64, 16, MESH8)
    assert mesh is not None and mesh.shape == {"data": 1, "inst": 8}
    assert shard_mesh_for(64, 16, make_mesh(data=4, inst=2, devices=[CPU] * 8)).shape == {
        "data": 1, "inst": 8}
    assert shard_mesh_for(68, 16, MESH8) is None
    assert shard_mesh_for(64, 16, make_mesh(devices=[CPU])) is None
    assert shard_mesh_for(64, 16) is None  # no CUDA device: no default mesh
    assert jloops._shard_mesh_for(16, 16) is None and jloops._shard_mesh_for(68, 16) is None
    assert jloops._shard_mesh_for(64, 16).shape["inst"] == jax.device_count() == 8


def test_det_step_sharded_equals_whole_and_jax(jax_params):
    """The deterministic sharded step equals the whole-bag forward (logits
    and loss within 1e-5, same prediction) and JAX's sharded step (1e-4)."""
    jm, tm = _models(jax_params, 0.1)
    bag, jbag = _bags()
    with torch.no_grad():
        y_s = loops._det_step_sharded(tm, MESH8)(bag.patches, bag.mask)
        y, _ = tm(bag.patches, bag.mask)
    loss_s, pred_s = cross_entropy(y_s[None], bag.label[None]), torch.argmax(y_s)
    torch.testing.assert_close(y_s, y, atol=1e-5, rtol=0)
    torch.testing.assert_close(loss_s, cross_entropy(y[None], bag.label[None]), atol=1e-5, rtol=0)
    assert int(pred_s) == int(torch.argmax(y))
    jloss, jpred = jloops._det_step_sharded(jm, jcrit.cross_entropy)(
        jax_params, jbag.patches, jbag.mask, jbag.label)
    assert abs(float(loss_s) - float(jloss)) < 1e-4 and int(pred_s) == int(jpred)


def _spy(monkeypatch, name):
    """Record the bucket of each bag a sharded step factory's step gets."""
    routed = []
    real = getattr(loops, name)

    def factory(*a, **k):
        fn = real(*a, **k)

        def step(patches, *rest):
            routed.append(patches.shape[0])
            return fn(patches, *rest)

        return step

    monkeypatch.setattr(loops, name, factory)
    return routed


@pytest.mark.parametrize("loop", ["test", "validate", "mc_validate", "mc_test"])
def test_eval_loops_route_oversized_bags(jax_params, streams, monkeypatch, loop):
    """Each eval loop sends only the oversized bag through its sharded step,
    and at dropout 0 its result equals JAX's with the same ``shard_over``
    (accuracy equal, loss within 1e-4)."""
    jm, tm = _models(jax_params, 0.0)
    items, jitems = streams
    step = {"test": "_det_step_sharded", "validate": "_det_step_sharded",
            "mc_validate": "_mc_val_step_sharded", "mc_test": "_mc_test_step_sharded"}[loop]
    routed = _spy(monkeypatch, step)
    kw, jkw = {"shard_over": 16, "mesh": MESH8}, {"shard_over": 16}
    if loop in ("test", "mc_test"):
        if loop == "mc_test":
            kw.update(num_samples=2, seed=1)
            jkw.update(num_samples=2, key=jax.random.key(1))
        got = getattr(loops, loop)(tm, items, **kw)[0]
        want = getattr(jloops, loop)(jm, jax_params, jitems, **jkw)[0]
        assert got == want
    else:
        if loop == "mc_validate":
            kw.update(num_samples=2, key=3)
            jkw.update(num_samples=2, key=jax.random.key(3))
        got = getattr(loops, loop)(tm, items, cross_entropy, epoch=1, **kw)
        want = getattr(jloops, loop)(jm, jax_params, jitems, jcrit.cross_entropy, epoch=1, **jkw)
        assert abs(got - want) < 1e-4
    assert routed == [64]


@pytest.mark.parametrize("loop", ["mc_validate", "mc_test"])
def test_routed_mc_loops_equal_whole_with_dropout(jax_params, streams, loop):
    """Dropout on: the sharded bag draws the whole bag's masks, so the loop
    over a mesh of 8 equals the loop over one device (the bag whole)."""
    _, tm = _models(jax_params, 0.2)
    items, _ = streams
    one = make_mesh(devices=[CPU])
    if loop == "mc_test":
        got = loops._mc_test_outputs(tm, items, num_samples=3, seed=2, shard_over=16, mesh=MESH8)
        want = loops._mc_test_outputs(tm, items, num_samples=3, seed=2, shard_over=16, mesh=one)
        assert got[1] == want[1]
        for a, b in zip(got[2], want[2]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    else:
        kw = dict(epoch=2, num_samples=3, key=5, shard_over=16)
        got = loops.mc_validate(tm, items, cross_entropy, mesh=MESH8, **kw)
        assert abs(got - loops.mc_validate(tm, items, cross_entropy, mesh=one, **kw)) < 1e-5


def test_mc_test_dp_diverts_oversized_bags(jax_params, streams, monkeypatch):
    """The data-parallel MC test batches the regular bags over ``data`` and
    sends the oversized one, alone, instance-sharded over all the mesh's
    devices; labels and logits equal the sequential ``mc_test``'s with the
    same ``shard_over`` and mesh."""
    _, tm = _models(jax_params, 0.1)
    items, _ = streams
    mesh = make_mesh(data=4, devices=[CPU] * 4)
    routed = _spy(monkeypatch, "_mc_test_step_sharded")
    got = dp_eval._mc_test_dp_outputs(tm, items, num_samples=2, seed=2, mesh=mesh,
                                      shard_over=16)
    assert routed == [64]
    want = loops._mc_test_outputs(tm, items, num_samples=2, seed=2, shard_over=16, mesh=mesh)
    assert got[1] == want[1] and all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_mc_test_warns_on_mixed_regime(jax_params):
    """The int8 path says once per loop that an oversized bag took the float
    sharded path, as JAX's does; the dp loop too."""
    _, tm = _models(jax_params, 0.1)
    big, _ = _bags()
    with pytest.warns(UserWarning, match="mixes evaluation regimes"):
        loops.mc_test(tm, [(big, None), (big, None)], num_samples=2, seed=4, quantized=True,
                      shard_over=16, mesh=MESH8)
    with pytest.warns(UserWarning, match="mixes evaluation regimes"):
        dp_eval.mc_test_dp(tm, [(big, None)], num_samples=2, seed=4, quantized=True,
                           shard_over=16, mesh=MESH8)


def test_runners_route_by_the_registry():
    """``_shard_over`` is the largest registry bucket; a model on the CPU
    gets no evaluation mesh, so runs here stay sequential and whole."""
    cfg = Config()
    assert runners._shard_over(cfg) == max(cfg.tpu.buckets) == 1024
    assert runners._eval_mesh(MultiHeadGatedAttentionMIL()) is None


# 64x64 image, 16 px tiles, 50 % overlap: 42 valid tiles of a dense image,
# far above the 16-tile cap (JAX's tests/test_oversized.py geometry).
DENSE = dict(height=64, width=64, patch_size=PATCH, overlap=0.5, empty_threshold=0.05, bucket=16)


def test_predictor_shards_oversized_requests(jax_params):
    """An oversized request with a mesh of 8 picks JAX's extended bucket (a
    multiple of the device count), keeps every tile, and equals the
    whole-bag predictor's result; ``predict_many`` routes it off the batch
    and batches the rest, each result equal to ``predict``'s."""
    _, tm = _models(jax_params, 0.1)
    spec = BucketSpec((8, 16))
    sharded = MCDOPredictor(tm, PipelineConfig(**DENSE), num_samples=3, bucket_spec=spec,
                            device="cpu", mesh=MESH8)
    whole = MCDOPredictor(tm, PipelineConfig(**DENSE), num_samples=3, bucket_spec=spec,
                          device="cpu")
    jpred = JaxPredictor(JaxMIL(backbone="r18"), None, JaxPipelineConfig(**DENSE),
                         use_pallas=False, bucket_spec=JaxBucketSpec((8, 16)))
    img = np.ones((64, 64), np.float32)
    bucket = sharded._pick_bucket(img, "L")
    assert bucket == jpred._pick_bucket(img, "L") > 16 and bucket % 8 == 0
    assert whole._pick_bucket(img, "L") == spec.extended_bucket(42) == 48
    r, w = sharded.predict(img, seed=3), whole.predict(img, seed=3)
    assert r.num_instances == w.num_instances == 42 and r.bucket == bucket
    torch.testing.assert_close(r.stats.mean_probs, w.stats.mean_probs, atol=1e-5, rtol=0)
    torch.testing.assert_close(r.attention.mean[:, :42], w.attention.mean[:, :42], atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(r.attention.std[:, :42], w.attention.std[:, :42], atol=1e-6,
                               rtol=0)
    imgs = [img, np.zeros((64, 64), np.float32), synthetic_image(64, 64, positive=True, seed=1)]
    many = sharded.predict_many(imgs, seeds=[3, 4, 5], dp=True)
    for m, im, s in zip(many, imgs, [3, 4, 5]):
        p = sharded.predict(im, seed=s)
        assert (m.bucket, m.num_instances) == (p.bucket, p.num_instances)
        assert torch.equal(m.stats.mean_probs, p.stats.mean_probs)
        assert torch.equal(m.attention.std, p.attention.std)
    assert many[0].num_instances == 42 and many[1].num_instances == 0


def test_predict_many_dp_equals_predict(jax_params):
    """Requests under the cap ride the batch: grouped by bucket over a
    ``data`` mesh of 2, each result equals ``predict``'s bit for bit, and
    ``dp=None`` takes the batched path with a mesh of several devices."""
    _, tm = _models(jax_params, 0.1)
    pipe = dict(height=128, width=128, patch_size=PATCH, overlap=0.0, empty_threshold=0.05,
                bucket=64)
    pred = MCDOPredictor(tm, PipelineConfig(**pipe), num_samples=3,
                         bucket_spec=BucketSpec((8, 16, 32, 64)), device="cpu",
                         mesh=make_mesh(data=2, devices=[CPU] * 2))
    imgs = [synthetic_image(128, 128, positive=bool(s % 2), seed=s) for s in range(5)]
    lats = ["L", "R", "L", "R", "L"]
    calls = []
    real = pred._predict_many_dp
    pred._predict_many_dp = lambda *a: calls.append(1) or real(*a)
    many = pred.predict_many(imgs, lats, seed=7)
    assert calls == [1]
    assert len({m.bucket for m in many}) > 1  # several groups, some partial
    for i, (m, im, lat) in enumerate(zip(many, imgs, lats)):
        p = pred.predict(im, lat, seed=7 + i)
        assert (m.bucket, m.num_instances, m.prediction) == (p.bucket, p.num_instances,
                                                              p.prediction)
        for f in vars(p.stats):
            assert torch.equal(getattr(m.stats, f), getattr(p.stats, f)), f
        assert torch.equal(m.attention.mean, p.attention.mean)
    seq = pred.predict_many(imgs[:2], lats[:2], seed=7, dp=False)
    assert [torch.equal(a.stats.mean_probs, b.stats.mean_probs)
            for a, b in zip(seq, many)] == [True, True]
