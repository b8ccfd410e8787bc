"""The port's data path for training: resize, augmentation, BagLoader,
splits and records against the JAX package's (CPU)."""

import threading
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core.bag import BucketSpec as JaxBucketSpec
from montecarlo_gated_mil_tpu.data import pipeline as jpl
from montecarlo_gated_mil_tpu.data import records as jrec
from montecarlo_gated_mil_tpu.data import splits as jsplits
from montecarlo_gated_mil_tpu.data import synthetic as jsyn
from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
from montecarlo_gated_mil_tpu_torch.data import pipeline as tpl
from montecarlo_gated_mil_tpu_torch.data import records as trec
from montecarlo_gated_mil_tpu_torch.data import splits as tsplits
from montecarlo_gated_mil_tpu_torch.data import synthetic as tsyn


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once, and oversubscribed OpenMP threads slow these many
    small CPU ops down tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(height=128, width=128, patch_size=64, overlap=0.5, empty_threshold=0.5, bucket=16)


@pytest.mark.parametrize(
    "src,dst", [((150, 110), (96, 80)), ((1800, 720), (1759, 700))], ids=["small", "near-size"]
)

def test_offsize_resize_matches_jax(src, dst):
    """``canonicalize_image`` on an off-size image equals
    ``jax.image.resize(bilinear, antialias=True)`` within 1e-6, including a
    one-axis, mammogram-like near-size downscale."""
    img = np.random.default_rng(0).random(src).astype(np.float32)
    for flip in (False, True):
        got = tpl.canonicalize_image(torch.from_numpy(img), flip, dst).numpy()
        want = np.asarray(jpl.canonicalize_image(jnp.asarray(img), jnp.asarray(flip), dst))
        assert got.shape == want.shape == dst
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_augmented_bag_matches_jax_given_the_flips():
    """With JAX's own flip draws handed in, the augmented bag equals the JAX
    pipeline's (mask, tile indices, patches within 1e-6)."""
    img = tsyn.synthetic_image(128, 128, positive=True, seed=1)
    jcfg = jpl.PipelineConfig(**CFG, augment=True)
    tcfg = tpl.PipelineConfig(**CFG, augment=True)
    starts = jcfg.grid().tiles_array()[:, :2]
    key = jax.random.key(5)
    jbag = jpl.image_to_bag(jnp.asarray(img), jnp.asarray(True), jnp.asarray(1), key,
                            jnp.asarray(starts), jcfg)
    kh, kv = jax.random.split(key)
    flips = tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (CFG["bucket"],))))
                  for k in (kh, kv))
    assert flips[0].any() and not flips[0].all()
    tbag = tpl.image_to_bag(img, True, 1, torch.from_numpy(starts), tcfg, device="cpu",
                            flips=flips)
    np.testing.assert_array_equal(tbag.mask.numpy(), np.asarray(jbag.mask))
    np.testing.assert_array_equal(tbag.tile_indices.numpy(), np.asarray(jbag.tile_indices))
    np.testing.assert_allclose(tbag.patches.numpy(), np.asarray(jbag.patches), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="flips"):
        tpl.image_to_bag(img, True, 1, torch.from_numpy(starts), tcfg, device="cpu")


def test_flip_patches_axes():
    x = torch.arange(2 * 3 * 3, dtype=torch.float32).view(2, 3, 3, 1)
    out = tpl.flip_patches(x, torch.tensor([True, False]), torch.tensor([False, True]))
    assert torch.equal(out[0], x[0].flip(1)) and torch.equal(out[1], x[1].flip(0))


def _records(n, seed=0):
    jr, tr = jsyn.synthetic_records(n, seed=seed), tsyn.synthetic_records(n, seed=seed)
    assert [(r.paths, r.class_name, r.view, r.laterality) for r in jr] == [
        (r.paths, r.class_name, r.view, r.laterality) for r in tr
    ]
    return jr, tr


@pytest.mark.parametrize("kind", ["plain", "shuffle", "weighted"])
def test_epoch_orders_equal_jax(kind):
    jr, tr = _records(7)
    kw = {"shuffle": kind == "shuffle"}
    if kind == "weighted":
        kw["sample_weights"] = trec.class_weights(tr)[1]
    jl = jpl.BagLoader(jr, None, jpl.PipelineConfig(**CFG), seed=11, **kw)
    tl = tpl.BagLoader(tr, None, tpl.PipelineConfig(**CFG), seed=11, device="cpu", **kw)
    for epoch in range(4):
        np.testing.assert_array_equal(tl._epoch_order(epoch), jl._epoch_order(epoch))


def test_bag_loader_matches_jax():
    """Four synthetic records, shuffled, adaptive buckets: the same order,
    records, buckets, masks and patches as the JAX loader (no flips)."""
    jr, tr = _records(4, seed=2)
    spec = (8, 16)
    jl = jpl.BagLoader(jr, jsyn.make_synthetic_reader(128, 128), jpl.PipelineConfig(**CFG),
                       seed=3, shuffle=True, bucket_spec=JaxBucketSpec(spec))
    tl = tpl.BagLoader(tr, tsyn.make_synthetic_reader(128, 128), tpl.PipelineConfig(**CFG),
                       seed=3, shuffle=True, bucket_spec=BucketSpec(spec), device="cpu")
    assert len(tl) == 4
    got, want = list(tl.epoch(1)), list(jl.epoch(1))
    assert [r.paths for _, r in got] == [r.paths for _, r in want]
    for (tb, _), (jb, _) in zip(got, want):
        assert tb.mask.shape == jb.mask.shape
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
        assert int(tb.label) == int(jb.label)
        np.testing.assert_allclose(tb.patches.numpy(), np.asarray(jb.patches), atol=1e-6, rtol=0)


def test_bag_loader_sample_order_matches_jax():
    """A fixed ``sample_order`` with a repeated index (shuffling asked for,
    and overridden by it): the same ``len`` as the JAX loader and the same
    sequence of records, labels, masks and patches, in that order at every
    epoch; passing it with ``sample_weights`` raises in both packages."""
    jr, tr = _records(4, seed=2)
    order = np.array([2, 0, 2, 3, 1])
    jl = jpl.BagLoader(jr, jsyn.make_synthetic_reader(128, 128), jpl.PipelineConfig(**CFG),
                       seed=3, shuffle=True, sample_order=order)
    tl = tpl.BagLoader(tr, tsyn.make_synthetic_reader(128, 128), tpl.PipelineConfig(**CFG),
                       seed=3, shuffle=True, sample_order=order, device="cpu")
    assert len(tl) == len(jl) == 5
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert [r.paths for _, r in got] == [r.paths for _, r in want] == [
            tr[i].paths for i in order]
        for (tb, _), (jb, _) in zip(got, want):
            assert int(tb.label) == int(jb.label)
            np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
            np.testing.assert_allclose(tb.patches.numpy(), np.asarray(jb.patches), atol=1e-6,
                                       rtol=0)
    weights = trec.class_weights(tr)[1]
    with pytest.raises(ValueError, match="not both"):
        tpl.BagLoader(tr, None, tpl.PipelineConfig(**CFG), sample_order=order,
                      sample_weights=weights, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        jpl.BagLoader(jr, None, jpl.PipelineConfig(**CFG), sample_order=order,
                      sample_weights=weights)


def test_augmented_loader_is_seeded():
    _, tr = _records(2, seed=4)
    reader = tsyn.make_synthetic_reader(128, 128)
    cfg = tpl.PipelineConfig(**CFG, augment=True)

    def bags(seed, epoch):
        loader = tpl.BagLoader(tr, reader, cfg, seed=seed, device="cpu")
        return [b.patches for b, _ in loader.epoch(epoch)]

    a, b, c = bags(1, 0), bags(1, 0), bags(1, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("policy", ["extend", "truncate"])
def test_oversized_bags_extend_or_truncate_as_jax(policy):
    """A bag with more valid tiles than the cap bucket: extended (every tile
    kept) or truncated with a warning and a count, the same bucket as the
    JAX loader picks."""
    cfg = dict(CFG, height=256, width=256, patch_size=32, empty_threshold=0.3, bucket=16)
    _, tr = _records(1, seed=6)
    jr, _ = _records(1, seed=6)
    reader = tsyn.make_synthetic_reader(256, 256)
    jl = jpl.BagLoader(jr, jsyn.make_synthetic_reader(256, 256), jpl.PipelineConfig(**cfg),
                       bucket_spec=JaxBucketSpec((8, 16)), oversized=policy)
    tl = tpl.BagLoader(tr, reader, tpl.PipelineConfig(**cfg), bucket_spec=BucketSpec((8, 16)),
                       oversized=policy, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (tb, _), = list(tl.epoch(0))
    (jb, _), = list(jl.epoch(0))
    assert tb.mask.shape[0] == jb.mask.shape[0]
    n = int(tb.mask.sum())
    if policy == "extend":
        assert tb.mask.shape[0] > 16 and n == int(jb.mask.sum()) > 16
        assert tl.truncated_bags == 0
    else:
        assert tb.mask.shape[0] == 16 == n and tl.truncated_bags == 1
        assert any("truncated" in str(w.message) for w in caught)


def test_loader_raises_reader_errors_and_stops_when_left():
    _, tr = _records(3, seed=8)
    good = tsyn.make_synthetic_reader(128, 128)

    def reader(rec):
        if rec.paths[0].endswith("//1"):
            raise OSError("unreadable record")
        return good(rec)

    before = threading.active_count()
    loader = tpl.BagLoader(tr, reader, tpl.PipelineConfig(**CFG), device="cpu")
    with pytest.raises(OSError, match="unreadable"):
        list(loader.epoch(0))
    it = tpl.BagLoader(tr, good, tpl.PipelineConfig(**CFG), prefetch=1, device="cpu").epoch(0)
    next(it)
    it.close()  # leaving the loop early stops and joins the producer
    assert threading.active_count() == before


@pytest.mark.parametrize("n,frac,seed", [(20, 0.15, 0), (33, 0.15, 42), (12, 0.3, 7), (50, 0.2, 3)])
def test_splits_equal_jax(n, frac, seed):
    """The numpy splits equal the JAX package's (scikit-learn's
    ``train_test_split(stratify=...)`` and ``KFold``) index for index."""
    labels = [int(x) for x in np.random.default_rng(seed).random(n) < 0.4]
    for a, b in zip(tsplits.stratified_test_split(labels, frac, seed),
                    jsplits.stratified_test_split(labels, frac, seed)):
        np.testing.assert_array_equal(a, b)
    for fold in range(5):
        for a, b in zip(tsplits.kfold_split(n, 5, fold, seed), jsplits.kfold_split(n, 5, fold, seed)):
            np.testing.assert_array_equal(a, b)
    ts, js = tsplits.random_split(n, 0.75, 0.5, seed), jsplits.random_split(n, 0.75, 0.5, seed)
    for f in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    w = np.random.default_rng(seed).random(n) + 0.1
    np.testing.assert_array_equal(tsplits.weighted_sample_order(w, n, seed),
                                  jsplits.weighted_sample_order(w, n, seed))


def test_records_and_class_weights_equal_jax():
    jr, tr = _records(11, seed=9)
    assert [r.label for r in tr] == [r.label for r in jr]
    assert trec.class_weights(tr) == jrec.class_weights(jr)
    img = tsyn.make_synthetic_reader(64, 48)(tr[3])
    np.testing.assert_array_equal(img, jsyn.make_synthetic_reader(64, 48)(jr[3]))
