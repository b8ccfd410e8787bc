"""Port's ResNet with masked batch-statistics BN vs the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.models import resnet as jr
from montecarlo_gated_mil_tpu_torch.models import resnet as tr
from montecarlo_gated_mil_tpu_torch.weights import backbone_from_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once, and oversubscribed OpenMP threads slow these CPU
    convolutions down severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(tree, rng):
    """Non-trivial BN affines, so the test sees scale and bias."""
    if "scale" in tree:
        c = tree["scale"].shape
        return {"scale": 1.0 + 0.2 * rng.standard_normal(c), "bias": 0.2 * rng.standard_normal(c)}
    if "kernel" in tree:
        return {"kernel": np.asarray(tree["kernel"])}
    return {k: _randomize_bn(v, rng) for k, v in tree.items()}


_R18 = jr.make_backbone("r18")
_R18_FNS = (jax.jit(_R18.init), jax.jit(_R18.apply))  # shared: one compile


def _pair(jmodel, tmodel, x, mask, dtype, randomize=True, fns=None):
    init, apply = fns or (jax.jit(jmodel.init), jax.jit(jmodel.apply))
    params = init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    params = jax.tree.map(np.asarray, params)
    if randomize:
        params = _randomize_bn(params, np.random.default_rng(1))
    params = jax.tree.map(lambda a: np.asarray(a, dtype), params)
    tmodel.load_state_dict(backbone_from_jax(params))
    got = tmodel(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    want = np.asarray(apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    return got, want


@pytest.mark.parametrize(
    "dtype,hw,atol", [(np.float64, 32, 1e-10), (np.float32, 64, 1e-4)]
)
def test_small_resnet_matches_jax(dtype, hw, atol):
    """stage_sizes=(1,1,1,1), N=6 with 4 valid.  f64 at 32x32 patches pins
    the architecture; the f32 tolerance covers conv summation order.  f32
    runs at 64x64: at 32x32 the last stage is 1x1, its BN normalizes over 4
    values per channel and amplifies f32 rounding differences past 1e-4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, hw, hw, 3)).astype(dtype)
    mask = np.arange(6) < 4
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tmodel = tr.ResNetFeatures((1, 1, 1, 1), tr.BasicBlock, dtype=tdt).to(tdt)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jmodel = jr.ResNetFeatures(stage_sizes=(1, 1, 1, 1), block_cls=jr.BasicBlock, dtype=jdt)
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        got, want = _pair(jmodel, tmodel, x, mask, dtype)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.dtype == dtype and got.shape == (6, 512)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_r18_matches_jax():
    """Full r18 at 96x96 (its last stage is 3x3, so every BN sees enough
    values that f32 rounding stays inside 1e-4), padded slots inside the bag."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 96, 96, 3)).astype(np.float32)
    mask = np.array([True, True, False, True, True, False, True, True])
    got, want = _pair(_R18, tr.make_backbone("r18"), x, mask, np.float32, fns=_R18_FNS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_all_masked_bag_gives_zeros():
    """Every BN of an all-masked bag multiplies by min(n_valid, 1) = 0, so
    the default (zero-bias) model emits exact zeros, as the JAX one does."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 96, 96, 3)).astype(np.float32)
    mask = np.zeros(8, bool)
    got, want = _pair(
        _R18, tr.make_backbone("r18"), x, mask, np.float32, randomize=False, fns=_R18_FNS
    )
    assert np.all(got == 0) and np.all(want == 0)


def test_bn_statistics_ignore_padded_instances():
    bn = tr.MaskedBatchStatsNorm(4)
    x = torch.randn(5, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([True, True, True, False, False])
    padded = x.clone()
    padded[3:] = 1e3
    torch.testing.assert_close(bn(padded, mask)[:3], bn(x[:3]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,L", [("r18", 512), ("r34", 512), ("r50", 2048)])
def test_feature_dims_and_keys(name, L):
    m = tr.make_backbone(name)
    assert m.num_features == L == tr.feature_dim(name)
    keys = set(m.state_dict())
    assert "conv1.weight" in keys and "layer2.0.downsample.0.weight" in keys
    assert "layer4.0.downsample.1.bias" in keys


def test_s2d_stem_kernel_and_input_equal_jax():
    """The space-to-depth rearrangements are pure reshapes: bit-equal."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((7, 7, 3, 64)).astype(np.float32)
    np.testing.assert_array_equal(tr.s2d_stem_kernel(torch.from_numpy(w)).numpy(),
                                  np.asarray(jr.s2d_stem_kernel(jnp.asarray(w))))
    x = rng.standard_normal((2, 10, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tr.s2d_input(torch.from_numpy(x)).numpy(),
                                  np.asarray(jr.s2d_input(jnp.asarray(x))))


def test_space_to_depth_stem_matches_plain_stem():
    """``space_to_depth=True`` is the same function with the same weights
    (``tests/test_parity.py``'s tolerance), and needs even sides."""
    torch.manual_seed(0)
    plain, s2d = tr.make_backbone("r18"), tr.make_backbone("r18", space_to_depth=True)
    assert list(plain.state_dict()) == list(s2d.state_dict())
    s2d.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64, 64, 3)).astype(np.float32))
    mask = torch.ones(4, dtype=torch.bool)
    with torch.no_grad():
        np.testing.assert_allclose(s2d(x, mask).numpy(), plain(x, mask).numpy(), atol=2e-4, rtol=1e-4)
        with pytest.raises(ValueError, match="even"):
            s2d(x[:, :63], mask)


def test_space_to_depth_resnet_matches_jax():
    """The s2d stem against JAX's ``SpaceToDepthStem`` (same parameter tree)
    in a small f32 ResNet, as ``test_small_resnet_matches_jax``."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, 64, 64, 3)).astype(np.float32)
    mask = np.arange(6) < 4
    tmodel = tr.ResNetFeatures((1, 1, 1, 1), tr.BasicBlock, space_to_depth=True)
    jmodel = jr.ResNetFeatures(stage_sizes=(1, 1, 1, 1), block_cls=jr.BasicBlock,
                               space_to_depth=True)
    got, want = _pair(jmodel, tmodel, x, mask, np.float32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
