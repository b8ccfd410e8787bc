"""The port's int8 PTQ embed (``ops/quantized.py`` and the plain versions of
K6-K8 in ``ops/quant_kernels.py``) against the JAX package's
``ops/quantized.py``, and the acceptance of ``tests/test_quantized.py``
mirrored on the port.  CPU, plain versions of the kernels."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.ops import quantized as jq
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk
from montecarlo_gated_mil_tpu_torch.ops import quantized as tq
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

STORES = ["bf16", "f8", "i8"]
STEMS = ["bf16", "s2d_i8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(backbone="r18"):
    return _models_cached(backbone)


@functools.lru_cache(maxsize=None)
def _models_cached(backbone):
    """``tests/test_quantized.py``'s model in both packages, same weights."""
    jmodel = JaxMIL(backbone=backbone, shared_attention=True)
    key = jax.random.key(0)
    variables = jax.jit(jmodel.init)(
        {"params": key, "dropout": key}, jnp.zeros((4, 64, 64, 3)), jnp.ones(4, bool)
    )
    variables = jax.tree.map(np.asarray, variables)
    tmodel = MultiHeadGatedAttentionMIL(backbone=backbone, shared_attention=True)
    tmodel.load_state_dict(from_jax_params(variables["params"]))
    return jmodel, variables, tmodel.eval()


def _bags(n_bags=6, n=12, hw=64, seed=0):
    """``tests/test_quantized.py``'s synthetic bags, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_bags):
        p = np.clip(rng.normal(0.0, 0.8, size=(n, hw, hw, 3)).astype(np.float32), -2.2, 2.7)
        out.append((p, np.arange(n) < (n - (i % 3))))
    return out


def _plans(store="bf16", stem="bf16", backbone="r18"):
    return _plans_cached(store, stem, backbone)


@functools.lru_cache(maxsize=None)
def _plans_cached(store, stem, backbone):
    """Both packages' plans of the same weights."""
    jmodel, variables, tmodel = _models(backbone)
    jp = jq.quantize_backbone_static(
        variables["params"]["features"], backbone, conv_store=store, stem=stem
    )
    return jp, tq.quantize_backbone_static(
        tmodel.feature_extractor, backbone, conv_store=store, stem=stem
    )


def _port_embed(plan, p, mask, backbone="r18"):
    with torch.no_grad():
        return tq.quantized_embed_static(
            plan, torch.from_numpy(p), torch.from_numpy(mask), backbone=backbone
        ).numpy()


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


def _np(x):
    return np.asarray(x.float() if x.dtype in (torch.float8_e4m3fn, torch.bfloat16) else x)


def _jax_bn_affine(t, t_tq, bn, m):
    """JAX's ``_bn_affine`` of the port's stored tensor, read back as JAX's
    ``_load_t`` reads it."""
    se, be = jq._bn_affine(jnp.asarray(qk.load_stored(t, t_tq).numpy()),
                           {k: jnp.asarray(v.numpy()) for k, v in bn.items()},
                           jnp.asarray(m.numpy() > 0))
    return torch.from_numpy(np.array(se)), torch.from_numpy(np.array(be))


def pin_rounding_to_jax(monkeypatch):
    """Give the port JAX's BN affines and JAX's bf16 stem conv, computed from
    the port's own tensors.  These are the two stages whose f32/bf16
    rounding the packages do not share (sums in another order, another
    conv); the int8 s2d stem is exact in both and stays the port's.  With
    them shared, the two int8 chains must agree code for code: what is left
    to differ is the wiring (which scale, stride, pad, store and residual
    goes where)."""
    port_stem = tq._stem

    def jax_stem(plan, patches):
        if "conv1_q" in plan and patches.shape[1] % 2 == 0 and patches.shape[2] % 2 == 0:
            return port_stem(plan, patches)
        t = jax.lax.conv_general_dilated(
            jnp.asarray(patches.numpy()).astype(jnp.bfloat16),
            jnp.asarray(plan["conv1"].float().permute(2, 3, 1, 0).numpy()).astype(jnp.bfloat16),
            (2, 2), ((3, 3), (3, 3)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.bfloat16,
        )
        return torch.from_numpy(np.array(t.astype(jnp.float32))).to(torch.bfloat16)

    monkeypatch.setattr(tq, "_bn_affine", _jax_bn_affine)
    monkeypatch.setattr(tq, "_stem", jax_stem)


def _record_conv_inputs(monkeypatch):
    """Every int8 conv's input codes, in call order, in both packages."""
    jcodes, tcodes = [], []
    jconv, tconv = jq._qconv_stored, tq._qconv_stored

    def jax_rec(ai, *args):
        jcodes.append(np.asarray(ai))
        return jconv(ai, *args)

    def port_rec(ai, *args):
        tcodes.append(ai.numpy().copy())
        return tconv(ai, *args)

    monkeypatch.setattr(jq, "_qconv_stored", jax_rec)
    monkeypatch.setattr(tq, "_qconv_stored", port_rec)
    return jcodes, tcodes


# --------------------------------------------------------------- the plan


@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("store", STORES)
def test_plan_codes_and_scales_equal_jax(store, stem):
    """Every int8 weight code and every scale of the plan is JAX's, bit for
    bit; the i8 stores' moment-based ``t`` scales within 1e-6 relative."""
    jp, tp = _plans(store, stem)
    blocks = [k for k in jp if k.startswith("layer")]
    assert blocks == [k for k in tp if k.startswith("layer")] and len(blocks) == 8
    for blk in blocks:
        for name in ("in_scale", "mid_scale", "out_scale"):
            np.testing.assert_array_equal(np.asarray(jp[blk][name]), tp[blk][name].numpy())
        for conv in ("conv1", "conv2", "downsample_conv"):
            if conv not in jp[blk]:
                assert conv not in tp[blk]
                continue
            j, t = jp[blk][conv], tp[blk][conv]
            np.testing.assert_array_equal(np.asarray(j["w"]), tq.hwio(t["w"]).numpy())
            np.testing.assert_array_equal(np.asarray(j["s"]), t["s"].numpy())
            if store == "i8":
                np.testing.assert_allclose(t["t"].numpy(), np.asarray(j["t"]), rtol=1e-6)
            else:
                assert j["t"] is None and "t" not in t
    np.testing.assert_array_equal(
        np.asarray(jp["conv1"], np.float32), tp["conv1"].float().permute(2, 3, 1, 0).numpy()
    )
    if stem == "s2d_i8":
        np.testing.assert_array_equal(np.asarray(jp["stem_in_scale"]), tp["stem_in_scale"].numpy())
        np.testing.assert_array_equal(np.asarray(jp["conv1_q"]["w"]), tq.hwio(tp["conv1_q"]["w"]).numpy())
        np.testing.assert_array_equal(np.asarray(jp["conv1_q"]["s"]), tp["conv1_q"]["s"].numpy())
    else:
        assert "conv1_q" not in jp and "conv1_q" not in tp


def test_quantize_kernel_equals_jax_within_half_step():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 3, 16, 32)).astype(np.float32)
    q = tq.quantize_kernel(torch.from_numpy(w))
    j = jq.quantize_kernel(w)
    np.testing.assert_array_equal(tq.hwio(q["w"]).numpy(), np.asarray(j["w"]))
    np.testing.assert_array_equal(q["s"].numpy(), np.asarray(j["s"]))
    back = tq.hwio(q["w"]).numpy().astype(np.float32) * q["s"].numpy()
    err = np.abs(back - w).max(axis=(0, 1, 2))
    assert (err <= q["s"].numpy() * 0.5 + 1e-7).all()


def test_relu_moments_match_jax_and_monte_carlo():
    """Closed-form Gaussian relu moments: JAX's within 1e-6 relative (the
    variance, ``E[r^2] - E[r]^2``, also within 1e-8 absolute: a few f32 ulps
    of the moments it cancels), and a Monte-Carlo estimate
    (``tests/test_quantized.py``'s check)."""
    mu = np.asarray([-1.0, -0.2, 0.0, 0.5, 2.0], np.float32)
    sigma = np.asarray([0.5, 1.0, 2.0, 0.1, 1.5], np.float32)
    e1, var = tq._relu_moments(torch.from_numpy(mu), torch.from_numpy(sigma))
    je1, jvar = jq._relu_moments(jnp.asarray(mu), jnp.asarray(sigma))
    np.testing.assert_allclose(e1.numpy(), np.asarray(je1), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-6, atol=1e-8)
    x = np.random.default_rng(0).normal(size=(200_000, 1)) * sigma + mu
    r = np.maximum(x, 0.0)
    np.testing.assert_allclose(e1.numpy(), r.mean(0), atol=2e-2)
    np.testing.assert_allclose(var.numpy(), r.var(0), atol=5e-2)


def test_plan_rejects_unknown_options():
    _, _, tmodel = _models()
    fx = tmodel.feature_extractor
    with pytest.raises(ValueError, match="r18"):
        tq.quantize_backbone_static(fx, "vgg")
    with pytest.raises(ValueError, match="conv_store"):
        tq.quantize_backbone_static(fx, "r18", conv_store="int4")
    with pytest.raises(ValueError, match="stem"):
        tq.quantize_backbone_static(fx, "r18", stem="nope")


# ------------------------------------------------- the kernels' plain versions


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("geometry", ["3x3_s1", "3x3_s2", "1x1_s2"])
def test_plain_qconv_equals_jax_qconv_stored(store, geometry):
    """K6's plain version (exact f64 accumulators) equals JAX's
    ``_qconv_stored`` bit for bit for every store, narrow stores at
    Cout >= 128 as there."""
    k, stride, pad = {"3x3_s1": (3, 1, 1), "3x3_s2": (3, 2, 1), "1x1_s2": (1, 2, 0)}[geometry]
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(3, 9, 10, 64)).astype(np.int8)
    w = rng.integers(-127, 128, size=(k, k, 64, 128)).astype(np.int8)
    s = (rng.random(128) * 1e-3 + 1e-5).astype(np.float32)
    t = (rng.random(128) * 0.5 + 0.1).astype(np.float32)
    want = jq._qconv_stored(jnp.asarray(a), {"w": w, "s": s, "t": t}, stride, pad, store)
    plan_w = {"w": torch.from_numpy(w).permute(3, 0, 1, 2).contiguous(),
              "s": torch.from_numpy(s), "t": torch.from_numpy(t),
              "st": torch.from_numpy(s) / torch.from_numpy(t)}
    got, got_tq = tq._qconv_stored(torch.from_numpy(a), plan_w, stride, pad, store)
    assert got.dtype == qk.STORE_DTYPES[store]
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))
    assert (got_tq is not None) == (store == "i8")


def test_plain_s2d_stem_conv_equals_jax():
    """The s2d stem's 4x4 int8 conv with padding (2, 1): K6's plain version
    against JAX's conv of the same codes."""
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, size=(2, 16, 14, 12)).astype(np.int8)
    w = rng.integers(-127, 128, size=(4, 4, 12, 64)).astype(np.int8)
    s = (rng.random(64) * 1e-3).astype(np.float32)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(a), jnp.asarray(w), (1, 1), ((2, 1), (2, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    want = np.asarray((y.astype(jnp.float32) * s).astype(jnp.bfloat16).astype(jnp.float32))
    got = qk.qconv(torch.from_numpy(a), torch.from_numpy(w).permute(3, 0, 1, 2).contiguous(),
                   torch.from_numpy(s), 1, (2, 1, 2, 1), "bf16")
    assert got.shape == (2, 16, 14, 64)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _stored(store, shape, seed):
    """A stored conv output made by JAX's own ``_qconv_stored`` epilogue."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-30000, 30000, size=shape).astype(np.int32)
    s = (rng.random(shape[-1]) * 2e-4 + 1e-5).astype(np.float32)
    t = (rng.random(shape[-1]) * 0.02 + 0.01).astype(np.float32)
    if store == "i8":
        j = jnp.clip(jnp.round(jnp.asarray(acc).astype(jnp.float32) * (s / t)), -127, 127)
        j = j.astype(jnp.int8)
        return j, t, torch.from_numpy(np.array(j)), torch.from_numpy(t)
    yf = jnp.asarray(acc).astype(jnp.float32) * s
    j = jnp.clip(yf, -448.0, 448.0).astype(jnp.float8_e4m3fn) if store == "f8" else yf.astype(
        jnp.bfloat16)
    port = torch.from_numpy(np.array(j.astype(jnp.float32))).to(qk.STORE_DTYPES[store])
    return j, None, port, None


def _jax_load(j, t):
    return j.astype(jnp.float32) * t if t is not None else j.astype(jnp.float32)


def _assert_codes_close(got, want):
    """Equal, or at most 1e-4 of the codes one off: the affines come from
    f32 sums taken in another order, a last-bit difference that moves a
    value lying on a rounding boundary."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, ((d > 0).mean(), d.max())


def _bn(rng, c):
    return {"scale": (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32),
            "bias": (0.3 * rng.standard_normal(c)).astype(np.float32)}


@pytest.mark.parametrize("store", STORES)
def test_norm_requant_codes_equal_jax(store):
    """K7 + K8 plain versions given JAX's stored tensor: the BN affine
    within 1e-6 relative of JAX's ``_bn_affine`` and the int8 codes of
    ``norm_relu_quant``, the residual block end and the last block's mean
    pool equal to JAX's lines."""
    shape = (10, 14, 14, 128)
    j, jt, t, t_tq = _stored(store, shape, 1)
    jd, jdt, d, d_tq = _stored(store, shape, 2)
    rng = np.random.default_rng(3)
    mask = np.arange(10) < 8
    bn, bnd = _bn(rng, 128), _bn(rng, 128)
    scale = (rng.random(128) * 0.05 + 0.02).astype(np.float32)
    inv = (1.0 / (rng.random(128) * 0.1 + 0.05)).astype(np.float32)
    m = torch.from_numpy(mask).float()
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()}
    tbnd = {k: torch.from_numpy(v) for k, v in bnd.items()}

    tl = _jax_load(j, jt)
    jse, jbe = jq._bn_affine(tl, bn, jnp.asarray(mask))
    se, be = tq._bn_affine(t, t_tq, tbn, m)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-6)
    np.testing.assert_allclose(be.numpy(), np.asarray(jbe), rtol=1e-6, atol=1e-6)

    # norm_relu_quant (ops/quantized.py:497-502)
    want = jnp.clip(jnp.round(jnp.maximum(tl * (jse / scale) + jbe / scale, 0.0)), -127, 127)
    got = qk.bn_relu_quant(t, t_tq, se / torch.from_numpy(scale), be / torch.from_numpy(scale))
    _assert_codes_close(got.numpy(), np.asarray(want.astype(jnp.int8)))

    # residual through the downsample, then the identity (:536-549)
    dl = _jax_load(jd, jdt)
    jsed, jbed = jq._bn_affine(dl, bnd, jnp.asarray(mask))
    sed, bed = tq._bn_affine(d, d_tq, tbnd, m)
    tinv = torch.from_numpy(inv)
    xr = jnp.maximum(tl * (jse * inv) + jbe * inv + (dl * (jsed * inv) + jbed * inv), 0.0)
    got = qk.bn_relu_quant(t, t_tq, se * tinv, be * tinv,
                           qk.Residual(d, d_tq, sed * tinv, bed * tinv))
    _assert_codes_close(got.numpy(), np.asarray(jnp.clip(jnp.round(xr), -127, 127).astype(jnp.int8)))
    xq = np.array(jnp.clip(jnp.round(xr), -127, 127).astype(jnp.int8))
    x_scale = (rng.random(128) * 0.05 + 0.02).astype(np.float32)
    xr = jnp.maximum(tl * (jse * inv) + jbe * inv + jnp.asarray(xq).astype(jnp.float32) * (
        x_scale * inv), 0.0)
    got = qk.bn_relu_quant(t, t_tq, se * tinv, be * tinv,
                           qk.Residual(torch.from_numpy(xq), None, torch.from_numpy(x_scale) * tinv,
                                       None))
    _assert_codes_close(got.numpy(), np.asarray(jnp.clip(jnp.round(xr), -127, 127).astype(jnp.int8)))
    # the last block: inv = 1, f32 mean over (h, w)
    want = jnp.mean(jnp.maximum(tl * (jse * 1.0) + jbe * 1.0 + jnp.asarray(xq).astype(
        jnp.float32) * x_scale, 0.0), axis=(1, 2))
    got = qk.bn_relu_quant(t, t_tq, se, be,
                           qk.Residual(torch.from_numpy(xq), None, torch.from_numpy(x_scale), None),
                           mode="mean")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_stem_pool_codes_equal_jax():
    """K8's stem mode (plain version): affine folded with 1/b1, ReLU, the
    3x3/2 max-pool padded with -inf, round and clip (ops/quantized.py:
    473-492), given JAX's stored bf16 stem output."""
    j, _, t, _ = _stored("bf16", (6, 32, 32, 64), 7)
    rng = np.random.default_rng(8)
    mask = np.arange(6) < 5
    bn = _bn(rng, 64)
    b1 = (rng.random(64) * 0.05 + 0.02).astype(np.float32)
    jse, jbe = jq._bn_affine(j, bn, jnp.asarray(mask))
    a0 = jnp.maximum(j.astype(jnp.float32) * (jse / b1) + jbe / b1, 0.0)
    pooled = jax.lax.reduce_window(a0, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                   ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.asarray(jnp.clip(jnp.round(pooled), -127, 127).astype(jnp.int8))
    se, be = tq._bn_affine(t, None, {k: torch.from_numpy(v) for k, v in bn.items()},
                           torch.from_numpy(mask).float())
    got = qk.bn_relu_quant(t, None, se / torch.from_numpy(b1), be / torch.from_numpy(b1),
                           mode="pool_i8")
    assert got.shape == (6, 16, 16, 64)
    _assert_codes_close(got.numpy(), want)


# ------------------------------------------------------------- the embed

@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("store", STORES)
def test_quantized_embed_matches_jax(store, stem, monkeypatch):
    """The whole int8 r18 chain against JAX's ``quantized_embed_static``
    (run op by op), with the port's BN affines and bf16 stem conv pinned to
    JAX's (``pin_rounding_to_jax``): all 19 convs' int8 input codes equal
    JAX's (measured: every code, for every store and stem) and the features
    within cosine 0.9999 (measured worst 0.99999994, max |d| 4.8e-7).

    Unpinned, the f32 statistics differ from JAX's in the last bit and a
    random-init r18 whose BN sees few pixels amplifies each flipped code;
    JAX does the same to itself: its jitted embed of this bag sits at a
    per-instance cosine of 0.977-0.987 from its op-by-op run (measured for
    the bf16 and i8 stores, both stems).  So the
    unpinned port is held only to the float embed's bar, below."""
    jp, tp = _plans(store, stem)
    p, mask = _bags(2, seed=3)[1]
    jcodes, tcodes = _record_conv_inputs(monkeypatch)
    want = np.asarray(jq.quantized_embed_static(jp, jnp.asarray(p), jnp.asarray(mask)), np.float32)
    pin_rounding_to_jax(monkeypatch)
    got = _port_embed(tp, p, mask)
    assert got.dtype == np.float32 and got.shape == want.shape == (12, 512)
    assert len(tcodes) == len(jcodes) == 19
    for t, j in zip(tcodes, jcodes):
        assert t.shape == j.shape and t.dtype == j.dtype == np.int8
        _assert_codes_close(t, j)
    nv = int(mask.sum())
    assert _cos(got[:nv], want[:nv]).min() >= 0.9999
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("store", STORES)
def test_quantized_features_agree_with_float(store):
    """``tests/test_quantized.py``'s bar on the port: cosine > 0.97 against
    the port's own float embed."""
    _, _, tmodel = _models()
    _, tp = _plans(store)
    for p, mask in _bags(4):
        with torch.no_grad():
            hf = tmodel.embed(torch.from_numpy(p), torch.from_numpy(mask)).numpy()
        hq = _port_embed(tp, p, mask)
        nv = int(mask.sum())
        assert _cos(hf[:nv], hq[:nv]).min() > 0.97


def test_quantized_s2d_stem_agrees_with_bf16_stem():
    _, tp = _plans("bf16", "bf16")
    _, ts = _plans("bf16", "s2d_i8")
    for p, mask in _bags(2, seed=3):
        nv = int(mask.sum())
        a, b = _port_embed(tp, p, mask), _port_embed(ts, p, mask)
        assert _cos(a[:nv], b[:nv]).min() > 0.97


def test_quantized_predictions_agree():
    """The deterministic MIL prediction from int8 features matches the float
    path on all but at most one of six bags."""
    _, _, tmodel = _models()
    _, tp = _plans()
    agree = 0
    bags = _bags(6, seed=3)
    for p, mask in bags:
        x, m = torch.from_numpy(p), torch.from_numpy(mask)
        with torch.no_grad():
            yf, _ = tmodel.head(tmodel.embed(x, m), m)
            yq, _ = tmodel.head(torch.from_numpy(_port_embed(tp, p, mask)), m)
        agree += int(torch.argmax(yf) == torch.argmax(yq))
    assert agree >= len(bags) - 1


@pytest.mark.parametrize("store", ["bf16", "i8"])
def test_quantized_masking_invariance(store):
    """Static scales and masked statistics: padded slots cannot move valid
    features."""
    _, tp = _plans(store)
    rng = np.random.default_rng(7)
    p = rng.normal(0.0, 0.8, size=(6, 64, 64, 3)).astype(np.float32)
    pad_a = np.zeros((2, 64, 64, 3), np.float32)
    pad_b = rng.normal(0.0, 5.0, size=(2, 64, 64, 3)).astype(np.float32)
    mask = np.array([True] * 6 + [False] * 2)
    ha = _port_embed(tp, np.concatenate([p, pad_a]), mask)
    hb = _port_embed(tp, np.concatenate([p, pad_b]), mask)
    np.testing.assert_allclose(ha[:6], hb[:6], rtol=1e-5, atol=1e-5)


def test_i8_conv_outputs_do_not_saturate(monkeypatch):
    """The static moment-based t-scales bound the raw conv outputs: no
    stored int8 value may sit on the clip rail (< 1e-3 of them)."""
    _, tp = _plans("i8")
    saturated = []
    orig = tq._qconv_stored

    def probe(ai, qw, stride, pad, store):
        out, t_q = orig(ai, qw, stride, pad, store)
        if t_q is not None:
            saturated.append(float((out.to(torch.int32).abs() >= 127).float().mean()))
        return out, t_q

    monkeypatch.setattr(tq, "_qconv_stored", probe)
    for p, mask in _bags(2, seed=11):
        _port_embed(tp, p, mask)
    assert saturated, "i8 storage was never exercised"
    assert max(saturated) < 1e-3, max(saturated)


def test_embed_fn_dispatch_and_mc_inference():
    """``make_embed_fn`` builds the plan once and returns f32 features;
    ``mc_inference(quantized=True)`` runs through it."""
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn, mc_inference

    _, _, tmodel = _models()
    p, mask = _bags(1)[0]
    embed = make_embed_fn(tmodel, quantized=True)
    _, tp = _plans()
    with torch.no_grad():
        h = embed(torch.from_numpy(p), torch.from_numpy(mask))
    np.testing.assert_array_equal(h.numpy(), _port_embed(tp, p, mask))
    assert make_embed_fn(tmodel) == tmodel.embed
    out = mc_inference(tmodel, p, mask, 3, 0, quantized=True, device="cpu")
    assert out.predictions.shape == (3, 2) and bool(torch.isfinite(out.predictions).all())


@pytest.mark.slow
@pytest.mark.parametrize("backbone,cos_min", [("r34", 0.8), ("r50", 0.75)])
def test_quantized_deeper_backbones_agree_with_float(backbone, cos_min):
    """r34 and r50 (Bottleneck) through the int8 plan: the bars of
    ``tests/test_quantized.py``'s slow cases, and the plan codes equal to
    JAX's."""
    _, _, tmodel = _models(backbone)
    jp, tp = _plans("bf16", "bf16", backbone)
    for blk in (k for k in jp if k.startswith("layer")):
        np.testing.assert_array_equal(np.asarray(jp[blk]["conv2"]["w"]),
                                      tq.hwio(tp[blk]["conv2"]["w"]).numpy())
    agree = 0
    bags = _bags(5, n=8, seed=13 if backbone == "r34" else 9)
    for p, mask in bags:
        x, m = torch.from_numpy(p), torch.from_numpy(mask)
        with torch.no_grad():
            hf = tmodel.embed(x, m).numpy()
            hq = _port_embed(tp, p, mask, backbone)
            yf, _ = tmodel.head(torch.from_numpy(hf), m)
            yq, _ = tmodel.head(torch.from_numpy(hq), m)
        nv = int(mask.sum())
        assert _cos(hf[:nv], hq[:nv]).min() > cos_min
        agree += int(torch.argmax(yf) == torch.argmax(yq))
    assert agree >= len(bags) - 1
