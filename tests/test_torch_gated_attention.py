"""Port's MC gated-attention head vs the JAX package's (plain version on the
CPU; the CUDA kernel against the plain version where a card exists)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarlo_gated_mil_tpu.ops import gated_attention as jga
from montecarlo_gated_mil_tpu_torch.ops import gated_attention as tga


def _params_np(seed, L=128, D=32, C=2, separate=False):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    if separate:
        return dict(w_V=r(C, L, D), b_V=r(C, D), w_U=r(C, L, D), b_U=r(C, D),
                    w_att=r(C, D), b_att=r(C), w_cls=r(C, L))
    return dict(w_V=r(L, D), b_V=r(D), w_U=r(L, D), b_U=r(D),
                w_att=r(D, C), b_att=r(C), w_cls=r(C, L))


def _both(p):
    return (
        jga.GatedAttentionParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        tga.GatedAttentionParams(**{k: torch.from_numpy(v) for k, v in p.items()}),
    )


@pytest.mark.parametrize("separate", [False, True])
def test_plain_head_matches_interpreted_pallas_kernel(separate):
    """Dropout 0: the port's plain head (the CPU path of the wrapper) equals
    the JAX package's interpreted K1 (separate) / K2 (shared) kernel, with
    the JAX package's own CPU tolerances."""
    N, L, T = 64, 128, 3
    rng = np.random.default_rng(1)
    H = rng.standard_normal((N, L)).astype(np.float32)
    mask = np.arange(N) < 50
    jp, tp = _both(_params_np(0, L=L, separate=separate))
    y_j, a_j = jga.mc_gated_attention_fused(
        jnp.asarray(H), jnp.asarray(mask), jp, T, jnp.asarray(1, jnp.int32),
        0.0, 0.0, interpret=True,
    )
    y_t, a_t = tga.mc_gated_attention(
        torch.from_numpy(H), torch.from_numpy(mask), tp, T, 1, 0.0, 0.0
    )
    assert y_t.shape == (T, 2) and a_t.shape == (T, 2, N)
    assert y_t.dtype == torch.float32 and a_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6)
    assert np.all(a_t.numpy()[:, :, 50:] == 0)


@pytest.mark.parametrize("separate", [False, True])
def test_dropout_statistics_match_jax_reference(separate):
    """With dropout on, the two packages draw different random streams, so
    they agree statistically: at T=2048 the per-class mean logit lies within
    4 sigma / sqrt(T) and the std within 15 %; each seed is exactly
    deterministic and two seeds differ."""
    N, L, D, T = 16, 32, 8, 2048
    rng = np.random.default_rng(2)
    H = np.abs(rng.standard_normal((N, L))).astype(np.float32)
    mask = np.arange(N) < 12
    p = _params_np(3, L=L, D=D, separate=separate)
    p["w_cls"] = p["w_cls"] * 20.0  # logits with a visible spread
    jp, tp = _both(p)
    import jax

    y_j, _ = jga.mc_head_reference(
        jnp.asarray(H), jnp.asarray(mask), jp, T, jax.random.key(0), 0.1, 0.1
    )
    Ht, mt = torch.from_numpy(H), torch.from_numpy(mask)
    y_t, a_t = tga.mc_gated_attention(Ht, mt, tp, T, 5, 0.1, 0.1)
    y_j, y_t = np.asarray(y_j, np.float64), y_t.numpy().astype(np.float64)
    sigma = y_j.std(0)
    assert np.all(sigma > 0)
    np.testing.assert_array_less(np.abs(y_t.mean(0) - y_j.mean(0)), 4 * sigma / np.sqrt(T))
    np.testing.assert_allclose(y_t.std(0), sigma, rtol=0.15)
    y_again, a_again = tga.mc_gated_attention(Ht, mt, tp, 4, 5, 0.1, 0.1)
    assert torch.equal(y_again, torch.from_numpy(y_t[:4].astype(np.float32)))
    assert torch.equal(a_again, a_t[:4])
    y_other, _ = tga.mc_gated_attention(Ht, mt, tp, 4, 6, 0.1, 0.1)
    assert not torch.equal(y_other, y_again)
    # sample t of seed s is sample t-1 of seed s+1
    assert torch.equal(y_other[:3], y_again[1:])
    assert np.all(a_t.numpy()[:, :, 12:] == 0)


@pytest.mark.parametrize(
    "counter,key,expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answer_vectors(counter, key, expected):
    """Random123's published Philox4x32-10 known-answer vectors."""
    out = tga.philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w[0]) for w in out) == expected


def test_dropout_uniform_maps_elements_to_philox_words():
    """Element e of a draw is word e % 4 of counter (e // 4, 0, 0, 0): at key
    (0, 0) elements 0-3 are Random123's first known-answer vector, and
    element 4 starts counter 1."""
    words = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    u = tga.dropout_uniform(0, 0, 6, "cpu")
    assert [float(x) for x in u[:4]] == [(w >> 8) * 2.0**-24 for w in words]
    one = torch.ones(1, dtype=torch.int64)
    zero = torch.zeros(1, dtype=torch.int64)
    nxt = tga.philox4x32_10((one, zero, zero, zero), (0, 0))
    assert [float(x) for x in u[4:]] == [(int(w[0]) >> 8) * 2.0**-24 for w in nxt[:2]]


def test_dropout_uniform_is_uniform_and_keyed():
    u = tga.dropout_uniform(123, 0, 1 << 16, "cpu")
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float((u < 0.1).float().mean()) - 0.1) < 0.01
    assert not torch.equal(u, tga.dropout_uniform(123, 1, 1 << 16, "cpu"))
    assert not torch.equal(u, tga.dropout_uniform(124, 0, 1 << 16, "cpu"))


def test_all_masked_bag_gives_zero_attention():
    jp, tp = _both(_params_np(4, L=16, D=8))
    H = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    y, a = tga.mc_gated_attention(H, torch.zeros(8, dtype=torch.bool), tp, 2, 0, 0.1, 0.1)
    assert torch.all(a == 0) and torch.all(y == 0)
