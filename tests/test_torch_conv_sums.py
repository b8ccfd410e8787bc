"""K7's BN sums taken in K6's epilogue (``ops/quant_kernels.py::
qconv_stats``), on the CPU: the plain version, and a host emulation of what
the kernel does on the card (per run of 8 x 8 output tiles of one
instance, its pixels in row order by groups of rows, pixels past the map
left out, then the runs of each instance folded in order, all in float64)
against K7's plain sums.  The card runs the kernels themselves in
``tests/test_torch_kernels_gpu.py``."""

import numpy as np
import pytest
import torch

from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk

STORES = ("bf16", "f8", "i8")
SUMS_VS_PLAIN = 1e-6  # K7's limit: max|d| / max|plain sum|


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_inputs(n, h, w, cin, cout, k, store, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8))
    s = torch.from_numpy((rng.random(cout) * 2e-4 + 1e-5).astype(np.float32))
    tq = torch.from_numpy((rng.random(cout) * 0.5 + 0.1).astype(np.float32))
    if store == "i8":
        return a, wt, s / tq * 50.0, tq
    return a, wt, s, None


# r18's conv geometries at 64 px (layers 1-4 run on 16, 8, 4 and 2 pixels).
GEOMETRIES = {
    "layer1_3x3": (16, 16, 64, 64, 3, 1, 1),
    "layer2_3x3_s2": (16, 16, 64, 128, 3, 2, 1),
    "layer3_1x1_s2": (8, 8, 128, 256, 1, 2, 0),
    "layer4_3x3": (2, 2, 512, 512, 3, 1, 1),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("store", STORES)
def test_plain_conv_with_sums_is_qconv_then_k7(store, geometry):
    """The plain path of K6 with K7's sums returns exactly
    ``qconv_reference``'s stored tensor and ``bn_stats_reference``'s sums
    of it (with the int8 store's tq)."""
    h, w, cin, cout, k, stride, pad = GEOMETRIES[geometry]
    a, wt, scale, tq = _conv_inputs(10, h, w, cin, cout, k, store, 1)
    pads = (pad,) * 4
    t, s1, s2 = qk.qconv_stats(a, wt, scale, stride, pads, store, tq)
    want = qk.qconv_reference(a, wt, scale, stride, pads, store)
    r1, r2 = qk.bn_stats_reference(want, tq)
    assert t.dtype == want.dtype == qk.STORE_DTYPES[store]
    assert torch.equal(t.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(s1, r1) and torch.equal(s2, r2)
    assert s1.shape == s2.shape == (10, cout) and s1.dtype == torch.float32


def emulate_tile_sums(t: torch.Tensor, tq: torch.Tensor | None, run: int):
    """What the card computes, in its order.  K6's warpgroup sums ``run``
    consecutive 8 x 8 tiles of one instance together (``qk.run_ends``); a
    column tile of BN channels (256, 128 or 64, as ``Cout`` divides) splits
    a tile's 8 pixel rows into 256 / BN groups, each thread adding its
    group's pixels of the run's tiles, tile by tile, in row order, into
    float64 (pixels past the map left out), then the groups' sums added in
    order.  The fold adds the runs of each instance in order; a map of one
    tile rounds its own sums to f32.  Returns the f32 sums and the number
    of tiles an instance has."""
    v = qk.load_stored(t, tq)
    n, oh, ow, c = v.shape
    tile = qk.SUM_TILE
    bn = 256 if c % 256 == 0 else 128 if c % 128 == 0 else 64
    rows = tile * bn // 256
    origins = [(oy0, ox0) for oy0 in range(0, oh, tile) for ox0 in range(0, ow, tile)]
    assert len(origins) == qk.sum_tiles(oh, ow)
    if len(origins) == 1:
        run = 1
    ends = qk.run_ends(n, len(origins), run)
    part = torch.full((n, len(origins), c, 2), float("nan"), dtype=torch.float64)
    for i in range(n):
        start = 0
        for k in range(len(origins)):
            if not ends[i, k]:
                continue
            total = None
            for y_lo in range(0, tile, rows):
                a = torch.zeros(c, dtype=torch.float64)
                b = torch.zeros(c, dtype=torch.float64)
                for oy0, ox0 in origins[start:k + 1]:
                    for y in range(y_lo, min(y_lo + rows, oh - oy0)):
                        for x in range(min(tile, ow - ox0)):
                            p = v[i, oy0 + y, ox0 + x, :].to(torch.float64)
                            a = a + p
                            b = b + p * p
                group = torch.stack([a, b], dim=-1)
                total = group if total is None else total + group
            part[i, k] = total
            start = k + 1
    if len(origins) == 1:
        return part[:, 0, :, 0].to(torch.float32), part[:, 0, :, 1].to(torch.float32), 1
    return (*qk.bn_stats_fold(part, run), len(origins))


@pytest.mark.parametrize("hw, tiles, c, run", [((7, 7), 1, 512, 1), ((14, 14), 4, 256, 1),
                                               ((28, 28), 16, 128, 2), ((56, 56), 49, 64, 4),
                                               ((9, 13), 4, 64, 4), ((17, 6), 3, 128, 2)])
@pytest.mark.parametrize("store", STORES)
def test_tile_partials_folded_match_k7(store, hw, tiles, c, run):
    """The kernel's per-run sums and their fold, emulated on the host at
    r18's 7x7, 14x14, 28x28 and 56x56 maps (at their widths and runs) and at
    ragged 8 x 8 tiles, within 1e-6 (of max|plain|) of K7's plain sums; the
    slots that end no run are NaN and must be left out."""
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    acc = rng.integers(-30000, 30000, (8, *hw, c)).astype(np.int32)
    scale = (rng.random(c) * 2e-4 + 1e-5).astype(np.float32)
    tq = torch.from_numpy((rng.random(c) * 0.5 + 0.1).astype(np.float32))
    acc = torch.from_numpy(acc)
    if store == "i8":
        t = qk.store_epilogue(acc, torch.from_numpy(scale) / tq, "i8")
    else:
        t, tq = qk.store_epilogue(acc, torch.from_numpy(scale), store), None
    s1, s2, n_tiles = emulate_tile_sums(t, tq, run)
    r1, r2 = qk.bn_stats_reference(t, tq)
    assert n_tiles == tiles
    for got, want in ((s1, r1), (s2, r2)):
        assert float((got - want).abs().max()) <= SUMS_VS_PLAIN * float(want.abs().max())


@pytest.mark.parametrize("run", [1, 2, 4])
def test_fold_adds_runs_in_order(run):
    """The fold's plain version adds the slots that end a run one by one
    from 0, in float64, as the kernel's loop does: bit for bit the
    sequential sum of those slots, which a pairwise sum need not be; the
    other slots are never read."""
    rng = np.random.default_rng(3)
    part = torch.from_numpy(rng.standard_normal((5, 49, 16, 2)) * 10.0 ** rng.integers(
        -8, 8, (5, 49, 16, 2)))
    ends = qk.run_ends(5, 49, run)
    assert bool(ends[:, -1].all()) and int(ends.sum()) == sum(
        len({(i * 49 + k) // run for k in range(49)}) for i in range(5))
    part[~ends] = float("nan")
    s1, s2 = qk.bn_stats_fold(part, run)
    want = np.zeros((5, 16, 2))
    for k in range(49):
        want = np.where(ends[:, k, None, None].numpy(), want + part[:, k].numpy(), want)
    assert np.array_equal(s1.numpy(), want[..., 0].astype(np.float32))
    assert np.array_equal(s2.numpy(), want[..., 1].astype(np.float32))


def test_sum_tiles_counts_r18_maps():
    assert [qk.sum_tiles(h, h) for h in (56, 28, 14, 7)] == [49, 16, 4, 1]
    assert qk.sum_tiles(9, 13) == 4 and qk.sum_tiles(1, 1) == 1


def test_block_convs_carry_their_sums_to_the_affine(monkeypatch):
    """Every conv of the int8 embed's blocks hands its sums to
    ``_bn_affine`` with the stored tensor, so K7 (``bn_stats``) runs for the
    stem alone, and the embed's features are those of K7 on every output."""
    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone
    from montecarlo_gated_mil_tpu_torch.ops import quantized

    torch.manual_seed(0)
    plan = quantized.quantize_backbone_static(make_backbone("r18"), "r18")
    patches = torch.from_numpy(
        np.random.default_rng(2).uniform(-2.0, 2.5, (8, 64, 64, 3)).astype(np.float32))
    mask = torch.arange(8) < 6
    with torch.inference_mode():
        fused = quantized.quantized_embed_static(plan, patches, mask)
    k7 = []
    stats = quantized.bn_stats

    def recording(t, tq=None):
        k7.append(tuple(t.shape))
        return stats(t, tq)

    monkeypatch.setattr(quantized, "bn_stats", recording)
    with torch.inference_mode():
        quantized.quantized_embed_static(plan, patches, mask)
    assert k7 == [(8, 32, 32, 64)]
    k7.clear()

    def no_sums(ai, qw, stride, pad, store):  # the stored tensor alone: K7 reads it back
        store = quantized._store_for(qw, store)
        scale = qw["st"] if store == "i8" else qw["s"]
        return (quantized.qconv(ai, qw["w"], scale, stride, (pad,) * 4, store),
                qw["t"] if store == "i8" else None)

    monkeypatch.setattr(quantized, "_qconv_stored", no_sums)
    with torch.inference_mode():
        standalone = quantized.quantized_embed_static(plan, patches, mask)
    assert len(k7) == 20
    assert torch.equal(fused, standalone)
