"""The float embed's masked BN written as K9 computes it, against the chain
the port has always run (``ops/float_bn.py``), and the embed's features
through the fused call sites against the walk as it was before them.

On the CPU ``bn_apply`` runs the chain; ``bn_apply_reference`` is K9's own
algorithm in torch (the stem pooled first by the sign of each channel's
weight, the downsample's BN inline), so these tests hold the algorithm to
the chain bit for bit, and the card tests (``test_torch_kernels_gpu.py``)
hold K9 to it.
"""

import copy
import types
import zlib

import pytest
import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.models import resnet
from montecarlo_gated_mil_tpu_torch.ops import float_bn as fb


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test, as in test_torch_resnet.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn(c, g):
    """A BN with weights of both signs and a bias."""
    bn = resnet.MaskedBatchStatsNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.weight[0] = -abs(float(bn.weight[0]))
        bn.weight[1] = abs(float(bn.weight[1]))
        bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return bn


def _raw(shape, dtype, g):
    """A conv output: NCHW in channels_last memory."""
    n, c, h, w = shape
    return (torch.randn(n, h, w, c, generator=g) * 3 + 0.5).to(dtype).permute(0, 3, 1, 2)


MASKS = {
    "mask": lambda n: torch.tensor([True, False, True, True, False, True])[:n],
    "none": lambda n: None,
    "all_masked": lambda n: torch.zeros(n, dtype=torch.bool),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", list(MASKS))
@pytest.mark.parametrize("epilogue", ["relu", "identity", "downsample", "pool"])
def test_fused_bn_equals_the_chain(epilogue, mask_kind, dtype):
    """The chain (the BN module, then ReLU, the residual add and ReLU, or
    ReLU and the 3x3/2 pool, as the walk ran them) against K9's algorithm
    and against the fused call site (``_whole_norm``'s ``norm`` with the
    residual or the pool): the same bits, padded borders (9 x 7) and an
    all-masked bag (scale 0) included."""
    g = torch.Generator().manual_seed(zlib.crc32(f"{epilogue} {mask_kind}".encode()))
    shape = (6, 16, 9, 7)
    mask = MASKS[mask_kind](shape[0])
    bn, ds_bn = _bn(shape[1], g), _bn(shape[1], g)
    x = _raw(shape, dtype, g)
    residual = _raw(shape, dtype, g)
    with torch.no_grad():
        y = bn(x, mask)
        if epilogue == "identity":
            want = F.relu(y + residual)
        elif epilogue == "downsample":
            want = F.relu(y + ds_bn(residual, mask))
        else:
            want = F.relu(y)
        if epilogue == "pool":
            want = F.max_pool2d(want, kernel_size=3, stride=2, padding=1)

        _, _, mean, inv, scale = resnet._moments(x, mask, bn.eps)
        norm = fb.Norm(mean, inv, bn.weight, bn.bias)
        kw = dict(relu=True, pool=epilogue == "pool")
        if epilogue == "identity":
            kw["residual"] = residual
        elif epilogue == "downsample":
            _, _, r_mean, r_inv, _ = resnet._moments(residual, mask, ds_bn.eps)
            kw["residual"] = fb.Downsample(residual, fb.Norm(r_mean, r_inv, ds_bn.weight,
                                                             ds_bn.bias))
        got = fb.bn_apply_reference(x, scale, norm, **kw)

        res = None
        if epilogue == "identity":
            res = [residual]
        elif epilogue == "downsample":
            res = [resnet._Pending(residual, ds_bn)]
        site = resnet._whole_norm(mask)([bn], [x.clone()], True, res, epilogue == "pool")[0]
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(site, want)
    if mask_kind == "all_masked":
        assert float(scale) == 0.0


def _embed_as_before(nets, x, bn_step):
    """The float embed as the walk ran it before its BNs took epilogues:
    every BN through ``bn_step(bns, ys, relu)``, the block end's ``relu(y +
    r)`` with the downsample normalized on its own, the stem's pool after
    its ReLU."""
    xs = [t.to(nets[0].dtype) for t in x]
    with resnet._exact_float_convs(nets[0].dtype):
        ys = bn_step([n.bn1 for n in nets], [n._stem(t) for n, t in zip(nets, xs)], True)
        xs = [F.max_pool2d(y, kernel_size=3, stride=2, padding=1) for y in ys]
        for i in range(1, nets[0].num_stages + 1):
            for j in range(len(getattr(nets[0], f"layer{i}"))):
                blocks = [getattr(n, f"layer{i}")[j] for n in nets]
                ys = xs
                for k in range(1, blocks[0].depth + 1):
                    ys = bn_step([getattr(b, f"bn{k}") for b in blocks],
                                 [resnet._conv(getattr(b, f"conv{k}"), y)
                                  for b, y in zip(blocks, ys)], k < blocks[0].depth)
                rs = xs
                if blocks[0].downsample is not None:
                    rs = bn_step([b.downsample[1] for b in blocks],
                                 [resnet._conv(b.downsample[0], t) for b, t in zip(blocks, xs)],
                                 False)
                xs = [F.relu(y + r) for y, r in zip(ys, rs)]
    return [t.to(resnet._stats_dtype(t.dtype)).mean(dim=(2, 3)) for t in xs]


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("route", ["whole", "sharded"])
def test_embed_features_equal_the_walk_before(route, grad):
    """r18 at 448 x 256 px, 3 instances, 2 valid: ``ResNetFeatures.forward``
    and ``sharded_features`` (2 shards) give the features the walk gave
    before the BNs took their epilogues, bit for bit, where autograd
    records and where it does not."""
    torch.manual_seed(0)
    net = resnet.make_backbone("r18")
    x = torch.randn(3, 448, 256, 3, generator=torch.Generator().manual_seed(1))
    mask = torch.tensor([True, False, True])
    ctx = torch.enable_grad() if grad else torch.no_grad()
    with ctx:
        if route == "whole":
            got = [net(x, mask)]
            want = _embed_as_before([net], [x], lambda bns, ys, relu: [
                F.relu(bns[0](ys[0], mask)) if relu else bns[0](ys[0], mask)])
        else:
            nets = [net, copy.deepcopy(net)]
            xs, masks = [x[:2], x[2:]], [mask[:2], mask[2:]]
            got = resnet.sharded_features(nets, list(xs), masks)
            want = _embed_as_before(nets, xs, lambda bns, ys, relu: (
                resnet.sharded_batch_norm(bns, list(ys), masks, relu)))
    assert got[0].requires_grad == grad
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("launch", ["bn_stats", "bn_apply", "bn_apply_pool"])
def test_kernels_launch_on_the_tensors_card(launch, monkeypatch):
    """K7 and K9 launch with their tensor's card current: a shard of the
    instance-sharded route may lie on another card than the current one,
    and a card's stream takes no launch from another.  The library is
    mocked (no card here): each launch records the devices entered."""
    from montecarlo_gated_mil_tpu_torch.ops import cuda_build
    from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk

    current, seen = [], []

    class Guard:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    def library_call(*args):
        seen.append(list(current))
        return 0

    lib = types.SimpleNamespace(bn_stats=library_call, bn_apply=library_call,
                                bn_apply_pool=library_call)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(cuda_build, "load", lambda source: lib)
    monkeypatch.setattr(cuda_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(qk, "_require", lambda *args: None)
    kernel = cuda_build.KERNELS["bn_stats" if launch == "bn_stats" else "bn_apply"]
    monkeypatch.setattr(kernel, "launches", kernel.launches)
    c = 16
    x = torch.randn(2, c, 8, 8).contiguous(memory_format=torch.channels_last)
    if launch == "bn_stats":
        qk._bn_stats_cuda(x.permute(0, 2, 3, 1), None)
    else:
        nm = fb.Norm(torch.zeros(c), torch.ones(c), torch.ones(c), torch.zeros(c))
        fb._bn_apply_cuda(x, None, nm, True, None, launch == "bn_apply_pool", False)
    assert seen == [[x.device]]
