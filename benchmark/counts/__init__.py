"""Operations and bytes of the model and of the port's kernels, from shapes.

A kernel's bound is the larger of its operations over the peak of their
precision and its bytes over the HBM bandwidth, each input byte counted
once and each output byte once.  K1 (the MC head forward) counts its
three TF32 products of each f32 product (3xTF32) on the tensor cores and
the rest on the FP32 cores, as the kernel table of ``chip_smoke.py`` does;
K6 (the int8 convolution with the BN sums in its epilogue) counts
``2 * pixels * Cout * K`` int8 operations, the input pixels its taps read,
the weights, the bf16 store, the scales and the per-instance sums.

The model's work (for the ``mfu`` metrics) is the ResNet's convolutions on
the valid tiles (2 operations a multiply-add), as
``benchmark/backbones/<backbone>.json`` describes them, the head's T
samples, and for a training step the backward at twice the forward.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark import device as dev
from benchmark import spec


@dataclass(frozen=True)
class Conv:
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    h: int  # input height (= width)

    @property
    def out(self) -> int:
        return (self.h + 2 * self.pad - self.k) // self.stride + 1

    def flops(self) -> float:
        return 2.0 * self.cout * self.cin * self.k * self.k * self.out * self.out


def _conv(c: spec.ConvBN, h: int) -> Conv:
    return Conv(c.cin, c.cout, c.kernel, c.stride, c.pad, h)


def stem(patch: int = 224, backbone: str = "r18") -> Conv:
    return _conv(spec.load_backbone(backbone).stem, patch)


def block_convs(backbone: str = "r18", patch: int = 224) -> list[Conv]:
    """The convolutions after the stem, in launch order per block: its
    convs, then the downsample where there is one."""
    net = spec.load_backbone(backbone)
    k, stride, pad = net.pool
    h = (stem(patch, backbone).out + 2 * pad - k) // stride + 1
    out = []
    for blk in net.blocks:
        h_in = h
        for c in blk.convs:
            out.append(_conv(c, h))
            h = out[-1].out
        if blk.downsample is not None:
            out.append(_conv(blk.downsample, h_in))
    return out


def embed_flops(backbone: str = "r18", patch: int = 224) -> tuple[float, float]:
    """``(stem, rest)`` forward operations of one tile."""
    return stem(patch, backbone).flops(), sum(c.flops() for c in block_convs(backbone, patch))


def head_flops(n_valid: int, T: int, L: int, D: int, C: int, gates: int) -> float:
    """The MC head's T samples over ``n_valid`` rows: the gate products and
    the attention, pooling and classifier products."""
    return T * (2.0 * n_valid * L * 2 * gates * D + 2.0 * n_valid * D * C + 2.0 * C * n_valid * L)


def request_least_s(n_valid: int, cfg: dict) -> float:
    """The least time the card could take for one request's model work."""
    stem_f, rest_f = embed_flops(cfg["backbone"], cfg["patch"])
    gates = 1 if cfg["shared_att"] else cfg["C"]
    head = head_flops(n_valid, cfg["T"], cfg["L"], cfg["D"], cfg["C"], gates) / dev.PEAK_FP32_FLOPS
    if cfg["embed"] == "int8":
        return n_valid * (stem_f / dev.PEAK_BF16_FLOPS + rest_f / dev.PEAK_INT8_OPS) + head
    return n_valid * (stem_f + rest_f) / dev.PEAK_FP32_FLOPS + head


def train_step_least_s(n_valid: int, cfg: dict) -> float:
    """One bag's forward and backward (three times the forward) at f32,
    the head at T=1."""
    stem_f, rest_f = embed_flops(cfg["backbone"], cfg["patch"])
    gates = 1 if cfg["shared_att"] else cfg["C"]
    head = head_flops(n_valid, 1, cfg["L"], cfg["D"], cfg["C"], gates)
    return 3.0 * (n_valid * (stem_f + rest_f) + head) / dev.PEAK_FP32_FLOPS


def k1_bound_s(n: int, n_valid: int, T: int, L: int, D: int, C: int, gates: int) -> float:
    """K1's least time at a bucket of ``n`` rows, ``n_valid`` of them valid."""
    products = T * 2.0 * n_valid * L * 2 * gates * D
    rest = T * (2.0 * n_valid * D * C + 2.0 * C * n_valid * L)
    nbytes = 4.0 * (n * L + n + gates * L * D * 2 + T * C * (n + L))
    t_ops = 3 * products / dev.PEAK_TF32_FLOPS + rest / dev.PEAK_FP32_FLOPS
    return max(t_ops, nbytes / dev.PEAK_BYTES)


def _pixels_read(h: int, k: int, stride: int, pad: int) -> int:
    """Input pixels of one instance that a k x k conv's taps read."""
    out = (h + 2 * pad - k) // stride + 1
    axis = len({o * stride + t - pad for o in range(out) for t in range(k)} & set(range(h)))
    return axis * axis


def k6_bounds_s(n: int, backbone: str = "r18", patch: int = 224) -> list[float]:
    """K6's least time for each of a request's int8 convolutions at a bucket
    of ``n`` instances (bf16 store, with the BN sums)."""
    out = []
    for c in block_convs(backbone, patch):
        m = n * c.out * c.out
        ops = 2.0 * m * c.cout * c.k * c.k * c.cin
        nbytes = (n * _pixels_read(c.h, c.k, c.stride, c.pad) * c.cin
                  + c.cout * c.k * c.k * c.cin + 2.0 * m * c.cout + 4 * c.cout
                  + 2 * 4.0 * n * c.cout)
        out.append(max(ops / dev.PEAK_INT8_OPS, nbytes / dev.PEAK_BYTES))
    return out
