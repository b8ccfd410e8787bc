"""Monte Carlo gated-attention head: the hand-written kernel and its plain twin.

Counterpart of ``montecarlo_gated_mil_tpu/ops/gated_attention.py``.  The hot
MCDO stage is T independent passes of

    Hd   = feature_dropout(H)                       # (N, L)
    G    = tanh(Hd Wv + bv) * sigmoid(Hd Wu + bu)   # (N, D), per class if separate
    lgts = attention_dropout(G Wa + ba)             # (N, C)
    A    = masked_softmax_over_N(lgts)              # (C, N)
    M    = A Hd                                     # (C, L)
    Y    = sum(M * Wcls, axis=-1)                   # (C,)

On a CUDA tensor :func:`mc_gated_attention` runs ``csrc/mc_head.cu`` (see
its header for the design); on a CPU tensor it runs
:func:`mc_head_reference`, the plain PyTorch version of the same function.
Both draw dropout from one counter-based stream, Philox4x32-10 keyed on
``(seed + t, draw)`` and counted by the element index, so kernel and plain
version agree with dropout on as well as off.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.ops import cuda_build
from montecarlo_gated_mil_tpu_torch.ops.masked import masked_softmax

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_INV_2_24 = float(2.0**-24)
FEATURE_DRAW, ATTENTION_DRAW = 0, 1


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * m`` for 32-bit ``a`` held in int64.
    torch has no unsigned 64-bit multiply, so the product is taken in 16-bit
    limbs: every partial product fits in int64 without overflow."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid = a_hi * m_lo + a_lo * m_hi  # < 2^33
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)  # < 2^33
    hi = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return hi, low & _MASK32


def philox4x32_10(
    counter: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[int, int],
) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 words; bit-exact with
    ``philox4x32_10`` in ``csrc/philox.cuh``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_uniform(key: int, draw: int, n: int, device) -> torch.Tensor:
    """U[0,1) float32 for elements ``0..n-1`` of one draw: the top 24 bits of
    word 0 of Philox at counter ``(index, 0, 0, 0)`` and key ``(key, draw)``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    bits = philox4x32_10((idx, zero, zero, zero), (key, draw))[0]
    return (bits >> 8).to(torch.float32) * _INV_2_24


def _dropout(x: torch.Tensor, p: float, key: int, draw: int) -> torch.Tensor:
    """``x * keep * (1/(1-p))`` with ``keep = u >= p``, as the kernels do."""
    u = dropout_uniform(key, draw, x.numel(), x.device).view(x.shape)
    keep = (u >= torch.tensor(p, dtype=torch.float32)).to(x.dtype)
    return x * keep * (1.0 / (1.0 - p))


@dataclass(frozen=True)
class GatedAttentionParams:
    """Multi-head gated-attention parameters in the JAX kernel layout.

    Shared gate: w_V/w_U (L, D); b_V/b_U (D,); w_att (D, C); b_att (C,).
    Separate per-class gates: w_V/w_U (C, L, D); b_V/b_U (C, D);
    w_att (C, D); b_att (C,).  Either way w_cls (C, L).
    """

    w_V: torch.Tensor
    b_V: torch.Tensor
    w_U: torch.Tensor
    b_U: torch.Tensor
    w_att: torch.Tensor
    b_att: torch.Tensor
    w_cls: torch.Tensor

    @property
    def separate(self) -> bool:
        return self.w_V.ndim == 3

    @staticmethod
    def from_model_params(p: dict) -> "GatedAttentionParams":
        """From ``MultiHeadGatedAttentionMIL`` parameters in the JAX
        package's tree layout (numpy arrays or tensors)."""
        t = {k: torch.as_tensor(np.array(p[k])) for k in
             ("w_V", "b_V", "w_U", "b_U", "w_att", "b_att", "w_cls")}
        w_att = t["w_att"][:, :, 0]  # (C, D, 1) -> (C, D)
        return GatedAttentionParams(
            w_V=t["w_V"], b_V=t["b_V"], w_U=t["w_U"], b_U=t["b_U"],
            w_att=w_att if t["w_V"].ndim == 3 else w_att.T.contiguous(),
            b_att=t["b_att"][:, 0],
            w_cls=t["w_cls"][:, :, 0],
        )

    @staticmethod
    def from_module(model) -> "GatedAttentionParams":
        """From the port's ``MultiHeadGatedAttentionMIL`` (reference schema:
        Linear weights are (out, in))."""
        C = model.num_classes
        if model.shared_attention:
            wv, bv = model.attention_V[0].weight.T, model.attention_V[0].bias
            wu, bu = model.attention_U[0].weight.T, model.attention_U[0].bias
            w_att = torch.cat([model.attention_weights[c].weight for c in range(C)]).T
        else:
            wv = torch.stack([model.attention_V[c][0].weight.T for c in range(C)])
            bv = torch.stack([model.attention_V[c][0].bias for c in range(C)])
            wu = torch.stack([model.attention_U[c][0].weight.T for c in range(C)])
            bu = torch.stack([model.attention_U[c][0].bias for c in range(C)])
            w_att = torch.cat([model.attention_weights[c].weight for c in range(C)])
        return GatedAttentionParams(
            w_V=wv.detach().contiguous(), b_V=bv.detach(),
            w_U=wu.detach().contiguous(), b_U=bu.detach(),
            w_att=w_att.detach().contiguous(),
            b_att=torch.cat([model.attention_weights[c].bias for c in range(C)]).detach(),
            w_cls=torch.cat([model.classifiers[c].weight for c in range(C)]).detach(),
        )

    def to(self, device=None, dtype=None) -> "GatedAttentionParams":
        return GatedAttentionParams(
            *(getattr(self, f).to(device=device, dtype=dtype) for f in
              ("w_V", "b_V", "w_U", "b_U", "w_att", "b_att", "w_cls"))
        )


def mc_head_reference(
    H: torch.Tensor,
    mask: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    feature_dropout: float,
    attention_dropout: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the MC head kernels: T head passes, sample t
    seeded with ``seed + t``.  Returns ``(Y (T, C), A (T, C, N))``.  Math in
    >= f32 (a bf16 embed is promoted, an f64 run stays f64)."""
    dt = torch.promote_types(H.dtype, torch.float32)
    p = params.to(H.device, dt)
    Hf = H.to(dt)
    mask = mask.to(H.device).bool()
    ys, attns = [], []
    for t in range(num_samples):
        key = (seed + t) & _MASK32
        Hd = _dropout(Hf, feature_dropout, key, FEATURE_DRAW) if feature_dropout > 0 else Hf
        if p.separate:
            V = torch.tanh(torch.einsum("nl,cld->cnd", Hd, p.w_V) + p.b_V[:, None, :])
            U = torch.sigmoid(torch.einsum("nl,cld->cnd", Hd, p.w_U) + p.b_U[:, None, :])
            logits = torch.einsum("cnd,cd->cn", V * U, p.w_att) + p.b_att[:, None]
        else:
            G = torch.tanh(Hd @ p.w_V + p.b_V) * torch.sigmoid(Hd @ p.w_U + p.b_U)
            logits = (G @ p.w_att + p.b_att).T  # (C, N)
        if attention_dropout > 0:
            # Element index n * C + c of the (N, C) logit matrix.
            logits = _dropout(logits.T, attention_dropout, key, ATTENTION_DRAW).T
        A = masked_softmax(logits, mask[None, :])
        M = A @ Hd  # (C, L)
        ys.append((M * p.w_cls).sum(-1))
        attns.append(A)
    return torch.stack(ys), torch.stack(attns)


def _kernel_operands(params: GatedAttentionParams, device) -> tuple[torch.Tensor, ...]:
    """``(wv, bv, wu, bu, wa_full, ba)`` in the kernel's layout: gates as
    (G, L, D) / (G, D), and the attention vectors as ``wa_full (C, G, D)``,
    zero off each class's own gate when the gates are separate."""
    p = params.to(device, torch.float32)
    if p.separate:
        wv, bv, wu, bu = p.w_V, p.b_V, p.w_U, p.b_U
        wa_full = torch.diag_embed(p.w_att.T).permute(1, 2, 0)  # (C, C, D)
    else:
        wv, bv, wu, bu = p.w_V[None], p.b_V[None], p.w_U[None], p.b_U[None]
        wa_full = p.w_att.T[:, None, :]  # (C, 1, D)
    return tuple(x.contiguous() for x in (wv, bv, wu, bu, wa_full, p.b_att))


def _mc_head_cuda(
    H: torch.Tensor,
    mask: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    p_feat: float,
    p_att: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/mc_head.cu``; returns ``(M (T, C, L), A (T, C, N))``."""
    kernel = cuda_build.KERNELS["mc_head_sep" if params.separate else "mc_head_shared"]
    dev = H.device
    Hc = H.to(torch.float32).contiguous()
    maskf = mask.to(device=dev, dtype=torch.float32).contiguous()
    wv, bv, wu, bu, wa_full, ba = _kernel_operands(params, dev)
    N, L = Hc.shape
    G, _, D = wv.shape
    C = ba.shape[0]
    T = num_samples
    cuda_build.require_cuda_f32(kernel.name, Hc, maskf, wv, bv, wu, bu, wa_full, ba)
    if wv.shape[1] != L or D % 4 or (G * D) % 32 or G * D > 1024 or not 1 <= C <= 8:
        raise ValueError(
            f"{kernel.name}: unsupported shapes N={N} L={L} D={D} C={C} G={G} "
            "(needs D % 4 == 0, G*D a multiple of 32 up to 1024, 1 <= C <= 8)"
        )
    logits = torch.empty((T, C, N), dtype=torch.float32, device=dev)
    A = torch.empty((T, C, N), dtype=torch.float32, device=dev)
    M = torch.empty((T, C, L), dtype=torch.float32, device=dev)
    fn = cuda_build.load(kernel.source).mc_head_forward
    fn.restype = ctypes.c_int
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
                   ctypes.c_uint, f32, f32, f32, f32, ptr, ptr, ptr, ptr]
    err = fn(
        Hc.data_ptr(), maskf.data_ptr(), N, L, D, C, G, T,
        wv.data_ptr(), bv.data_ptr(), wu.data_ptr(), bu.data_ptr(),
        wa_full.data_ptr(), ba.data_ptr(),
        seed & _MASK32, p_feat, 1.0 / (1.0 - p_feat), p_att, 1.0 / (1.0 - p_att),
        logits.data_ptr(), A.data_ptr(), M.data_ptr(), cuda_build.stream_handle(dev),
    )
    cuda_build.check(err, kernel.name)
    kernel.launches += 1
    return M, A


def mc_gated_attention(
    H: torch.Tensor,
    mask: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    feature_dropout: float = 0.1,
    attention_dropout: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All T MC samples of the gated-attention head.

    Counterpart of ``mc_gated_attention_fused``.  ``H (N, L)`` features,
    ``mask (N,)`` bool validity, sample t seeded with ``seed + t``.  Returns
    ``(Y (T, C) f32, A (T, C, N) f32)``.  A CUDA ``H`` launches the kernel
    (separate or shared gates, by ``params.w_V.ndim``); a CPU ``H`` runs the
    plain version.  ``Y = M w_cls`` stays a plain tensor op, as in JAX.
    """
    if not H.is_cuda:
        return mc_head_reference(
            H, mask, params, num_samples, seed, feature_dropout, attention_dropout
        )
    M, A = _mc_head_cuda(
        H, mask, params, num_samples, seed, float(feature_dropout), float(attention_dropout)
    )
    Y = torch.einsum("tcl,cl->tc", M, params.w_cls.to(device=H.device, dtype=torch.float32))
    return Y, A
