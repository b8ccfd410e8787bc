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
its header for the design) and, where a gradient is asked for, differentiates
it with ``csrc/mc_head_bwd.cu`` through :class:`_MCHead`; on a CPU tensor, or
with ``kernel=False`` on any tensor, it runs :func:`mc_head_reference`, the
plain PyTorch version of the same function, under ordinary autograd.
:func:`mc_head_backward_reference` is the plain version of the backward
kernels.  All draw dropout from one
counter-based stream, Philox4x32-10 keyed on ``(seed + t, draw)``, element
``e`` taking word ``e % 4`` of counter ``e // 4``, so kernels and plain
versions agree with dropout on as well as off.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.ops import cuda_build
from montecarlo_gated_mil_tpu_torch.ops.masked import masked_softmax
from montecarlo_gated_mil_tpu_torch.utils.tf32 import tf32_off

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
    key: tuple,
) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 words; bit-exact with
    ``philox4x32_10`` in ``csrc/philox.cuh``.  A key word is an int or an
    int64 tensor that broadcasts against the counter."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_uniforms(key, draws, device) -> list[torch.Tensor]:
    """U[0,1) float32 for several draws of one key in one Philox call.

    ``draws`` is a sequence of ``(draw, n)`` or ``(draw, n, start)``; the
    result holds, for each, elements ``start..start+n-1`` of that draw
    (``start`` 0 by default).  Element ``e`` of draw ``d`` is the top 24
    bits of word ``e % 4`` of Philox at counter ``(e // 4, 0, 0, 0)`` and key
    ``(key, d)``, so one call serves four elements, and element ``e`` is the
    same word whoever draws it: a shard of rows draws exactly the uniforms
    the whole draw holds for them.  A ``start`` that is not a multiple of 4
    skips the first words of its first counter.

    ``key`` is one key, or a 1-D int64 tensor of T keys: then every result
    has a leading T axis, all T drawn in the same call."""
    if not draws:
        return []
    draws = [(d[0], d[1], d[2] if len(d) > 2 else 0) for d in draws]
    skips = [start % 4 for _, _, start in draws]
    groups = [(skip + n + 3) // 4 for (_, n, _), skip in zip(draws, skips)]
    counter = torch.cat([
        torch.arange(start // 4, start // 4 + g, dtype=torch.int64, device=device)
        for (_, _, start), g in zip(draws, groups)
    ])
    draw = torch.cat([torch.full((g,), d, dtype=torch.int64, device=device)
                      for (d, _, _), g in zip(draws, groups)])
    if isinstance(key, torch.Tensor):
        key, counter, draw = torch.broadcast_tensors(
            key.to(device=device, dtype=torch.int64)[:, None], counter, draw)
    zero = torch.zeros_like(counter)
    words = torch.stack(philox4x32_10((counter, zero, zero, zero), (key, draw)), -1)
    out = []
    for part, (_, n, _), skip in zip(torch.split(words, groups, dim=-2), draws, skips):
        flat = part.reshape(*part.shape[:-2], -1)[..., skip:skip + n]
        out.append((flat >> 8).to(torch.float32) * _INV_2_24)
    return out


def dropout_uniform(key: int, draw: int, n: int, device) -> torch.Tensor:
    """U[0,1) float32 for elements ``0..n-1`` of one draw
    (:func:`dropout_uniforms`)."""
    return dropout_uniforms(key, [(draw, n)], device)[0]


def apply_dropout(x: torch.Tensor, u: torch.Tensor, p: float) -> torch.Tensor:
    """``x * keep * (1/(1-p))`` with ``keep = u >= p``, element ``e`` of
    ``x`` (row-major) taking uniform ``e``, as the kernels do."""
    keep = u.view(x.shape) >= torch.tensor(p, dtype=torch.float32)
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


def _keep(shape, p: float, key: int, draw: int, device, dtype) -> torch.Tensor:
    """The 0/1 dropout mask ``u >= p`` of one draw, as the kernels draw it."""
    n = 1
    for s in shape:
        n *= s
    u = dropout_uniform(key, draw, n, device).view(shape)
    return (u >= torch.tensor(p, dtype=torch.float32)).to(dtype)


def _dropout(x: torch.Tensor, p: float, key: int, draw: int) -> torch.Tensor:
    """``x * keep * (1/(1-p))`` with ``keep = u >= p``, as the kernels do."""
    return apply_dropout(x, dropout_uniform(key, draw, x.numel(), x.device), p)


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
    def from_module(model, *, detach: bool = True) -> "GatedAttentionParams":
        """From the port's ``MultiHeadGatedAttentionMIL`` (reference schema:
        Linear weights are (out, in)).  ``detach=True`` gives a copy for
        inference, converted once; ``detach=False`` keeps the autograd graph
        to the module's parameters, so a loss on the head trains them."""
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
        p = GatedAttentionParams(
            w_V=wv.contiguous(), b_V=bv,
            w_U=wu.contiguous(), b_U=bu,
            w_att=w_att.contiguous(),
            b_att=torch.cat([model.attention_weights[c].bias for c in range(C)]),
            w_cls=torch.cat([model.classifiers[c].weight for c in range(C)]),
        )
        if detach:
            p = GatedAttentionParams(*(getattr(p, f).detach() for f in _FIELDS))
        return p

    def to(self, device=None, dtype=None) -> "GatedAttentionParams":
        return GatedAttentionParams(
            *(getattr(self, f).to(device=device, dtype=dtype) for f in _FIELDS)
        )


_HEAD_FIELDS = ("w_V", "b_V", "w_U", "b_U", "w_att", "b_att")  # what the kernels take
_FIELDS = _HEAD_FIELDS + ("w_cls",)


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
        Hd, logits = _sample_logits(Hf, p, (seed + t) & _MASK32, feature_dropout,
                                    attention_dropout)
        A = masked_softmax(logits, mask[None, :])
        M = A @ Hd  # (C, L)
        ys.append((M * p.w_cls).sum(-1))
        attns.append(A)
    return torch.stack(ys), torch.stack(attns)


def _sample_logits(
    Hf: torch.Tensor, p: GatedAttentionParams, key: int, feature_dropout: float,
    attention_dropout: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One sample of the plain version: the dropout-masked features
    ``Hd (N, L)`` and the logits ``(C, N)`` after attention dropout."""
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
    return Hd, logits


def mc_head_logits_reference(
    H: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    feature_dropout: float,
    attention_dropout: float,
) -> torch.Tensor:
    """The plain version's logits ``(T, C, N)`` after attention dropout: what
    the forward kernel holds before its softmax (``_mc_head_cuda(...,
    keep_logits=True)``).  In the dtype of ``H`` (at least f32): an f64 run
    is the exact product the kernel's tensor-core math is held to."""
    dt = torch.promote_types(H.dtype, torch.float32)
    p = params.to(H.device, dt)
    Hf = H.to(dt)
    return torch.stack([
        _sample_logits(Hf, p, (seed + t) & _MASK32, feature_dropout, attention_dropout)[1]
        for t in range(num_samples)
    ])


def mc_head_backward_reference(
    H: torch.Tensor,
    mask: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    feature_dropout: float,
    attention_dropout: float,
    dM: torch.Tensor,
    dA: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernels (K4/K5): the gradients
    of ``M (T, C, L)`` and ``A (T, C, N)`` of the T-sample head, given their
    cotangents ``dM`` and ``dA``, with respect to ``H`` and the head weights,
    summed over the samples.  Per sample it replays both dropout masks,
    recomputes gate, logits and softmax, and follows the JAX package's
    ``_mc_bwd_kernel(_sep)`` math.  Returns ``(dH, dw_V, db_V, dw_U, db_U,
    dw_att, db_att)`` in :class:`GatedAttentionParams` layout."""
    dt = torch.promote_types(H.dtype, torch.float32)
    p = params.to(H.device, dt)
    Hf = H.to(dt)
    N = Hf.shape[0]
    C = p.b_att.shape[0]
    mask = mask.to(H.device).bool()
    dM, dA = dM.to(dt), dA.to(dt)
    grads = [torch.zeros_like(getattr(p, f)) for f in _HEAD_FIELDS]
    dw_V, db_V, dw_U, db_U, dw_att, db_att = grads
    dH = torch.zeros_like(Hf)
    for t in range(num_samples):
        key = (seed + t) & _MASK32
        kf = ka = None
        Hd = Hf
        if feature_dropout > 0:
            kf = _keep(Hf.shape, feature_dropout, key, FEATURE_DRAW, H.device, dt)
            Hd = Hf * kf * (1.0 / (1.0 - feature_dropout))
        if p.separate:
            V = torch.tanh(torch.einsum("nl,cld->cnd", Hd, p.w_V) + p.b_V[:, None, :])
            U = torch.sigmoid(torch.einsum("nl,cld->cnd", Hd, p.w_U) + p.b_U[:, None, :])
            G = V * U  # (C, N, D)
            logits = torch.einsum("cnd,cd->cn", G, p.w_att) + p.b_att[:, None]
        else:
            V = torch.tanh(Hd @ p.w_V + p.b_V)
            U = torch.sigmoid(Hd @ p.w_U + p.b_U)
            G = V * U  # (N, D)
            logits = (G @ p.w_att + p.b_att).T
        if attention_dropout > 0:
            ka = _keep((N, C), attention_dropout, key, ATTENTION_DRAW, H.device, dt).T
            logits = logits * ka * (1.0 / (1.0 - attention_dropout))
        A = masked_softmax(logits, mask[None, :])  # (C, N)
        dAt = dA[t] + dM[t] @ Hd.T  # A feeds the output and M = A Hd
        dHd = A.T @ dM[t]
        # masked-softmax backward (padded rows have A == 0: zero gradient)
        dlg = A * (dAt - (dAt * A).sum(-1, keepdim=True))
        if ka is not None:
            dlg = dlg * ka * (1.0 / (1.0 - attention_dropout))
        db_att += dlg.sum(-1)
        if p.separate:
            dG = dlg[:, :, None] * p.w_att[:, None, :]
            dw_att += torch.einsum("cnd,cn->cd", G, dlg)
            dzv, dzu = dG * U * (1.0 - V * V), dG * V * U * (1.0 - U)
            dHd = dHd + torch.einsum("cnd,cld->nl", dzv, p.w_V) + torch.einsum(
                "cnd,cld->nl", dzu, p.w_U
            )
            dw_V += torch.einsum("nl,cnd->cld", Hd, dzv)
            dw_U += torch.einsum("nl,cnd->cld", Hd, dzu)
            db_V += dzv.sum(1)
            db_U += dzu.sum(1)
        else:
            dG = dlg.T @ p.w_att.T  # (N, D)
            dw_att += G.T @ dlg.T
            dzv, dzu = dG * U * (1.0 - V * V), dG * V * U * (1.0 - U)
            dHd = dHd + dzv @ p.w_V.T + dzu @ p.w_U.T
            dw_V += Hd.T @ dzv
            dw_U += Hd.T @ dzu
            db_V += dzv.sum(0)
            db_U += dzu.sum(0)
        dH += dHd * kf * (1.0 / (1.0 - feature_dropout)) if kf is not None else dHd
    return (dH, *grads)


def _kernel_operands(params: GatedAttentionParams, device) -> tuple[torch.Tensor, ...]:
    """``(wv, bv, wu, bu, wa_full, ba)`` in the kernel's layout: gates as
    (G, L, D) / (G, D), and the attention vectors as ``wa_full (C, G, D)``,
    zero off each class's own gate when the gates are separate.  Reads the
    six head fields only (``w_cls`` may be None)."""
    w_V, b_V, w_U, b_U, w_att, b_att = (
        getattr(params, f).to(device=device, dtype=torch.float32) for f in _HEAD_FIELDS
    )
    if params.separate:
        wv, bv, wu, bu = w_V, b_V, w_U, b_U
        wa_full = torch.diag_embed(w_att.T).permute(1, 2, 0)  # (C, C, D)
    else:
        wv, bv, wu, bu = w_V[None], b_V[None], w_U[None], b_U[None]
        wa_full = w_att.T[:, None, :]  # (C, 1, D)
    return tuple(x.contiguous() for x in (wv, bv, wu, bu, wa_full, b_att))


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of f32 ``x`` as ``split_tf32`` in ``csrc/mc_tile.cuh``:
    hi = tf32(x), lo = tf32(x - hi), each rounded on the bits to nearest,
    ties away from zero (add half a unit of the 13 dropped bits, clear
    them)."""

    def tf32(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)  # -0x2000 == 0xFFFFE000

    hi = tf32(x)
    return hi, tf32(x - hi)


def gate_split(wv: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """The gate weights as the forward kernel's wgmma pass reads them
    (``csrc/mc_head.cu``, ``mc_fwd_wgmma_kernel``): ``(2, G, D / 64, 128,
    L)``, the TF32 hi and lo planes of, for each gate and 64 columns of D,
    those columns of Wv then the same of Wu, each along L (K-major).
    ``wv``, ``wu``: (G, L, D) f32 with D % 64 == 0."""
    G, L, D = wv.shape
    w = torch.stack([wv, wu], 1).reshape(G, 2, L, D // 64, 64)  # (G, V|U, L, pass, 64)
    w = w.permute(0, 3, 1, 4, 2).reshape(G, D // 64, 128, L)
    return torch.stack(split_tf32(w)).contiguous()


# The split gate weights of a weight set, computed once per set: keyed on
# the id of the parameters' w_V tensor (dropped when it dies), and taken
# again only while w_V and w_U are the same tensors at the same version on
# the same device (an optimizer step bumps the version).  Tensors made in
# inference mode keep no version, so theirs is split at every call.
_gate_split_cache: dict[int, tuple] = {}


def _cached_gate_split(params: GatedAttentionParams, wv: torch.Tensor,
                       wu: torch.Tensor) -> torch.Tensor | None:
    if wv.shape[-1] % 64:
        return None  # the wgmma pass does not take these shapes
    key = params.w_V
    if key.is_inference() or params.w_U.is_inference():
        with torch.no_grad():
            return gate_split(wv, wu)
    tag = (wv.device, key._version, id(params.w_U), params.w_U._version)
    hit = _gate_split_cache.get(id(key))
    if hit is not None and hit[0]() is key and hit[1] == tag:
        return hit[2]
    with torch.no_grad():
        split = gate_split(wv, wu)
    ref = weakref.ref(key, lambda _, i=id(key): _gate_split_cache.pop(i, None))
    _gate_split_cache[id(key)] = (ref, tag, split)
    return split


def _check_shapes(name: str, N: int, L: int, wv: torch.Tensor, C: int, work: int) -> None:
    """Raise on shapes the kernels cannot take: ``work`` is the library's
    workspace size, -1 where ``shapes_ok`` in ``csrc/mc_tile.cuh`` refuses
    the shapes or a tile does not fit in shared memory."""
    G, L_w, D = wv.shape
    if L_w != L or work < 0:
        raise ValueError(
            f"{name}: unsupported shapes N={N} L={L} D={D} C={C} G={G} (needs L a multiple "
            "of 64, D a multiple of 32 up to 128, 1 <= C <= 8, G 1 or C, tiles that fit in "
            "shared memory)"
        )


def _mc_head_cuda(
    H: torch.Tensor,
    mask: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    p_feat: float,
    p_att: float,
    keep_logits: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Launch ``csrc/mc_head.cu``; returns ``(M (T, C, L), A (T, C, N))``.
    ``keep_logits`` adds the kernel's logits ``(T, C, N)`` after attention
    dropout, as its workspace holds them; only the rows of tiles that hold a
    valid row are written, the rest is undefined."""
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
    lib = cuda_build.load(kernel.source)
    i32, f32, ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    ws = lib.mc_head_forward_workspace
    ws.restype = ctypes.c_long
    ws.argtypes = [i32] * 6
    fn = lib.mc_head_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                   ctypes.c_uint, f32, f32, f32, f32, ptr, ptr, ptr, ptr]
    wsplit = _cached_gate_split(params, wv, wu)
    with torch.cuda.device(dev):  # the row plan and shared-memory limit are per device
        size = ws(N, L, D, C, G, T)
        _check_shapes(kernel.name, N, L, wv, C, size)
        work = torch.empty(size, dtype=torch.float32, device=dev)
        A = torch.empty((T, C, N), dtype=torch.float32, device=dev)
        M = torch.empty((T, C, L), dtype=torch.float32, device=dev)
        err = fn(
            Hc.data_ptr(), maskf.data_ptr(), N, L, D, C, G, T,
            wv.data_ptr(), bv.data_ptr(), wu.data_ptr(), bu.data_ptr(),
            wa_full.data_ptr(), ba.data_ptr(), None if wsplit is None else wsplit.data_ptr(),
            seed & _MASK32, p_feat, 1.0 / (1.0 - p_feat), p_att, 1.0 / (1.0 - p_att),
            work.data_ptr(), A.data_ptr(), M.data_ptr(), cuda_build.stream_handle(dev),
        )
    cuda_build.check(err, kernel.name)
    kernel.launches += 1
    if keep_logits:
        return M, A, work[: T * C * N].view(T, C, N)
    return M, A


def _mc_head_bwd_cuda(
    H: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    p_feat: float,
    p_att: float,
    A: torch.Tensor,
    dM: torch.Tensor,
    dA: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Launch ``csrc/mc_head_bwd.cu`` on the forward's inputs and saved
    ``A (T, C, N)``, with cotangents ``dM (T, C, L)``, ``dA (T, C, N)``.
    Returns ``(dH (N, L), dwv, dbv, dwu, dbu (kernel layout), dwa (C, D),
    dba (C,))``."""
    kernel = cuda_build.KERNELS["mc_head_bwd_sep" if params.separate else "mc_head_bwd_shared"]
    dev = H.device
    Hc = H.to(torch.float32).contiguous()
    wv, bv, wu, bu, wa_full, _ = _kernel_operands(params, dev)
    A, dM, dA = (x.to(device=dev, dtype=torch.float32).contiguous() for x in (A, dM, dA))
    N, L = Hc.shape
    G, _, D = wv.shape
    T, C = A.shape[0], A.shape[1]
    cuda_build.require_cuda_f32(kernel.name, Hc, wv, bv, wu, bu, wa_full, A, dM, dA)
    if A.shape != (T, C, N) or dA.shape != (T, C, N) or dM.shape != (T, C, L) or T != num_samples:
        raise ValueError(
            f"{kernel.name}: A {tuple(A.shape)}, dA {tuple(dA.shape)}, dM {tuple(dM.shape)} "
            f"do not fit T={num_samples} C={C} N={N} L={L}"
        )
    # Split-K slices of the weight gradient: about 128 rows of T*N each.
    slices = max(1, min(16, -(-T * N // 128)))
    lib = cuda_build.load(kernel.source)
    i32, f32, ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    ws = lib.mc_head_backward_workspace
    ws.restype = ctypes.c_long
    ws.argtypes = [i32] * 7
    fn = lib.mc_head_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                   ctypes.c_uint, f32, f32, f32, f32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                   ptr, ptr]
    with torch.cuda.device(dev):  # the row plan and shared-memory limits are per device
        size = ws(N, L, D, C, G, T, slices)
        _check_shapes(kernel.name, N, L, wv, C, size)
        work = torch.empty(size, dtype=torch.float32, device=dev)
        dH = torch.empty((N, L), dtype=torch.float32, device=dev)
        dwv, dwu = (torch.empty((G, L, D), dtype=torch.float32, device=dev) for _ in range(2))
        dbv, dbu = (torch.empty((G, D), dtype=torch.float32, device=dev) for _ in range(2))
        dwa = torch.empty((C, D), dtype=torch.float32, device=dev)
        dba = torch.empty((C,), dtype=torch.float32, device=dev)
        err = fn(
            Hc.data_ptr(), N, L, D, C, G, T, wv.data_ptr(), bv.data_ptr(), wu.data_ptr(),
            bu.data_ptr(), wa_full.data_ptr(), A.data_ptr(), dM.data_ptr(), dA.data_ptr(),
            seed & _MASK32, p_feat, 1.0 / (1.0 - p_feat), p_att, 1.0 / (1.0 - p_att), slices,
            work.data_ptr(), dH.data_ptr(), dwv.data_ptr(), dbv.data_ptr(), dwu.data_ptr(),
            dbu.data_ptr(), dwa.data_ptr(), dba.data_ptr(), cuda_build.stream_handle(dev),
        )
    cuda_build.check(err, kernel.name)
    kernel.launches += 1
    return dH, dwv, dbv, dwu, dbu, dwa, dba


def param_layout_grads(separate: bool, dwv, dbv, dwu, dbu, dwa, dba) -> tuple[torch.Tensor, ...]:
    """The backward kernel's weight gradients in :class:`GatedAttentionParams`
    layout: ``(dw_V, db_V, dw_U, db_U, dw_att, db_att)``."""
    if separate:
        return dwv, dbv, dwu, dbu, dwa, dba
    return dwv[0], dbv[0], dwu[0], dbu[0], dwa.T, dba


class _MCHead(torch.autograd.Function):
    """The MC head on the card with a gradient: forward K1/K2, backward
    K4/K5.  Saves the forward's inputs and its output ``A``; the backward
    kernels replay the dropout masks from the seed and recompute the rest."""

    @staticmethod
    def forward(ctx, H, mask, w_V, b_V, w_U, b_U, w_att, b_att, num_samples, seed, p_feat, p_att):
        params = GatedAttentionParams(w_V, b_V, w_U, b_U, w_att, b_att, None)
        M, A = _mc_head_cuda(H, mask, params, num_samples, seed, p_feat, p_att)
        ctx.save_for_backward(H, w_V, b_V, w_U, b_U, w_att, b_att, A)
        ctx.args = (num_samples, seed, p_feat, p_att)
        return M, A

    @staticmethod
    def backward(ctx, dM, dA):
        H, *weights, A = ctx.saved_tensors
        params = GatedAttentionParams(*weights, None)
        dM = torch.zeros((A.shape[0], A.shape[1], H.shape[1]), device=H.device) if dM is None else dM
        dA = torch.zeros_like(A) if dA is None else dA
        dH, *grads = _mc_head_bwd_cuda(H, params, *ctx.args, A, dM, dA)
        grads = param_layout_grads(params.separate, *grads)
        grads = tuple(g.to(w.dtype) for g, w in zip(grads, weights))
        return (dH.to(H.dtype), None, *grads, None, None, None, None)


def use_pallas_from(cfg, use_pallas: bool | None = None) -> bool | None:
    """The head switch: ``use_pallas`` where the caller gives one (or where
    there is no config), else what ``cfg`` asks for --
    ``tpu.use_pallas_attention: true`` gives ``None`` (the head's kernels on
    the card), ``false`` gives ``False`` (the plain head on the card too),
    as JAX's ``serve.py`` maps it."""
    if use_pallas is not None or cfg is None:
        return use_pallas
    return None if cfg.tpu.use_pallas_attention else False


def kernel_on(use_pallas: bool | None) -> bool:
    """Whether the head runs its kernels on a CUDA tensor under the switch
    ``use_pallas``: unless it is ``False``.  This is
    :func:`mc_gated_attention`'s ``kernel``."""
    return use_pallas is not False


def mc_gated_attention(
    H: torch.Tensor,
    mask: torch.Tensor,
    params: GatedAttentionParams,
    num_samples: int,
    seed: int,
    feature_dropout: float = 0.1,
    attention_dropout: float = 0.1,
    *,
    kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All T MC samples of the gated-attention head.

    Counterpart of ``mc_gated_attention_fused``.  ``H (N, L)`` features,
    ``mask (N,)`` bool validity, sample t seeded with ``seed + t``.  Returns
    ``(Y (T, C) f32, A (T, C, N) f32)``.  A CUDA ``H`` launches the kernel
    (separate or shared gates, by ``params.w_V.ndim``) through
    :class:`_MCHead`, whose backward is the K4/K5 kernel; where autograd
    does not record, that is the forward kernel alone.  A CPU ``H`` runs
    the plain version under ordinary autograd.  ``Y = M w_cls`` stays a
    plain tensor op, as in JAX.

    ``kernel=False`` (the JAX package's ``use_pallas=False``) runs the plain
    version on a CUDA ``H`` too, its products in full f32 whatever the
    process's TF32 flag for matrix products (the kernels compute in 3xTF32,
    about f32), and its backward by autograd.
    """
    if not H.is_cuda:
        return mc_head_reference(
            H, mask, params, num_samples, seed, feature_dropout, attention_dropout
        )
    if not kernel:
        with tf32_off("matmul"):
            return mc_head_reference(
                H, mask, params, num_samples, seed, feature_dropout, attention_dropout
            )
    weights = [getattr(params, f) for f in _HEAD_FIELDS]
    M, A = _MCHead.apply(
        H, mask, *weights, num_samples, seed, float(feature_dropout), float(attention_dropout)
    )
    Y = torch.einsum("tcl,cl->tc", M, params.w_cls.to(device=H.device, dtype=torch.float32))
    return Y, A
