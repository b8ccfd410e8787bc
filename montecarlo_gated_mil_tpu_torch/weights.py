"""JAX parameter tree -> the port's ``state_dict``.

The inverse of ``montecarlo_gated_mil_tpu/models/port.py``: that module
turns a reference-schema torch state_dict into the JAX package's flax
parameters; this one turns flax parameters (as numpy arrays) back into the
reference schema, which is the port's own.  With both, the two packages run
the same weights and compute the same function.

Layout conversions:
  conv kernel  (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
  Linear       (I, O)         -> (O, I)
  BN scale/bias               -> weight/bias
  stacked per-class w_V/w_U (C, L, D), w_att (C, D, 1), b_att (C, 1),
  w_cls (C, L, 1)             -> per-class ``attention_V.{i}.0``,
                                 ``attention_weights.{i}``, ``classifiers.{i}``
  single-head w_V/w_U (L, D), w_att (D, K), w_cls (L*K, C), b_cls (C,)
                              -> ``attention_V.0``, ``attention_U.0``,
                                 ``attention_weights``, ``classifier.0``
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_RENAME = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def backbone_from_jax(features: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """A ``ResNetFeatures`` parameter tree -> torchvision-named tensors.

    Walks the tree, so any stage layout converts: ``layer{s}_{b}`` becomes
    ``layer{s}.{b}``, ``downsample_conv``/``downsample_bn`` become
    ``downsample.0``/``downsample.1``.
    """
    out: dict[str, torch.Tensor] = {}
    for name, sub in features.items():
        if name.startswith("layer"):
            stage, block = name[len("layer"):].split("_")
            out.update(backbone_from_jax(sub, f"{prefix}layer{stage}.{block}."))
            continue
        key = prefix + _RENAME.get(name, name)
        if "kernel" in sub:
            out[key + ".weight"] = _t(np.asarray(sub["kernel"]).transpose(3, 2, 0, 1))
        else:
            out[key + ".weight"] = _t(sub["scale"])
            out[key + ".bias"] = _t(sub["bias"])
    return out


def from_jax_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``MultiHeadGatedAttentionMIL`` flax params (with or without the
    ``{"params": ...}`` wrapper) -> the port's state_dict."""
    p = params.get("params", params)
    sd = backbone_from_jax(p["features"], "feature_extractor.")
    w_V = np.asarray(p["w_V"])
    if w_V.ndim == 2:  # shared gate
        for gate in ("V", "U"):
            sd[f"attention_{gate}.0.weight"] = _t(np.asarray(p[f"w_{gate}"]).T)
            sd[f"attention_{gate}.0.bias"] = _t(p[f"b_{gate}"])
    else:
        for gate in ("V", "U"):
            w, b = np.asarray(p[f"w_{gate}"]), np.asarray(p[f"b_{gate}"])
            for i in range(w.shape[0]):
                sd[f"attention_{gate}.{i}.0.weight"] = _t(w[i].T)
                sd[f"attention_{gate}.{i}.0.bias"] = _t(b[i])
    w_att, b_att, w_cls = (np.asarray(p[k]) for k in ("w_att", "b_att", "w_cls"))
    for i in range(w_att.shape[0]):
        sd[f"attention_weights.{i}.weight"] = _t(w_att[i].T)  # (D, 1) -> (1, D)
        sd[f"attention_weights.{i}.bias"] = _t(b_att[i])  # (1,)
        sd[f"classifiers.{i}.weight"] = _t(w_cls[i].T)  # (L, 1) -> (1, L)
    return sd


def from_jax_singlehead_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``GatedAttentionMIL`` flax params (with or without the
    ``{"params": ...}`` wrapper) -> the port's state_dict: the inverse of
    ``models/port.py::port_singlehead_gamil``."""
    p = params.get("params", params)
    sd = backbone_from_jax(p["features"], "feature_extractor.")
    for key, w, b in (("attention_V.0", "w_V", "b_V"), ("attention_U.0", "w_U", "b_U"),
                      ("attention_weights", "w_att", "b_att"), ("classifier.0", "w_cls", "b_cls")):
        sd[f"{key}.weight"] = _t(np.asarray(p[w]).T)  # (in, out) -> (out, in)
        sd[f"{key}.bias"] = _t(p[b])
    return sd
