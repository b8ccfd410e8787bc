"""What the tools share: their start, the main path's settings, the shipped
model and the kernel-table lines."""

from __future__ import annotations

import argparse
import contextlib

import torch

from montecarlo_gated_mil_tpu_torch.utils.profiling import device_line


def ints(text: str) -> tuple[int, ...]:
    """``"2,6,12"`` -> ``(2, 6, 12)`` (argparse type)."""
    return tuple(int(x) for x in text.split(",") if x)


def parser(doc: str) -> argparse.ArgumentParser:
    return argparse.ArgumentParser(description=doc.strip().splitlines()[0])


def slope_args(ap: argparse.ArgumentParser, ks=(2, 6, 12), reps: int = 4) -> None:
    """The chained slope's lengths and repeats (``utils/profiling.py``)."""
    ap.add_argument("--ks", type=ints, default=ks, help="chain lengths (three)")
    ap.add_argument("--reps", type=int, default=reps, help="timed runs per chain length")


def start(device) -> torch.device:
    """The device, its line printed first (``nvidia-smi``'s name and power
    limit, or ``cpu``)."""
    device = torch.device(device)
    print(device_line(device), flush=True)
    return device


@contextlib.contextmanager
def main_path_settings():
    """The main path's numerics as ``chip_smoke.py`` drives it: cuDNN
    chooses its algorithms by its defaults (no autotuning, not
    deterministic), and no convolution or matrix product runs in TF32.
    The model turns TF32 off around its float32 forward convolutions
    (``models/resnet.py::_exact_float_convs``), but autograd runs their
    backward outside that context, so the setting is global here."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def shipped_model(device, cfg=None, dtype: str | None = None, seed: int = 0):
    """The shipped configuration's model (``Config()`` unless ``cfg``) with
    seeded weights, in eval mode; ``dtype`` overrides its compute dtype."""
    from dataclasses import replace

    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.experiment import build_model

    cfg = cfg or Config()
    if dtype is not None:
        cfg = replace(cfg, tpu=replace(cfg.tpu, compute_dtype=dtype))
    return build_model(cfg, seed=seed).to(device).eval()


def ms(seconds: float) -> str:
    return f"{seconds * 1e3:.3f} ms"
