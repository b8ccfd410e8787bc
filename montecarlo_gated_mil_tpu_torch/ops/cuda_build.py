"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (Hopper) at first use and
loaded with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.
Builds go to ``csrc/build/`` inside the package, which ``.gitignore``
lists.  Nothing here runs at import time: the CPU tests import every module.

Every kernel has a :class:`Kernel` record with a launch counter that its
wrapper bumps once per launch, so a run can show which kernels its main
path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


@dataclass
class Kernel:
    """A hand-written kernel: where it lives, what TPU kernel it replaces,
    and how often the current run launched it."""

    name: str
    source: str  # file under csrc/
    replaces: str  # file:line of the Pallas kernel (or XLA-compiled function) it replaces
    launches: int = 0


# The __global__ functions each source launches, by the names a profiler
# shows (templates carry their arguments after the name).
DEVICE_FUNCTIONS: dict[str, tuple[str, ...]] = {
    "mc_head.cu": ("mc_fwd_tile_kernel", "mc_fwd_wgmma_kernel", "mc_fwd_finalize_kernel"),
    "mc_head_bwd.cu": (
        "bwd_gate_kernel", "bwd_dz_kernel", "bwd_dh_kernel", "bwd_dw_kernel", "bwd_reduce_kernel",
    ),
    "gather.cu": ("gather_tiles_kernel",),
    "qconv.cu": ("qconv_wgmma_kernel", "qconv_wgmma_pair_kernel", "qconv_gather_kernel"),
    "bn_quant.cu": (
        "bn_stats_kernel", "bn_stats_fold_kernel", "bn_relu_quant_kernel", "bn_relu_mean_kernel",
        "stem_pool_quant_kernel",
    ),
}

KERNELS: dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel(
            "mc_head_sep", "mc_head.cu",
            "montecarlo_gated_mil_tpu/ops/gated_attention.py:253",
        ),
        Kernel(
            "mc_head_shared", "mc_head.cu",
            "montecarlo_gated_mil_tpu/ops/gated_attention.py:163",
        ),
        Kernel(
            "gather_tiles", "gather.cu",
            "montecarlo_gated_mil_tpu/ops/patching.py:138",
        ),
        Kernel(
            "mc_head_bwd_sep", "mc_head_bwd.cu",
            "montecarlo_gated_mil_tpu/ops/gated_attention.py:538",
        ),
        Kernel(
            "mc_head_bwd_shared", "mc_head_bwd.cu",
            "montecarlo_gated_mil_tpu/ops/gated_attention.py:356",
        ),
        # The int8 embed's kernels replace XLA ops, not Pallas kernels.
        Kernel(
            "qconv_i8", "qconv.cu",
            "montecarlo_gated_mil_tpu/ops/quantized.py:370",
        ),
        Kernel(
            "bn_stats", "bn_quant.cu",
            "montecarlo_gated_mil_tpu/ops/quantized.py:409",
        ),
        # K7's fold of the per-tile sums that K6 takes in its epilogue.
        Kernel(
            "bn_stats_fold", "bn_quant.cu",
            "montecarlo_gated_mil_tpu/ops/quantized.py:409",
        ),
        Kernel(
            "bn_relu_quant", "bn_quant.cu",
            "montecarlo_gated_mil_tpu/ops/quantized.py:497",
        ),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # the source and the shared headers
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc): cannot build kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _start_build(source: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start ``nvcc`` for one source unless its library is already built."""
    out = _library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish_build(job: tuple[Path, Path, subprocess.Popen]) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build of the same hash is harmless


def build_all() -> list[str]:
    """Build every kernel library, one ``nvcc`` per source, all started
    together.  Returns the library paths."""
    sources = sorted({k.source for k in KERNELS.values()})
    with _lock:
        jobs = [j for j in (_start_build(s) for s in sources) if j is not None]
        for j in jobs:
            _finish_build(j)
    return [str(_library_path(s)) for s in sources]


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            job = _start_build(source)
            if job is not None:
                _finish_build(job)
            lib = ctypes.CDLL(str(_library_path(source)))
            _loaded[source] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous float32 CUDA tensors, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
