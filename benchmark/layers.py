"""The port's hand-written kernels by the device-function names a profiler
records (a frozen copy of ``ops/cuda_build.py::DEVICE_FUNCTIONS``), so the
trace can be split into the port's kernels and everything else (cuDNN,
cuBLAS and PyTorch's own kernels)."""

from __future__ import annotations

PORT_KERNELS: dict[str, tuple[str, ...]] = {
    "K1": ("mc_fwd_tile_kernel", "mc_fwd_wgmma_kernel", "mc_fwd_finalize_kernel"),
    "K4/K5": ("bwd_gate_kernel", "bwd_dz_kernel", "bwd_dh_kernel", "bwd_dw_kernel",
              "bwd_reduce_kernel"),
    "K3": ("gather_tiles_kernel",),
    "K6": ("qconv_wgmma_kernel", "qconv_wgmma_pair_kernel", "qconv_gather_kernel"),
    "K7/K8": ("bn_stats_kernel", "bn_stats_fold_kernel", "bn_relu_quant_kernel",
              "bn_relu_mean_kernel", "stem_pool_quant_kernel"),
}

K1_WGMMA_OR_TILE = ("mc_fwd_tile_kernel", "mc_fwd_wgmma_kernel")
K6_CONV = ("qconv_wgmma_kernel", "qconv_wgmma_pair_kernel")


def kernel_of(name: str) -> str | None:
    """The port kernel a recorded device function belongs to, or None for
    a library's (or PyTorch's) kernel."""
    for k, funcs in PORT_KERNELS.items():
        if any(f in name for f in funcs):
            return k
    return None
