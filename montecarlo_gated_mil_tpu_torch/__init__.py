"""PyTorch/CUDA port of ``montecarlo_gated_mil_tpu`` for NVIDIA Hopper.

The JAX package is the reference this port is held against; the two share
no code.  Kernels are hand-written CUDA under ``csrc/``, built at first use.
"""
