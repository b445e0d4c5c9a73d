"""PyTorch + CUDA port of `nerf_siren_tpu`, for one NVIDIA H100.

The JAX package `nerf_siren_tpu` is the reference: every module here mirrors
a module of the same name there and is tested against it on the same inputs.
Plain tensor code is PyTorch; the TPU Pallas kernels on the ported paths are
kernels written by hand for Hopper under `csrc/`, each with a plain PyTorch
version beside its wrapper (`ops/kernels/`).

Only `nerf_siren_tpu.config` (framework-free dataclasses) is imported from the
reference package at module level, through `nerf_siren_tpu_torch.config`.
"""
