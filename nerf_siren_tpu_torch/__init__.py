"""PyTorch + CUDA port of `nerf_siren_tpu`, for one NVIDIA H100.

The JAX package `nerf_siren_tpu` is the reference: every module here mirrors
a module of the same name there and is tested against it on the same inputs.
Plain tensor code is PyTorch; the TPU Pallas kernels on the ported paths are
kernels written by hand for Hopper under `csrc/`, each with a plain PyTorch
version beside its wrapper (`ops/kernels/`).

The port imports nothing of the JAX package, not even its framework-free
modules: it keeps its own copies (`config.py`, `datasets/`, `opt.py`,
`utils/data.py`). `tests/test_torch_no_jax_imports.py` holds it to that.
"""
