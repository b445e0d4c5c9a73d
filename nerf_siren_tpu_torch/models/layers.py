"""Linear layers with the reference's init and an optional bf16 compute type.

Counterpart of `nerf_siren_tpu/models/layers.py`. Weights are torch-layout
`(out, in)` `nn.Linear`s; `convert.py` maps them to and from the JAX
`kernel (in, out)` trees.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def init_linear(in_dim: int, out_dim: int, *,
                generator: Optional[torch.Generator] = None,
                device=None, dtype=torch.float32) -> nn.Linear:
    """Torch-default Linear init, U(-1/sqrt(in), 1/sqrt(in)) for weight and
    bias, drawn from `generator` (the global RNG is left untouched)."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim,
                               device="cpu" if device is None else device, dtype=dtype)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear(layer: nn.Linear, x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x W^T + b with float32 accumulation.

    With `compute_dtype` (bf16) the operands are rounded to it and multiplied
    in float32, which is what the JAX `preferred_element_type=float32` dot
    computes: products of bf16 values are exact in float32, so only the
    summation order differs. (A bf16 `torch.matmul` would round the result
    to bf16 as well.) On CUDA this assumes TF32 matmuls are off, the default.
    """
    w = layer.weight
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    return nn.functional.linear(x, w, layer.bias.float())
