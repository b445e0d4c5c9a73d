"""filtered_lrelu: StyleGAN3's upsample -> bias -> leaky ReLU -> clamp ->
downsample.

Counterpart of `nerf_siren_tpu/ops/filtered_lrelu.py`, composed of the
port's `bias_act` and `upfirdn2d` (the reference path's semantics; the
reference's CUDA implementation is never called by the repo, and neither
package has a caller: it is kept for completeness).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from nerf_siren_tpu_torch.ops.bias_act import bias_act
from nerf_siren_tpu_torch.ops.upfirdn2d import upfirdn2d


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                   fd: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
                   up: int = 1, down: int = 1, padding=0, gain: float = math.sqrt(2),
                   slope: float = 0.2, clamp: Optional[float] = None) -> torch.Tensor:
    """y = downsample(fd, clamp(lrelu(upsample(fu, x + b)) * gain)).

    The bias first, a zero-stuffing upsample by `fu` (gain up^2), the leaky
    ReLU with `gain`, an optional +-clamp, FIR decimation by `fd`. The
    padding applies to the upsampled grid."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down)
