"""2D convolution with optional up/downsampling.

Counterpart of `nerf_siren_tpu/ops/conv2d_resample.py` (the reference's
`torch_utils/ops/conv2d_resample.py` generic path): pad once, zero-stuff
and FIR-filter to upsample, convolve, FIR-filter and decimate to
downsample. `flip_weight=True` is correlation (`F.conv2d`); False flips
the kernel (a true convolution).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from nerf_siren_tpu_torch.ops.upfirdn2d import _parse_padding, upfirdn2d


def conv2d(x: torch.Tensor, w: torch.Tensor, padding=0, stride: int = 1,
           groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """F.conv2d with the JAX package's `flip_weight`. w: (O, I // groups, kh, kw)."""
    if not flip_weight and w.shape[-1] > 1:
        w = w.flip([-2, -1])
    if not isinstance(padding, int):
        padding = tuple(padding)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[torch.Tensor] = None,
                    up: int = 1, down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True, flip_filter: bool = False) -> torch.Tensor:
    fw = f.shape[-1] if f is not None else 1
    fh = f.shape[0] if f is not None else 1
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if down > 1 and up == 1:
        # filter + pad, then a strided convolution (reference fast path 3)
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    # generic: upsample (+ filter) with the adjusted padding, then convolve
    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2, flip_filter=flip_filter)
    x = conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
