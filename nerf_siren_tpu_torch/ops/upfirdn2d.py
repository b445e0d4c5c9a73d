"""upfirdn2d: zero-stuffing upsample, pad or crop, FIR filter, decimate.

Counterpart of `nerf_siren_tpu/ops/upfirdn2d.py` (the reference's
`torch_utils/ops/upfirdn2d.py` plain path and helpers). The depthwise FIR
is `F.conv2d(groups=C)` with the filter flipped unless `flip_filter`, as
there; no hand kernel (the JAX package has none either).

Layout: NCHW activations; filters are 1-D or 2-D float32 tensors from
`setup_filter` (normalised; [1, 3, 3, 1] becomes its 4x4 outer product).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def setup_filter(f, normalize: bool = True, gain: float = 1.0,
                 device=None) -> torch.Tensor:
    """A FIR filter as upfirdn2d takes it (reference upfirdn2d.py:21-61)."""
    if f is None:
        f = [1.0]
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.ndim == 0:
        f = f[None]
    separable = f.ndim == 1 and f.numel() >= 8
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    return f * (gain ** (f.ndim / 2))


def _parse_padding(padding) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    return tuple(padding)


def _parse_scaling(s) -> Tuple[int, int]:
    if isinstance(s, int):
        return s, s
    return tuple(s)


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """x: (N, C, H, W) -> filtered and resampled (N, C, H', W')."""
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    n, c, in_h, in_w = x.shape

    if upx > 1 or upy > 1:   # zero insertion
        x = x.reshape(n, c, in_h, 1, in_w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, in_h * upy, in_w * upx)

    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0),
          max(-px0, 0): x.shape[3] - max(-px1, 0)]

    fk = (f * (gain ** (f.ndim / 2))).to(x.dtype)
    if not flip_filter:
        fk = fk.flip(list(range(fk.ndim)))

    def depthwise(x, kern):
        kh, kw = kern.shape[-2], kern.shape[-1]
        return F.conv2d(x, kern.reshape(1, 1, kh, kw).expand(c, 1, kh, kw), groups=c)

    if fk.ndim == 2:
        x = depthwise(x, fk)
    else:   # separable 1-D: vertical, then horizontal
        x = depthwise(x, fk.reshape(-1, 1))
        x = depthwise(x, fk.reshape(1, -1))
    return x[:, :, ::downy, ::downx]


def _filter_size(f) -> Tuple[int, int]:
    if f is None:
        return 1, 1
    return f.shape[-1], f.shape[0]


def upsample2d(x, f, up=2, padding=0, gain: float = 1.0) -> torch.Tensor:
    """(reference upfirdn2d.py:312-340)."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, gain: float = 1.0) -> torch.Tensor:
    """(reference upfirdn2d.py:361-391)."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, gain=gain)


def filter2d(x, f, padding=0, gain: float = 1.0) -> torch.Tensor:
    """(reference upfirdn2d.py:279-310)."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, gain=gain)
