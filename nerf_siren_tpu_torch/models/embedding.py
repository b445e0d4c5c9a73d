"""NeRF positional (Fourier-feature) encoding.

Counterpart of `nerf_siren_tpu/models/embedding.py`, same channel order:
``[x, sin(f0·x), cos(f0·x), sin(f1·x), cos(f1·x), ...]``.
"""
from __future__ import annotations

import torch


def embedding_out_channels(in_channels: int, n_freqs: int) -> int:
    return in_channels * (2 * n_freqs + 1)


def _freq_bands(n_freqs: int, logscale: bool, dtype, device) -> torch.Tensor:
    if logscale:
        # exact powers of two (a float pow may round 2^k), made on the device:
        # a copy from a host list cannot be captured into a CUDA graph
        return (1 << torch.arange(n_freqs, device=device)).to(dtype)
    return torch.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs, dtype=dtype, device=device)


def positional_encoding(x: torch.Tensor, n_freqs: int, logscale: bool = True) -> torch.Tensor:
    """Embed x (..., C) -> (..., C * (2*n_freqs + 1))."""
    if n_freqs == 0:
        return x
    freqs = _freq_bands(n_freqs, logscale, x.dtype, x.device)      # (F,)
    xb = x[..., None, None, :] * freqs[:, None, None]               # (..., F, 1, C)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-2)         # (..., F, 2, C)
    enc = enc.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
