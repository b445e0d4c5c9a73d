"""Row-wise searchsorted.

Counterpart of `nerf_siren_tpu/ops/searchsorted.py`. The JAX package builds
it from an all-pairs comparison because that suits the TPU's vector unit;
on the GPU `torch.searchsorted` is the reference's own call.
"""
from __future__ import annotations

import torch


def searchsorted(sorted_sequence: torch.Tensor, values: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """Insertion indices in [0, A] of `values` (..., V) into the rows of
    `sorted_sequence` (..., A); leading dims broadcast.

    side='left': first index that keeps order; 'right': last such index
    (numpy semantics). Returns int64 indices.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    lead = torch.broadcast_shapes(sorted_sequence.shape[:-1], values.shape[:-1])
    seq = sorted_sequence.expand(*lead, sorted_sequence.shape[-1]).contiguous()
    vals = values.expand(*lead, values.shape[-1]).contiguous()
    return torch.searchsorted(seq, vals, right=(side == "right"))
