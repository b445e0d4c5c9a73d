"""Bilinear grid sampling with `F.grid_sample`'s semantics (mode 'bilinear',
padding 'zeros', align_corners=False): the triplane sampling op.

Counterpart of `nerf_siren_tpu/ops/grid_sample.py`:
- `grid_sample_2d`: the 4-corner form on (B, C, H, W) features;
- `grid_sample_3d`: trilinear samples of (B, C, D, H, W) volumes, the 8
  corners gathered with zeros outside (JAX has no caller for it either);
- `pack_grid_for_block_sample` / `grid_sample_2d_packed`: the same function
  on a channel-last table with a 1-texel zero border, where the four
  corners of a point are rows iy0+1, iy0+2 and columns ix0+1, ix0+2 of the
  table (`packed_corner_block`). This is the plain version of the triplane gather kernel K5
  (`ops/kernels/triplane_gather.py`, `csrc/triplane_gather.cu`), which
  rounds at the same points in the same order.

The port computes these itself rather than calling `F.grid_sample`, so the
rounding order is the JAX package's (and the kernel's); `F.grid_sample` is
the yardstick the tests and the smoke hold them to.
"""
from __future__ import annotations

import torch


def _corner_coords(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Unnormalised coordinates, their floors and the bilinear weights."""
    ix = ((x + 1) * w - 1) / 2
    iy = ((y + 1) * h - 1) / 2
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    return ix0, iy0, ix - ix0, iy - iy0


def grid_sample_2d(features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (B, C, H, W) features at (B, M, 2) normalised (x, y) coords in
    [-1, 1] (x indexes the width) -> (B, M, C)."""
    b, c, h, w = features.shape
    ix0, iy0, wx1, wy1 = _corner_coords(coords[..., 0], coords[..., 1], h, w)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = features.reshape(b, c, h * w)

    def gather(iy_, ix_):
        mask = (ix_ >= 0) & (ix_ < w) & (iy_ >= 0) & (iy_ < h)
        idx = (iy_.clamp(0, h - 1) * w + ix_.clamp(0, w - 1)).nan_to_num(0.0).long()
        out = flat.gather(2, idx[:, None, :].expand(b, c, idx.shape[1]))   # (B, C, M)
        return torch.where(mask[:, None, :], out, 0.0)

    out = (gather(iy0, ix0) * (wy0 * wx0)[:, None, :]
           + gather(iy0, ix0 + 1) * (wy0 * wx1)[:, None, :]
           + gather(iy0 + 1, ix0) * (wy1 * wx0)[:, None, :]
           + gather(iy0 + 1, ix0 + 1) * (wy1 * wx1)[:, None, :])
    return out.transpose(1, 2)


def pack_grid_for_block_sample(features: torch.Tensor,
                               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, C, H, W) -> (B, H+2, W+2, C) zero-bordered channel-last table.

    The border makes the clamped 2x2 corner block exact for every corner
    index in [-1, size-1]: a corner that falls on the border reads the zero
    that zeros padding asks for."""
    t = features.permute(0, 2, 3, 1).to(dtype)
    return torch.nn.functional.pad(t, [0, 0, 1, 1, 1, 1]).contiguous()


def grid_sample_2d_packed(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample_2d on a pack_grid_for_block_sample table.

    table (B, H+2, W+2, C), coords (B, M, 2) -> (B, M, C) float32. For each
    point: ix = ((x + 1) W - 1) / 2, ix0 = floor(ix), wx1 = ix - ix0 (y
    alike); the corners at table rows iy0+1, iy0+2 and columns ix0+1,
    ix0+2, clamped into the table; out = b00 (wy0 wx0) + b01 (wy0 wx1) +
    b10 (wy1 wx0) + b11 (wy1 wx1), summed left to right; times 0 where
    ix0 or iy0 lies outside [-1, size-1] (beyond the border every corner is
    zero, and the clamped block would read others)."""
    b, hp, wp, c = table.shape
    r0, c0, wx1, wy1, valid = packed_corner_block(coords, hp - 2, wp - 2)
    wx1, wy1 = wx1[..., None], wy1[..., None]
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    bi = torch.arange(b, device=table.device)[:, None]

    def corner(dr, dc):
        return table[bi, r0 + dr, c0 + dc].float()                        # (B, M, C)

    out = (corner(0, 0) * (wy0 * wx0) + corner(0, 1) * (wy0 * wx1)
           + corner(1, 0) * (wy1 * wx0) + corner(1, 1) * (wy1 * wx1))
    return out * valid[..., None]


def packed_corner_block(coords: torch.Tensor, h: int, w: int):
    """Where grid_sample_2d_packed reads, for (..., 2) coords on an h x w
    grid: the table row r0 and column c0 of each point's 2x2 corner block
    (clamped into the table; long), the weights wx1, wy1 of its second
    column and row, and whether the point samples the grid at all."""
    ix0, iy0, wx1, wy1 = _corner_coords(coords[..., 0], coords[..., 1], h, w)
    r0 = (iy0 + 1).nan_to_num(0.0).clamp(0, h).long()
    c0 = (ix0 + 1).nan_to_num(0.0).clamp(0, w).long()
    valid = (ix0 >= -1) & (ix0 <= w - 1) & (iy0 >= -1) & (iy0 <= h - 1)
    return r0, c0, wx1, wy1, valid


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (B, C, D, H, W) at (B, M, 3) normalised (x, y, z) coords; x
    indexes W, y H and z D (`F.grid_sample`'s convention: trilinear, zeros
    padding, align_corners=False) -> (B, M, C). The eight corners are summed
    in JAX's order: z outermost, then y, then x."""
    b, c, d, h, w = grid.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    ix = ((x + 1) * w - 1) / 2
    iy = ((y + 1) * h - 1) / 2
    iz = ((z + 1) * d - 1) / 2
    ix0, iy0, iz0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    fx, fy, fz = ix - ix0, iy - iy0, iz - iz0
    flat = grid.reshape(b, c, d * h * w)

    def gather(iz_, iy_, ix_):
        mask = (ix_ >= 0) & (ix_ < w) & (iy_ >= 0) & (iy_ < h) & (iz_ >= 0) & (iz_ < d)
        idx = ((iz_.clamp(0, d - 1) * h + iy_.clamp(0, h - 1)) * w
               + ix_.clamp(0, w - 1)).nan_to_num(0.0).long()
        out = flat.gather(2, idx[:, None, :].expand(b, c, idx.shape[1]))   # (B, C, M)
        return torch.where(mask[:, None, :], out, 0.0)

    out = 0.0
    for cz, wz in ((iz0, 1 - fz), (iz0 + 1, fz)):
        for cy, wy in ((iy0, 1 - fy), (iy0 + 1, fy)):
            for cx, wx in ((ix0, 1 - fx), (ix0 + 1, fx)):
                out = out + gather(cz, cy, cx) * (wz * wy * wx)[:, None, :]
    return out.transpose(1, 2)
