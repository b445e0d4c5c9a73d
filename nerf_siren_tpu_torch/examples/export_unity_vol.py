"""Export a .vol density volume for Unity Texture3D volume rendering (the
capability of the reference's extract_mesh.ipynb "Generate .vol" cell; see
docs/unity.md for the binary layout).

Counterpart of the JAX package's `examples/export_unity_vol.py`, with its
flags plus `--device`:

    python -m nerf_siren_tpu_torch.examples.export_unity_vol --ckpt_path ... \\
        [--N_grid 512 --sigma_max 100 --out scene.vol]

The sigma grid is `extract_color_mesh.py::predict_sigma_grid` (the fine
field's float32 plain forward, relu(sigma)); `write_vol` writes it.
"""
from __future__ import annotations

import argparse
import struct

import numpy as np


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--N_grid", type=int, default=512)
    parser.add_argument("--x_range", nargs="+", type=float, default=[-1.2, 1.2])
    parser.add_argument("--y_range", nargs="+", type=float, default=None)
    parser.add_argument("--z_range", nargs="+", type=float, default=None)
    parser.add_argument("--sigma_max", type=float, default=100.0,
                        help="sigma mapped to 255 in the quantized volume")
    parser.add_argument("--chunk", type=int, default=65536)
    parser.add_argument("--out", default="scene.vol")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; fails when no card is visible) or 'cpu'")
    args = parser.parse_args(argv)
    args.y_range = args.y_range or args.x_range
    args.z_range = args.z_range or args.x_range
    return args


def write_vol(path: str, sigma: np.ndarray, spacing, origin, sigma_max: float):
    """Write an (n, n, n) sigma grid as a .vol file: the grid size (3 int32),
    the box's min and max corners (3 float32 each), then sigma / sigma_max
    clipped to [0, 1] as n^3 bytes (x slowest). Returns the two corners."""
    q = np.clip(sigma / sigma_max, 0, 1)
    q = (q * 255).astype(np.uint8)
    n = sigma.shape[0]
    bb_min = np.asarray(origin, np.float32)
    bb_max = bb_min + np.asarray(spacing, np.float32) * (n - 1)
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", n, n, n))
        f.write(bb_min.tobytes())
        f.write(bb_max.tobytes())
        f.write(q.tobytes())
    return bb_min, bb_max


def main(args):
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.extract_color_mesh import load_fine, predict_sigma_grid

    device = resolve_device(args.device)
    fine = load_fine(args.ckpt_path, device)
    sigma, spacing, origin = predict_sigma_grid(fine, args, device)
    bb_min, bb_max = write_vol(args.out, sigma, spacing, origin, args.sigma_max)
    n = args.N_grid
    print(f"wrote {args.out}: {n}^3 voxels, bbox {bb_min.tolist()} .. {bb_max.tolist()}")


if __name__ == "__main__":
    main(get_opts())
