"""Mesh-extraction parameter search (the headless version of the
reference's extract_mesh.ipynb): sweep sigma thresholds over a coarse grid
and report mesh statistics, to pick `--sigma_threshold` for
`extract_color_mesh`.

Counterpart of the JAX package's `examples/mesh_threshold_sweep.py`, with
its flags plus `--device`:

    python -m nerf_siren_tpu_torch.examples.mesh_threshold_sweep --ckpt_path ... \\
        [--N_grid 128 --thresholds 5 10 20 50]

The sigma grid is `extract_color_mesh.py::predict_sigma_grid`; `sweep`
runs marching tetrahedra (`mesh/marching.py`) at each threshold.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--N_grid", type=int, default=128)
    parser.add_argument("--x_range", nargs="+", type=float, default=[-1.2, 1.2])
    parser.add_argument("--thresholds", nargs="+", type=float,
                        default=[2, 5, 10, 20, 50])
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; fails when no card is visible) or 'cpu'")
    args = parser.parse_args(argv)
    args.y_range = args.z_range = args.x_range
    args.chunk = 65536
    return args


def sweep(sigma: np.ndarray, thresholds, spacing, origin
          ) -> List[Tuple[float, int, int, float]]:
    """(threshold, vertices, faces, the largest connected component's share
    of the faces) at each threshold."""
    from nerf_siren_tpu_torch.mesh.marching import (largest_connected_component,
                                                    marching_tetrahedra)

    rows = []
    for t in thresholds:
        verts, faces = marching_tetrahedra(sigma, t, spacing, origin)
        if len(verts):
            _, f2, _ = largest_connected_component(verts, faces)
            frac = len(f2) / max(len(faces), 1)
        else:
            frac = 0.0
        rows.append((float(t), len(verts), len(faces), frac))
    return rows


def main(args):
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.extract_color_mesh import load_fine, predict_sigma_grid

    device = resolve_device(args.device)
    fine = load_fine(args.ckpt_path, device)
    sigma, spacing, origin = predict_sigma_grid(fine, args, device)
    print(f"sigma grid {sigma.shape}: min={sigma.min():.2f} "
          f"mean={sigma.mean():.2f} max={sigma.max():.2f}")
    print(f"{'threshold':>10} {'vertices':>10} {'faces':>10} {'largest-cc':>10}")
    rows = sweep(sigma, args.thresholds, spacing, origin)
    for t, n_verts, n_faces, frac in rows:
        print(f"{t:>10.1f} {n_verts:>10} {n_faces:>10} {frac:>9.0%}")
    return rows


if __name__ == "__main__":
    main(get_opts())
