"""EG3D mesh extraction CLI of the port:
`python -m nerf_siren_tpu_torch.extract_color_mesh_eg3d`.

Counterpart of the JAX package's root `extract_color_mesh_eg3d.py`, with
its flags and defaults plus `--device`. The scene's raw sigma over a cube
of side `--cube_length` (`--N_grid`^3 points, `--chunk` at a time, through
the plain triplane sampler and the OSG decoder, as `eg3d_sample` computes
it), the border padded with -1000 so the iso-surface closes, marching
tetrahedra at `--sigma_threshold`, with `--colorize` the decoder's rgb at
each vertex, and a binary PLY at `<out_dir>/<scene_name>.ply`. The JAX CLI
synthesises the planes again in every chunk; they are the same planes, so
the port synthesises them once.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def get_opts(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--ckpt_path', type=str, required=True)
    parser.add_argument('--scene_name', type=str, default='scene_eg3d')
    parser.add_argument('--N_grid', type=int, default=256)
    parser.add_argument('--cube_length', type=float, default=2.0,
                        help='side length of the sampled cube (world units)')
    parser.add_argument('--sigma_threshold', type=float, default=10.0)
    parser.add_argument('--chunk', type=int, default=65536)
    parser.add_argument('--colorize', default=False, action='store_true')
    parser.add_argument('--out_dir', type=str, default='results/meshes')
    parser.add_argument('--eg3d_plane_res', type=int, default=256)
    parser.add_argument('--eg3d_channel_base', type=int, default=32768)
    parser.add_argument('--eg3d_channel_max', type=int, default=512)
    parser.add_argument('--eg3d_z_dim', type=int, default=512)
    parser.add_argument('--eg3d_box_warp', type=float, default=15.0)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default; fails when no card is visible) or 'cpu'")
    return parser.parse_args(args)


def mesh_config(hparams):
    """The JAX CLI's TriPlaneConfig: its flags, every other field default."""
    from nerf_siren_tpu_torch.render.triplane import RenderingOptions, TriPlaneConfig

    return TriPlaneConfig(z_dim=hparams.eg3d_z_dim, w_dim=hparams.eg3d_z_dim,
                          plane_resolution=hparams.eg3d_plane_res,
                          channel_base=hparams.eg3d_channel_base,
                          channel_max=hparams.eg3d_channel_max,
                          rendering=RenderingOptions(box_warp=hparams.eg3d_box_warp))


def load_model(hparams, device):
    """The renderer of `mesh_config` with the checkpoint's `eg3d_renderer`
    weights (the init, from a seed-0 generator, where the file has none)."""
    from nerf_siren_tpu_torch.render.triplane import EG3DRenderer
    from nerf_siren_tpu_torch.training.checkpoints import load_eg3d_ckpt

    model = EG3DRenderer(mesh_config(hparams), generator=torch.Generator().manual_seed(0))
    return load_eg3d_ckpt(model, hparams.ckpt_path).to(device).eval()


def scene_sampler(model):
    """pts (N, 3) -> the decoder's {'sigma' (N, 1), 'rgb' (N, 3)} on the
    scene's planes, synthesised once (`sample.planes`)."""
    from nerf_siren_tpu_torch.render.triplane import run_model

    with torch.no_grad():
        planes = model.planes(model.mapping(model.z))

    @torch.no_grad()
    def sample(pts: torch.Tensor):
        out = run_model(planes, model.decoder, pts[None], model.cfg.rendering)
        return {k: v[0] for k, v in out.items()}
    sample.planes = planes
    return sample


def sigma_grid(sample, hparams, device) -> np.ndarray:
    """(N, N, N) raw sigma over the cube, the border set to -1000."""
    n = hparams.N_grid
    half = hparams.cube_length / 2
    lin = np.linspace(-half, half, n, dtype=np.float32)
    xyz = np.stack(np.meshgrid(lin, lin, lin, indexing='ij'), -1).reshape(-1, 3)
    out = []
    for i in range(0, xyz.shape[0], hparams.chunk):
        pts = torch.from_numpy(np.ascontiguousarray(xyz[i:i + hparams.chunk])).to(device)
        out.append(sample(pts)["sigma"][:, 0].cpu().numpy())
    sigma = np.concatenate(out).reshape(n, n, n)
    pad = -1000.0   # close the surface at the border
    sigma[:1] = sigma[-1:] = pad
    sigma[:, :1] = sigma[:, -1:] = pad
    sigma[:, :, :1] = sigma[:, :, -1:] = pad
    return sigma


def vertex_colors(sample, verts: np.ndarray, chunk: int, device) -> np.ndarray:
    """The decoder's rgb at each vertex, clipped to [0, 1]."""
    cols = []
    for i in range(0, len(verts), chunk):
        pts = torch.from_numpy(np.ascontiguousarray(verts[i:i + chunk], np.float32)).to(device)
        cols.append(sample(pts)["rgb"].cpu().numpy())
    return np.concatenate(cols).clip(0, 1)


def main(hparams):
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.mesh.marching import marching_tetrahedra
    from nerf_siren_tpu_torch.mesh.ply import write_ply

    device = resolve_device(hparams.device)
    sample = scene_sampler(load_model(hparams, device))
    print('Sampling sigma ...', flush=True)
    sigma = sigma_grid(sample, hparams, device)
    print('Extracting mesh ...', flush=True)
    half = hparams.cube_length / 2
    step = hparams.cube_length / (hparams.N_grid - 1)
    verts, faces = marching_tetrahedra(sigma, hparams.sigma_threshold, spacing=(step,) * 3,
                                       origin=(-half, -half, -half))
    print(f'  {len(verts)} vertices, {len(faces)} faces', flush=True)
    colors = None
    if hparams.colorize and len(verts):
        colors = vertex_colors(sample, verts, hparams.chunk, device)
    os.makedirs(hparams.out_dir, exist_ok=True)
    out_path = os.path.join(hparams.out_dir, f'{hparams.scene_name}.ply')
    write_ply(out_path, verts, faces, colors)
    print(f'wrote {out_path}', flush=True)
    return out_path


if __name__ == '__main__':
    main(get_opts())
