"""Mesh extraction CLI of the port: `python -m nerf_siren_tpu_torch.extract_color_mesh`.

Counterpart of the JAX package's root `extract_color_mesh.py`, with its
flags and defaults plus `--device`. A dense sigma grid over the box (the
fine field's float32 plain forward, relu(sigma), in `--chunk`-point
slices: JAX's `apply_nerf`, not the eval kernel K1) -> marching tetrahedra
(`mesh/marching.py`) -> optionally the largest connected component ->
vertex colours by `--vis_type`:
- 'fusion' (default): occlusion-aware fusion over the training views:
  each vertex projected into every view, its colour sampled bilinearly,
  weighted by 0.1 / depth plus 1 where the coarse-only opacity render
  (`--N_samples` samples, the fine weights as the coarse field) from the
  camera to the vertex stays below `--occ_threshold`;
- 'normal': the field's rgb at each vertex, looking along the inward
  vertex normal;
- 'label': the fusion of the views' semantic label maps (a `labels/`
  folder beside the images), painted with the semantic palette.
Writes a coloured binary PLY to `<out_dir>/<scene_name>.ply`.

Images are read only in the CLI's dataset layer (`view_images`, with PIL,
as the port's datasets read them); `fuse_colors` takes arrays, so it runs
on a machine without PIL or cv2. Its bilinear lookup is `remap_linear`,
cv2.remap's INTER_LINEAR rule in OpenCV 5 (fused lerps, zeros outside;
bit-equal to it), and labels are resized by `resize_nearest`, cv2.resize's
INTER_NEAREST index rule.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np
import torch


def get_opts(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True)
    parser.add_argument('--dataset_name', type=str, default='blender',
                        choices=['blender', 'blender_cls_ib', 'llff', 'replica'])
    parser.add_argument('--scene_name', type=str, default='scene')
    parser.add_argument('--img_wh', nargs='+', type=int, default=[800, 800])
    parser.add_argument('--ckpt_path', type=str, required=True)
    parser.add_argument('--N_grid', type=int, default=256)
    parser.add_argument('--x_range', nargs='+', type=float, default=[-1.2, 1.2])
    parser.add_argument('--y_range', nargs='+', type=float, default=[-1.2, 1.2])
    parser.add_argument('--z_range', nargs='+', type=float, default=[-1.2, 1.2])
    parser.add_argument('--sigma_threshold', type=float, default=20.0)
    parser.add_argument('--occ_threshold', type=float, default=0.2)
    parser.add_argument('--chunk', type=int, default=32 * 1024)
    parser.add_argument('--N_samples', type=int, default=64)
    parser.add_argument('--vis_type', type=str, default='fusion',
                        choices=['fusion', 'normal', 'label'])
    parser.add_argument('--keep_largest', default=False, action='store_true',
                        help='largest-connected-component denoise')
    parser.add_argument('--out_dir', type=str, default='results/meshes')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default; fails when no card is visible) or 'cpu'")
    return parser.parse_args(args)


def grid_points(hparams):
    """The grid's (N^3, 3) float32 points (x slowest), spacing and origin."""
    n = hparams.N_grid
    x = np.linspace(*hparams.x_range, n)
    y = np.linspace(*hparams.y_range, n)
    z = np.linspace(*hparams.z_range, n)
    xyz = np.stack(np.meshgrid(x, y, z, indexing='ij'), -1).reshape(-1, 3).astype(np.float32)
    spacing = ((x[-1] - x[0]) / (n - 1), (y[-1] - y[0]) / (n - 1), (z[-1] - z[0]) / (n - 1))
    return xyz, spacing, (x[0], y[0], z[0])


@torch.no_grad()
def field_sigma(model, pts: torch.Tensor) -> torch.Tensor:
    """relu(sigma) (N,) of the float32 plain field at (N, 3) points."""
    from nerf_siren_tpu_torch.models.embedding import positional_encoding

    return torch.relu(model(positional_encoding(pts, 10), None)[:, 0])


def predict_sigma_grid(model, hparams, device):
    """(N, N, N) relu(sigma) over the box, its spacing and origin."""
    xyz, spacing, origin = grid_points(hparams)
    out = []
    for i in range(0, xyz.shape[0], hparams.chunk):
        pts = torch.from_numpy(xyz[i:i + hparams.chunk]).to(device)
        out.append(field_sigma(model, pts).cpu().numpy())
    n = hparams.N_grid
    return np.concatenate(out).reshape(n, n, n), spacing, origin


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def remap_linear(image: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """`cv2.remap(image, x, y, cv2.INTER_LINEAR)` (OpenCV 5) at (N,) float32
    pixel coordinates of an (H, W, C) float32 image -> (N, C): with
    t = x - floor(x), two fused lerps along x, then one along y
    (a = fma(c01 - c00, tx, c00), b = fma(c11 - c10, tx, c10), fma(b - a,
    ty, a)), corners outside the image read 0 (BORDER_CONSTANT). OpenCV 4
    rounds each coordinate to 1/32 pixel first (INTER_BITS 5), which moves a
    colour by at most 1/64 of the step between neighbouring pixels."""
    h, w = image.shape[:2]
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    tx = (x - x0.astype(np.float32))[:, None]
    ty = (y - y0.astype(np.float32))[:, None]

    def corner(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = image[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float32)
        return np.where(inside[:, None], v, np.float32(0))

    c00, c01 = corner(y0, x0), corner(y0, x0 + 1)
    c10, c11 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    a = _fma(c01 - c00, tx, c00)
    b = _fma(c11 - c10, tx, c10)
    return _fma(b - a, ty, a)


def resize_nearest(image: np.ndarray, w: int, h: int) -> np.ndarray:
    """`cv2.resize(image, (w, h), interpolation=cv2.INTER_NEAREST)`: output
    pixel i reads source pixel min(floor(i * src / dst), src - 1)."""
    sh, sw = image.shape[:2]
    ix = np.minimum(np.floor(np.arange(w) * (sw / w)).astype(np.int64), sw - 1)
    iy = np.minimum(np.floor(np.arange(h) * (sh / h)).astype(np.int64), sh - 1)
    return image[iy[:, None], ix[None, :]]


def view_images(dataset, hparams) -> List[np.ndarray]:
    """The dataset's views as (H, W, 3) float32 arrays in [0, 255]: the
    images (RGB, Lanczos-resized to img_wh) or, for `--vis_type label`, the
    label maps beside them (`train` -> `labels` in the path, ids / 10,
    nearest-resized, painted with the palette). The CLI's only image reads
    (PIL)."""
    from PIL import Image

    from nerf_siren_tpu_torch.utils.color import colorize_cls

    w, h = hparams.img_wh
    out = []
    for path in dataset.image_paths:
        if hparams.vis_type == 'label':
            parse = np.asarray(Image.open(path.replace('train', 'labels'))) / 10
            parse = resize_nearest(parse, w, h)
            out.append(colorize_cls(parse.astype(np.uint8)).astype(np.float32))
        else:
            image = Image.open(path).convert('RGB')
            out.append(np.array(image.resize((w, h), Image.LANCZOS), np.float32))
    return out


def fuse_colors(models: Dict[str, torch.nn.Module], images: List[np.ndarray],
                poses: np.ndarray, focal: float, near: float, verts: np.ndarray,
                hparams, device) -> np.ndarray:
    """Occlusion-aware colour fusion of (V, 3) vertices over views
    (`images` (H, W, 3) float32 in [0, 255], `poses` (N, 3, 4) camera to
    world): (V, 3) colours in [0, 1]. `models['coarse']` is the field whose
    coarse-only opacity render, from each camera to each vertex (depths
    near .. the vertex's), marks the vertex occluded in that view."""
    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.render.rendering import render_rays_chunked

    w, h = hparams.img_wh
    k_mat = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    n_v = len(verts)
    verts_homo = np.concatenate([verts, np.ones((n_v, 1))], 1)
    non_occluded_sum = np.zeros((n_v, 1))
    v_color_sum = np.zeros((n_v, 3))
    cfg = RenderConfig(n_samples=hparams.N_samples, n_importance=0, perturb=0.0,
                       noise_std=0.0, test_time=True, chunk=hparams.chunk)
    for idx, image in enumerate(images):
        p_c2w = np.concatenate([poses[idx], [[0, 0, 0, 1]]], 0)
        p_w2c = np.linalg.inv(p_c2w)[:3]
        v_cam = p_w2c @ verts_homo.T                    # (3, N), "right up back"
        v_cam[1:] *= -1                                 # -> "right down forward"
        v_img = (k_mat @ v_cam).T
        depth = v_img[:, -1:] + 1e-5
        v_img = (v_img[:, :2] / depth).astype(np.float32)
        v_img[:, 0] = np.clip(v_img[:, 0], 0, w - 1)
        v_img[:, 1] = np.clip(v_img[:, 1], 0, h - 1)
        colors = remap_linear(image, v_img[:, 0], v_img[:, 1])

        rays_o = np.broadcast_to(poses[idx][:, -1], (n_v, 3)).astype(np.float32)
        rays_d = verts - rays_o
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        near_v = np.full((n_v, 1), float(near), np.float32)
        rays = np.concatenate([rays_o, rays_d, near_v, depth.astype(np.float32)], 1)
        with torch.no_grad():
            out = render_rays_chunked(models, torch.from_numpy(rays.astype(np.float32)).to(device),
                                      cfg, None)
        opacity = out["opacity_coarse"].cpu().numpy()[:, None]
        opacity = np.nan_to_num(opacity, nan=1.0)

        non_occluded = np.ones_like(non_occluded_sum) * 0.1 / depth
        non_occluded += opacity < hparams.occ_threshold
        v_color_sum += colors * non_occluded
        non_occluded_sum += non_occluded
        print(f'fused image {idx + 1}/{len(images)}', flush=True)
    return (v_color_sum / non_occluded_sum / 255.0).clip(0, 1)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit (V, 3) vertex normals: the sum of the adjacent faces' normals."""
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-8)


@torch.no_grad()
def normal_colors(model, verts: np.ndarray, faces: np.ndarray, device) -> np.ndarray:
    """The float32 plain field's rgb at each vertex, seen along the inward
    vertex normal."""
    from nerf_siren_tpu_torch.models.embedding import positional_encoding

    vn = vertex_normals(verts, faces)
    out = []
    for i in range(0, len(verts), 32768):
        pts = torch.from_numpy(np.ascontiguousarray(verts[i:i + 32768], np.float32)).to(device)
        dirs = torch.from_numpy(np.ascontiguousarray(-vn[i:i + 32768], np.float32)).to(device)
        out.append(model(positional_encoding(pts, 10),
                         positional_encoding(dirs, 4))[:, :3].cpu().numpy())
    return np.concatenate(out)


def load_fine(path: str, device):
    """The checkpoint's `nerf_fine` weights in the full-width field (the
    JAX CLI's init where the file has none, drawn from a seed-0 generator)."""
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.training.checkpoints import load_ckpt

    model = NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(0))
    return load_ckpt(model, path, 'nerf_fine').to(device).eval()


def extract(model, hparams, device, views=None):
    """Sigma grid -> mesh -> colours. `views` () -> (images, poses, focal,
    near) gives the fusion's views (read only when colours are fused).
    Returns (verts, faces, colors or None)."""
    from nerf_siren_tpu_torch.mesh.marching import largest_connected_component, marching_tetrahedra

    print('Predicting occupancy ...', flush=True)
    sigma, spacing, origin = predict_sigma_grid(model, hparams, device)
    print('Extracting mesh ...', flush=True)
    verts, faces = marching_tetrahedra(sigma, hparams.sigma_threshold, spacing=spacing,
                                       origin=origin)
    print(f'  {len(verts)} vertices, {len(faces)} faces', flush=True)
    if hparams.keep_largest and len(verts):
        verts, faces, _ = largest_connected_component(verts, faces)
        print(f'  kept largest component: {len(verts)} vertices', flush=True)
    if len(verts) == 0:
        return verts, faces, None
    if hparams.vis_type == 'normal':
        return verts, faces, normal_colors(model, verts, faces, device)
    images, poses, focal, near = views()
    return verts, faces, fuse_colors({'coarse': model}, images, poses, focal, near, verts,
                                     hparams, device)


def main(hparams):
    from nerf_siren_tpu_torch.datasets import dataset_dict
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.mesh.ply import write_ply

    device = resolve_device(hparams.device)
    kwargs = dict(root_dir=hparams.root_dir, img_wh=tuple(hparams.img_wh))
    if hparams.dataset_name == 'llff':
        kwargs.update(spheric_poses=True, split='test')
    else:
        kwargs['split'] = 'train'
    dataset = dataset_dict[hparams.dataset_name](**kwargs)
    model = load_fine(hparams.ckpt_path, device)

    def views():
        return (view_images(dataset, hparams), dataset.poses, dataset.focal,
                float(dataset.bounds.min()))

    verts, faces, colors = extract(model, hparams, device, views)
    os.makedirs(hparams.out_dir, exist_ok=True)
    out_path = os.path.join(hparams.out_dir, f'{hparams.scene_name}.ply')
    write_ply(out_path, verts, faces, colors)
    print(f'wrote {out_path}', flush=True)
    return out_path


if __name__ == '__main__':
    main(get_opts())
