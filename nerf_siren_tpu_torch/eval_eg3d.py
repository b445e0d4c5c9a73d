"""EG3D evaluation CLI of the port: `python -m nerf_siren_tpu_torch.eval_eg3d`.

Counterpart of the JAX package's `eval_eg3d.py` (reference
eval_eg3d.py:22-135), with its flags, names and defaults: loads the
`eg3d_renderer` tree (triplane backbone, decoder, learnable z) of a
(JAX-written) msgpack checkpoint, renders every item of the split with the
exact importance renderer in `--chunk`-ray tiles, planes synthesised once
per frame, and writes PNG frames, an animated GIF and the mean PSNR when
ground truth exists. `--plane_sampler gather` (the default, as in JAX)
samples the planes with the plain PyTorch gather; `kernel` with the CUDA
kernel K5 (`csrc/triplane_gather.cu`; its plain version on the CPU). It
runs on `--device` (default `cuda`, which fails when no card is visible;
the tests pass `--device cpu`). `--renderer fast` (with its `--fast_*`
flags) and `--num_chips` other than 1 are refused with the ROADMAP slice
that brings them. `--dataset_name` takes the JAX CLI's choices: blender,
llff and replica.

`make_renderer` holds the render call, so every caller (this CLI,
`chip_smoke.py`) drives the same code. Datasets (PIL) and `imageio` are
imported inside `main` only.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict

import numpy as np
import torch

from nerf_siren_tpu_torch.render.triplane import (EG3DRenderer, RenderingOptions,
                                                  TriPlaneConfig)
from nerf_siren_tpu_torch.training.checkpoints import load_eg3d_ckpt
from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem


def get_opts(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True)
    parser.add_argument('--dataset_name', type=str, default='blender',
                        choices=['blender', 'llff', 'replica'])
    parser.add_argument('--scene_name', type=str, default='test_eg3d')
    parser.add_argument('--split', type=str, default='test')
    parser.add_argument('--img_wh', nargs='+', type=int, default=[128, 128])
    parser.add_argument('--spheric_poses', default=False, action='store_true')
    parser.add_argument('--chunk', type=int, default=4096)
    parser.add_argument('--num_chips', type=int, default=1,
                        help="only 1: multi-GPU eval comes with ROADMAP slice 6")
    parser.add_argument('--ckpt_path', type=str, required=True)
    parser.add_argument('--eg3d_plane_res', type=int, default=256)
    parser.add_argument('--eg3d_channel_base', type=int, default=32768)
    parser.add_argument('--eg3d_channel_max', type=int, default=512)
    parser.add_argument('--eg3d_z_dim', type=int, default=512)
    parser.add_argument('--N_samples', type=int, default=64)
    parser.add_argument('--N_importance', type=int, default=64)
    parser.add_argument('--eg3d_ray_start', type=float, default=0.1)
    parser.add_argument('--eg3d_ray_end', type=float, default=10.0)
    parser.add_argument('--eg3d_box_warp', type=float, default=15.0)
    parser.add_argument('--plane_sampler', type=str, default='gather',
                        choices=['gather', 'kernel'],
                        help="'gather' samples the planes with the plain PyTorch "
                             "gather; 'kernel' with the CUDA gather kernel "
                             "(csrc/triplane_gather.cu)")
    parser.add_argument('--renderer', type=str, default='exact', choices=['exact', 'fast'],
                        help="only 'exact': the fast EG3D renderer comes with a later "
                             "part of ROADMAP slice 5")
    # the fast renderer's flags, accepted with the JAX CLI's names and defaults
    parser.add_argument('--fast_candidates', type=int, default=32)
    parser.add_argument('--fast_keep', type=int, default=16)
    parser.add_argument('--fast_distill_steps', type=int, default=500)
    parser.add_argument('--fast_distill_batch', type=int, default=32768)
    parser.add_argument('--fast_cull', type=str, default=None, choices=['auto'])
    parser.add_argument('--fast_cull_margin', type=float, default=1.2)
    parser.add_argument('--fast_placement', type=str, default='mid', choices=['edges', 'mid'])
    parser.add_argument('--fast_quadrature', type=str, default='delta',
                        choices=['delta', 'ratio'])
    parser.add_argument('--fast_opacity_eps', type=str, default='auto')
    parser.add_argument('--fast_prepass', type=int, default=16)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default; fails when no card is visible) or 'cpu'")
    opts = parser.parse_args(args)
    if opts.num_chips != 1:
        parser.error(f"--num_chips {opts.num_chips}: the port renders on one device; "
                     f"multi-GPU eval comes with ROADMAP slice 6 (multi-GPU)")
    if opts.renderer == 'fast':
        parser.error("--renderer fast is not ported yet for EG3D: it comes with a later part "
                     "of ROADMAP slice 5 (render/triplane_fast.py)")
    return opts


def triplane_config(hparams, white_back: bool) -> TriPlaneConfig:
    """The JAX CLI's TriPlaneConfig from its flags."""
    return TriPlaneConfig(
        z_dim=hparams.eg3d_z_dim, w_dim=hparams.eg3d_z_dim,
        plane_resolution=hparams.eg3d_plane_res,
        channel_base=hparams.eg3d_channel_base, channel_max=hparams.eg3d_channel_max,
        rendering=RenderingOptions(
            depth_resolution=hparams.N_samples,
            depth_resolution_importance=max(hparams.N_importance, 1),
            ray_start=hparams.eg3d_ray_start, ray_end=hparams.eg3d_ray_end,
            box_warp=hparams.eg3d_box_warp, white_back=white_back))


def load_model(system: EG3DSystem, ckpt_path: str, device: torch.device) -> EG3DRenderer:
    """The renderer of `system`'s config with the checkpoint's
    `eg3d_renderer` weights (the init, seed 0, where the file has none)."""
    model = system.init_model(torch.Generator().manual_seed(0))
    return load_eg3d_ckpt(model, ckpt_path).to(device)


def make_renderer(system: EG3DSystem, model: EG3DRenderer,
                  chunk: int) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """A function of one frame's (N, >= 6) rays -> render outputs."""
    def render(rays: torch.Tensor) -> Dict[str, torch.Tensor]:
        return system.render(model, rays, chunk=chunk)
    return render


def main(hparams):
    import imageio

    from nerf_siren_tpu_torch.datasets import dataset_dict
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.training.metrics import psnr as psnr_fn

    device = resolve_device(hparams.device)
    w, h = hparams.img_wh
    kwargs = dict(root_dir=hparams.root_dir, split=hparams.split, img_wh=tuple(hparams.img_wh))
    if hparams.dataset_name.startswith('llff'):
        kwargs['spheric_poses'] = hparams.spheric_poses
    dataset = dataset_dict[hparams.dataset_name](**kwargs)

    system = EG3DSystem(triplane_config(hparams, dataset.white_back), hparams.plane_sampler)
    render = make_renderer(system, load_model(system, hparams.ckpt_path, device), hparams.chunk)

    out_dir = os.path.join('results', hparams.dataset_name, hparams.scene_name)
    os.makedirs(out_dir, exist_ok=True)
    imgs, psnrs = [], []
    for i in range(len(dataset)):
        sample = dataset[i]
        out = render(torch.as_tensor(np.asarray(sample['rays'], np.float32), device=device))
        pred = out['rgb_fine'].float().cpu().numpy().reshape(h, w, 3)
        img = (np.clip(pred, 0, 1) * 255).astype(np.uint8)
        imgs.append(img)
        imageio.imwrite(os.path.join(out_dir, f'{i:03d}.png'), img)
        if 'rgbs' in sample:
            gt = np.asarray(sample['rgbs'], np.float32).reshape(h, w, 3)
            psnrs.append(float(psnr_fn(torch.from_numpy(pred), torch.from_numpy(gt))))
        print(f'rendered {i + 1}/{len(dataset)}', flush=True)

    imageio.mimsave(os.path.join(out_dir, f'{hparams.scene_name}.gif'), imgs, duration=1000 / 30)
    if psnrs:
        print(f'Mean PSNR: {np.mean(psnrs):.2f}')
    return np.mean(psnrs) if psnrs else None


if __name__ == '__main__':
    main(get_opts())
