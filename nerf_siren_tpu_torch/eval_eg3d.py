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
the tests pass `--device cpu`). `--renderer fast` renders with the
proxy-culled fast renderer (`render/triplane_fast.py`, its `--fast_*`
flags, the proxy distilled once from a generator seeded 7): K3 select
places `--fast_keep` samples a ray from `--fast_candidates`, in `--chunk`
tiles; with `--fast_cull auto` the frame renders whole (the culling ranks
the whole frame) and K3 opacity is its prepass. On the card K3 takes at
most 256 candidates a ray, so `--fast_candidates` and `--fast_prepass`
above that are refused at parse time there. `--num_chips` other than 1 is
refused with the ROADMAP slice that brings it. `--dataset_name` takes the
JAX CLI's choices: blender, llff and replica.

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

from nerf_siren_tpu_torch.ops.kernels.proxy_march import MAX_CANDIDATES
from nerf_siren_tpu_torch.render.rendering import map_chunks
from nerf_siren_tpu_torch.render.triplane import (EG3DRenderer, RenderingOptions,
                                                  TriPlaneConfig)
from nerf_siren_tpu_torch.render.triplane_fast import make_fast_eg3d_renderer
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
                        help="'fast': the proxy-culled renderer (render/triplane_fast.py): "
                             "a density proxy distilled once per scene, K3 placing "
                             "--fast_keep samples a ray, the planes sampled and decoded "
                             "only there")
    # the fast renderer's flags, with the JAX CLI's names and defaults
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
    if opts.renderer == 'fast' and torch.device(opts.device).type == 'cuda':
        for flag in ('fast_candidates', 'fast_prepass'):
            if getattr(opts, flag) > MAX_CANDIDATES:
                parser.error(f"--{flag} {getattr(opts, flag)}: K3, the proxy march kernel "
                             f"(csrc/proxy_march.cu), takes at most {MAX_CANDIDATES} "
                             f"candidates a ray on the card")
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


def setup_fast_renderer(system: EG3DSystem, model: EG3DRenderer, hparams, proxy=None):
    """The CLI's fast renderer of the scene at the `--fast_*` flags (its
    proxy distilled from a generator seeded 7 on the model's device, unless
    `proxy` is given)."""
    eps = hparams.fast_opacity_eps
    return make_fast_eg3d_renderer(
        model, system.cfg, n_candidates=hparams.fast_candidates, n_keep=hparams.fast_keep,
        distill_steps=hparams.fast_distill_steps, distill_batch=hparams.fast_distill_batch,
        generator=torch.Generator(device=model.z.device).manual_seed(7),
        cull=hparams.fast_cull, cull_margin=hparams.fast_cull_margin,
        opacity_eps=eps if eps == 'auto' else float(eps),
        prepass_candidates=hparams.fast_prepass, placement=hparams.fast_placement,
        quadrature=hparams.fast_quadrature, proxy=proxy)


def make_renderer(system: EG3DSystem, model: EG3DRenderer, chunk: int, fast=None,
                  whole_frame: bool = False
                  ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """A function of one frame's (N, >= 6) rays -> render outputs: the exact
    renderer, or `fast` (`setup_fast_renderer`) in `chunk`-ray tiles, or on
    the whole frame (`whole_frame`, the auto-cull renderer)."""
    if fast is not None:
        if whole_frame:
            return fast
        return lambda rays: map_chunks(fast, rays, chunk)

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
    model = load_model(system, hparams.ckpt_path, device)
    fast = None
    if hparams.renderer == 'fast':
        print('distilling density proxy ...', flush=True)
        fast = setup_fast_renderer(system, model, hparams)
    render = make_renderer(system, model, hparams.chunk, fast, hparams.fast_cull == 'auto')

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
