"""Evaluation / rendering CLI of the port: `python -m nerf_siren_tpu_torch.eval`.

The `--renderer exact|fused` subset of the JAX package's `eval.py`: loads
nerf_coarse / nerf_fine from a (JAX-written) msgpack checkpoint, renders
every item of the split with the sigma-only coarse pass, and writes PNG
frames, an animated GIF, optional depth dumps and the mean PSNR when ground
truth exists. `fused` runs both field passes on the hand-written CUDA
kernel (on a CUDA device) or its plain version (on the CPU); `exact` runs
the plain `render_rays` at `--compute_dtype`.

`make_renderer` holds the ray tiling and the render call, so every caller
(this CLI, `chip_smoke.py`) drives the same code. Datasets (PIL, cv2) and
`imageio` are imported inside `main` only.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import pack_model_params
from nerf_siren_tpu_torch.render.fused import render_rays_fused
from nerf_siren_tpu_torch.render.rendering import map_chunks, render_rays_chunked


def get_opts(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True)
    parser.add_argument('--dataset_name', type=str, default='blender',
                        choices=['blender', 'blender_cls_ib', 'llff',
                                 'llff_cls', 'llff_cls_ib', 'replica'])
    parser.add_argument('--scene_name', type=str, default='test',
                        help='scene name, used as output folder name')
    parser.add_argument('--split', type=str, default='test')
    parser.add_argument('--img_wh', nargs='+', type=int, default=[800, 800])
    parser.add_argument('--spheric_poses', default=False, action='store_true')
    parser.add_argument('--N_samples', type=int, default=64)
    parser.add_argument('--N_importance', type=int, default=128)
    parser.add_argument('--use_disp', default=False, action='store_true')
    parser.add_argument('--chunk', type=int, default=32 * 1024)
    parser.add_argument('--ckpt_path', type=str, required=True)
    parser.add_argument('--save_depth', default=False, action='store_true')
    parser.add_argument('--depth_format', type=str, default='pfm',
                        choices=['pfm', 'bytes'])
    parser.add_argument('--compute_dtype', type=str, default='bfloat16',
                        choices=['float32', 'bfloat16'],
                        help="matmul operand type of the exact renderer (the "
                             "fused field always takes bf16 operands)")
    parser.add_argument('--renderer', type=str, default='fused',
                        choices=['exact', 'fused'],
                        help="'fused' runs the exact coarse+fine math with both "
                             "field passes on the fused CUDA kernel; 'exact' "
                             "runs the plain PyTorch render_rays")
    return parser.parse_args(args)


def make_renderer(models: Dict[str, NeRF], render_cfg: RenderConfig, *, renderer: str,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """A function of (N, 8) rays -> render outputs, tiled by `render_cfg.chunk`.

    'fused' packs the fields once here and runs `render_rays_fused` per tile
    (it needs the test_time coarse pass, n_importance > 0); 'exact' runs
    `render_rays` per tile at `compute_dtype`."""
    if renderer == 'fused':
        packed = pack_model_params(models)

        def render(rays):
            return map_chunks(lambda t: render_rays_fused(packed, t, render_cfg),
                              rays, render_cfg.chunk)
        return render
    if renderer == 'exact':
        def render(rays):
            return render_rays_chunked(models, rays, render_cfg, None,
                                       compute_dtype=compute_dtype)
        return render
    raise ValueError(f"unknown renderer {renderer!r}")


def main(hparams):
    import imageio

    from nerf_siren_tpu.datasets import dataset_dict
    from nerf_siren_tpu.datasets.depth_utils import save_pfm
    from nerf_siren_tpu_torch.training.checkpoints import load_ckpt
    from nerf_siren_tpu_torch.training.metrics import psnr as psnr_fn

    w, h = hparams.img_wh
    kwargs = dict(root_dir=hparams.root_dir, split=hparams.split,
                  img_wh=tuple(hparams.img_wh))
    if hparams.dataset_name.startswith('llff'):
        kwargs['spheric_poses'] = hparams.spheric_poses
    dataset = dataset_dict[hparams.dataset_name](**kwargs)

    device = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    nerf_cfg = NeRFConfig()
    render_cfg = RenderConfig(
        n_samples=hparams.N_samples, n_importance=hparams.N_importance,
        use_disp=hparams.use_disp, perturb=0.0, noise_std=0.0,
        white_back=dataset.white_back, test_time=hparams.N_importance > 0,
        chunk=hparams.chunk,
    )
    compute_dtype = torch.bfloat16 if hparams.compute_dtype == 'bfloat16' else None

    def model(seed, name):
        gen = torch.Generator().manual_seed(seed)
        return load_ckpt(NeRF(nerf_cfg, generator=gen), hparams.ckpt_path, name).to(device)

    models = {'coarse': model(0, 'nerf_coarse')}
    if hparams.N_importance > 0:
        models['fine'] = model(1, 'nerf_fine')

    renderer = hparams.renderer
    if renderer == 'fused' and not render_cfg.test_time:
        print('NOTE: --renderer fused requires N_importance > 0 '
              '(test_time coarse pass); falling back to the exact renderer',
              flush=True)
        renderer = 'exact'
    render = make_renderer(models, render_cfg, renderer=renderer,
                           compute_dtype=compute_dtype)

    out_dir = os.path.join('results', hparams.dataset_name, hparams.scene_name)
    os.makedirs(out_dir, exist_ok=True)

    imgs, psnrs = [], []
    with torch.no_grad():
        for i in range(len(dataset)):
            sample = dataset[i]
            out = render(torch.as_tensor(np.asarray(sample['rays'], np.float32), device=device))
            key = 'rgb_fine' if 'rgb_fine' in out else 'rgb_coarse'
            pred = out[key].float().cpu().numpy().reshape(h, w, 3)
            img = (np.clip(pred, 0, 1) * 255).astype(np.uint8)
            imgs.append(img)
            imageio.imwrite(os.path.join(out_dir, f'{i:03d}.png'), img)

            if hparams.save_depth:
                depth = out[key.replace('rgb', 'depth')].float().cpu().numpy().reshape(h, w)
                if hparams.depth_format == 'pfm':
                    save_pfm(os.path.join(out_dir, f'depth_{i:03d}.pfm'), depth)
                else:
                    with open(os.path.join(out_dir, f'depth_{i:03d}'), 'wb') as f:
                        f.write(depth.tobytes())

            if 'rgbs' in sample:
                gt = np.asarray(sample['rgbs'], np.float32).reshape(h, w, 3)
                psnrs.append(float(psnr_fn(torch.from_numpy(pred), torch.from_numpy(gt))))
            print(f'rendered {i + 1}/{len(dataset)}', flush=True)

    imageio.mimsave(os.path.join(out_dir, f'{hparams.scene_name}.gif'),
                    imgs, duration=1000 / 30)
    if psnrs:
        print(f'Mean PSNR: {np.mean(psnrs):.2f}')
    return np.mean(psnrs) if psnrs else None


if __name__ == '__main__':
    main(get_opts())
