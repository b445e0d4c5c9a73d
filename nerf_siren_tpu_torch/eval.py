"""Evaluation / rendering CLI of the port: `python -m nerf_siren_tpu_torch.eval`.

The `--mode normal` eval of the JAX package's `eval.py` on one device:
loads nerf_coarse / nerf_fine from a (JAX-written) msgpack checkpoint,
renders every item of the split, and writes PNG frames, an animated GIF,
optional depth dumps and the mean PSNR when ground truth exists. It runs on
`--device` (default `cuda`, which fails when no card is visible; the tests
pass `--device cpu`). Renderers:
- `fused`: the exact coarse + fine math with both field passes on the
  hand-written CUDA field kernel (K1, or K4 with `--fast_field_dtype int8`),
  or its plain version on the CPU;
- `exact`: the plain `render_rays` at `--compute_dtype`;
- `fast`: the proxy-culled renderer (`render/fast.py`) with the `--fast_*`
  flags of the JAX CLI, names and defaults included. The density proxy is
  the checkpoint's online one (its `proxy` entry), or a distilled one,
  cached beside the checkpoint as `<ckpt>.proxy.msgpack` keyed by the
  checkpoint's sha256 and the distillation settings: the same file the JAX
  CLI reads and writes.
`--num_chips` > 1 and `--mode d3` are refused with the ROADMAP slice that
brings them.

`make_renderer` holds the ray tiling and the render call, so every caller
(this CLI, `chip_smoke.py`) drives the same code. Datasets (PIL, cv2) and
`imageio` are imported inside `main` only.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig
from nerf_siren_tpu_torch.convert import proxy_from_jax, proxy_to_jax
from nerf_siren_tpu_torch.datasets import dataset_name
from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import pack_model_params
from nerf_siren_tpu_torch.ops.kernels.fused_mlp_int8 import pack_model_params_int8
from nerf_siren_tpu_torch.ops.kernels.proxy_march import pack_proxy_params
from nerf_siren_tpu_torch.render.fast import (Proxy, distill_proxy, estimate_scene_aabb,
                                              make_auto_cull_renderer,
                                              make_edge_refined_renderer, render_rays_fast)
from nerf_siren_tpu_torch.render.fused import render_rays_fused
from nerf_siren_tpu_torch.render.rendering import map_chunks, render_rays_chunked
from nerf_siren_tpu_torch.training.checkpoints import (extract_model_state, load_checkpoint,
                                                         save_checkpoint)


def get_opts(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True)
    parser.add_argument('--dataset_name', type=dataset_name, default='blender',
                        help="a ported loader: 'blender' or 'llff'")
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
                        choices=['exact', 'fused', 'fast'],
                        help="'fused' runs the exact coarse+fine math with both "
                             "field passes on the fused CUDA kernel; 'exact' "
                             "runs the plain PyTorch render_rays; 'fast' "
                             "renders with proxy-culled sampling")
    parser.add_argument('--fast_candidates', type=int, default=32)
    parser.add_argument('--fast_keep', type=int, default=16)
    parser.add_argument('--fast_select', type=str, default='pdf', choices=['topk', 'pdf'])
    parser.add_argument('--fast_distill_steps', type=int, default=500)
    parser.add_argument('--fast_distill_batch', type=int, default=65536)
    parser.add_argument('--fast_adaptive', type=float, nargs=2, default=None,
                        metavar=('HI_FRACTION', 'K_HI'),
                        help="re-render the HI_FRACTION most ambiguous rays at "
                             "K_HI survivors (kernel route)")
    parser.add_argument('--fast_cull', type=str, default=None,
                        help="empty-ray culling on the kernel route: a FRACTION "
                             "of rays (the most proxy-opaque) or 'auto' (a "
                             "per-frame budget from the opacity prepass)")
    parser.add_argument('--fast_cull_margin', type=float, default=1.2,
                        help="auto-cull budget headroom over the measured "
                             "foreground block count")
    parser.add_argument('--fast_placement', type=str, default='mid',
                        choices=['edges', 'mid'],
                        help="pdf placement: 'mid' u=(k+.5)/K, 'edges' u=k/(K-1)")
    parser.add_argument('--fast_field_dtype', type=str, default='bf16',
                        choices=['bf16', 'int8'],
                        help="field trunk precision of --renderer fast (the "
                             "survivors) and --renderer fused: 'int8' runs the "
                             "8x256 trunk on the int8 kernel (dynamic "
                             "per-point activation scales, no calibration)")
    parser.add_argument('--fast_edge_refine', type=float, default=None,
                        metavar='CAP_FRAC',
                        help="after each fast frame, re-render the top CAP_FRAC "
                             "of rays by opacity/depth edge score through the "
                             "exact fused path at --fast_edge_lite samples "
                             "(full frames in scanline order)")
    parser.add_argument('--fast_edge_lite', type=int, nargs=2, default=(48, 16),
                        metavar=('N_SAMPLES', 'N_IMP'))
    parser.add_argument('--fast_quadrature', type=str, default='delta',
                        choices=['delta', 'ratio'],
                        help="'delta' consecutive differences; 'ratio' the "
                             "proxy-shaped stratum quadrature (needs mid placement)")
    parser.add_argument('--fast_opacity_eps', type=str, default='auto',
                        help="auto-cull threshold on the proxy opacity: a float, "
                             "or 'auto' to calibrate it every frame")
    parser.add_argument('--fast_prepass', type=int, default=16,
                        help="proxy candidates per ray of the auto-cull prepass")
    parser.add_argument('--fast_proxy_path', type=str, default=None,
                        help="the distilled proxy's cache (default "
                             "<ckpt_path>.proxy.msgpack; 'none' disables it)")
    parser.add_argument('--num_chips', type=int, default=1,
                        help="only 1: multi-GPU eval comes with ROADMAP slice 6")
    parser.add_argument('--mode', type=str, default='normal', choices=['normal', 'd3'],
                        help="only 'normal': 'd3' comes with ROADMAP slice 4")
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default; fails when no card is visible) "
                             "or 'cpu'")
    opts = parser.parse_args(args)
    if opts.num_chips != 1:
        parser.error(f"--num_chips {opts.num_chips}: the port renders on one device; "
                     f"multi-GPU eval comes with ROADMAP slice 6 (multi-GPU)")
    if opts.mode == 'd3':
        parser.error("--mode d3 is not ported yet: it comes with ROADMAP slice 4 "
                     "(the semantic stack)")
    return opts


def resolve_device(name: str) -> torch.device:
    """The device an entry point asked for. A request for a card fails when
    none is visible instead of running elsewhere."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is visible "
                         f"(pass --device cpu to run on the CPU)")
    return device


@dataclasses.dataclass
class FastSetup:
    """What the fast renderer needs beside the fields: the field key it
    renders, the density proxy, the scene box, the field packs of the
    survivors (bf16 or int8) and the proxy's kernel pack (None off the
    kernel route)."""
    model_key: str
    proxy: Proxy
    aabb: Tuple[np.ndarray, np.ndarray]
    packed: Dict[str, Dict[str, torch.Tensor]]
    packed_proxy: Optional[Dict[str, torch.Tensor]]


def field_sigma_fn(models: Dict[str, NeRF]):
    """(model key, sigma_fn) of the field the fast renderer draws: the
    float32 plain sigma pass of the fine field (else the coarse one), as the
    JAX CLI's `apply_nerf`, so the scene box it yields equals JAX's on the
    same field; it takes points anywhere and answers on the field's device."""
    model_key = 'fine' if 'fine' in models else 'coarse'
    net = models[model_key]
    device = next(net.parameters()).device

    def sigma_fn(pts: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net(positional_encoding(pts.to(device), 10))[:, 0]
    return model_key, sigma_fn


def setup_fast_proxy(models: Dict[str, NeRF], hparams, bounds) -> FastSetup:
    """The density proxy, scene box and kernel packs of `--renderer fast`.

    The proxy is, in this order: the checkpoint's online proxy (its 'proxy'
    entry; only without an explicit --fast_proxy_path), the cache at
    --fast_proxy_path (default <ckpt>.proxy.msgpack) when its checkpoint
    sha256 and distillation settings match, or a fresh distillation over
    the cube of half-side max|bounds|/2 (generator seed 7), written to the
    cache. Cache and checkpoint formats are the JAX CLI's."""
    model_key, sigma_fn = field_sigma_fn(models)
    device = next(models[model_key].parameters()).device
    half = float(np.max(np.abs(bounds))) * 0.5

    def estimate_aabb():
        return estimate_scene_aabb(sigma_fn, [-half] * 3, [half] * 3)

    def to_proxy(tree):
        state = proxy_from_jax(tree)
        proxy = Proxy(state["l1.weight"].shape[0])
        proxy.load_state_dict(state)
        return proxy.to(device)

    proxy_path = hparams.fast_proxy_path
    if proxy_path is None:
        proxy_path = hparams.ckpt_path + '.proxy.msgpack'
    with open(hparams.ckpt_path, 'rb') as f:
        ckpt_sha = hashlib.sha256(f.read()).digest()
    proxy = aabb = None
    if hparams.fast_proxy_path is None:
        trained = extract_model_state(load_checkpoint(hparams.ckpt_path), 'proxy')
        if trained is not None:
            proxy, aabb = to_proxy(trained), estimate_aabb()
            print('reusing the online culled-training proxy from the checkpoint '
                  '(no distillation)', flush=True)
    if proxy is None and proxy_path != 'none' and os.path.exists(proxy_path):
        try:
            blob = load_checkpoint(proxy_path)
            meta = blob['meta']
            if (bytes(np.asarray(meta['ckpt_sha'], np.uint8)) == ckpt_sha
                    and int(meta['distill_steps']) == hparams.fast_distill_steps
                    and int(meta['distill_batch']) == hparams.fast_distill_batch):
                proxy = to_proxy(blob['proxy'])
                aabb = (np.asarray(blob['aabb'][0], np.float32),
                        np.asarray(blob['aabb'][1], np.float32))
                print(f'reusing distilled proxy: {proxy_path}', flush=True)
            else:
                print(f'proxy cache stale (checkpoint or distill config changed), '
                      f're-distilling: {proxy_path}', flush=True)
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f'ignoring unreadable proxy cache {proxy_path}: {e!r}', flush=True)
    if proxy is None:
        print('distilling density proxy ...', flush=True)
        gen = torch.Generator(device).manual_seed(7)
        proxy = distill_proxy(sigma_fn, [-half] * 3, [half] * 3, gen,
                              steps=hparams.fast_distill_steps,
                              batch=hparams.fast_distill_batch)
        aabb = estimate_aabb()
        if proxy_path != 'none':
            save_checkpoint(proxy_path, {
                'proxy': proxy_to_jax(proxy.state_dict()),
                'aabb': np.stack([np.asarray(aabb[0], np.float32),
                                  np.asarray(aabb[1], np.float32)]),
                'meta': {'ckpt_sha': np.frombuffer(ckpt_sha, np.uint8).copy(),
                         'distill_steps': np.asarray(hparams.fast_distill_steps),
                         'distill_batch': np.asarray(hparams.fast_distill_batch)}})
            print(f'saved distilled proxy: {proxy_path}', flush=True)
    print(f'scene AABB: {np.round(aabb[0], 2)} .. {np.round(aabb[1], 2)}', flush=True)
    packed = field_packs(models, hparams.fast_field_dtype)
    packed_proxy = None
    if hparams.fast_select == 'pdf' and hparams.fast_keep >= 2:
        packed_proxy = pack_proxy_params(proxy)   # the K3 route: march + placement
    return FastSetup(model_key, proxy, aabb, packed, packed_proxy)


def field_packs(models: Dict[str, NeRF], field_dtype: str):
    """Kernel packs of the fields: bf16 (K1) or int8 (K4)."""
    if field_dtype == 'int8':
        print('int8 trunk: dynamic per-point activation scales (no calibration)',
              flush=True)
        return pack_model_params_int8(models)
    return pack_model_params(models)


def make_fast_renderer(models: Dict[str, NeRF], render_cfg: RenderConfig, fast: FastSetup,
                       hparams, compute_dtype: Optional[torch.dtype] = None,
                       img_hw: Optional[Tuple[int, int]] = None):
    """`--renderer fast` as the JAX CLI builds it: `render_rays_fast` per
    tile of `render_cfg.chunk` rays (with `--fast_adaptive` or a fixed
    `--fast_cull`), or the auto-cull frame driver (`--fast_cull auto`), then
    the edge refinement pass (`--fast_edge_refine`, needs `img_hw`)."""
    h = hparams
    common = dict(n_candidates=h.fast_candidates, n_keep=h.fast_keep, model=fast.model_key,
                  white_back=render_cfg.white_back, compute_dtype=compute_dtype,
                  scene_aabb=fast.aabb, packed_params=fast.packed,
                  packed_proxy=fast.packed_proxy, placement=h.fast_placement,
                  quadrature=h.fast_quadrature)
    if (h.fast_cull is not None or h.fast_adaptive is not None) and fast.packed_proxy is None:
        raise SystemExit('--fast_cull / --fast_adaptive need the kernel route '
                         '(--fast_select pdf, --fast_keep >= 2)')
    if h.fast_cull == 'auto':
        eps = h.fast_opacity_eps if h.fast_opacity_eps == 'auto' else float(h.fast_opacity_eps)
        render = make_auto_cull_renderer(models, fast.proxy, margin=h.fast_cull_margin,
                                         opacity_eps=eps, prepass_candidates=h.fast_prepass,
                                         **common)
    else:
        adaptive = None if h.fast_adaptive is None else (float(h.fast_adaptive[0]),
                                                         int(h.fast_adaptive[1]))
        cull = None if h.fast_cull is None else float(h.fast_cull)

        def render(rays):
            return map_chunks(lambda t: render_rays_fast(models, fast.proxy, t,
                                                         select=h.fast_select,
                                                         adaptive=adaptive, cull=cull,
                                                         **common),
                              rays, render_cfg.chunk)
    if h.fast_edge_refine is None:
        return render
    if 'fine' not in models or not render_cfg.test_time:
        raise SystemExit('--fast_edge_refine needs a coarse+fine checkpoint and '
                         'N_importance > 0')
    ns_lite, ni_lite = h.fast_edge_lite
    # the edge pass always takes the bf16 pack: it is the quality anchor
    return make_edge_refined_renderer(render, pack_model_params(models), img_hw,
                                      white_back=render_cfg.white_back, n_samples=ns_lite,
                                      n_importance=ni_lite, cap_frac=h.fast_edge_refine,
                                      model=fast.model_key)


def make_renderer(models: Dict[str, NeRF], render_cfg: RenderConfig, *, renderer: str,
                  compute_dtype: Optional[torch.dtype] = None, field_dtype: str = 'bf16',
                  fast: Optional[FastSetup] = None, hparams=None,
                  img_hw: Optional[Tuple[int, int]] = None
                  ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """A function of (N, 8) rays -> render outputs, tiled by `render_cfg.chunk`.

    'fused' packs the fields once here (bf16, or int8 with `field_dtype`)
    and runs `render_rays_fused` per tile (it needs the test_time coarse
    pass, n_importance > 0); 'exact' runs `render_rays` per tile at
    `compute_dtype`; 'fast' runs `make_fast_renderer` with `fast`
    (`setup_fast_proxy`) and the CLI options `hparams`."""
    if renderer == 'fast':
        return make_fast_renderer(models, render_cfg, fast, hparams, compute_dtype, img_hw)
    if renderer == 'fused':
        packed = field_packs(models, field_dtype)

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

    from nerf_siren_tpu_torch.datasets import dataset_dict
    from nerf_siren_tpu_torch.datasets.depth_utils import save_pfm
    from nerf_siren_tpu_torch.training.checkpoints import load_ckpt
    from nerf_siren_tpu_torch.training.metrics import psnr as psnr_fn

    device = resolve_device(hparams.device)
    w, h = hparams.img_wh
    kwargs = dict(root_dir=hparams.root_dir, split=hparams.split,
                  img_wh=tuple(hparams.img_wh))
    if hparams.dataset_name.startswith('llff'):
        kwargs['spheric_poses'] = hparams.spheric_poses
    dataset = dataset_dict[hparams.dataset_name](**kwargs)

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
    fast = None
    if renderer == 'fast':
        fast = setup_fast_proxy(models, hparams, dataset.bounds)
    render = make_renderer(models, render_cfg, renderer=renderer, compute_dtype=compute_dtype,
                           field_dtype=hparams.fast_field_dtype, fast=fast, hparams=hparams,
                           img_hw=(h, w))

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
