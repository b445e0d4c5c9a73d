"""Evaluation / rendering CLI of the port: `python -m nerf_siren_tpu_torch.eval`.

The JAX package's `eval.py` on one device: loads nerf_coarse / nerf_fine
from a (JAX-written) msgpack checkpoint, renders every item of the split,
and writes PNG frames, an animated GIF, optional depth dumps and the mean
PSNR when ground truth exists. It runs on
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
K3 takes any `--fast_candidates` and `--fast_prepass` on the card: above
53,103 a ray (`proxy_march.MAX_CANDIDATES`, its one-ray block in 227 KB of
shared memory) each block's row of scores lives in a device scratch.

`--mode d3` (semantic evaluation): the point network of `--semantic_network`
loads from the checkpoint's 'points' entry (its class count from the
checkpoint's head when `--n_classes` is 0; a count that differs from the
head is refused, since the non-strict load would keep a random head), and
every tile's point cloud gives the class maps (`render/rendering_3d.py`):
on the exact `render_rays_3d` (`--renderer fused` renders there too: K1 has
no class head), or with `--renderer fast` over the fast renderer's
survivors (K3 then K1 on the card, `return_samples`), which refuses
`--fast_cull` and `--fast_adaptive` as JAX does. Each frame adds the class
map `r_<i>.png` (class id x 10) and the `color_cls` overlays in
`<scene_name>_cls_map/`, and with labels the pixel accuracy and mIoU.

`--num_chips N` (0: every visible card; a count above the visible one is
refused, naming it) renders each frame over a `parallel/mesh.py::Mesh` of
N devices of `--device` (on the CPU, N slots of it), zero collectives, as
JAX's CLI: the exact route in contiguous slabs of the frame (each chunked
as on one device), the fused, fast and d3 routes through
`sharded_tile_render` (each slab padded to whole `--chunk` tiles, so the
tiles are the one-device ones), `--fast_cull auto` in the auto-cull
renderer's mesh mode (per-shard budgets, the next frame sized from the
maximum). `--fast_edge_refine` is refused with more than one device, as
JAX refuses it.

`make_renderer` and `make_semantic_renderer` hold the ray tiling and the
render call, so every caller (this CLI, `chip_smoke.py`) drives the same
code. Datasets (PIL, cv2) and `imageio` are imported inside `main` only.
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
from nerf_siren_tpu_torch.opt import add_point_capacity
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import pack_model_params
from nerf_siren_tpu_torch.ops.kernels.fused_mlp_int8 import pack_model_params_int8
from nerf_siren_tpu_torch.ops.kernels.proxy_march import pack_proxy_params
from nerf_siren_tpu_torch.render.fast import (Proxy, distill_proxy, estimate_scene_aabb,
                                              make_auto_cull_renderer,
                                              make_edge_refined_renderer, render_rays_fast,
                                              scene_box)
from nerf_siren_tpu_torch.render.fused import render_rays_fused
from nerf_siren_tpu_torch.render.rendering import map_chunks, render_rays_chunked
from nerf_siren_tpu_torch.render.rendering_3d import render_rays_3d, semantic_from_weights
from nerf_siren_tpu_torch.training.checkpoints import (extract_model_state, load_checkpoint,
                                                         save_checkpoint)


def get_opts(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True)
    parser.add_argument('--dataset_name', type=dataset_name, default='blender',
                        help="'blender', 'llff', or a semantic loader "
                             "('blender_cls_ib', 'llff_cls', 'llff_cls_ib', 'replica')")
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
                        help="devices of --device to render each frame over (slabs "
                             "of its rays); 0: every visible card")
    parser.add_argument('--mode', type=str, default='normal', choices=['normal', 'd3'],
                        help="'d3': semantic evaluation, class maps from the "
                             "checkpoint's point network over each tile's point cloud")
    parser.add_argument('--semantic_network', type=str, default='pointnet',
                        choices=['pointnet', 'conv3d'])
    parser.add_argument('--n_classes', type=int, default=0,
                        help="semantic class count; 0 (default) reads it from the "
                             "checkpoint's point-network head")
    parser.add_argument('--point_norm', type=str, default='frob', choices=['frob', 'rms'],
                        help="semantic cloud normalization (as in training)")
    add_point_capacity(parser)
    parser.add_argument('--cls_threshold', type=float, default=None,
                        help="weight threshold of a valid cloud point; default 0.5 with "
                             "N_importance > 0 (test time), else 0; pass 0.0 for a "
                             "field whose weights stay below 0.5")
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default; fails when no card is visible) "
                             "or 'cpu'")
    opts = parser.parse_args(args)
    if opts.mode == 'd3' and opts.renderer == 'fast' and (
            opts.fast_cull is not None or opts.fast_adaptive is not None):
        parser.error("--mode d3 --renderer fast does not take --fast_cull or "
                     "--fast_adaptive: the class head needs every ray's survivors")
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
    renders, the density proxy, the scene box (on the host, as the proxy
    cache keeps it; the renderers put it on their devices, `fast_box`), the
    field packs of the survivors (bf16 or int8) and the proxy's kernel pack
    (None off the kernel route)."""
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


def fast_kwargs(render_cfg: RenderConfig, fast: FastSetup, hparams,
                compute_dtype: Optional[torch.dtype] = None) -> dict:
    """The `render_rays_fast` arguments every fast path shares; not the box,
    which each renderer puts on its devices once (`fast_box`)."""
    h = hparams
    return dict(n_candidates=h.fast_candidates, n_keep=h.fast_keep, model=fast.model_key,
                white_back=render_cfg.white_back, compute_dtype=compute_dtype,
                packed_params=fast.packed, packed_proxy=fast.packed_proxy,
                placement=h.fast_placement, quadrature=h.fast_quadrature)


def fast_box(models: Dict[str, torch.nn.Module], fast: FastSetup) -> Optional[torch.Tensor]:
    """`fast.aabb` as a (2, 3) float32 tensor on the rendered field's device
    (None without a box): made once per renderer, so that no tile copies
    the box from the host (a copy that would wait for the device)."""
    if fast.aabb is None:
        return None
    return scene_box(fast.aabb, next(models[fast.model_key].parameters()).device)


def eval_mesh(device, num_chips: int):
    """The mesh of `--num_chips` on `device`'s type, or None for one device
    (`parallel/mesh.py::mesh_devices` refuses a count above the visible
    one)."""
    from nerf_siren_tpu_torch.parallel.mesh import make_mesh, mesh_devices

    if num_chips == 1:
        return None
    devices = mesh_devices(device, num_chips)
    return make_mesh(devices=devices) if len(devices) > 1 else None


def tiled(tile_fn_for: Callable, objs: tuple, chunk: int, mesh=None):
    """A frame renderer from a tile renderer: tile_fn_for(*objs) tiled by
    `chunk` on one device, or with a mesh one per device on the device's
    replicas of `objs` through `sharded_tile_render`."""
    from nerf_siren_tpu_torch.parallel.mesh import replicate, sharded_tile_render

    if mesh is None:
        tile = tile_fn_for(*objs)
        return lambda rays: map_chunks(tile, rays, chunk)
    reps = list(zip(*(replicate(o, mesh) for o in objs)))
    return sharded_tile_render([tile_fn_for(*r) for r in reps], mesh, chunk)


def make_fast_renderer(models: Dict[str, NeRF], render_cfg: RenderConfig, fast: FastSetup,
                       hparams, compute_dtype: Optional[torch.dtype] = None,
                       img_hw: Optional[Tuple[int, int]] = None, mesh=None):
    """`--renderer fast` as the JAX CLI builds it: `render_rays_fast` per
    tile of `render_cfg.chunk` rays (with `--fast_adaptive` or a fixed
    `--fast_cull`), or the auto-cull frame driver (`--fast_cull auto`), then
    the edge refinement pass (`--fast_edge_refine`, needs `img_hw`); over
    `mesh` when given (see the module docstring)."""
    h = hparams
    common = fast_kwargs(render_cfg, fast, hparams, compute_dtype)
    if (h.fast_cull is not None or h.fast_adaptive is not None) and fast.packed_proxy is None:
        raise SystemExit('--fast_cull / --fast_adaptive need the kernel route '
                         '(--fast_select pdf, --fast_keep >= 2)')
    if h.fast_cull == 'auto':
        eps = h.fast_opacity_eps if h.fast_opacity_eps == 'auto' else float(h.fast_opacity_eps)
        render = make_auto_cull_renderer(models, fast.proxy, margin=h.fast_cull_margin,
                                         opacity_eps=eps, prepass_candidates=h.fast_prepass,
                                         scene_aabb=fast.aabb, mesh=mesh, **common)
    else:
        adaptive = None if h.fast_adaptive is None else (float(h.fast_adaptive[0]),
                                                         int(h.fast_adaptive[1]))
        cull = None if h.fast_cull is None else float(h.fast_cull)

        def tile_for(ms, proxy, packed, packed_proxy, box):
            kw = dict(common, packed_params=packed, packed_proxy=packed_proxy, scene_aabb=box)
            return lambda t: render_rays_fast(ms, proxy, t, select=h.fast_select,
                                              adaptive=adaptive, cull=cull, **kw)

        render = tiled(tile_for, (models, fast.proxy, fast.packed, fast.packed_proxy,
                                  fast_box(models, fast)), render_cfg.chunk, mesh)
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
                  img_hw: Optional[Tuple[int, int]] = None, mesh=None
                  ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """A function of (N, 8) rays -> render outputs, tiled by `render_cfg.chunk`.

    'fused' packs the fields once here (bf16, or int8 with `field_dtype`)
    and runs `render_rays_fused` per tile (it needs the test_time coarse
    pass, n_importance > 0); 'exact' runs `render_rays` per tile at
    `compute_dtype`; 'fast' runs `make_fast_renderer` with `fast`
    (`setup_fast_proxy`) and the CLI options `hparams`. With `mesh` every
    route renders over its devices (the module docstring)."""
    if renderer == 'fast':
        return make_fast_renderer(models, render_cfg, fast, hparams, compute_dtype, img_hw,
                                  mesh)
    if renderer == 'fused':
        return tiled(lambda packed: lambda t: render_rays_fused(packed, t, render_cfg),
                     (field_packs(models, field_dtype),), render_cfg.chunk, mesh)
    if renderer == 'exact':
        def exact(ms):
            return lambda rays: render_rays_chunked(ms, rays, render_cfg, None,
                                                    compute_dtype=compute_dtype)
        if mesh is None:
            return exact(models)
        from nerf_siren_tpu_torch.parallel.mesh import render_slabs, replicate

        fns = [exact(ms) for ms in replicate(models, mesh)]
        return lambda rays: render_slabs(fns, mesh, rays)
    raise ValueError(f"unknown renderer {renderer!r}")


def make_semantic_renderer(models: Dict[str, torch.nn.Module], render_cfg: RenderConfig, *,
                           renderer: str, n_classes: int, point_capacity: int = 8192,
                           point_norm: str = 'frob', cls_threshold: Optional[float] = None,
                           compute_dtype: Optional[torch.dtype] = None,
                           fast: Optional[FastSetup] = None, hparams=None, mesh=None
                           ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """`--mode d3`: a function of (N, 8) rays -> render outputs with
    cls_<model> (log-probabilities), one point cloud per `render_cfg.chunk`
    tile (the last one may be shorter: its cloud is the one JAX builds on
    the tile padded with zero rays, whose samples all weigh 0 and are never
    valid). 'exact' runs `render_rays_3d` at `compute_dtype`; 'fast' runs
    `render_rays_fast` with `fast` and the CLI's options `hparams` and
    composites the class maps over its survivors. `models` holds the fields
    and 'points'. With `mesh` the tiles are the one-device tiles, spread
    over the devices (`sharded_tile_render`), so the clouds are the same."""
    threshold = (0.5 if render_cfg.test_time else 0.0) if cls_threshold is None \
        else cls_threshold
    sem = dict(n_classes=n_classes, point_capacity=point_capacity, point_norm=point_norm)
    if renderer == 'fast':
        common = fast_kwargs(render_cfg, fast, hparams, compute_dtype)

        def tile_for(ms, proxy, packed, packed_proxy, box):
            kw = dict(common, packed_params=packed, packed_proxy=packed_proxy, scene_aabb=box)

            def tile(t):
                out = render_rays_fast(ms, proxy, t, select=hparams.fast_select,
                                       return_samples=True, **kw)
                xyz = t[:, None, 0:3] + t[:, None, 3:6] * out.pop('z_samples')[..., None]
                out[f'cls_{fast.model_key}'] = semantic_from_weights(
                    ms['points'], xyz, out.pop('rgb_samples'), out.pop('w_samples'),
                    threshold=threshold, **sem)
                return out
            return tile
        objs = (models, fast.proxy, fast.packed, fast.packed_proxy, fast_box(models, fast))
    elif renderer == 'exact':
        def tile_for(ms):
            return lambda t: render_rays_3d(ms, t, render_cfg, None, no_grad_on_nerf=False,
                                            compute_dtype=compute_dtype,
                                            cls_threshold=threshold, **sem)
        objs = (models,)
    else:
        raise ValueError(f"--mode d3 renders 'exact' or 'fast', not {renderer!r}")
    return tiled(tile_for, objs, render_cfg.chunk, mesh)


def infer_ckpt_classes(ckpt_path: str, semantic_network: str) -> Optional[int]:
    """The class count of the checkpoint's point-network head (pointnet:
    `conv4`'s kernel (128, k); conv3d: `head`'s (1, 1, 1, 16, k)), or None."""
    tree = load_checkpoint(ckpt_path)
    tree = tree.get('params', tree) if isinstance(tree, dict) else {}
    pts = tree.get('points') if isinstance(tree, dict) else None
    if not isinstance(pts, dict):
        return None
    try:
        head = pts['conv4'] if semantic_network == 'pointnet' else pts['head']
        return int(np.asarray(head['kernel']).shape[-1])
    except (KeyError, TypeError):
        return None


def resolve_classes(hparams, dataset) -> int:
    """`--n_classes`, or with 0 the checkpoint head's count (else the
    dataset's, else 6); a count that differs from the head exits."""
    ckpt_classes = infer_ckpt_classes(hparams.ckpt_path, hparams.semantic_network)
    if hparams.n_classes == 0:
        n = ckpt_classes or getattr(dataset, 'n_classes', 0) or 6
        print(f'n_classes = {n} ({"checkpoint head" if ckpt_classes else "dataset"})',
              flush=True)
        return n
    if ckpt_classes and ckpt_classes != hparams.n_classes:
        raise SystemExit(
            f"--n_classes {hparams.n_classes} does not match the checkpoint's "
            f"{hparams.semantic_network} classifier head ({ckpt_classes} classes); the "
            f"non-strict load would keep the random init. Pass --n_classes "
            f"{ckpt_classes} or 0 (auto).")
    return hparams.n_classes


def main(hparams):
    import imageio

    from nerf_siren_tpu_torch.datasets import dataset_dict
    from nerf_siren_tpu_torch.datasets.depth_utils import save_pfm
    from nerf_siren_tpu_torch.training.checkpoints import load_ckpt, load_nerf_fields
    from nerf_siren_tpu_torch.training.metrics import miou as miou_fn
    from nerf_siren_tpu_torch.training.metrics import psnr as psnr_fn
    from nerf_siren_tpu_torch.utils.color import color_cls

    device = resolve_device(hparams.device)
    mesh = eval_mesh(device, hparams.num_chips)
    if mesh is not None and hparams.renderer == 'fast' and hparams.fast_edge_refine is not None:
        raise SystemExit('--fast_edge_refine is an image-space pass '
                         'and does not compose with --num_chips yet')
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

    models = load_nerf_fields(hparams.ckpt_path, device, hparams.N_importance, nerf_cfg)

    renderer = hparams.renderer
    if renderer == 'fused' and not render_cfg.test_time:
        print('NOTE: --renderer fused requires N_importance > 0 '
              '(test_time coarse pass); falling back to the exact renderer',
              flush=True)
        renderer = 'exact'
    d3 = hparams.mode == 'd3'
    if d3 and renderer == 'fused':
        print('NOTE: --mode d3 renders through the exact render_rays_3d path (--renderer '
              'fused has no semantic head); pass --renderer fast for the survivor path',
              flush=True)
        renderer = 'exact'
    if mesh is not None:
        print(f'rendering each frame over {mesh.size} devices: '
              f'{", ".join(str(d) for d in mesh.devices)}', flush=True)
    fast = None
    if renderer == 'fast':
        fast = setup_fast_proxy(models, hparams, dataset.bounds)
    if d3:
        from nerf_siren_tpu_torch.training.semantic_system import make_points_network

        n_classes = resolve_classes(hparams, dataset)
        points = make_points_network(hparams.semantic_network, n_classes,
                                     torch.Generator().manual_seed(2))
        models['points'] = load_ckpt(points, hparams.ckpt_path, 'points').to(device)
        render = make_semantic_renderer(
            models, render_cfg, renderer=renderer, n_classes=n_classes,
            point_capacity=hparams.point_capacity, point_norm=hparams.point_norm,
            cls_threshold=hparams.cls_threshold, compute_dtype=compute_dtype, fast=fast,
            hparams=hparams, mesh=mesh)
    else:
        render = make_renderer(models, render_cfg, renderer=renderer,
                               compute_dtype=compute_dtype, field_dtype=hparams.fast_field_dtype,
                               fast=fast, hparams=hparams, img_hw=(h, w), mesh=mesh)

    out_dir = os.path.join('results', hparams.dataset_name, hparams.scene_name)
    os.makedirs(out_dir, exist_ok=True)

    imgs, psnrs, cls_accs, mious, empty_frac = [], [], [], [], []
    with torch.no_grad():
        for i in range(len(dataset)):
            sample = dataset[i]
            out = render(torch.as_tensor(np.asarray(sample['rays'], np.float32), device=device))
            key = 'rgb_fine' if 'rgb_fine' in out else 'rgb_coarse'
            pred = out[key].float().cpu().numpy().reshape(h, w, 3)
            img = (np.clip(pred, 0, 1) * 255).astype(np.uint8)
            imgs.append(img)
            imageio.imwrite(os.path.join(out_dir, f'{i:03d}.png'), img)

            if d3:
                raw_cls = out[key.replace('rgb', 'cls')].float().cpu()
                cls_pred = raw_cls.argmax(-1).numpy().reshape(h, w)
                # an all-zero row: the ray's samples had no valid cloud point
                empty_frac.append(float((raw_cls == 0).all(-1).float().mean()))
                imageio.imwrite(os.path.join(out_dir, f'r_{i}.png'),
                                (cls_pred * 10).astype(np.uint8))
                color_cls(img, cls_pred, prefix=str(i),
                          savedir=os.path.join('results', hparams.dataset_name,
                                               f'{hparams.scene_name}_cls_map'))
                if 'cls' in sample:
                    gt_cls = torch.as_tensor(np.asarray(sample['cls'])).reshape(-1)
                    flat_pred = torch.from_numpy(cls_pred.reshape(-1))
                    cls_accs.append(float((flat_pred == gt_cls).float().mean()))
                    mious.append(float(miou_fn(flat_pred, gt_cls, n_classes)[0]))

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
    if cls_accs:
        print(f'Mean class accuracy: {np.mean(cls_accs):.4f} mIoU: {np.mean(mious):.4f}')
    if empty_frac and np.mean(empty_frac) > 0.9:
        thr = ('0.5 (reference test-time mask)' if hparams.cls_threshold is None
               else hparams.cls_threshold)
        print(f'WARNING: {np.mean(empty_frac):.0%} of rays had no point above the weight '
              f'mask (threshold {thr}): the class maps are degenerate. For coarse-only or '
              f'low-N_samples checkpoints pass --cls_threshold 0.0 (the training mask).')
    return np.mean(psnrs) if psnrs else None


if __name__ == '__main__':
    main(get_opts())
