"""Single-image inference walkthrough (the headless version of the
reference's test.ipynb): load a checkpoint, render one view of a split,
report PSNR and timing, save the rgb and JET-depth images.

Counterpart of the JAX package's `examples/render_single_image.py`, with
its flags plus `--device`:

    python -m nerf_siren_tpu_torch.examples.render_single_image --root_dir ... \\
        --ckpt_path ... [--dataset_name blender --img_wh 400 400 --idx 0]

`render_view` is the work (the plain `render_rays_chunked` with bf16 field
compute, as JAX's example renders); the dataset (PIL) and the image writes
(imageio) stay in `main`.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--dataset_name", default="blender")
    parser.add_argument("--split", default="val")
    parser.add_argument("--img_wh", nargs="+", type=int, default=[400, 400])
    parser.add_argument("--idx", type=int, default=0)
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--N_importance", type=int, default=64)
    parser.add_argument("--out_dir", default="results/single")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; fails when no card is visible) or 'cpu'")
    return parser.parse_args(argv)


@torch.no_grad()
def render_view(models: Dict[str, torch.nn.Module], rays: torch.Tensor, cfg
                ) -> Dict[str, torch.Tensor]:
    """One view's (N, 8) rays rendered under `cfg` in `cfg.chunk` tiles,
    the fields computing in bf16."""
    from nerf_siren_tpu_torch.render.rendering import render_rays_chunked

    return render_rays_chunked(models, rays, cfg, None, compute_dtype=torch.bfloat16)


def main(args):
    import imageio

    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.datasets import dataset_dict
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.training.checkpoints import load_nerf_fields
    from nerf_siren_tpu_torch.training.metrics import psnr
    from nerf_siren_tpu_torch.utils.visualization import visualize_depth

    device = resolve_device(args.device)
    w, h = args.img_wh
    ds = dataset_dict[args.dataset_name](root_dir=args.root_dir, split=args.split,
                                         img_wh=tuple(args.img_wh))
    sample = ds[args.idx]
    models = load_nerf_fields(args.ckpt_path, device, args.N_importance)
    cfg = RenderConfig(n_samples=args.N_samples, n_importance=args.N_importance,
                       perturb=0.0, noise_std=0.0, white_back=ds.white_back,
                       test_time=args.N_importance > 0)

    def synced(fn):
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    rays = torch.as_tensor(np.asarray(sample["rays"], np.float32), device=device)
    synced(lambda: render_view(models, rays, cfg))   # warm-up
    t0 = time.perf_counter()
    out = synced(lambda: render_view(models, rays, cfg))
    dt = time.perf_counter() - t0
    key = "rgb_fine" if "rgb_fine" in out else "rgb_coarse"

    pred = out[key].float().cpu().numpy().reshape(h, w, 3)
    depth = out[key.replace("rgb", "depth")].float().cpu().numpy().reshape(h, w)
    print(f"render time: {dt * 1000:.1f} ms ({rays.shape[0] / dt / 1e3:.0f}K rays/s)")
    if "rgbs" in sample:
        gt = np.asarray(sample["rgbs"], np.float32).reshape(h, w, 3)
        print(f"PSNR: {float(psnr(torch.from_numpy(pred), torch.from_numpy(gt))):.2f} dB")

    os.makedirs(args.out_dir, exist_ok=True)
    imageio.imwrite(os.path.join(args.out_dir, "rgb.png"),
                    (np.clip(pred, 0, 1) * 255).astype(np.uint8))
    imageio.imwrite(os.path.join(args.out_dir, "depth.png"), visualize_depth(depth))
    print(f"wrote {args.out_dir}/rgb.png and depth.png")


if __name__ == "__main__":
    main(get_opts())
