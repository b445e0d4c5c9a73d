"""Training CLI of the port: `python -m nerf_siren_tpu_torch.train`.

Counterpart of the JAX package's root `train.py` in `--mode normal` with
the MLP field: builds the dataset and the `NeRFSystem`, runs the epoch
loop (`epoch_iterator` batches, one `train_step` each), validates on the
`val` split (loss and PSNR of the first image, plain renderer), keeps the
best `--save_topk` checkpoints by validation loss, and supports a full
resume (`--ckpt_path`, a checkpoint this CLI wrote) and a warm start of the
weights (`--pretrained`, a checkpoint of either package). TensorBoard
scalars are written when `tensorboardX` imports. It runs on `--device`
(default `cuda`, which fails when no card is visible; the tests pass
`--device cpu`); `--train_backend fused` runs the field on K2 there.
Not ported yet (ROADMAP): the depth image of validation (needs cv2's
`visualize_depth`), `--steps_per_dispatch`, multi-GPU.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from nerf_siren_tpu_torch.opt import get_opts


def build_system(hparams, white_back: bool, steps_per_epoch: int, device):
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    render_cfg = RenderConfig(
        n_samples=hparams.N_samples, n_importance=hparams.N_importance,
        use_disp=hparams.use_disp, perturb=hparams.perturb, noise_std=hparams.noise_std,
        white_back=white_back, chunk=hparams.chunk)
    train_cfg = TrainConfig(
        optimizer=hparams.optimizer, lr=hparams.lr, momentum=hparams.momentum,
        weight_decay=hparams.weight_decay, lr_scheduler=hparams.lr_scheduler,
        decay_step=tuple(hparams.decay_step), decay_gamma=hparams.decay_gamma,
        warmup_epochs=hparams.warmup_epochs, warmup_multiplier=hparams.warmup_multiplier,
        poly_exp=hparams.poly_exp, num_epochs=hparams.num_epochs,
        batch_size=hparams.batch_size, loss_type=hparams.loss_type, seed=hparams.seed)
    nerf_cfg = NeRFConfig(n_classes=hparams.n_classes or 0)
    return NeRFSystem(render_cfg, train_cfg, nerf_cfg, steps_per_epoch,
                      train_backend=hparams.train_backend, device=device)


def validate(system, state, val_ds, writer, step: int, img_wh, max_images: int = 1):
    """Mean loss and PSNR (over the valid mask, when the split has one) of
    the first `max_images` validation images."""
    from nerf_siren_tpu_torch.training.metrics import psnr as psnr_fn

    w, h = img_wh
    losses, psnrs = [], []
    for i in range(min(len(val_ds), max_images)):
        sample = val_ds[i]
        out = system.render(state.models, sample["rays"])
        key = "rgb_fine" if "rgb_fine" in out else "rgb_coarse"
        pred = out[key].float().cpu().reshape(h, w, 3)
        gt = torch.from_numpy(np.asarray(sample["rgbs"], np.float32).reshape(h, w, 3))
        mask = sample.get("valid_mask")
        mask3 = (torch.from_numpy(np.asarray(mask).reshape(h, w, 1)).expand(h, w, 3)
                 if mask is not None else None)
        losses.append(float(((pred - gt) ** 2).mean()))
        psnrs.append(float(psnr_fn(pred, gt, mask3)))
    val_loss, val_psnr = float(np.mean(losses)), float(np.mean(psnrs))
    if writer is not None:
        writer.add_scalar("val/loss", val_loss, step)
        writer.add_scalar("val/psnr", val_psnr, step)
    return val_loss, val_psnr


def main(hparams):
    from nerf_siren_tpu_torch.datasets import dataset_dict
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.training import checkpoints as ckpt_lib
    from nerf_siren_tpu_torch.training.system import epoch_iterator

    device = resolve_device(hparams.device)
    dataset_cls = dataset_dict[hparams.dataset_name]
    kwargs = dict(root_dir=hparams.root_dir, img_wh=tuple(hparams.img_wh))
    if hparams.dataset_name == "llff":
        kwargs["spheric_poses"] = hparams.spheric_poses
    train_ds = dataset_cls(split="train", **kwargs)
    val_ds = dataset_cls(split="val", **kwargs)

    steps_per_epoch = max(1, len(train_ds.all_rays) // hparams.batch_size)
    system = build_system(hparams, train_ds.white_back, steps_per_epoch, device)
    optimizer = hparams.optimizer

    state = system.init_state(hparams.seed)
    start_epoch = 0
    if hparams.ckpt_path:  # full resume
        state, start_epoch = ckpt_lib.restore_train_state(hparams.ckpt_path, state, optimizer)
        print(f"resumed from {hparams.ckpt_path} at epoch {start_epoch}, step {state.step}")
    elif hparams.pretrained:  # warm start of the weights only
        for key, name in ckpt_lib.MODEL_NAMES.items():
            if key in state.models:
                ckpt_lib.load_ckpt(state.models[key], hparams.pretrained, name,
                                   hparams.prefixes_to_ignore)
        state = system.state_for(state.models)
        print(f"warm-started from {hparams.pretrained}")

    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        SummaryWriter = None
    if SummaryWriter is not None:
        writer = SummaryWriter(os.path.join("logs", hparams.exp_name))

    ckpt_dir = os.path.join("ckpts", hparams.exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    saved: list = []  # (val_loss, path)
    checkpointer = ckpt_lib.AsyncCheckpointer()
    try:
        for epoch in range(start_epoch, hparams.num_epochs):
            t0 = time.time()
            metrics: Dict = {}
            for batch in epoch_iterator(train_ds.all_rays, train_ds.all_rgbs,
                                        hparams.batch_size, hparams.seed, epoch):
                state, metrics = system.train_step(state, batch, hparams.seed + 1)
            step = state.step
            if writer is not None:
                for k, v in metrics.items():
                    writer.add_scalar(k, float(v), step)
                writer.add_scalar("lr", system.current_lr(state), step)
            line = f"epoch {epoch} step {step} " + " ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()) + f" ({time.time() - t0:.1f}s)"

            if (epoch + 1) % hparams.val_every == 0 or epoch == hparams.num_epochs - 1:
                val_loss, val_psnr = validate(system, state, val_ds, writer, step,
                                              tuple(hparams.img_wh))
                line += f" val/loss={val_loss:.4f} val/psnr={val_psnr:.2f}"
                path = os.path.join(ckpt_dir, f"epoch={epoch}-step={step}.msgpack")
                checkpointer.save_train_state(path, state, epoch + 1, optimizer)
                saved.append((val_loss, path))
                saved.sort(key=lambda t: t[0])
                if len(saved) > hparams.save_topk:
                    checkpointer.wait()  # never unlink a file still being written
                for _, stale in saved[hparams.save_topk:]:
                    if os.path.exists(stale):
                        os.remove(stale)
                saved = saved[: hparams.save_topk]
            print(line, flush=True)
    finally:
        checkpointer.close()  # every checkpoint file is on disk before returning
        if writer is not None:
            writer.close()
    return state


if __name__ == "__main__":
    main(get_opts())
