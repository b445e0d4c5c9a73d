"""Training CLI of the port: `python -m nerf_siren_tpu_torch.train`.

Counterpart of the JAX package's root `train.py` in `--mode normal` (the
MLP field, or `--field siren`), `--mode d3` / `d3_ib` (the semantic
system, `--semantic_network pointnet|conv3d`, on a dataset with class
labels) and `--mode eg3d` (the single-scene EG3D renderer,
`training/eg3d_system.py`, sized by the `--eg3d_*` flags, `--N_samples` +
`--N_importance` samples): builds the dataset and the system, runs the epoch loop
(`epoch_iterator` batches, with the dataset's 'cls' labels when it has
them, one `train_step` each, or with `--steps_per_dispatch` N > 1 groups of
N batches through `train_scan_batches`, a captured CUDA graph on the card,
the epoch's tail as one smaller group), validates on the `val` split (loss
and PSNR of the first image, plain renderer; with class maps also the
pixel accuracy and mIoU, and the first image's class map written under
`mid_results/<exp_name>/`; the GT | prediction | depth image to
TensorBoard), keeps the best `--save_topk` checkpoints by validation loss,
and supports a full resume (`--ckpt_path`, a checkpoint this CLI wrote; the
weights load into the same tensors, so a captured graph stays valid) and a
warm start of the weights (`--pretrained`, a checkpoint of either
package). TensorBoard scalars are written when `tensorboardX` imports. It
runs on `--device` (default `cuda`, which fails when no card is visible;
the tests pass `--device cpu`); `--train_backend fused` runs the field on
K2 there, `culled` trains with the online proxy's sample placement
(`render/culled_train.py`, logging `train/proxy_loss`; the checkpoints
hold the proxy under `proxy`) and `culled_fused` does both.

Data-parallel training (`parallel/shard_train.py`), one process per
device, every backend and mode, eager and grouped:
- `--num_chips N` (N > 1) spawns N local ranks with `torch.multiprocessing`
  (NCCL between cards, gloo on the CPU, a `file://` store in a temporary
  directory), rank r on the r-th device; each takes the rows [r B / N,
  (r + 1) B / N) of the one-process batches (`epoch_iterator(block=)`),
  so N ranks train the `--num_chips 1` trajectory. 0 means every visible
  card (the CPU counts as one); a count above the visible one is refused,
  naming it. With one device no process group is made.
- `--multihost`: this process is one rank of a group (torchrun, or
  `--coordinator_address`, `--num_processes`, `--process_id` and JAX's
  `NERF_TPU_*` names; `parallel/multihost.py`); it reads JAX's interleaved
  shard of every epoch (`epoch_iterator(shard_index=rank,
  num_shards=world)`), and checkpoints are ranked by the epoch-mean train
  loss, as in JAX.
Rank 0 alone prints, writes TensorBoard scalars and checkpoints; under
`--num_chips` it validates on its device.
"""
from __future__ import annotations

import inspect
import os
import time
from typing import Dict

import numpy as np
import torch

from nerf_siren_tpu_torch.opt import get_opts


def build_system(hparams, white_back: bool, steps_per_epoch: int, device,
                 n_classes: int = 0, data_parallel=None):
    """The system of `--mode`: `NeRFSystem` (normal), `NeRF3DSystem` (d3,
    d3_ib; `n_classes` from the dataset, else 6) or `EG3DSystem` (eg3d: the
    `--eg3d_*` flags, N_importance floored at 1, the dataset's background)."""
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
    if hparams.mode == "eg3d":
        from nerf_siren_tpu_torch.eval_eg3d import triplane_config
        from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

        return EG3DSystem(triplane_config(hparams, white_back), train_cfg=train_cfg,
                          steps_per_epoch=steps_per_epoch, device=device,
                          data_parallel=data_parallel)
    if hparams.mode in ("d3", "d3_ib"):
        from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem

        if hparams.train_backend != "jnp":
            print(f"NOTE: --mode {hparams.mode} trains the plain field (jnp), as the JAX "
                  f"package does; --train_backend {hparams.train_backend} is not used",
                  flush=True)
        return NeRF3DSystem(render_cfg, train_cfg, nerf_cfg, steps_per_epoch,
                            semantic_network=hparams.semantic_network,
                            point_norm=hparams.point_norm, n_classes=n_classes or 6,
                            device=device, data_parallel=data_parallel)
    return NeRFSystem(render_cfg, train_cfg, nerf_cfg, steps_per_epoch,
                      train_backend=hparams.train_backend, device=device,
                      field_type=hparams.field, siren_box_warp=hparams.siren_box_warp,
                      data_parallel=data_parallel)


def validate(system, state, val_ds, writer, step: int, img_wh, max_images: int = 1,
             exp_name: str = "exp"):
    """Mean loss and PSNR (over the valid mask, when the split has one) of
    the first `max_images` validation images; the first image's GT,
    prediction and depth side by side to `writer`. With class maps and
    labels also the pixel accuracy and mIoU, and the first image's class
    map (`utils/color.py::color_cls`) under `mid_results/<exp_name>/`."""
    from nerf_siren_tpu_torch.training.metrics import miou as miou_fn
    from nerf_siren_tpu_torch.training.metrics import psnr as psnr_fn
    from nerf_siren_tpu_torch.utils.visualization import visualize_depth

    w, h = img_wh
    losses, psnrs, cls_accs, mious = [], [], [], []
    # the EG3D system renders its one model, the others their dict of models
    models = state.models.get("eg3d_renderer", state.models)
    for i in range(min(len(val_ds), max_images)):
        sample = val_ds[i]
        rays = torch.as_tensor(np.asarray(sample["rays"], np.float32), device=system.device)
        out = system.render(models, rays)
        key = "rgb_fine" if "rgb_fine" in out else "rgb_coarse"
        pred = out[key].float().cpu().reshape(h, w, 3)
        gt = torch.from_numpy(np.asarray(sample["rgbs"], np.float32).reshape(h, w, 3))
        mask = sample.get("valid_mask")
        mask3 = (torch.from_numpy(np.asarray(mask).reshape(h, w, 1)).expand(h, w, 3)
                 if mask is not None else None)
        losses.append(float(((pred - gt) ** 2).mean()))
        psnrs.append(float(psnr_fn(pred, gt, mask3)))
        cls_key = key.replace("rgb", "cls")
        if cls_key in out and "cls" in sample:
            pred_cls = out[cls_key].float().cpu().argmax(-1)
            gt_cls = torch.as_tensor(np.asarray(sample["cls"])).reshape(-1)
            cls_accs.append(float((pred_cls == gt_cls).float().mean()))
            mious.append(float(miou_fn(pred_cls, gt_cls, out[cls_key].shape[-1])[0]))
            if i == 0:
                from nerf_siren_tpu_torch.utils.color import color_cls

                color_cls((np.clip(pred.numpy(), 0, 1) * 255).astype(np.uint8),
                          pred_cls.numpy().reshape(h, w),
                          savedir=os.path.join("mid_results", exp_name), prefix=f"step{step}_")
        if writer is not None and i == 0:
            depth = out[key.replace("rgb", "depth")].float().cpu().reshape(h, w)
            depth_vis = visualize_depth(depth.numpy()).astype(np.float32) / 255.0
            triplet = np.concatenate([gt.numpy(), pred.numpy(), depth_vis], axis=1)
            writer.add_image("val/GT_pred_depth", np.clip(triplet, 0, 1), step,
                             dataformats="HWC")
    val_loss, val_psnr = float(np.mean(losses)), float(np.mean(psnrs))
    if writer is not None:
        writer.add_scalar("val/loss", val_loss, step)
        writer.add_scalar("val/psnr", val_psnr, step)
        if cls_accs:
            writer.add_scalar("val/cls_acc", float(np.mean(cls_accs)), step)
            writer.add_scalar("val/miou", float(np.mean(mious)), step)
    return val_loss, val_psnr


def main(hparams):
    """Train as the flags say: one process, N spawned local ranks
    (`--num_chips`), or one rank of a multi-process group (`--multihost`).
    Returns the final state (None in the process that spawned ranks)."""
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.parallel.mesh import mesh_devices

    device = resolve_device(hparams.device)
    if hparams.multihost:
        from nerf_siren_tpu_torch.parallel import multihost
        from nerf_siren_tpu_torch.parallel.shard_train import DataParallel

        multihost.initialize_distributed(hparams.coordinator_address, hparams.num_processes,
                                         hparams.process_id, device.type)
        if device.type == "cuda":
            device = multihost.local_device("cuda")
        dp = DataParallel() if multihost.process_count() > 1 else None
        return train(hparams, device, dp, multihost=True)
    devices = mesh_devices(device, hparams.num_chips)
    if len(devices) == 1:
        return train(hparams, device)
    spawn_ranks(hparams, devices)
    return None


def spawn_ranks(hparams, devices) -> None:
    """Run `train` on len(devices) local ranks, rank r on devices[r], joined
    by a file store in a fresh temporary directory (removed afterwards)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from nerf_siren_tpu_torch.parallel.shard_train import batch_split_error

    err = batch_split_error(hparams.batch_size, len(devices))
    if err:
        raise SystemExit(err)
    store_dir = tempfile.mkdtemp(prefix="nerf_torch_ranks_")
    # CPU ranks share this process's intra-op threads
    threads = max(1, torch.get_num_threads() // len(devices))
    try:
        mp.spawn(_rank_main, args=(hparams, [str(d) for d in devices],
                                   os.path.join(store_dir, "store"), threads),
                 nprocs=len(devices), join=True)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _rank_main(rank: int, hparams, devices, store: str, threads: int) -> None:
    """One spawned rank: join the group, train on devices[rank] (on the CPU
    with `threads` intra-op threads)."""
    import torch.distributed as dist

    from nerf_siren_tpu_torch.parallel.multihost import backend_for
    from nerf_siren_tpu_torch.parallel.shard_train import DataParallel

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend_for(device.type), init_method=f"file://{store}",
                            world_size=len(devices), rank=rank)
    try:
        train(hparams, device, DataParallel())
    finally:
        dist.destroy_process_group()


def train(hparams, device, dp=None, multihost: bool = False):
    """The epoch loop on `device`; with `dp` (a `DataParallel`) as one rank
    of it: `--multihost` reads the rank's interleaved shard, otherwise the
    rank's rows of the one-process batches."""
    from nerf_siren_tpu_torch.datasets import dataset_dict
    from nerf_siren_tpu_torch.training import checkpoints as ckpt_lib
    from nerf_siren_tpu_torch.training.system import epoch_iterator

    rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
    primary = rank == 0
    dataset_cls = dataset_dict[hparams.dataset_name]
    kwargs = dict(root_dir=hparams.root_dir, img_wh=tuple(hparams.img_wh))
    if hparams.dataset_name.startswith("llff"):
        kwargs["spheric_poses"] = hparams.spheric_poses
    if hparams.dataset_name == "blender_cls_ib" and hparams.is_crop:
        kwargs.update(is_crop=True, crop_size=hparams.crop_size)
    train_ds = dataset_cls(split="train", **kwargs)
    val_ds = dataset_cls(split="val", **kwargs)

    steps_per_epoch = max(1, len(train_ds.all_rays) // hparams.batch_size)
    system = build_system(hparams, train_ds.white_back, steps_per_epoch, device,
                          getattr(train_ds, "n_classes", 0), data_parallel=dp)
    optimizer = hparams.optimizer

    state = system.init_state(hparams.seed)
    start_epoch = 0
    log = print if primary else (lambda *a, **k: None)
    if hparams.ckpt_path:  # full resume
        state, start_epoch = ckpt_lib.restore_train_state(hparams.ckpt_path, state, optimizer)
        log(f"resumed from {hparams.ckpt_path} at epoch {start_epoch}, step {state.step}")
    elif hparams.pretrained:  # warm start of the weights only
        if "eg3d_renderer" in state.models:
            ckpt_lib.load_eg3d_ckpt(state.models["eg3d_renderer"], hparams.pretrained)
        for key in ("coarse", "fine"):   # the fields only, as JAX's warm start
            name = ckpt_lib.MODEL_NAMES[key]
            if key in state.models:
                ckpt_lib.load_ckpt(state.models[key], hparams.pretrained, name,
                                   hparams.prefixes_to_ignore)
        state = system.state_for(state.models)
        log(f"warm-started from {hparams.pretrained}")

    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        SummaryWriter = None
    if SummaryWriter is not None and primary:
        writer = SummaryWriter(os.path.join("logs", hparams.exp_name))

    ckpt_dir = os.path.join("ckpts", hparams.exp_name)
    if primary:
        os.makedirs(ckpt_dir, exist_ok=True)
    saved: list = []  # (val_loss, path)
    checkpointer = ckpt_lib.AsyncCheckpointer() if primary else None
    extras = {"cls": train_ds.all_cls} if hasattr(train_ds, "all_cls") else None
    shards = dict(shard_index=rank, num_shards=world) if multihost else dict(block=(rank, world))

    def batches(epoch):
        for batch in epoch_iterator(train_ds.all_rays, train_ds.all_rgbs, hparams.batch_size,
                                    hparams.seed, epoch, extras, **shards):
            yield batch

    spd = max(1, hparams.steps_per_dispatch)
    if extras and "cls_b" not in inspect.signature(system.train_scan_batches).parameters:
        spd = 1   # as JAX: groups carry class targets on the semantic system only

    def flush_group(state, group):
        kw = {"cls_b": np.stack([b["cls"] for b in group])} if "cls" in group[0] else {}
        return system.train_scan_batches(state, np.stack([b["rays"] for b in group]),
                                         np.stack([b["rgbs"] for b in group]), hparams.seed + 1,
                                         **kw)

    try:
        for epoch in range(start_epoch, hparams.num_epochs):
            t0 = time.time()
            metrics: Dict = {}
            group: list = []
            losses: list = []   # device scalars, fetched once an epoch
            for batch in batches(epoch):
                if spd == 1:
                    state, metrics = system.train_step(state, batch, hparams.seed + 1)
                    losses.append(metrics[system.LOSS_KEY])
                    continue
                group.append(batch)
                if len(group) == spd:
                    state, metrics = flush_group(state, group)
                    losses.append(metrics[system.LOSS_KEY])
                    group = []
            if group:   # the epoch's tail: one smaller group (its own graph)
                state, metrics = flush_group(state, group)
                losses.append(metrics[system.LOSS_KEY])
            step = state.step
            if not primary:
                continue
            if writer is not None:
                for k, v in metrics.items():
                    writer.add_scalar(k, float(v), step)
                writer.add_scalar("lr", system.current_lr(state), step)
            line = f"epoch {epoch} step {step} " + " ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()) + f" ({time.time() - t0:.1f}s)"

            if (epoch + 1) % hparams.val_every == 0 or epoch == hparams.num_epochs - 1:
                if multihost and world > 1:
                    # as JAX: rank checkpoints by the epoch-mean train loss
                    val_loss = float(torch.stack(losses).mean()) if losses else 0.0
                else:
                    val_loss, val_psnr = validate(system, state, val_ds, writer, step,
                                                  tuple(hparams.img_wh),
                                                  exp_name=hparams.exp_name)
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
        if checkpointer is not None:
            checkpointer.close()  # every checkpoint file is on disk before returning
        if writer is not None:
            writer.close()
    return state


if __name__ == "__main__":
    main(get_opts())
