#!/bin/bash
# EG3D triplane renderer, single-scene overfit with learnable latent
# (reference cmd: --mode eg3d runs)
python -m nerf_siren_tpu_torch.train \
  --mode eg3d \
  --dataset_name blender \
  --root_dir "$1" \
  --img_wh 128 128 \
  --num_epochs 30 --batch_size 4096 \
  --lr 2e-3 --lr_scheduler cosine \
  --exp_name eg3d
