#!/bin/bash
# Semantic NeRF: PointNet over weight-sampled point clouds, image batches
# (reference train.sh: llff_cls_ib + conv3d/pointnet)
python -m nerf_siren_tpu_torch.train \
  --mode d3_ib \
  --dataset_name llff_cls_ib \
  --semantic_network pointnet \
  --loss_type msenll \
  --root_dir "$1" \
  --N_importance 64 --img_wh 504 378 \
  --num_epochs 30 --batch_size 1024 \
  --lr 5e-4 --decay_step 10 20 --decay_gamma 0.5 \
  --exp_name semantic
