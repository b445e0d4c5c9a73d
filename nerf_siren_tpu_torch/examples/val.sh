#!/bin/bash
# Render the test split from a checkpoint (reference val.sh)
python -m nerf_siren_tpu_torch.eval \
  --root_dir "$1" \
  --ckpt_path "$2" \
  --dataset_name blender --split test \
  --img_wh 800 800 --N_importance 64 \
  --scene_name eval --save_depth
