#!/bin/bash
# Blender-synthetic lego, the reference's canonical recipe
# (reference README.md:77-85: 16 epochs, batch 1024, lr 5e-4, steplr 2/4/8 x0.5)
python -m nerf_siren_tpu_torch.train \
  --dataset_name blender \
  --root_dir "$1" \
  --N_importance 64 --img_wh 800 800 \
  --num_epochs 16 --batch_size 1024 \
  --optimizer adam --lr 5e-4 \
  --lr_scheduler steplr --decay_step 2 4 8 --decay_gamma 0.5 \
  --exp_name lego
