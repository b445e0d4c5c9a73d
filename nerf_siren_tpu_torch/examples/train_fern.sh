#!/bin/bash
# LLFF fern forward-facing with NDC rays
# (reference README.md:105-114: 30 epochs, batch 1024, steplr 10/20 x0.5)
python -m nerf_siren_tpu_torch.train \
  --dataset_name llff \
  --root_dir "$1" \
  --N_importance 64 --img_wh 504 378 \
  --num_epochs 30 --batch_size 1024 \
  --optimizer adam --lr 5e-4 \
  --lr_scheduler steplr --decay_step 10 20 --decay_gamma 0.5 \
  --exp_name fern
