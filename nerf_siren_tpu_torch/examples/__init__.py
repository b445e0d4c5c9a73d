"""Examples of the port, each the twin of one in the JAX package's
`examples/`: `render_single_image` (one view, its PSNR and time, the rgb
and depth images), `export_unity_vol` (a quantised density volume for
Unity), `mesh_threshold_sweep` (mesh statistics over sigma thresholds),
and the five training / eval recipes as shell scripts on the port's CLIs
(`train_lego.sh`, `train_fern.sh`, `train_semantic.sh`, `train_eg3d.sh`,
`val.sh`). Run a Python example with `python -m
nerf_siren_tpu_torch.examples.<name>` (`--device cpu` off the card)."""
