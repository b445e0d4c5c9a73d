"""Tools of the port: `import_torch_ckpt` (a reference Lightning checkpoint
-> the msgpack both packages read), `psnr_parity` (trained-scene PSNR of
each renderer against a torch oracle of the reference pipeline), and their
helpers `scene` (the analytic 3-sphere scene) and `oracle` (the reference's
render pipeline in plain torch). Run each with `python -m
nerf_siren_tpu_torch.tools.<name>`."""
