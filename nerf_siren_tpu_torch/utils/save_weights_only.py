"""Strip a full training checkpoint to its model weights (the "portable
scene" export). Counterpart of `nerf_siren_tpu/utils/save_weights_only.py`,
with its CLI:

    python -m nerf_siren_tpu_torch.utils.save_weights_only --ckpt_path a.msgpack

writes `a_weights.msgpack` (or `--out_path`), which both packages' `load_ckpt`
read. Runs on the host only: no tensor is made.
"""
from __future__ import annotations

import argparse
import os


def save_weights_only(ckpt_path: str, out_path: str = None) -> str:
    """The `params` tree of a full-resume checkpoint (or the whole tree of a
    weights-only one) written to `out_path`, by default `<base>_weights<ext>`;
    returns the path written."""
    from nerf_siren_tpu_torch.training.checkpoints import load_checkpoint, save_checkpoint

    ckpt = load_checkpoint(ckpt_path)
    params = ckpt.get("params", ckpt)  # full-resume checkpoints nest under 'params'
    if out_path is None:
        base, ext = os.path.splitext(ckpt_path)
        out_path = base + "_weights" + ext
    save_checkpoint(out_path, params)
    return out_path


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, default=None)
    args = parser.parse_args()
    print(save_weights_only(args.ckpt_path, args.out_path))
