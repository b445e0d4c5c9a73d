"""Import a reference PyTorch(-Lightning) checkpoint into the msgpack that
both packages read.

Counterpart of the JAX package's `tools/import_torch_ckpt.py`, with its
CLI. It reads the flat Lightning `state_dict` (reference naming:
`nerf_coarse.xyz_encoding_1.0.weight`, `nerf_fine.sigma.bias`, ...,
reference utils/__init__.py:56-71 / models/nerf.py:60-81), converts each
NeRF (and NeRF_3D, with its semantic `parse` head) submodel into the JAX
package's param tree (torch Linear weights are (out, in), so they are
transposed to (in, out) kernels), and writes the checkpoint under the
model names (`nerf_coarse`, `nerf_fine`), which the port's `load_ckpt`
and the JAX package's read alike. Runs on the host only.

Usage:
  python -m nerf_siren_tpu_torch.tools.import_torch_ckpt --torch_ckpt epoch=15.ckpt \
      --out lego_imported.msgpack [--models nerf_coarse nerf_fine]
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def extract_state_dict(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the checkpoint's `state_dict` (or of the file itself,
    when it is a bare state_dict) as numpy, on the CPU."""
    import torch

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if hasattr(v, "detach")}


def split_by_model(state: Dict[str, np.ndarray], model_name: str) -> Dict[str, np.ndarray]:
    """Filter + strip a `model_name.` prefix (reference extract_model_state_dict)."""
    pfx = model_name + "."
    return {k[len(pfx):]: v for k, v in state.items() if k.startswith(pfx)}


def convert_nerf_state(sd: Dict[str, np.ndarray]) -> Dict:
    """Reference NeRF/NeRF_3D state_dict -> the JAX-layout param tree."""
    def lin(prefix):
        w = sd[f"{prefix}.weight"]
        b = sd[f"{prefix}.bias"]
        return {"kernel": np.ascontiguousarray(w.T.astype(np.float32)),
                "bias": b.astype(np.float32)}

    depth = 0
    while f"xyz_encoding_{depth + 1}.0.weight" in sd:
        depth += 1
    if depth == 0:
        raise ValueError("not a reference NeRF state_dict (no xyz_encoding_*)")

    params = {
        "xyz_layers": [lin(f"xyz_encoding_{i + 1}.0") for i in range(depth)],
        "xyz_final": lin("xyz_encoding_final"),
        "sigma": lin("sigma"),
        "dir_layer": lin("dir_encoding.0"),
        "rgb": lin("rgb.0"),
    }
    if "parse.0.weight" in sd:  # NeRF_3D semantic head
        params["parse"] = [lin("parse.0"), lin("parse.1")]
    return params


def import_torch_ckpt(torch_ckpt: str, out_path: str,
                      models=("nerf_coarse", "nerf_fine")) -> Dict:
    """Convert the `models` of a reference checkpoint and write them to
    `out_path`; returns the written tree."""
    from nerf_siren_tpu_torch.training.checkpoints import save_checkpoint

    state = extract_state_dict(torch_ckpt)
    out = {}
    for name in models:
        sub = split_by_model(state, name)
        if sub:
            out[name] = convert_nerf_state(sub)
            print(f"converted {name}: depth "
                  f"{len(out[name]['xyz_layers'])}, "
                  f"{'with' if 'parse' in out[name] else 'no'} semantic head")
        else:
            print(f"{name}: not present in checkpoint, skipped")
    if not out:
        raise ValueError("no known models found in the checkpoint")
    save_checkpoint(out_path, out)
    print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--models", nargs="+",
                        default=["nerf_coarse", "nerf_fine"])
    args = parser.parse_args()
    import_torch_ckpt(args.torch_ckpt, args.out, args.models)
