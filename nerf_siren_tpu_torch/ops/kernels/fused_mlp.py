"""Fused NeRF field: pack, plain PyTorch version, and the CUDA kernel's wrappers.

Counterpart of `nerf_siren_tpu/ops/pallas/fused_mlp.py` (the TPU kernels
`_sigma_kernel` / `_full_kernel`). The kernel is `csrc/fused_mlp.cu`; this
module owns everything around it:

- `pack_nerf_params` / `pack_model_params`: the kernel's weight layout.
  Torch-layout `(out, in)` bf16 weights, float32 biases. The embedding
  columns stay in reference order ``[x, sin(2^0 x), cos(2^0 x), ...]``,
  zero-padded from 63 to `EMB_X` (xyz) and from 27 to `EMB_D` (direction)
  columns; the skip layer's weight is split into its embedding and hidden
  columns. The direction branch is folded in float32 before the bf16 cast,
  ``W_comb = W_dir[:, :W] @ W_xyz_final`` (no nonlinearity between the two
  linears), as the JAX pack does (~1e-4 output delta against the unfolded
  MLP). The TPU layout tricks (k-major permuted sin/cos rows, +pi/2 cos
  phase, 128-row heads, the (8, N) lane-major point layout) are not kept.
- `fused_sigma_ref` / `fused_full_ref`: the plain version of the kernel's
  math — bf16 operands (rounded, then multiplied in float32 with TF32 off),
  float32 accumulation, biases and heads.
- `fused_nerf_sigma` / `fused_nerf_full`: the public wrappers. A CPU tensor
  goes to the plain version; a CUDA tensor launches the kernel or raises.
  `LAUNCHES` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.models.nerf import NeRF

EMB_X = 64        # 63 xyz-embedding channels + 1 zero column (wmma k-step of 16)
EMB_D = 32        # 27 direction-embedding channels + 5 zero columns
KERNEL_WIDTH = 256  # the width csrc/fused_mlp.cu is compiled for
MAX_DEPTH = 16

LAUNCHES = {"sigma": 0, "full": 0}

Packed = Dict[str, torch.Tensor]


def pack_nerf_params(model: NeRF, device=None) -> Packed:
    """One `NeRF` -> the kernel's weight dict (the `parse` head is not used)."""
    cfg = model.cfg
    if cfg.in_channels_xyz != 63 or cfg.in_channels_dir != 27:
        raise ValueError("the fused field is fixed to 10 xyz / 4 direction frequencies")
    device = model.sigma.weight.device if device is None else torch.device(device)
    width, emb = cfg.width, cfg.in_channels_xyz

    def f32(t):
        return t.detach().to("cpu", torch.float32)

    w: Dict[str, torch.Tensor] = {}
    b: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(model.xyz_layers):
        k = f32(layer.weight)                               # (W, in)
        if i == 0:
            w["w0e"] = F.pad(k, (0, EMB_X - emb))
        elif i in cfg.skips:                                # input is [emb, h]
            w[f"w{i}e"] = F.pad(k[:, :emb], (0, EMB_X - emb))
            w[f"w{i}"] = k[:, emb:]
        else:
            w[f"w{i}"] = k
        b[f"b{i}"] = f32(layer.bias)
    w["w_sigma"] = f32(model.sigma.weight)[0]
    b["b_sigma"] = f32(model.sigma.bias)
    wd = f32(model.dir_layer.weight)                        # (W/2, W + 27)
    w["w_comb"] = wd[:, :width] @ f32(model.xyz_final.weight)
    b["b_comb"] = wd[:, :width] @ f32(model.xyz_final.bias) + f32(model.dir_layer.bias)
    w["w_dir"] = F.pad(wd[:, width:], (0, EMB_D - (wd.shape[1] - width)))
    w["w_rgb"] = f32(model.rgb.weight)
    b["b_rgb"] = f32(model.rgb.bias)

    out = {k: v.to(device, torch.bfloat16).contiguous() for k, v in w.items()}
    out.update({k: v.to(device).contiguous() for k, v in b.items()})
    return out


def pack_model_params(models: Dict[str, NeRF], device=None) -> Dict[str, Packed]:
    """Pack each field of a {'coarse': NeRF, 'fine': NeRF} dict."""
    return {k: pack_nerf_params(m, device) for k, m in models.items()}


def _depth(packed: Packed) -> int:
    return sum(1 for k in packed if k[0] == "b" and k[1:].isdigit())


# ---- plain PyTorch version --------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _embed(x: torch.Tensor, n_freqs: int, cols: int) -> torch.Tensor:
    e = positional_encoding(x, n_freqs)
    return _bf16(F.pad(e, (0, cols - e.shape[-1])))


def _trunk_ref(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    ex = _embed(xyz, 10, EMB_X)
    h = None
    for i in range(_depth(packed)):
        y = packed[f"b{i}"]
        if f"w{i}" in packed:
            y = y + h @ packed[f"w{i}"].float().t()
        if f"w{i}e" in packed:
            y = y + ex @ packed[f"w{i}e"].float().t()
        h = _bf16(torch.relu(y))
    return h


def _sigma_head(packed: Packed, h: torch.Tensor) -> torch.Tensor:
    return h @ packed["w_sigma"].float()[:, None] + packed["b_sigma"]


def fused_sigma_ref(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """Plain version of the sigma pass: (N, 3) f32 -> (N, 1) f32."""
    return _sigma_head(packed, _trunk_ref(packed, xyz))


def fused_full_ref(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                   samples_per_dir: int = 1) -> torch.Tensor:
    """Plain version of the full pass: (N, 3) points and (N / samples_per_dir,
    3) directions (point p uses direction p // samples_per_dir) -> (N, 4)
    f32 [r, g, b, sigma]."""
    h = _trunk_ref(packed, xyz)
    d = dirs.repeat_interleave(samples_per_dir, dim=0)[: xyz.shape[0]]
    y = (packed["b_comb"] + h @ packed["w_comb"].float().t()
         + _embed(d, 4, EMB_D) @ packed["w_dir"].float().t())
    hd = _bf16(torch.relu(y))
    rgb = torch.sigmoid(hd @ packed["w_rgb"].float().t() + packed["b_rgb"])
    return torch.cat([rgb, _sigma_head(packed, h)], dim=-1)


# ---- CUDA kernel ------------------------------------------------------------

def _kernel_fn():
    """`nerf_field_forward` from the built library (built at first use)."""
    from nerf_siren_tpu_torch.ops.kernels import _build

    fn = _build.load("fused_mlp").nerf_field_forward
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, device, dtype, shape) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 32:
        raise ValueError(f"{name}: must be contiguous and 32-byte aligned")


def _pointer_table(packed: Packed, device) -> list:
    """Validate the pack against the kernel and list its device pointers in
    the order `nerf_field_forward` reads them."""
    depth = _depth(packed)
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"fused kernel takes depth 1..{MAX_DEPTH}, got {depth}")
    width = packed["w_sigma"].shape[0]
    if width != KERNEL_WIDTH:
        raise ValueError(f"fused kernel is built for width {KERNEL_WIDTH}, got {width}")
    bf, f32 = torch.bfloat16, torch.float32
    shapes = {"w0e": (bf, (width, EMB_X)), "w_sigma": (bf, (width,)), "b_sigma": (f32, (1,)),
              "w_comb": (bf, (width // 2, width)), "w_dir": (bf, (width // 2, EMB_D)),
              "b_comb": (f32, (width // 2,)), "w_rgb": (bf, (3, width // 2)),
              "b_rgb": (f32, (3,))}
    for i in range(depth):
        shapes[f"b{i}"] = (f32, (width,))
        if i > 0:
            shapes[f"w{i}"] = (bf, (width, width))
            if f"w{i}e" in packed:
                shapes[f"w{i}e"] = (bf, (width, EMB_X))
    for k, (dtype, shape) in shapes.items():
        _check(packed[k], k, device, dtype, shape)

    def ptr(k):
        return packed[k].data_ptr() if k in packed else 0

    return ([ptr(f"w{i}") if i else 0 for i in range(depth)]
            + [ptr(f"w{i}e") for i in range(depth)]
            + [ptr(f"b{i}") for i in range(depth)]
            + [ptr(k) for k in ("w_sigma", "b_sigma", "w_comb", "w_dir", "b_comb",
                                "w_rgb", "b_rgb")])


def _launch(packed: Packed, xyz: torch.Tensor, dirs: Optional[torch.Tensor],
            samples_per_dir: int) -> torch.Tensor:
    if xyz.device.type != "cuda":
        raise ValueError(f"fused NeRF field: unsupported device {xyz.device}")
    n = xyz.shape[0]
    full = dirs is not None
    _check(xyz, "xyz", xyz.device, torch.float32, (n, 3))
    if full:
        if samples_per_dir < 1:
            raise ValueError(f"samples_per_dir must be >= 1, got {samples_per_dir}")
        _check(dirs, "dirs", xyz.device, torch.float32, (-(-n // samples_per_dir), 3))
    table = _pointer_table(packed, xyz.device)
    out = torch.empty((n, 4 if full else 1), dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn((ctypes.c_void_p * len(table))(*table), _depth(packed), KERNEL_WIDTH,
                 xyz.data_ptr(), dirs.data_ptr() if full else None, samples_per_dir,
                 out.data_ptr(), n, int(full), stream)
    if err != 0:
        raise RuntimeError(f"nerf_field_forward failed: cudaError {err}")
    LAUNCHES["full" if full else "sigma"] += 1
    return out


def fused_nerf_sigma(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """Raw sigma (N, 1) f32 for (N, 3) f32 points."""
    if xyz.device.type == "cpu":
        return fused_sigma_ref(packed, xyz)
    return _launch(packed, xyz, None, 1)


def fused_nerf_full(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                    samples_per_dir: int = 1) -> torch.Tensor:
    """[r, g, b, sigma] (N, 4) f32 for (N, 3) points; point p takes direction
    `dirs[p // samples_per_dir]`, so a render passes one direction per ray."""
    if xyz.device.type == "cpu":
        return fused_full_ref(packed, xyz, dirs, samples_per_dir)
    return _launch(packed, xyz, dirs, samples_per_dir)
