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
- `k1_stream` (a key of the pack at every width the kernels take: any
  multiple of 128, `takes_width`): the weights again,
  as the kernel streams them. One bf16 buffer of 64-input slices in the
  order `k1_schedule` lists (the order the kernel consumes them), each
  slice (rows, 64) in the 128-byte swizzle its wgmma reads: 16-byte chunk
  j of row r holds chunk j ^ (r % 8). `unpack_k1_stream` is its plain
  inverse. The other keys stay: the plain versions and the int8 pack read
  them.
- `fused_sigma_ref` / `fused_full_ref`: the plain version of the kernel's
  math — bf16 operands (rounded, then multiplied in float32 with TF32 off),
  float32 accumulation, biases and heads.
- `fused_nerf_sigma` / `fused_nerf_full`: the public wrappers. A CPU tensor
  goes to the plain version; a CUDA tensor launches the kernel or raises:
  the resident kernel (`csrc/fused_mlp.cu`) at `KERNEL_WIDTHS` up to
  `MAX_DEPTH` layers, else the wide kernel (`csrc/fused_mlp_wide.cu`,
  `wide_launch`, shared with K4) at any width % 128 == 0 and any depth.
  `LAUNCHES` counts kernel launches per wrapper ('sigma' / 'full' the
  resident kernel's, 'sigma_wide' / 'full_wide' the wide kernel's).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels._build import count_launch

EMB_X = 64        # 63 xyz-embedding channels + 1 zero column
EMB_D = 32        # 27 direction-embedding channels + 5 zero columns
KERNEL_WIDTHS = (128, 256, 384, 512)   # the widths csrc/fused_mlp.cu is compiled for
MAX_DEPTH = 16    # the resident kernels' per-layer argument tables; deeper fields run wide
SLICE = 64        # inputs per slice of `k1_stream`: one 128-byte swizzle row

LAUNCHES = {"sigma": 0, "full": 0, "sigma_wide": 0, "full_wide": 0}

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

    if takes_width(width):
        w["k1_stream"] = _k1_stream(w, cfg.depth, width)
    out = {k: v.to(device, torch.bfloat16).contiguous() for k, v in w.items()}
    out.update({k: v.to(device).contiguous() for k, v in b.items()})
    return out


def takes_width(width: int) -> bool:
    """Whether the kernels take a trunk of this width: any multiple of 128
    (JAX's pack asserts the same)."""
    return width >= 128 and width % 128 == 0


def resident(width: int, depth: int) -> bool:
    """Whether K1's resident kernel (csrc/fused_mlp.cu) runs this field;
    else the wide kernel does."""
    return width in KERNEL_WIDTHS and depth <= MAX_DEPTH


def pack_model_params(models: Dict[str, NeRF], device=None) -> Dict[str, Packed]:
    """Pack each field of a {'coarse': NeRF, 'fine': NeRF} dict."""
    return {k: pack_nerf_params(m, device) for k, m in models.items()}


def _depth(packed: Packed) -> int:
    return sum(1 for k in packed if k[0] == "b" and k[1:].isdigit())


def _emb_layers(packed: Packed) -> list:
    return [i for i in range(_depth(packed)) if f"w{i}e" in packed]


def k1_schedule(depth: int, emb_layers, width: int) -> list:
    """The slices of `k1_stream` of a field of trunk width `width`, in the
    order the kernel consumes them, as (weight key, first input column): per
    trunk layer its hidden slices (none at layer 0), then its embedding
    slice if it takes the embedding; then W_comb's slices and W_dir's
    (zero-padded to SLICE inputs)."""
    out = []
    for i in range(depth):
        if i:
            out += [(f"w{i}", c) for c in range(0, width, SLICE)]
        if i in emb_layers:
            out.append((f"w{i}e", 0))
    return out + [("w_comb", c) for c in range(0, width, SLICE)] + [("w_dir", 0)]


_SWIZZLE: Dict[tuple, tuple] = {}   # (rows, device) -> index tensors, made once


def _swizzle128(s: torch.Tensor) -> torch.Tensor:
    """(..., rows, 64) -> the same slices with 8-element chunk j of row r
    moved to chunk j ^ (r % 8): the 128-byte swizzle (its own inverse)."""
    rows = s.shape[-2]
    key = (rows, s.device)
    if key not in _SWIZZLE:
        r = torch.arange(rows)
        _SWIZZLE[key] = (r[:, None].to(s.device),
                         (torch.arange(8)[None, :] ^ (r % 8)[:, None]).to(s.device))
    r, chunk = _SWIZZLE[key]
    return s.reshape(*s.shape[:-1], 8, 8)[..., r, chunk, :].reshape(s.shape)


def _k1_stream(w: Dict[str, torch.Tensor], depth: int, width: int) -> torch.Tensor:
    slices = []
    for k, c in k1_schedule(depth, [i for i in range(depth) if f"w{i}e" in w], width):
        s = w[k][:, c: c + SLICE]
        slices.append(_swizzle128(F.pad(s, (0, SLICE - s.shape[1]))).flatten())
    return torch.cat(slices)


def _slice_rows(key: str, width: int) -> int:
    return width // 2 if key in ("w_comb", "w_dir") else width


def k1_stream_numel(depth: int, emb_layers, width: int) -> int:
    return sum(_slice_rows(k, width) * SLICE for k, _ in k1_schedule(depth, emb_layers, width))


def unpack_k1_stream(stream: torch.Tensor, depth: int, emb_layers,
                     width: int) -> Dict[str, torch.Tensor]:
    """The weights `k1_stream` of a field of trunk width `width` holds,
    rebuilt from it alone (the plain inverse of the pack): {key: (rows, in)
    in the stream's dtype}; `w_dir` keeps its SLICE zero-padded inputs."""
    numel = k1_stream_numel(depth, emb_layers, width)
    if stream.numel() != numel:
        raise ValueError(f"k1_stream: {stream.numel()} elements, the schedule holds {numel}")
    parts: Dict[str, Dict[int, torch.Tensor]] = {}
    off = 0
    for k, c in k1_schedule(depth, emb_layers, width):
        rows = _slice_rows(k, width)
        parts.setdefault(k, {})[c] = _swizzle128(stream[off: off + rows * SLICE].view(rows, SLICE))
        off += rows * SLICE
    return {k: torch.cat([v[c] for c in sorted(v)], dim=1) for k, v in parts.items()}


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


def sigma_head_ref(packed: Packed, h: torch.Tensor) -> torch.Tensor:
    """(N, 1) sigma from the final bf16-valued trunk activations h (N, W)."""
    return h @ packed["w_sigma"].float()[:, None] + packed["b_sigma"]


def fused_sigma_ref(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """Plain version of the sigma pass: (N, 3) f32 -> (N, 1) f32."""
    return sigma_head_ref(packed, _trunk_ref(packed, xyz))


def fused_full_ref(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                   samples_per_dir: int = 1) -> torch.Tensor:
    """Plain version of the full pass: (N, 3) points and (N / samples_per_dir,
    3) directions (point p uses direction p // samples_per_dir) -> (N, 4)
    f32 [r, g, b, sigma]."""
    return full_heads_ref(packed, _trunk_ref(packed, xyz), dirs, samples_per_dir)


def full_heads_ref(packed: Packed, h: torch.Tensor, dirs: torch.Tensor,
                   samples_per_dir: int = 1) -> torch.Tensor:
    """(N, 4) [r, g, b, sigma] from the final bf16-valued trunk activations
    h (N, W) and one direction per `samples_per_dir` points."""
    d = dirs.repeat_interleave(samples_per_dir, dim=0)[: h.shape[0]]
    y = (packed["b_comb"] + h @ packed["w_comb"].float().t()
         + _embed(d, 4, EMB_D) @ packed["w_dir"].float().t())
    hd = _bf16(torch.relu(y))
    rgb = torch.sigmoid(hd @ packed["w_rgb"].float().t() + packed["b_rgb"])
    return torch.cat([rgb, sigma_head_ref(packed, h)], dim=-1)


# ---- CUDA kernel ------------------------------------------------------------

# nerf_field_forward(k1_stream, stream_elems, ptrs, depth, emb_mask, width, xyz, dirs,
#                    samples_per_dir, out, n_points, full, stream) -> cudaError_t
KERNEL_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]


def _kernel_fn():
    """`nerf_field_forward` from the built library (built at first use)."""
    from nerf_siren_tpu_torch.ops.kernels import _build

    fn = _build.load("fused_mlp").nerf_field_forward
    fn.argtypes = KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, device, dtype, shape) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 32:
        raise ValueError(f"{name}: must be contiguous and 32-byte aligned")


HEAD_KEYS = ("w_sigma", "b_sigma", "w_comb", "w_dir", "b_comb", "w_rgb", "b_rgb")


def _width(packed: Packed, what: str) -> int:
    depth, width = _depth(packed), packed["w_sigma"].shape[0]
    if depth < 1:
        raise ValueError(f"{what} takes depth >= 1, got {depth}")
    if not takes_width(width):
        raise ValueError(f"{what} takes trunk widths that are multiples of 128, got width "
                         f"{width}")
    return width


def head_pointers(packed: Packed, device) -> list:
    """Validate the bf16 heads of a pack and list their device pointers in
    the order the eval kernels read them (`HEAD_KEYS`)."""
    width = packed["w_sigma"].shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    shapes = {"w_sigma": (bf, (width,)), "b_sigma": (f32, (1,)),
              "w_comb": (bf, (width // 2, width)), "w_dir": (bf, (width // 2, EMB_D)),
              "b_comb": (f32, (width // 2,)), "w_rgb": (bf, (3, width // 2)),
              "b_rgb": (f32, (3,))}
    for k in HEAD_KEYS:
        _check(packed[k], k, device, *shapes[k])
    return [packed[k].data_ptr() for k in HEAD_KEYS]


def _kernel_args(packed: Packed, device) -> tuple:
    """Validate what the kernel reads of the pack (the weight stream, the
    biases, the heads) and return (stream, emb_mask, pointer table in the
    order `nerf_field_forward` reads it)."""
    depth, width = _depth(packed), _width(packed, "fused kernel")
    emb_layers = _emb_layers(packed)
    if 0 not in emb_layers or "w0" in packed:
        raise ValueError("fused kernel: layer 0 takes the embedding (w0e) and no hidden input")
    if "k1_stream" not in packed:
        raise ValueError("k1_stream: the pack has no weight stream (pack_nerf_params builds it)")
    stream = packed["k1_stream"]
    _check(stream, "k1_stream", device, torch.bfloat16,
           (k1_stream_numel(depth, emb_layers, width),))
    for i in range(depth):
        _check(packed[f"b{i}"], f"b{i}", device, torch.float32, (width,))
    emb_mask = sum(1 << i for i in emb_layers) if resident(width, depth) else 0
    return (stream, emb_mask,
            [packed[f"b{i}"].data_ptr() for i in range(depth)] + head_pointers(packed, device))


def check_points(what: str, xyz: torch.Tensor, dirs: Optional[torch.Tensor],
                 samples_per_dir: int) -> int:
    """Validate a field call's points (and directions); returns N."""
    if xyz.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xyz.device}")
    n = xyz.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{what}: at most 2^31 - 1 points per call, got {n}")
    _check(xyz, "xyz", xyz.device, torch.float32, (n, 3))
    if dirs is not None:
        if samples_per_dir < 1:
            raise ValueError(f"samples_per_dir must be >= 1, got {samples_per_dir}")
        _check(dirs, "dirs", xyz.device, torch.float32, (-(-n // samples_per_dir), 3))
    return n


# ---- the wide kernel (csrc/fused_mlp_wide.cu), K1's and K4's ------------------

# nerf_field_wide_forward(int8, stream, stream_bytes, layers, depth, width, n_trunk, heads,
#                         xyz, dirs, samples_per_dir, out, n_points, full, dump, scratch,
#                         grid, stream) -> cudaError_t
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
WIDE_ARGTYPES = [_i, _p, _ll, _p, _i, _i, _i, ctypes.POINTER(_p), _p, _p, _ll, _p, _ll, _i, _p,
                 _p, _i, _p]


def _wide_lib():
    from nerf_siren_tpu_torch.ops.kernels import _build

    lib = _build.load("fused_mlp_wide")
    lib.nerf_field_wide_forward.argtypes = WIDE_ARGTYPES
    lib.nerf_field_wide_forward.restype = _i
    lib.nerf_field_wide_cta_bytes.argtypes = [_i, _i]
    lib.nerf_field_wide_cta_bytes.restype = _ll
    return lib


def wide_launch(int8: bool, stream_w: torch.Tensor, n_trunk: int, layers: list, depth: int,
                width: int, heads: list, xyz: torch.Tensor, dirs: Optional[torch.Tensor],
                samples_per_dir: int, out: torch.Tensor,
                dump: Optional[torch.Tensor] = None) -> None:
    """Launch the wide kernel (K1's, or K4's when `int8`) on validated
    arguments: its per-layer table copied from `layers`, its per-CTA scratch
    allocated here (one CTA per SM, at most one per 128-point tile)."""
    n, dev = xyz.shape[0], xyz.device
    lib = _wide_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(sms, -(-n // 128)))
    scratch = torch.empty(grid * lib.nerf_field_wide_cta_bytes(int(int8), width),
                          dtype=torch.uint8, device=dev)
    # the per-layer table (int64 addresses and flags): an asynchronous copy,
    # ordered before the launch on the stream, with no wait for the host
    table = torch.tensor(layers, dtype=torch.int64).to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        err = lib.nerf_field_wide_forward(
            int(int8), stream_w.data_ptr(), stream_w.numel() * stream_w.element_size(),
            table.data_ptr(), depth, width,
            n_trunk, (ctypes.c_void_p * len(heads))(*heads), xyz.data_ptr(),
            None if dirs is None else dirs.data_ptr(), samples_per_dir, out.data_ptr(), n,
            int(dirs is not None), None if dump is None else dump.data_ptr(),
            scratch.data_ptr(), grid, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nerf_field_wide_forward failed: cudaError {err}")


def _launch(packed: Packed, xyz: torch.Tensor, dirs: Optional[torch.Tensor],
            samples_per_dir: int) -> torch.Tensor:
    n = check_points("fused NeRF field", xyz, dirs, samples_per_dir)
    full = dirs is not None
    weights, emb_mask, table = _kernel_args(packed, xyz.device)
    out = torch.empty((n, 4 if full else 1), dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    depth, width = _depth(packed), packed["w_sigma"].shape[0]
    if not resident(width, depth):
        emb = _emb_layers(packed)
        layers = []
        for i in range(depth):
            layers += [table[i], int(i in emb)]
        n_trunk = sum((width // SLICE if i else 0) + int(i in emb) for i in range(depth))
        wide_launch(False, weights, n_trunk, layers, depth, width, table[depth:], xyz, dirs,
                    samples_per_dir, out)
        count_launch(LAUNCHES, "full_wide" if full else "sigma_wide")
        return out
    fn = _kernel_fn()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(weights.data_ptr(), weights.numel(), (ctypes.c_void_p * len(table))(*table),
                 _depth(packed), emb_mask, packed["w_sigma"].shape[0], xyz.data_ptr(),
                 dirs.data_ptr() if full else None, samples_per_dir, out.data_ptr(), n, int(full),
                 stream)
    if err != 0:
        raise RuntimeError(f"nerf_field_forward failed: cudaError {err}")
    count_launch(LAUNCHES, "full" if full else "sigma")
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
