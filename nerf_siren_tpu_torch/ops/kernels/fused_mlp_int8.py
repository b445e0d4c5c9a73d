"""int8 NeRF field (K4): pack, plain PyTorch version, and the CUDA kernel's wrappers.

Counterpart of `nerf_siren_tpu/ops/pallas/fused_mlp_int8.py` (the TPU
kernels `_full_kernel_int8` / `_sigma_kernel_int8`). The kernel is
`csrc/fused_mlp_int8.cu`; this module owns everything around it:

- `pack_nerf_params_int8` / `pack_model_params_int8`: K1's field with the
  8x256 trunk in int8 and no calibration input. Each trunk weight is int8
  per output row, q = clip(round(w / s), +-127), s = max(max |w_row| / 127,
  1e-12). Layer 0 and the skip layer split their embedding columns into
  the 3 coordinates (``q{i}x`` (W, 3), scales ``f{i}x``) and the 60 sin/cos
  columns (``q{i}s`` (W, 64), reference order, zero-padded; scales
  ``f{i}s`` times the sin/cos operand's fixed 1/127); hidden columns are
  ``q{i}`` / ``f{i}``. Biases and the bf16 heads are K1's pack
  (`fused_mlp.pack_nerf_params`), the W_comb fold included. The key ``q0x``
  marks an int8 pack (`render.fused.field_kernels` dispatches on it).
- `k4_stream` (a key of the pack at every width the kernels take, any
  multiple of 128: `fused_mlp.takes_width`): the weights the
  kernel streams, as one int8 buffer of slices in the order `k4_schedule`
  lists (the order the kernel consumes them): per layer its hidden columns
  in 128-input slices (W / 128), then its sin/cos columns zero-padded to one; then
  K1's bf16 W_comb / W_dir slices (`fused_mlp.k1_schedule`), as bytes. Each
  slice has rows of 128 bytes in the 128-byte swizzle wgmma reads: 16-byte
  chunk j of row r holds chunk j ^ (r % 8). `unpack_k4_stream` is its plain
  inverse. The int8 pack carries no `k1_stream`.
- `fused_sigma_int8_ref` / `fused_full_int8_ref`: the plain version. Per
  point, coordinates and hidden activations are quantised at a dynamic
  scale s = max(absmax, 1e-9) * (1/127), q = clip(round(v / s), +-127); the
  sin/cos at the fixed scale, clip(round(127 e)). Every product is a sum of
  integers (exact in float32: |sum| < 2^24, TF32 off), then
  (sum * row scale) * point scale, combined in the TPU kernel's order.
- `fused_nerf_sigma_int8` / `fused_nerf_full_int8`: the public wrappers. A
  CPU tensor goes to the plain version; a CUDA tensor launches the kernel
  or raises: the resident kernel (`csrc/fused_mlp_int8.cu`) at K1's
  `KERNEL_WIDTHS` up to `MAX_DEPTH` layers where its per-column constants
  fit, else the wide kernel (`csrc/fused_mlp_wide.cu`) at any width %
  128 == 0 and any depth. `LAUNCHES` counts kernel launches per wrapper
  ('sigma' / 'full' the resident kernel's, 'sigma_wide' / 'full_wide' the
  wide kernel's).
- `int8_trunk_inputs`: every layer's int8 input (the kernel's, on the card),
  to count the entries where the kernel and the plain version round apart.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels._build import count_launch
from nerf_siren_tpu_torch.ops.kernels import fused_mlp
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import (HEAD_KEYS, KERNEL_WIDTHS, MAX_DEPTH,
                                                        SLICE, Packed, _bf16, _check, _depth,
                                                        _width, check_points, full_heads_ref,
                                                        head_pointers, sigma_head_ref,
                                                        takes_width, wide_launch)

EMB_Q = 64        # 60 sin/cos columns + 4 zero columns (two int8 k-steps of 32)
INV127 = 1.0 / 127.0
ROW_BYTES = 128   # bytes per row of a `k4_stream` slice: one 128-byte swizzle row

LAUNCHES = {"sigma": 0, "full": 0, "sigma_wide": 0, "full_wide": 0}
SMEM_MAX = 232448   # dynamic shared memory one block may use on an H100 (227 KB)


def _quant_rows(w: torch.Tensor):
    """Per-output-row symmetric int8 of a (out, in) float32 weight."""
    s = torch.clamp_min(w.abs().amax(dim=1) / 127.0, 1e-12)
    return torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8), s


def pack_nerf_params_int8(model: NeRF, device=None) -> Packed:
    """One `NeRF` -> the int8 kernel's weight dict."""
    cfg = model.cfg
    base = fused_mlp.pack_nerf_params(model, device)
    device = base["w_sigma"].device
    emb = cfg.in_channels_xyz
    out = {k: base[k] for k in HEAD_KEYS}
    q: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(model.xyz_layers):
        k = layer.weight.detach().to("cpu", torch.float32)
        if i == 0 or i in cfg.skips:                     # input is [emb, h]
            q[f"q{i}x"], q[f"f{i}x"] = _quant_rows(k[:, :3])
            qs, ss = _quant_rows(k[:, 3:emb])
            q[f"q{i}s"], q[f"f{i}s"] = F.pad(qs, (0, EMB_Q - (emb - 3))), ss * INV127
            if i:
                q[f"q{i}"], q[f"f{i}"] = _quant_rows(k[:, emb:])
        else:
            q[f"q{i}"], q[f"f{i}"] = _quant_rows(k)
        out[f"b{i}"] = base[f"b{i}"]
    if takes_width(cfg.width):
        q["k4_stream"] = _k4_stream({**q, "w_comb": base["w_comb"].cpu(),
                                     "w_dir": base["w_dir"].cpu()}, cfg.depth, cfg.width)
    out.update({k: v.to(device).contiguous() for k, v in q.items()})
    return out


def pack_model_params_int8(models: Dict[str, NeRF], device=None) -> Dict[str, Packed]:
    """Pack each field of a {'coarse': NeRF, 'fine': NeRF} dict for K4."""
    return {k: pack_nerf_params_int8(m, device) for k, m in models.items()}


def _emb_layers(packed: Packed) -> list:
    return [i for i in range(_depth(packed)) if f"q{i}x" in packed]


def k4_schedule(depth: int, emb_layers, width: int) -> list:
    """The slices of `k4_stream` of a field of trunk width `width`, in the
    order the kernel consumes them, as (weight key, first input column): per
    trunk layer its hidden slices of 128 int8 inputs (width / 128; none at
    layer 0), then its sin/cos slice if it takes the embedding; then K1's
    bf16 slices of W_comb (64 inputs each) and W_dir (zero-padded to 64)."""
    out = []
    for i in range(depth):
        if i:
            out += [(f"q{i}", c) for c in range(0, width, ROW_BYTES)]
        if i in emb_layers:
            out.append((f"q{i}s", 0))
    return out + [("w_comb", c) for c in range(0, width, SLICE)] + [("w_dir", 0)]


def _slice_shape(key: str, width: int) -> tuple:
    """(rows, inputs) of one slice of `key`: int8 trunk slices hold 128
    inputs of all W outputs, the bf16 direction-branch ones 64 of W / 2."""
    return (width // 2, SLICE) if key in ("w_comb", "w_dir") else (width, ROW_BYTES)


def _swizzle_bytes(s: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int8 -> the same slice with 16-byte chunk j of row r moved
    to chunk j ^ (r % 8): K1's 128-byte swizzle, on the bytes."""
    return fused_mlp._swizzle128(s.view(torch.int16)).view(torch.int8)


def _k4_stream(w: Dict[str, torch.Tensor], depth: int, width: int) -> torch.Tensor:
    slices = []
    for k, c in k4_schedule(depth, [i for i in range(depth) if f"q{i}x" in w], width):
        cols = _slice_shape(k, width)[1]
        s = F.pad(w[k][:, c: c + cols], (0, max(0, c + cols - w[k].shape[1])))
        slices.append(_swizzle_bytes(s.contiguous().view(torch.int8)).flatten())
    return torch.cat(slices)


def k4_stream_numel(depth: int, emb_layers, width: int) -> int:
    return sum(_slice_shape(k, width)[0] * ROW_BYTES
               for k, _ in k4_schedule(depth, emb_layers, width))


def unpack_k4_stream(stream: torch.Tensor, depth: int, emb_layers,
                     width: int) -> Dict[str, torch.Tensor]:
    """The weights `k4_stream` of a field of trunk width `width` holds,
    rebuilt from it alone (the plain inverse of the pack): {key: (rows,
    in)}, int8 for the trunk's ``q*`` keys and bf16 for ``w_comb`` /
    ``w_dir``; ``q{i}s`` keeps its 128 zero-padded inputs and ``w_dir`` its
    64."""
    numel = k4_stream_numel(depth, emb_layers, width)
    if stream.numel() != numel:
        raise ValueError(f"k4_stream: {stream.numel()} bytes, the schedule holds {numel}")
    parts: Dict[str, Dict[int, torch.Tensor]] = {}
    off = 0
    for k, c in k4_schedule(depth, emb_layers, width):
        rows = _slice_shape(k, width)[0]
        s = _swizzle_bytes(stream[off: off + rows * ROW_BYTES].view(rows, ROW_BYTES))
        parts.setdefault(k, {})[c] = s if k[0] == "q" else s.view(torch.bfloat16)
        off += rows * ROW_BYTES
    return {k: torch.cat([v[c] for c in sorted(v)], dim=1) for k, v in parts.items()}


# ---- plain PyTorch version --------------------------------------------------

def _quant_dyn(v: torch.Tensor):
    """Per-point (per-row) int8 at a dynamic scale: (integer-valued float32, scale (N, 1))."""
    s = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True), 1e-9) * INV127
    return torch.round(v / s).clamp(-127, 127), s


def _product(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued float32 activations and an int8 weight."""
    return q @ w.float().t()


def _trunk_int8_ref(packed: Packed, xyz: torch.Tensor, inputs: Optional[list] = None):
    """The final trunk activations, bf16-valued float32 (N, W). With a list
    `inputs`, every layer's int8 input is appended to it (as int8)."""
    xq, sx = _quant_dyn(xyz)
    e = positional_encoding(xyz, 10)[:, 3:]
    eq = torch.round(e * 127.0).clamp(-127, 127)
    if inputs is not None:
        width = packed["w_sigma"].shape[0]
        inputs.append(F.pad(torch.cat([xq, eq], 1), (0, width - 63)).to(torch.int8))
    hq = sa = h = None
    depth = _depth(packed)
    for i in range(depth):
        y = None
        if f"q{i}" in packed:
            y = _product(hq, packed[f"q{i}"]) * packed[f"f{i}"] * sa
        if f"q{i}x" in packed:
            tx = _product(xq, packed[f"q{i}x"]) * packed[f"f{i}x"] * sx
            y = tx if y is None else y + tx
            y = y + _product(eq, packed[f"q{i}s"][:, :60]) * packed[f"f{i}s"]
        h = torch.relu(y + packed[f"b{i}"])
        if i + 1 < depth:
            hq, sa = _quant_dyn(h)
            if inputs is not None:
                inputs.append(hq.to(torch.int8))
    return _bf16(h)


def fused_sigma_int8_ref(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 sigma pass: (N, 3) f32 -> (N, 1) f32."""
    return sigma_head_ref(packed, _trunk_int8_ref(packed, xyz))


def fused_full_int8_ref(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                        samples_per_dir: int = 1) -> torch.Tensor:
    """Plain version of the int8 full pass: (N, 4) f32 [r, g, b, sigma]."""
    return full_heads_ref(packed, _trunk_int8_ref(packed, xyz), dirs, samples_per_dir)


# ---- CUDA kernel ------------------------------------------------------------

def _lib():
    """The built library (built at first use), its entry points typed."""
    from nerf_siren_tpu_torch.ops.kernels import _build

    lib = _build.load("fused_mlp_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nerf_field_int8_forward.argtypes = [p, ctypes.c_longlong, ctypes.POINTER(p), i, i, p, p,
                                            p, ctypes.c_longlong, p, ctypes.c_longlong, i, p, p]
    lib.nerf_field_int8_consts_floats.argtypes = [i, i, i]
    lib.nerf_field_int8_smem_bytes.argtypes = [i, i, i, i]
    for fn in (lib.nerf_field_int8_forward, lib.nerf_field_int8_consts_floats,
               lib.nerf_field_int8_smem_bytes):
        fn.restype = i
    return lib


def _pointer_table(packed: Packed, device) -> list:
    """Validate the pack against the kernel (the weight stream, the int8
    weights and scales, the biases, the heads) and list its device pointers
    in the order `nerf_field_int8_forward` reads them."""
    depth, width = _depth(packed), _width(packed, "int8 kernel")
    if "k4_stream" not in packed:
        raise ValueError("k4_stream: the pack has no weight stream "
                         "(pack_nerf_params_int8 builds it)")
    _check(packed["k4_stream"], "k4_stream", device, torch.int8,
           (k4_stream_numel(depth, _emb_layers(packed), width),))
    i8, f32 = torch.int8, torch.float32
    shapes = {"q0x": (i8, (width, 3))}
    for i in range(depth):
        shapes[f"b{i}"] = (f32, (width,))
        if i:
            shapes[f"q{i}"] = (i8, (width, width))
        if f"q{i}x" in packed:
            shapes[f"q{i}x"], shapes[f"q{i}s"] = (i8, (width, 3)), (i8, (width, EMB_Q))
        for g in ("", "x", "s"):
            if f"q{i}{g}" in shapes:
                shapes[f"f{i}{g}"] = (f32, (width,))
    for k, (dtype, shape) in shapes.items():
        _check(packed[k], k, device, dtype, shape)

    def ptr(k):
        return packed[k].data_ptr() if k in packed else 0

    table = []
    for i in range(depth):
        table += [ptr(f"q{i}"), ptr(f"f{i}"), ptr(f"q{i}x"), ptr(f"f{i}x"), ptr(f"q{i}s"),
                  ptr(f"f{i}s"), ptr(f"b{i}")]
    return table + head_pointers(packed, device)


def resident(packed: Packed, full: bool) -> bool:
    """Whether K4's resident kernel (csrc/fused_mlp_int8.cu) runs this pack:
    one of K1's widths, at most MAX_DEPTH layers, and (widths 128 and 256)
    its per-column constants fitting shared memory; else the wide kernel."""
    depth, width = _depth(packed), packed["w_sigma"].shape[0]
    if width not in KERNEL_WIDTHS or depth > MAX_DEPTH:
        return False
    smem = _lib().nerf_field_int8_smem_bytes(width, int(full), depth, len(_emb_layers(packed)))
    return 0 < smem <= SMEM_MAX


def _launch(packed: Packed, xyz: torch.Tensor, dirs: Optional[torch.Tensor],
            samples_per_dir: int, dump: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, str]:
    """Launch the resident or the wide kernel; returns (out, the
    `LAUNCHES` key of the pass and kernel)."""
    n = check_points("int8 NeRF field", xyz, dirs, samples_per_dir)
    full = dirs is not None
    table = _pointer_table(packed, xyz.device)
    out = torch.empty((n, 4 if full else 1), dtype=torch.float32, device=xyz.device)
    key = "full" if full else "sigma"
    if n == 0:
        return out, key
    depth, width = _depth(packed), packed["w_sigma"].shape[0]
    if not resident(packed, full):
        layers, n_trunk = [], 0
        for i in range(depth):
            q_h, f_h, q_x, f_x, q_s, f_s, b = table[7 * i: 7 * i + 7]
            layers += [b, f_h, q_x, f_x, f_s, int(q_x != 0)]
            n_trunk += (width // ROW_BYTES if i else 0) + int(q_x != 0)
        wide_launch(True, packed["k4_stream"], n_trunk, layers, depth, width, table[7 * depth:],
                    xyz, dirs, samples_per_dir, out, dump)
        return out, key + "_wide"
    lib = _lib()
    # the split widths' per-column constants table, which the launch fills
    n_consts = lib.nerf_field_int8_consts_floats(width, depth, len(_emb_layers(packed)))
    consts = torch.empty(n_consts, dtype=torch.float32, device=xyz.device) if n_consts else None
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        weights = packed["k4_stream"]
        err = lib.nerf_field_int8_forward(
            weights.data_ptr(), weights.numel(), (ctypes.c_void_p * len(table))(*table), depth,
            width, None if consts is None else consts.data_ptr(), xyz.data_ptr(),
            dirs.data_ptr() if full else None, samples_per_dir, out.data_ptr(), n, int(full),
            None if dump is None else dump.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nerf_field_int8_forward failed: cudaError {err}")
    return out, key


def fused_nerf_sigma_int8(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """Raw sigma (N, 1) f32 for (N, 3) f32 points, int8 trunk."""
    if xyz.device.type == "cpu":
        return fused_sigma_int8_ref(packed, xyz)
    out, key = _launch(packed, xyz, None, 1)
    count_launch(LAUNCHES, key)
    return out


def fused_nerf_full_int8(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                         samples_per_dir: int = 1) -> torch.Tensor:
    """[r, g, b, sigma] (N, 4) f32 for (N, 3) points, int8 trunk; point p
    takes direction `dirs[p // samples_per_dir]`."""
    if xyz.device.type == "cpu":
        return fused_full_int8_ref(packed, xyz, dirs, samples_per_dir)
    out, key = _launch(packed, xyz, dirs, samples_per_dir)
    count_launch(LAUNCHES, key)
    return out


def int8_trunk_inputs_ref(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """The plain version's int8 layer inputs (`int8_trunk_inputs`), on any device."""
    inputs: list = []
    _trunk_int8_ref(packed, xyz, inputs)
    return torch.stack(inputs)


def int8_trunk_inputs(packed: Packed, xyz: torch.Tensor) -> torch.Tensor:
    """(depth, N, W) int8: slot 0 holds [x_q (3), sin/cos_q (60), 0...],
    slot l the int8 input of layer l. On a CUDA tensor the kernel's own
    (one sigma-pass launch, not counted in `LAUNCHES`), on a CPU tensor the
    plain version's."""
    if xyz.device.type == "cpu":
        return int8_trunk_inputs_ref(packed, xyz)
    dump = torch.zeros((_depth(packed), xyz.shape[0], packed["w_sigma"].shape[0]),
                       dtype=torch.int8, device=xyz.device)
    _launch(packed, xyz, None, 1, dump)
    return dump
