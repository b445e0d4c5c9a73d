"""Fused NeRF training field: pack, plain PyTorch forward and backward, the
CUDA kernels' wrappers, and the autograd Function around them.

Counterpart of `nerf_siren_tpu/ops/pallas/fused_mlp_train.py` (the TPU
kernels `_fwd_kernel` / `_bwd_kernel` and the `fused_field_train`
custom_vjp). The kernels are `csrc/fused_mlp_train.cu`; this module owns
everything around them:

- `pack_train_params`: one field's parameters in the kernels' layout, on
  their own device. Torch-layout `(out, in)` bf16 weights, float32 biases,
  embedding columns in reference order zero-padded to `EMB_X` / `EMB_D`,
  the skip layer split into its embedding (`w4e`) and hidden (`w4`)
  columns, and the heads UNFOLDED (`w_feat` is xyz_final, `w_dfeat` /
  `w_ddir` the two column blocks of dir_layer), because their gradients
  are separate parameters. The TPU layout (k-major permuted sin/cos rows,
  +pi/2 cos phase, 8-row padded heads, the (8, N) point layout, TILE_T)
  is not kept.
- `k2_stream` (a key of the pack): the weights again, as the tile kernel
  streams them. One bf16 buffer of 64-input slices in the order
  `k2_schedule` lists: every slice of the recompute (as K1's `k1_stream`
  cuts them, unfolded heads), then every slice of the dgrad chain, cut
  from W^T (its rows are the layer's inputs), each slice (rows, 64) in the
  128-byte swizzle wgmma reads. The forward reads its first
  `K2_FWD_SLICES` slices (`K2_FWD_STREAM_NUMEL` elements), the backward all
  of it. `unpack_k2_stream` is its plain inverse, `unpack_k2_forward` that
  of the forward's prefix.
- the stash layout the backward's kernels share (`block_stash`, with its
  plain inverse `unblock_stash`), and the weight-gradient GEMM's plan
  (`wgrad_jobs`, `wgrad_split_plan`), mirrors of the CUDA source's.
- `fused_train_fwd_ref` / `fused_train_bwd_ref`: the plain version. The
  TPU kernel's roundings, step by step in the order of `_bwd_kernel`:
  bf16 operands (rounded, then multiplied in float32 with TF32 off) and
  float32 sums; ReLU outputs and `feat` stored as bf16, ReLU masks read
  from them; every cotangent rounded to bf16 before a product, weight
  gradients included (as `_op_dtype` gives on the TPU); bias gradients
  summed from the float32 cotangents. Gradients come back keyed and shaped
  like the pack (float32). `backward_ref_from` is its gradient chain from
  given forward values.
- `fused_train_fwd` / `fused_train_bwd`: the wrappers. A CPU tensor goes to
  the plain version; a CUDA tensor launches the kernels or raises.
  `LAUNCHES` counts wrapper launches ("bwd" counts the three-kernel
  backward once). `fused_train_bwd_activations` also returns the forward
  values the backward kernel stashed, for the card tests.
- `fused_field_train` (an autograd Function over one `NeRF`'s parameters;
  no gradient for points or directions) and `make_fused_train_field_fn`,
  the `render_rays` field override of the `fused` training backend.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels._build import count_launch
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import (EMB_D, EMB_X, SLICE, _bf16, _check,
                                                        _embed, _swizzle128)

W = 256           # trunk width (reference topology)
WD = W // 2       # direction-branch width
DEPTH = 8
SKIP = 4
N_EMB_X = 63      # 3 * (2 * 10 + 1)
N_EMB_D = 27      # 3 * (2 * 4 + 1)
HEAD = 16         # rows of the kernel's head-gradient blocks
SIGMA_ROW = 3     # row of d w_sigma in that block (rows 0..2: d w_rgb)

TP = 128          # points per tile of the backward's tile kernel
BLOCK = 64        # points per block of the stash
G_M = 128         # gradient rows per CTA of the weight-gradient GEMM

LAUNCHES = {"fwd": 0, "bwd": 0}

Packed = Dict[str, torch.Tensor]


def check_topology(cfg: NeRFConfig) -> None:
    """The kernels implement the reference field only."""
    if (cfg.depth, cfg.width, tuple(cfg.skips), cfg.in_channels_xyz, cfg.in_channels_dir,
            cfg.n_classes) != (DEPTH, W, (SKIP,), N_EMB_X, N_EMB_D, 0):
        raise ValueError("the fused training field supports the reference 8x256 "
                         "skip-(4,) topology with PE 10/4 and no semantic head, "
                         f"got {cfg}")


def pack_train_params(params: Dict[str, torch.Tensor]) -> Packed:
    """One field's parameters (a `NeRF` state_dict or `named_parameters`
    dict) -> the kernels' weight dict, on the parameters' device, with the
    backward's weight stream `k2_stream`."""
    with torch.no_grad():
        p = _pack(params)
        p["k2_stream"] = k2_stream(p)
        return p


def _pack(params: Dict[str, torch.Tensor]) -> Packed:
    """`pack_train_params`, differentiable (the tests run autograd through
    the plain forward on it)."""
    bf = torch.bfloat16
    p: Packed = {}
    for i in range(DEPTH):
        w = params[f"xyz_layers.{i}.weight"]
        if i == 0:
            p["w0e"] = F.pad(w, (0, EMB_X - N_EMB_X)).to(bf)
        elif i == SKIP:
            p[f"w{i}e"] = F.pad(w[:, :N_EMB_X], (0, EMB_X - N_EMB_X)).to(bf)
            p[f"w{i}"] = w[:, N_EMB_X:].to(bf)
        else:
            p[f"w{i}"] = w.to(bf)
        p[f"b{i}"] = params[f"xyz_layers.{i}.bias"].float()
    p["w_sigma"] = params["sigma.weight"][0].to(bf)
    p["b_sigma"] = params["sigma.bias"].float()
    p["w_feat"] = params["xyz_final.weight"].to(bf)
    p["b_feat"] = params["xyz_final.bias"].float()
    wd = params["dir_layer.weight"]
    p["w_dfeat"] = wd[:, :W].to(bf)
    p["w_ddir"] = F.pad(wd[:, W:], (0, EMB_D - N_EMB_D)).to(bf)
    p["b_dir"] = params["dir_layer.bias"].float()
    p["w_rgb"] = params["rgb.weight"].to(bf)
    p["b_rgb"] = params["rgb.bias"].float()
    return {k: v.contiguous() for k, v in p.items()}


# ---- the backward's weight stream (k2_stream) --------------------------------

def k2_schedule() -> list:
    """The slices of `k2_stream` in the order the backward's tile kernel
    consumes them, as (weight key, transposed, first input column): the
    recompute's (layer 0's embedding slice; each hidden layer's 4 slices and
    the skip layer's embedding slice after them; W_feat's 4; W_dfeat's 4
    and W_ddir zero-padded to 64 inputs, 128 rows each), then the dgrad
    chain's, cut from W^T (W_dfeat^T's 2, W_feat^T's 4, W_7^T's .. W_1^T's 4
    each, 256 rows each)."""
    fwd = [("w0e", False, 0)]
    for i in range(1, DEPTH):
        fwd += [(f"w{i}", False, c) for c in range(0, W, SLICE)]
        if i == SKIP:
            fwd.append((f"w{i}e", False, 0))
    fwd += [("w_feat", False, c) for c in range(0, W, SLICE)]
    fwd += [("w_dfeat", False, c) for c in range(0, W, SLICE)] + [("w_ddir", False, 0)]
    bwd = [("w_dfeat", True, c) for c in range(0, WD, SLICE)]
    bwd += [("w_feat", True, c) for c in range(0, W, SLICE)]
    for i in range(DEPTH - 1, 0, -1):
        bwd += [(f"w{i}", True, c) for c in range(0, W, SLICE)]
    return fwd + bwd


def _slice_rows(key: str, transposed: bool) -> int:
    return WD if key in ("w_dfeat", "w_ddir") and not transposed else W


K2_STREAM_NUMEL = sum(_slice_rows(k, t) * SLICE for k, t, _ in k2_schedule())
# the recompute's slices, which lead the stream: all that the forward reads
K2_FWD_SLICES = next(j for j, (_, t, _) in enumerate(k2_schedule()) if t)
K2_FWD_STREAM_NUMEL = sum(_slice_rows(k, t) * SLICE for k, t, _ in k2_schedule()[:K2_FWD_SLICES])


def _slices(m: torch.Tensor) -> torch.Tensor:
    """(rows, 64 k) -> its k slices of 64 columns, swizzled, flattened in order."""
    rows = m.shape[0]
    return _swizzle128(m.reshape(rows, -1, SLICE).transpose(0, 1)).flatten()


def k2_stream(p: Packed) -> torch.Tensor:
    """The pack's weights in `k2_schedule`'s order and layout (bf16), in a
    few batched operations (the pack is rebuilt every training step)."""
    hidden = [p[f"w{i}"] for i in range(1, DEPTH)]
    fwd = torch.cat([p["w0e"], *hidden[:SKIP], p[f"w{SKIP}e"], *hidden[SKIP:], p["w_feat"]], 1)
    fwd_dir = torch.cat([p["w_dfeat"], F.pad(p["w_ddir"], (0, SLICE - EMB_D))], 1)
    bwd = torch.cat([p["w_dfeat"].t(), p["w_feat"].t(), *(w.t() for w in hidden[::-1])], 1)
    return torch.cat([_slices(fwd), _slices(fwd_dir), _slices(bwd)])


def unpack_k2_stream(stream: torch.Tensor) -> Dict[tuple, torch.Tensor]:
    """The weights `k2_stream` holds, rebuilt from it alone (the plain
    inverse of the pack): {(key, transposed): matrix}, the matrix W (rows
    out) or W^T (rows in) as the stream cut it; `w_ddir` keeps its 64
    zero-padded inputs."""
    return _unpack(stream, k2_schedule(), K2_STREAM_NUMEL)


def unpack_k2_forward(prefix: torch.Tensor) -> Dict[tuple, torch.Tensor]:
    """`unpack_k2_stream` of the stream's first `K2_FWD_STREAM_NUMEL`
    elements: the weights the forward reads."""
    return _unpack(prefix, k2_schedule()[:K2_FWD_SLICES], K2_FWD_STREAM_NUMEL)


def _unpack(stream: torch.Tensor, schedule: list, numel: int) -> Dict[tuple, torch.Tensor]:
    if stream.numel() != numel:
        raise ValueError(f"k2_stream: {stream.numel()} elements, the schedule holds {numel}")
    parts: Dict[tuple, Dict[int, torch.Tensor]] = {}
    off = 0
    for k, t, c in schedule:
        rows = _slice_rows(k, t)
        s = _swizzle128(stream[off: off + rows * SLICE].view(rows, SLICE))
        parts.setdefault((k, t), {})[c] = s
        off += rows * SLICE
    return {k: torch.cat([v[c] for c in sorted(v)], dim=1) for k, v in parts.items()}


# ---- the backward's stash and weight-gradient plan ---------------------------

def block_stash(x: torch.Tensor) -> torch.Tensor:
    """(n, F) -> the stash layout, flat: whole tiles of TP points (zero rows
    past n), in blocks of BLOCK points; block b is F rows of BLOCK values
    (feature f of its points), 8-value chunk j of row f stored at chunk
    j ^ (f % 8)."""
    n, cols = x.shape
    n_pad = -(-n // TP) * TP
    x = F.pad(x, (0, 0, 0, n_pad - n)).reshape(n_pad // BLOCK, BLOCK, cols).transpose(1, 2)
    return _swizzle128(x).flatten()


def unblock_stash(flat: torch.Tensor, n: int, cols: int) -> torch.Tensor:
    """The plain inverse of `block_stash`: the first n points, (n, cols)."""
    x = _swizzle128(flat.reshape(-1, cols, BLOCK))
    return x.transpose(1, 2).reshape(-1, cols)[:n]


def wgrad_jobs() -> list:
    """The weight-gradient GEMM's jobs, in the CUDA source's order: (stash
    array of the rows, its features, stash array of the columns, its
    features, gradient key, transposed). The gradient (rows, columns) =
    sum over points of rows^T columns; a transposed job's gradient is the
    (columns, rows) head block (`HEAD` rows). Each job is cut into
    rows / G_M CTA tiles."""
    jobs = [(f"dz{i}", W, f"h{i - 1}", W, f"w{i}", False) for i in range(1, DEPTH)]
    jobs += [("dfeat", W, f"h{DEPTH - 1}", W, "w_feat", False),
             ("dhd", WD, "feat", W, "w_dfeat", False),
             ("dz0", W, "emb", EMB_X, "w0e", False),
             (f"dz{SKIP}", W, "emb", EMB_X, f"w{SKIP}e", False),
             ("dhd", WD, "demb", EMB_D, "w_ddir", False),
             (f"h{DEPTH - 1}", W, "dhead", HEAD, "w_sigma", True),
             ("hd", WD, "dhead", HEAD, "w_rgb", True)]
    return jobs


def wgrad_split_plan(n: int) -> tuple:
    """(blocks, blocks per slab, slabs) of the weight-gradient GEMM for n
    points: up to 32 slabs of at least 16 blocks, none empty."""
    blocks = -(-n // TP) * TP // BLOCK
    want = min(max(blocks // 16, 1), 32)
    slab = -(-blocks // want)
    return blocks, slab, -(-blocks // slab)


STASH_FEATURES = ({"emb": EMB_X, "demb": EMB_D, "feat": W, "hd": WD, "dfeat": W, "dhd": WD,
                   "dhead": HEAD} | {f"h{i}": W for i in range(DEPTH)}
                  | {f"dz{i}": W for i in range(DEPTH)})


def stash_bytes_per_point() -> tuple:
    """(bytes the tile kernel writes to the stash, bytes the weight-gradient
    GEMM reads from it) per point, counted from the layout and the plan:
    a job reads its rows once and its columns once per CTA tile."""
    written = 2 * sum(STASH_FEATURES.values())
    read = 2 * sum(fa + fb * (fa // G_M) for _, fa, _, fb, _, _ in wgrad_jobs())
    return written, read


def grads_to_state_dict(g: Packed) -> Dict[str, torch.Tensor]:
    """Pack-layout gradients -> gradients keyed and shaped like the
    `NeRF` state_dict (the padding columns are dropped)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(DEPTH):
        if i == 0:
            w = g["w0e"][:, :N_EMB_X]
        elif i == SKIP:
            w = torch.cat([g[f"w{i}e"][:, :N_EMB_X], g[f"w{i}"]], dim=1)
        else:
            w = g[f"w{i}"]
        out[f"xyz_layers.{i}.weight"] = w
        out[f"xyz_layers.{i}.bias"] = g[f"b{i}"]
    out["xyz_final.weight"] = g["w_feat"]
    out["xyz_final.bias"] = g["b_feat"]
    out["sigma.weight"] = g["w_sigma"][None]
    out["sigma.bias"] = g["b_sigma"]
    out["dir_layer.weight"] = torch.cat([g["w_dfeat"], g["w_ddir"][:, :N_EMB_D]], dim=1)
    out["dir_layer.bias"] = g["b_dir"]
    out["rgb.weight"] = g["w_rgb"]
    out["rgb.bias"] = g["b_rgb"]
    return {k: v.contiguous() for k, v in out.items()}


# ---- plain PyTorch version --------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, I) bf16-valued activations x (O, I) bf16 weight -> (N, O) f32."""
    return a @ w.float().t()


def _point_dirs(dirs: torch.Tensor, n: int, samples_per_dir: int) -> torch.Tensor:
    return dirs.repeat_interleave(samples_per_dir, dim=0)[:n]


def _forward_ref(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                 samples_per_dir: int):
    ex = _embed(xyz, 10, EMB_X)
    hs = []
    h = None
    for i in range(DEPTH):
        y = packed[f"b{i}"]
        if i > 0:
            y = y + _mm(h, packed[f"w{i}"])
        if i in (0, SKIP):
            y = y + _mm(ex, packed[f"w{i}e"])
        h = _bf16(torch.relu(y))
        hs.append(h)
    sigma = h @ packed["w_sigma"].float() + packed["b_sigma"]
    feat = _bf16(_mm(h, packed["w_feat"]) + packed["b_feat"])
    demb = _embed(_point_dirs(dirs, xyz.shape[0], samples_per_dir), 4, EMB_D)
    hd = _bf16(torch.relu(_mm(feat, packed["w_dfeat"]) + _mm(demb, packed["w_ddir"])
                          + packed["b_dir"]))
    rgb = torch.sigmoid(_mm(hd, packed["w_rgb"]) + packed["b_rgb"])
    return ex, hs, sigma, feat, demb, hd, rgb


def fused_train_fwd_ref(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                        samples_per_dir: int = 1) -> torch.Tensor:
    """Plain forward: (N, 3) points, (ceil(N / samples_per_dir), 3)
    directions -> (N, 4) f32 [r, g, b, sigma]."""
    *_, sigma, _, _, _, rgb = _forward_ref(packed, xyz, dirs, samples_per_dir)
    return torch.cat([rgb, sigma[:, None]], dim=-1)


def fused_train_bwd_ref(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                        dy: torch.Tensor, samples_per_dir: int = 1) -> Packed:
    """Plain backward: recompute the forward, then the gradients of
    sum(out * dy) for every packed weight (f32, keyed like the pack)."""
    ex, hs, _, feat, demb, hd, rgb = _forward_ref(packed, xyz, dirs, samples_per_dir)
    return backward_ref_from(packed, (ex, hs, feat, demb, hd, rgb), dy)


def backward_ref_from(packed: Packed, acts, dy: torch.Tensor) -> Packed:
    """The plain backward's gradient chain from given forward values
    `acts` = (emb, [h_0..h_7], feat, demb, hd, rgb), float32 tensors of N
    rows (all but rgb bf16-valued). Fed the activations the backward
    kernel stashed, it takes the kernel's own ReLU masks."""
    ex, hs, feat, demb, hd, rgb = acts
    g: Packed = {}

    def wgrad(dz, a):                       # (N, O) x (N, I) -> (O, I)
        return _bf16(dz).t() @ a

    dz_r = dy[:, :3] * rgb * (1.0 - rgb)
    g["w_rgb"] = wgrad(dz_r, hd)
    g["b_rgb"] = dz_r.sum(0)

    dhd = _bf16(dz_r) @ packed["w_rgb"].float()
    dz_hd = torch.where(hd > 0, dhd, 0.0)
    g["w_dfeat"] = wgrad(dz_hd, feat)
    g["w_ddir"] = wgrad(dz_hd, demb)
    g["b_dir"] = dz_hd.sum(0)

    dfeat = _bf16(dz_hd) @ packed["w_dfeat"].float()
    g["w_feat"] = wgrad(dfeat, hs[-1])
    g["b_feat"] = dfeat.sum(0)

    dz_sig = dy[:, 3]
    g["w_sigma"] = _bf16(dz_sig) @ hs[-1]
    g["b_sigma"] = dz_sig.sum(0, keepdim=True)

    dh = (_bf16(dfeat) @ packed["w_feat"].float()
          + _bf16(dz_sig)[:, None] * packed["w_sigma"].float()[None])
    for i in range(DEPTH - 1, -1, -1):
        dz = torch.where(hs[i] > 0, dh, 0.0)
        if i in (0, SKIP):
            g[f"w{i}e"] = wgrad(dz, ex)
        if i > 0:
            g[f"w{i}"] = wgrad(dz, hs[i - 1])
        g[f"b{i}"] = dz.sum(0)
        if i > 0:
            dh = _bf16(dz) @ packed[f"w{i}"].float()
    return g


# ---- CUDA kernels -----------------------------------------------------------

def _lib():
    """The built `csrc/fused_mlp_train.cu` with its argtypes set."""
    from nerf_siren_tpu_torch.ops.kernels import _build

    lib = _build.load("fused_mlp_train")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    table = ctypes.POINTER(ctypes.c_void_p)
    lib.nerf_train_forward.argtypes = [table, vp, ll, vp, vp, ll, vp, ll, vp]
    lib.nerf_train_forward.restype = ctypes.c_int
    lib.nerf_train_workspace_bytes.argtypes = [ll]
    lib.nerf_train_workspace_bytes.restype = ll
    lib.nerf_train_backward.argtypes = [table, table, vp, ll, vp, vp, ll, vp, ll, vp, ll, vp]
    lib.nerf_train_backward.restype = ctypes.c_int
    lib.nerf_train_stream_elems.argtypes = []
    lib.nerf_train_stream_elems.restype = ll
    lib.nerf_train_forward_stream_elems.argtypes = []
    lib.nerf_train_forward_stream_elems.restype = ll
    lib.nerf_train_smem_bytes.argtypes = [ctypes.c_int]
    lib.nerf_train_smem_bytes.restype = ctypes.c_int
    lib.nerf_train_activation_offsets.argtypes = [ll, ctypes.POINTER(ll)]
    lib.nerf_train_activation_offsets.restype = None
    return lib


_WEIGHT_SHAPES = (
    {"w0e": (W, EMB_X), f"w{SKIP}e": (W, EMB_X)}
    | {f"w{i}": (W, W) for i in range(1, DEPTH)}
    | {"w_sigma": (W,), "w_feat": (W, W), "w_dfeat": (WD, W), "w_ddir": (WD, EMB_D),
       "w_rgb": (3, WD)}
)
_BIAS_SHAPES = ({f"b{i}": (W,) for i in range(DEPTH)}
                | {"b_sigma": (1,), "b_feat": (W,), "b_dir": (WD,), "b_rgb": (3,)})
_HEADS = ("w_sigma", "b_sigma", "w_feat", "b_feat", "w_dfeat", "w_ddir", "b_dir",
          "w_rgb", "b_rgb")


def _table(tensors: Dict[str, torch.Tensor]) -> ctypes.Array:
    """Device pointers in the kernels' table order (0 where absent)."""
    def ptr(k):
        return tensors[k].data_ptr() if k in tensors else 0

    keys = ([f"w{i}" if i else "" for i in range(DEPTH)]
            + [f"w{i}e" if i in (0, SKIP) else "" for i in range(DEPTH)]
            + [f"b{i}" for i in range(DEPTH)] + list(_HEADS))
    ptrs = [ptr(k) for k in keys]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check_pack(packed: Packed, device, stream: bool = False) -> None:
    for k, shape in _WEIGHT_SHAPES.items():
        _check(packed[k], k, device, torch.bfloat16, shape)
    for k, shape in _BIAS_SHAPES.items():
        _check(packed[k], k, device, torch.float32, shape)
    if stream:
        if "k2_stream" not in packed:
            raise ValueError("k2_stream: the pack has no weight stream (pack_train_params "
                             "builds it)")
        _check(packed["k2_stream"], "k2_stream", device, torch.bfloat16, (K2_STREAM_NUMEL,))


def _check_points(xyz, dirs, samples_per_dir):
    if xyz.device.type != "cuda":
        raise ValueError(f"fused training field: unsupported device {xyz.device}")
    if samples_per_dir < 1:
        raise ValueError(f"samples_per_dir must be >= 1, got {samples_per_dir}")
    n = xyz.shape[0]
    _check(xyz, "xyz", xyz.device, torch.float32, (n, 3))
    _check(dirs, "dirs", xyz.device, torch.float32, (-(-n // samples_per_dir), 3))
    return n


def _launch_fwd(packed, xyz, dirs, samples_per_dir, entry=None):
    """The forward's launch; `entry` replaces the library's
    `nerf_train_forward` (a variant of it built by `k2_ablation`)."""
    n = _check_points(xyz, dirs, samples_per_dir)
    _check_pack(packed, xyz.device, stream=True)
    out = torch.empty((n, 4), dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    lib = _lib()
    stream = packed["k2_stream"]
    with torch.cuda.device(xyz.device):
        err = (entry or lib.nerf_train_forward)(
            _table(packed), stream.data_ptr(), stream.numel(), xyz.data_ptr(), dirs.data_ptr(),
            samples_per_dir, out.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nerf_train_forward failed: cudaError {err}")
    count_launch(LAUNCHES, "fwd")
    return out


def _launch_bwd(packed, xyz, dirs, dy, samples_per_dir, entry=None):
    """The backward's launch; `entry` replaces the library's
    `nerf_train_backward` (a variant of it built by `k2_ablation`)."""
    n = _check_points(xyz, dirs, samples_per_dir)
    _check_pack(packed, xyz.device, stream=True)
    _check(dy, "dy", xyz.device, torch.float32, (n, 4))
    dev = xyz.device
    if n == 0:
        return {k: torch.zeros(s, dtype=torch.float32, device=dev)
                for k, s in (_WEIGHT_SHAPES | _BIAS_SHAPES).items()}, None
    # the kernels write every gradient
    grads = {k: torch.empty(s, dtype=torch.float32, device=dev)
             for k, s in (_WEIGHT_SHAPES | _BIAS_SHAPES).items()}
    # the kernels write the head weight gradients as (HEAD, in) row blocks
    outs = dict(grads, w_sigma=torch.empty((HEAD, W), dtype=torch.float32, device=dev),
                w_rgb=torch.empty((HEAD, WD), dtype=torch.float32, device=dev))
    lib = _lib()
    stream = packed["k2_stream"]
    with torch.cuda.device(dev):
        ws_bytes = lib.nerf_train_workspace_bytes(n)
        if ws_bytes < 0:
            raise RuntimeError("nerf_train_workspace_bytes: cannot query the device")
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
        err = (entry or lib.nerf_train_backward)(
            _table(packed), _table(outs), stream.data_ptr(), stream.numel(), xyz.data_ptr(),
            dirs.data_ptr(), samples_per_dir, dy.data_ptr(), n, ws.data_ptr(), ws.numel(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nerf_train_backward failed: cudaError {err}")
    count_launch(LAUNCHES, "bwd")
    grads["w_sigma"] = outs["w_sigma"][SIGMA_ROW]
    grads["w_rgb"] = outs["w_rgb"][:3]
    return grads, ws


def fused_train_bwd_activations(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                                dy: torch.Tensor, samples_per_dir: int = 1):
    """`fused_train_bwd` on CUDA tensors, with the forward values its tile
    kernel stashed, read back through the stash layout (`unblock_stash`):
    (grads, (emb, [h_0..h_7], feat, demb, hd)), float32 with N rows, in the
    order `backward_ref_from` takes (without rgb)."""
    grads, ws = _launch_bwd(packed, xyz, dirs, dy, samples_per_dir)
    n = xyz.shape[0]
    n_pad = -(-n // TP) * TP
    offs = (ctypes.c_longlong * 12)()
    _lib().nerf_train_activation_offsets(n, offs)

    def view(i, cols):
        flat = ws[offs[i]:offs[i] + n_pad * cols * 2].view(torch.bfloat16)
        return unblock_stash(flat, n, cols).float()

    hs = [view(2 + l, W) for l in range(DEPTH)]
    return grads, (view(0, EMB_X), hs, view(10, W), view(1, EMB_D), view(11, WD))


def fused_train_fwd(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                    samples_per_dir: int = 1) -> torch.Tensor:
    """[r, g, b, sigma] (N, 4) f32 for (N, 3) points; point p takes direction
    `dirs[p // samples_per_dir]` (one direction per ray)."""
    if xyz.device.type == "cpu":
        return fused_train_fwd_ref(packed, xyz, dirs, samples_per_dir)
    return _launch_fwd(packed, xyz, dirs, samples_per_dir)


def fused_train_bwd(packed: Packed, xyz: torch.Tensor, dirs: torch.Tensor,
                    dy: torch.Tensor, samples_per_dir: int = 1) -> Packed:
    """Gradients of sum(fused_train_fwd(...) * dy) for every packed weight."""
    if xyz.device.type == "cpu":
        return fused_train_bwd_ref(packed, xyz, dirs, dy, samples_per_dir)
    return _launch_bwd(packed, xyz, dirs, dy, samples_per_dir)[0]


class _FusedTrainField(torch.autograd.Function):
    """Forward on K2's forward kernel; backward on its backward kernels.
    Gradients flow to the field's parameters only: sample positions and
    directions are data in NeRF training."""

    @staticmethod
    def forward(ctx, xyz, dirs, samples_per_dir, names, *params):
        packed = pack_train_params(dict(zip(names, params)))
        ctx.save_for_backward(xyz, dirs)
        ctx.packed, ctx.samples_per_dir, ctx.names = packed, samples_per_dir, names
        return fused_train_fwd(packed, xyz, dirs, samples_per_dir)

    @staticmethod
    def backward(ctx, dy):
        xyz, dirs = ctx.saved_tensors
        g = grads_to_state_dict(fused_train_bwd(ctx.packed, xyz, dirs,
                                                dy.float().contiguous(), ctx.samples_per_dir))
        return (None, None, None, None, *(g[k] for k in ctx.names))


def fused_field_train(model: NeRF, xyz: torch.Tensor, dirs: torch.Tensor,
                      samples_per_dir: int = 1) -> torch.Tensor:
    """The full field of one reference-topology `NeRF` on K2: (N, 3) points
    -> (N, 4) [rgb, sigma], differentiable in the model's parameters."""
    check_topology(model.cfg)
    names: Sequence[str] = tuple(n for n, _ in model.named_parameters())
    params = [p for _, p in model.named_parameters()]
    return _FusedTrainField.apply(xyz.contiguous(), dirs.contiguous(), samples_per_dir,
                                  names, *params)


def make_fused_train_field_fn(rays_d: torch.Tensor) -> Callable:
    """A `render_rays` `field_fn` backed by K2 for rays with directions
    `rays_d` (R, 3): the kernels embed each ray's direction themselves, so
    the pre-embedded `dir_emb` is only checked for presence. Training only:
    under test_time=False both passes are full evaluations."""
    rays_d = rays_d.contiguous()

    def field_fn(model: NeRF, xyz: torch.Tensor, dir_emb) -> torch.Tensor:
        if dir_emb is None:
            raise ValueError("the fused training field serves full evaluations only")
        r, s, _ = xyz.shape
        return fused_field_train(model, xyz.reshape(r * s, 3), rays_d, s).view(r, s, 4)

    return field_fn
