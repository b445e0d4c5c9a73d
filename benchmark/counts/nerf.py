"""Operations and bytes of the NeRF field's passes, from the configuration's
widths and the path's point counts (not from any kernel's pack), so a count
stays the same whatever implements the work.

A forward pass of one point is one multiply-add per weight of the layers
it runs: the trunk (`depth` layers of `width`, the embedding concatenated
again at each skip), the sigma head and, for a full pass, the feature
layer, the direction layer (`width` + the direction embedding -> `dir_width`)
and the rgb head. Training a point takes the forward, one multiply-add per
weight for the weight gradients, and one per weight for the gradients of
the layers' inputs, except the inputs that are embeddings (nothing upstream
of them learns). A recomputation of the forward, which a kernel may choose,
is not counted: these are the operations the inputs need. Flops are two per
multiply-add.
"""
from __future__ import annotations


def emb_width(n_freqs: int) -> int:
    return 3 * (2 * n_freqs + 1)


def trunk_inputs(cfg: dict) -> list:
    """Input width of each trunk layer."""
    ex = emb_width(cfg["xyz_freqs"])
    return [ex if i == 0 else cfg["width"] + (ex if i in cfg["skips"] else 0)
            for i in range(cfg["depth"])]


def forward_macs(cfg: dict, full: bool) -> int:
    """Multiply-adds of one point's pass: sigma only, or full (rgb too)."""
    w = cfg["width"]
    macs = sum(i * w for i in trunk_inputs(cfg)) + w
    if full:
        macs += w * w + (w + emb_width(cfg["dir_freqs"])) * cfg["dir_width"] + cfg["dir_width"] * 3
    return macs


def embedding_input_macs(cfg: dict) -> int:
    """Multiply-adds of a full pass whose input is an embedding column."""
    ex = emb_width(cfg["xyz_freqs"])
    n_emb_layers = 1 + len(cfg["skips"])
    return n_emb_layers * ex * cfg["width"] + emb_width(cfg["dir_freqs"]) * cfg["dir_width"]


def train_flops_per_point(cfg: dict) -> int:
    """Flops of one point of a full pass trained: forward, weight gradients,
    input gradients (none into embeddings)."""
    f = forward_macs(cfg, full=True)
    return 2 * (3 * f - embedding_input_macs(cfg))


def train_points(cfg: dict, rays: int) -> int:
    """Points a training step runs through the fields: the coarse full pass
    at n_samples and the fine full pass at n_samples + n_importance."""
    return rays * (2 * cfg["n_samples"] + cfg["n_importance"])


def train_step_flops(cfg: dict, rays: int) -> int:
    return train_points(cfg, rays) * train_flops_per_point(cfg)


def param_count(cfg: dict) -> int:
    """Weights and biases of one field (full)."""
    w = cfg["width"]
    n = sum(i * w + w for i in trunk_inputs(cfg)) + (w + 1)
    n += (w * w + w) + ((w + emb_width(cfg["dir_freqs"])) * cfg["dir_width"] + cfg["dir_width"])
    return n + cfg["dir_width"] * 3 + 3


def train_step_bytes(cfg: dict, rays: int) -> int:
    """Bytes the field kernels of a training step must move at least: each
    field's bf16 weights read twice (forward and backward) and its float32
    gradients written once; per point its float32 position in and its four
    outputs out, and their four cotangents in; per ray its direction."""
    per_field = param_count(cfg) * (2 * 2 + 4)
    per_point = 4 * (3 + 4 + 4)
    return 2 * per_field + train_points(cfg, rays) * per_point + 2 * rays * 12


def frame_flops(cfg: dict, rays: int) -> int:
    """Flops of an exact frame: the sigma-only coarse pass at n_samples and
    the full fine pass at n_samples + n_importance."""
    s, i = cfg["n_samples"], cfg["n_importance"]
    return 2 * rays * (s * forward_macs(cfg, False) + (s + i) * forward_macs(cfg, True))


def frame_bytes(cfg: dict, rays: int) -> int:
    """Bytes an exact frame's field passes must move at least: both fields'
    bf16 weights once, each point's float32 position in and its outputs out
    (sigma: 1 float; full: 4), each ray's direction in."""
    s, i = cfg["n_samples"], cfg["n_importance"]
    return (2 * 2 * param_count(cfg) + rays * s * 4 * (3 + 1)
            + rays * (s + i) * 4 * (3 + 4) + rays * 12)


def survivor_flops(cfg: dict, points: int) -> int:
    """Flops of a full pass over `points` survivors."""
    return 2 * points * forward_macs(cfg, True)


def survivor_bytes(cfg: dict, points: int, rays: int) -> int:
    return 2 * param_count(cfg) + points * 4 * (3 + 4) + rays * 12


def proxy_flops(hidden: int, freqs: int, candidates: int) -> int:
    """Flops of the density proxy at `candidates` points: an embedding of
    `freqs` frequencies -> `hidden` (relu) -> 1."""
    return 2 * candidates * (emb_width(freqs) * hidden + hidden)


def proxy_bytes(hidden: int, freqs: int, rays: int, n_keep: int) -> int:
    """Bytes the proxy march and placement must move at least: its bf16
    weights, each ray's float32 row in (8 floats) and its K placed depths
    and points out (4 floats each)."""
    return 2 * (emb_width(freqs) * hidden + hidden) + rays * 4 * (8 + 4 * n_keep)
