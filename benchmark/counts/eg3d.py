"""Operations of an EG3D training step, from the configuration's widths:
the StyleGAN2 synthesis (each modulated 3x3 convolution at its output
resolution, each 1x1 toRGB, each style affine), the mapping, and the
renderer's decoder at every sample (its bilinear taps and the plane mean
are not counted: they are a few flops a channel). Training takes three
times the forward's multiply-adds (the forward, the weight gradients, the
input gradients); flops are two per multiply-add."""
from __future__ import annotations

import math


def synthesis_macs(cfg: dict) -> int:
    def ch(res):
        return min(cfg["channel_base"] // res, cfg["channel_max"])

    img_ch, w_dim = 3 * cfg["plane_channels"], cfg["w_dim"]
    macs = 0
    for res in (2 ** i for i in range(2, int(math.log2(cfg["plane_resolution"])) + 1)):
        out_ch = ch(res)
        ins = [out_ch] if res == 4 else [ch(res // 2), out_ch]
        for cin in ins:
            macs += cin * out_ch * 9 * res * res + w_dim * cin
        macs += out_ch * img_ch * res * res + w_dim * out_ch
    return macs


def mapping_macs(cfg: dict) -> int:
    return cfg["mapping_layers"] * cfg["w_dim"] * max(cfg["w_dim"], cfg["z_dim"])


def decoder_macs_per_point(cfg: dict) -> int:
    return cfg["plane_channels"] * cfg["decoder_hidden"] + cfg["decoder_hidden"] * cfg["decoder_out"]


def train_step_flops(cfg: dict, rays: int) -> int:
    points = rays * (cfg["n_samples"] + cfg["n_importance"])
    fwd = synthesis_macs(cfg) + mapping_macs(cfg) + points * decoder_macs_per_point(cfg)
    return 2 * 3 * fwd
