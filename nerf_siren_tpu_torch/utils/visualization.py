"""Depth visualisation (counterpart of `nerf_siren_tpu/utils/visualization.py`).

The JAX package colours a depth map with cv2's `applyColorMap(...,
COLORMAP_JET)`. The port carries that colour map as a table instead: the
machine with the card has no cv2. `JET_RGB` is cv2's JET map, the colour of
each of the 256 levels in RGB order, so the lookup below gives cv2's bytes.
"""
from __future__ import annotations

import numpy as np

# cv2.applyColorMap(arange(256, uint8), COLORMAP_JET), BGR -> RGB, as hex bytes
JET_RGB = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b80000bc"
    "0000c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff"
    "00c0ff00c4ff00c8ff00ccff00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd232ffce36ffca3affc63effc2"
    "42ffbe46ffba4affb64effb252ffae56ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000"
    "ffbc00ffb800ffb400ffb000ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000ff4c00ff4800ff4400ff4000"
    "ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c0000880000840000800000"
), np.uint8).reshape(256, 3)


def visualize_depth(depth) -> np.ndarray:
    """Normalise a (H, W) depth map (NaN read as 0) to [0, 255] and colour it
    with the JET map: (H, W, 3) uint8 RGB."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    mi, ma = np.min(x), np.max(x)
    x = (x - mi) / (ma - mi + 1e-8)
    return JET_RGB[(255 * x).astype(np.uint8)]
