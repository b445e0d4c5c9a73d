"""k1_roofline: the field kernel K1 (`csrc/fused_mlp.cu`: both passes of an
exact frame, or the full pass at the K survivors of a fast frame) against
the least time the card could take for the field work of the traced
frames (`benchmark/counts/nerf.py`: the frame's point counts, flops from
the widths, bytes of weights, points and outputs); also the reader of
`k1_roofline.fast`."""
from benchmark.metrics._common import frame_roofline_pct


def read(run):
    return frame_roofline_pct(run, "k1")
