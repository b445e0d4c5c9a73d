"""k3_roofline: the proxy kernels K3 (`csrc/proxy_march.cu`: the march and
placement) against the least time the card could take for the proxy's
work on the traced frames (`benchmark/counts/nerf.py`: the proxy at every
candidate; its weights, each ray's row and its placed samples)."""
from benchmark.metrics._common import frame_roofline_pct


def read(run):
    return frame_roofline_pct(run, "k3")
