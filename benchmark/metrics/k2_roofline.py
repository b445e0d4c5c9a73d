"""k2_roofline: K2 (`csrc/fused_mlp_train.cu`: its forward and backward
tile kernels, weight-gradient GEMM and reduction) against the least time
the card could take for the training steps' field work in the traced
slice (`benchmark/counts/nerf.py`: flops from the widths, forward and
backward, no recomputation; bytes of weights, points and gradients)."""
from benchmark.metrics._common import KERNEL_NAMES, roofline_pct


def read(run):
    r = run.readings
    if not r.get("traced_steps"):
        return None
    n = r["traced_steps"]
    return roofline_pct(run, KERNEL_NAMES["k2"], n * r["kernel_step_flops"],
                        n * r["kernel_step_bytes"])
