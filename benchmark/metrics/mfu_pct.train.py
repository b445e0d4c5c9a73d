"""mfu_pct.train: the training step's model flops (`benchmark/counts/`,
from the configuration's widths, forward and backward) times the window's
steps, over the window's seconds and the card's dense bf16 peak."""
from benchmark.metrics._common import PEAK_BF16_FLOPS


def read(run):
    r = run.readings
    if not r.get("steps") or not r.get("window_s"):
        return None
    return 100.0 * r["step_flops"] * r["steps"] / r["window_s"] / PEAK_BF16_FLOPS
