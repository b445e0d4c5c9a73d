"""d3_points_ms: device ms a traced semantic training step spends in the
program's `d3.points` device spans: the point network's forward on both
clouds (PointNet at every slot, masked BatchNorm and max-pools,
log_softmax)."""
from benchmark.metrics._device_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "d3.points")
