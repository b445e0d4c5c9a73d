"""d3_cloud_ms: device ms a traced semantic training step spends in the
program's `d3.cloud` device spans: building both clouds (the sort of the
compositing weights, the gathers of the points' xyz and rgb, the norm)."""
from benchmark.metrics._device_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "d3.cloud")
