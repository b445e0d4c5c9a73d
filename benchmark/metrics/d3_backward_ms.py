"""d3_backward_ms: device ms a traced semantic training step spends in the
program's `step.backward` device span: the step's backward, the point
network's through both clouds (the fields are frozen)."""
from benchmark.metrics._device_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "step.backward")
