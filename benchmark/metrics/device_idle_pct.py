"""device_idle_pct.<cells>: the share of the traced slice (training steps
or frames) in which no operation ran on the device (`torch.profiler`); the
reader of `device_idle_pct.train`, `.render` and `.fast`."""
from benchmark.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
