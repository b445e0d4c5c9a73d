"""host_idle_pct.<cells>: the share of the traced slice in which the device
was idle in gaps that began while a span of the program was open on the
host (`_program.idle_by_span`); `device_idle_pct` less this is the idle time
under the harness alone. The reader of `host_idle_pct.train`, `.render` and
`.fast`."""
from benchmark.metrics._program import host_idle_pct


def read(run):
    return host_idle_pct(run)
