"""renderer_other_ms.<cells>: device ms a frame spends in everything but
the field kernels K1 / K4 and the proxy kernels K3: sampling, sorting,
compositing and the renderer's glue, in the traced slice; the reader of
`renderer_other_ms.render` and `.fast`."""
from benchmark.metrics._common import renderer_other_ms


def read(run):
    return renderer_other_ms(run)
