"""enqueue_ms.<cells>: host ms of a frame's render call up to its return,
before the harness's synchronise (the `frame_call` span: the eval CLI's
tiling and every launch of the frame), mean over the window's frames; the
reader of `enqueue_ms.render` and `.fast`."""
from benchmark.metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "frame_call")
