"""group_h2d_ms.<cells>: host ms a traced group of training steps spends
in the program's `group.h2d` span: the copy of its batches (or pool) to the
device; the reader of `group_h2d_ms.train`."""
from benchmark.metrics._program import self_ms


def read(run):
    return self_ms(run, "group.h2d")
