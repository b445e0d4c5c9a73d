"""fast_composite_ms: host ms a traced frame spends in the fast
renderer's `fast.composite` spans: the alphas and the compositing of the
survivors into the chunk's outputs, summed over the chunks."""
from benchmark.metrics._program import self_ms


def read(run):
    return self_ms(run, "fast.composite")
