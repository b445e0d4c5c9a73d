"""fast_clip_ms: host ms a traced frame spends in the fast renderer's
`fast.clip` spans, less their children: the direction norms, the clip of
each ray to the scene box (`render/fast.py::_clip_to_aabb`) and the
march's (R, 8) rays, summed over the frame's chunks."""
from benchmark.metrics._program import self_ms


def read(run):
    return self_ms(run, "fast.clip")
