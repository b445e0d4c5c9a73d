"""fast_setup_s: host seconds of the fast renderer's set-up
(`eval.setup_fast_proxy`: the proxy's distillation and the scene box; the
driver's `fast_setup` span)."""


def read(run):
    d = run.spans.durations("fast_setup")
    return sum(d) if d else None
