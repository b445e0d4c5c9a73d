"""What the readers of the program's device spans share
(`nerf_siren_tpu_torch/utils/tracing.py::device_span`: a span that also
records a pair of CUDA timing events on the stream, read with
`device_times()`): the device milliseconds a traced step spends in the
spans of one name. A program without device spans, a run without a card or
without a profile gives nothing, and the readers return None."""
from __future__ import annotations

from typing import Optional

from benchmark.metrics._program import slice_records, tracing


def device_ms_per_step(run, name: str) -> Optional[float]:
    """Device ms a traced step spends in the program's device spans `name`
    (their stretches of the stream, summed over the traced slice, over its
    steps)."""
    module, recs, steps = tracing(), slice_records(run), run.readings.get("traced_steps")
    times = getattr(module, "device_times", None)
    if times is None or not recs or not steps:
        return None
    ms = times()
    ids = [r.id for r in recs if r.name == name and r.id in ms]
    return sum(ms[i] for i in ids) / steps if ids else None
