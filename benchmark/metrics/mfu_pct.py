"""mfu_pct.<frame cells>: the model flops a frame needs
(`benchmark/counts/nerf.py`: an exact frame's two field passes at 64 and
192 points a ray; a fast frame's full pass at K survivors a ray and the
proxy at C candidates a ray) times the window's frames, over the window's
seconds and the card's dense bf16 peak; the reader of `mfu_pct.render`
and `.fast` (training has `mfu_pct.train.py`)."""
from benchmark.metrics._common import frame_mfu_pct


def read(run):
    return frame_mfu_pct(run)
