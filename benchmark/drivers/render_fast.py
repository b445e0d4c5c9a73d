"""Frame traffic on the proxy-culled renderer: `render_exact`'s closed loop
and check, with the renderer `eval.py` builds for `--renderer fast`.

Set-up also runs the CLI's fast set-up (`eval.setup_fast_proxy`: the
density proxy distilled from the fine field, and the scene box; its
`fast_setup` span). The check takes nothing of that state: the fast
frame's rays are held, ray by ray, against the reference's exact render
of them, so the distillation, the box, the march and the placement of the
K survivors are judged together by what the frame shows. The fast render
approximates the exact one, so the cell compares the gaps' tail (the 99th
percentile over the checked rays) beside the widest colour gap.
"""
from benchmark.drivers.render_exact import control, run  # noqa: F401
