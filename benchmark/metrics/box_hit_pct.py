"""box_hit_pct: of the rays the fast renderer handed to the march over the
traced frames (the program's counter `fast.rays`: K3's rows, and K1's work
at their survivors), the share whose interval met the scene box
(`fast.rays_in_box`); the rest cannot meet the scene at all."""
from benchmark.metrics._program import counter_share_pct


def read(run):
    return counter_share_pct("fast.rays_in_box", "fast.rays")
