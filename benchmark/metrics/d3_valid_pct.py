"""d3_valid_pct: of the slots of the semantic clouds over the traced steps
(the program's counter `d3.cloud_slots`: K a pass), the share that held a
valid point (`d3.cloud_valid`: weight above the threshold); the rest run
through the point network masked."""
from benchmark.metrics._program import counter_share_pct


def read(run):
    return counter_share_pct("d3.cloud_valid", "d3.cloud_slots")
