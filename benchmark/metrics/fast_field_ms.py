"""fast_field_ms: host ms a traced frame spends in the fast renderer's
`fast.field` spans: the field kernel's call at the survivors (K1, or K4 for
an int8 pack), summed over the chunks."""
from benchmark.metrics._program import self_ms


def read(run):
    return self_ms(run, "fast.field")
