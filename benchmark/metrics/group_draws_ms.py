"""group_draws_ms.<cells>: host ms a traced group of training steps spends
in the program's `group.draws` span (`GroupedSteps.group_inputs`: the
steps' generators, their draws and the optimizer's scalar table); the
reader of `group_draws_ms.train`."""
from benchmark.metrics._program import self_ms


def read(run):
    return self_ms(run, "group.draws")
