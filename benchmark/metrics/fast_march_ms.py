"""fast_march_ms: host ms a traced frame spends in the fast renderer's
`fast.march` spans: the call of K3 (`proxy_march_select`: the march, the
inverse-CDF placement and the survivors' points), summed over the chunks."""
from benchmark.metrics._program import self_ms


def read(run):
    return self_ms(run, "fast.march")
