"""batch_prep_ms.train: host ms a group of steps spends in the train CLI's
epoch loop before its dispatch: `epoch_iterator`'s batches and their
`np.stack` (the harness's `batch_prep` span), mean over the window."""
from benchmark.metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "batch_prep")
