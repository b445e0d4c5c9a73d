"""Plot a metric column of a training CSV log to an image:
`python -m nerf_siren_tpu_torch.vis_log --log metrics.csv --metric train/psnr`.

Counterpart of the JAX package's root `vis_log.py` (reference vis_log.py:5-18),
with its CLI, split in two: `read_metric` (the CSV reader, host only) and
`plot` (matplotlib, imported inside it). Works on the CSV files that
TensorBoard event consumers export, or any CSV with a header row; a row's
`step` column is its x value (else its index).
"""
from __future__ import annotations

import argparse
import csv
from typing import List, Tuple


def read_metric(log_path: str, metric: str) -> Tuple[List[float], List[float]]:
    """(steps, values) of the rows of `log_path` where `metric` is set."""
    steps, values = [], []
    with open(log_path) as f:
        reader = csv.DictReader(f)
        for i, row in enumerate(reader):
            if metric in row and row[metric] not in ("", None):
                steps.append(float(row.get("step", i)))
                values.append(float(row[metric]))
    if not values:
        raise ValueError(f"metric {metric!r} not found in {log_path}")
    return steps, values


def plot(steps: List[float], values: List[float], metric: str, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 4))
    plt.plot(steps, values)
    plt.xlabel("step")
    plt.ylabel(metric)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()


def main(log_path: str, metric: str, out_path: str):
    steps, values = read_metric(log_path, metric)
    plot(steps, values, metric, out_path)
    print(f"wrote {out_path} ({len(values)} points)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--log", type=str, required=True)
    parser.add_argument("--metric", type=str, required=True)
    parser.add_argument("--out", type=str, default="metric.jpg")
    args = parser.parse_args()
    main(args.log, args.metric, args.out)
