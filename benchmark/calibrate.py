"""Readings for a cell's correctness limits: the program's numbers on many
seeds, the control's (the reference at the precision below the
configuration's, in the program's place) and those of a planted fault.

    python benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control] [--fault frozen_state|half_batch|altered_answer]
        [--seconds S]

Each seed runs the cell's set-up and check as a run does (with a window of
S seconds, default 0 for training; a frame cell needs enough frames for its
check) in this one process, and prints one JSON line of its readings. A
limit is set between the largest sound reading and the smallest control or
fault reading (benchmark/README.md). Needs a card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    side = "control" if args.control else (args.fault or "program")
    for seed in args.seeds:
        t0 = time.time()
        if args.control:
            workload, config = harness.load_cell(args.workload)
            run = harness.Run(workload, config, seed, args.seconds, False, device, t0)
            readings = harness.driver_module(workload["driver"]).control(run)
        else:
            fault = faults.FAULTS[args.fault]() if args.fault else _nothing()
            with fault:
                run = harness.run_cell(args.workload, seed, args.seconds, False, device)
            readings = {n: v for n, v, _ in run.checks}
            readings.update({k[6:]: v for k, v in run.readings.items() if k.startswith("check.")})
        print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                          "readings": readings, "s": round(time.time() - t0, 1)}), flush=True)
        torch.cuda.empty_cache()
    return 0


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


if __name__ == "__main__":
    sys.exit(main())
