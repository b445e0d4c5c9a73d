"""Run one cell of the PyTorch port's benchmark.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see benchmark/README.md.
"""
import sys
from pathlib import Path

# the checkout's root, so that `benchmark` and the port import as packages
sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
