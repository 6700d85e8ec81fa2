"""The benchmark of the PyTorch and CUDA port on one H100: one run of one
cell.

    python3 portbench/run.py --workload granite-3-2b.prefill-split \
        --seed 1234 --seconds 45 --trace 0

Run from the root of a checkout; ``harness/main.py`` says what a run does.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
