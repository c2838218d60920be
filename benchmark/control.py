"""Runs the float32 control of a cell's comparison on the given seeds
(harness/control.py); from the root of a checkout:

    python3 benchmark/control.py --workload ecoli2.blocks --seeds 1 2 3
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import control  # noqa: E402

if __name__ == "__main__":
    sys.exit(control.main(sys.argv[1:]))
