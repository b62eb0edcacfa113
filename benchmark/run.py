"""The benchmark's command: one run of one cell (`benchmark/harness.py`).

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
