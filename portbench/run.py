"""Run one cell of BENCHMARK.json once on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output; exits non-zero, printing no result, where no card is present."""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.harness import main
    sys.exit(main())
