"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object (see portbench/README.md)."""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    from portbench.harness.core import main
    sys.exit(main(sys.argv[1:], T_START))
