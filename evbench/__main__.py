"""python -m evbench --workload <name> --seed <n> --seconds <s> --trace <0|1>"""

import time

# set-up is timed from here: the imports below (torch, the port) count in it
T0 = time.perf_counter()

import sys  # noqa: E402

from evbench.run import main  # noqa: E402

sys.exit(main(t0=T0))
