"""``python -m reid_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``"""

import time

T0 = time.time()  # set-up counts from here, before torch is imported

import sys  # noqa: E402

from reid_bench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
