"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root.  Needs an NVIDIA card (exits 2 without one);
puts ``src/`` on the path itself and measures ``repro_torch`` only.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    # the repository root, not this folder, heads the path: no module here
    # shadows a library's
    sys.path[0] = str(root)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
