#!/usr/bin/env python3
"""The benchmark of ``softx_2020_200_tpu_torch`` on one NVIDIA GPU.

    python3 benchmark/run.py --workload tgv_re1600_q1.n96 --seed 7 \\
        --seconds 30 --trace 0

Runs one cell of ``BENCHMARK.json`` (``benchmark/workloads/<name>.json``
over ``benchmark/configs/<config>.json``) from the root of a checkout:
set-up, a window of ``--seconds``, the check against the plain float64
reference, and one JSON line last on standard output with ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones from a profiled window), ``device``
and, last, ``checks`` (each compared number with its limit, which also
end standard error).  Without CUDA, or with fewer devices than the cell
asks for, it prints no result and exits with 2.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from benchmark import harness
    try:
        result = harness.execute(args.workload, args.seed, args.seconds,
                                 bool(args.trace), T_PROCESS, ROOT)
    except SystemExit as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
