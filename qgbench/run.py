"""Run one benchmark cell once and print its result line.

    python3 qgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` and ``device`` (and, with
``--trace 1``, ``breakdown``), and last in it ``checks``: each number the
check compared, with its limit. The same numbers are the last lines of
standard error. Exits non-zero, printing no result, when JAX finds no GPU
or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)     # the checkout, not qgbench/, heads the path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from qgbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except harness.NoDevice as e:
        print(f"qgbench: {e}", file=sys.stderr)
        return 2
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
