"""Record a small trace of one cell on the GPU, for the CPU tests of the
trace reduction: the cell at a small grid with short intervals, traced,
through the harness's own run. Writes ``<out>.xplane.pb`` and, beside it,
``<out>.json`` with what ``qgbench.xplane.summarize`` read from it then.

    python3 qgbench/tests/record_trace.py --workload turbulence-2048.daily \
        --M 256 --interval 600 --out qgbench/tests/data/turbulence-256
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--M", type=int, required=True)
    ap.add_argument("--interval", type=float, required=True,
                    help="sample interval in model seconds")
    ap.add_argument("--trace-intervals", type=int, default=2)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from qgbench import harness, xplane

    out = pathlib.Path(args.out)
    cell = harness.load_cell(args.workload, ROOT)
    result = harness.run_cell(
        cell, 1, 0.5, True, time.perf_counter(),
        overrides={"model": {"M": args.M, "P": args.M},
                   "traffic": {"sample_interval_s": args.interval,
                               "trace_intervals": args.trace_intervals}},
        keep_trace=out.with_suffix(".xplane.pb"))
    summary = xplane.summarize(xplane.load(str(out.with_suffix(
        ".xplane.pb"))))
    summary.pop("ops")
    for d in summary["devices"].values():
        d.pop("ops")
    out.with_suffix(".json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
