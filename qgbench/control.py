"""The control for the check that decides ``correct``: the plain reference,
computed in bfloat16 (the precision below the configurations' float32),
put in the program's place. It must come out not correct.

Drives whole runs of a cell, one per seed in one process (so that the
programs compile once), each with a short window at the cell's own size
and load; the reference in bfloat16 then stands in for what the timed
path produced. Prints each seed's numbers beside their limits, one JSON
line per seed. Not part of the benchmark's own runs.

    python3 qgbench/control.py --workload <name> --seeds 11 12 13 --seconds 3
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def bfloat16_reference(ph, start: dict, steps: int) -> dict:
    """The reference's interval from the program's start state, with every
    field held in bfloat16."""
    import jax
    import jax.numpy as jnp

    from qgbench import reference as ref
    s0 = ref.from_host([start[k] for k in ("zeta", "psi", "f1", "f2")],
                       int(start["step"]), jnp.bfloat16, jax.devices()[0])
    out = ref.run(ph, s0, steps)
    return dict(zip(("zeta", "psi", "f1", "f2", "step"), out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from qgbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    refused = True
    for seed in args.seeds:
        t = time.perf_counter()
        try:
            result = harness.run_cell(cell, seed, args.seconds, False, t,
                                      substitute=bfloat16_reference)
        except harness.NoDevice as e:
            print(f"qgbench: {e}", file=sys.stderr)
            return 2
        refused = refused and not result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    print(json.dumps({"control_refused_on_every_seed": refused}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
