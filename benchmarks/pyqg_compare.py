"""Cross-framework comparison benchmark against pyqg (pseudospectral two-layer
QG) — the reference's Python baseline (reference: src/benchmarking/benchmarking.py).

pyqg is not part of this environment's baked-in package set; the script runs
the tpu_qg side unconditionally and the pyqg side only if importable, so the
CSV is directly comparable to the reference's python_data.csv protocol
(min-of-N wall clock of a 7-model-day run, dt=60 min, M-sweep — reference:
src/benchmarking/benchmarking.py:9-39).
"""

from __future__ import annotations

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import argparse
import csv
import time

import jax

from tpu_qg.config import ModelConfig
from tpu_qg.constants import DAY, KM, MINUTES
from tpu_qg.models.core import QGModel, init_state


def bench_tpu_qg(M: int, samples: int, dtype: str) -> float:
    cfg = ModelConfig(
        M=M, P=M, Lx=4000.0 * KM, Ly=4000.0 * KM,
        dt=60.0 * MINUTES, T=7.0 * DAY, r=1e-7, initial_kick=1e-6,
        dtype=dtype,
    )
    model = QGModel(cfg)
    state = init_state(cfg, key=jax.random.PRNGKey(0))
    steps = cfg.total_steps

    def run():
        jax.block_until_ready(model.run(state, steps))

    run()  # compile
    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_pyqg(M: int, samples: int) -> float:
    import pyqg  # noqa: F401  (optional dependency)
    YEAR = 24 * 60 * 60 * 365.0
    best = float("inf")
    for _ in range(samples):
        m = pyqg.QGModel(tmax=7.0 * DAY, twrite=10000, tavestart=5 * YEAR,
                         nx=M, dt=60.0 * MINUTES, log_level=2)
        t0 = time.perf_counter()
        m.run()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="pyqg_compare.csv")
    parser.add_argument("--samples", type=int, default=5)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--sizes", type=int, nargs="*",
                        default=[8, 16, 32, 64, 128])
    args = parser.parse_args(argv)

    try:
        import pyqg  # noqa: F401
        have_pyqg = True
    except ImportError:
        have_pyqg = False
        print("pyqg not installed — recording tpu_qg column only")

    rows = []
    for M in args.sizes:
        row = {"M": M, "tpu_qg": bench_tpu_qg(M, args.samples, args.dtype)}
        if have_pyqg:
            row["pyqg"] = bench_pyqg(M, args.samples)
        rows.append(row)
        print(row)

    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
