"""Benchmark sweeps producing CSVs shaped like the reference's.

Counterparts:
  * full-model sweep over M  — reference: src/benchmarking/benchmarking.jl
    (writes julia_benchmark_times.csv: columns M, Time)
  * per-part sweep           — reference: src/benchmarking/julia_bench_parts.jl
    (times the full run, evolve_psi, evolve_zeta, and the solver setup
    separately; writes julia_parts_benchmark4.csv)

Timing protocol: best-of-N wall clock of a jitted chunk, ended by
``jax.block_until_ready`` (the analog of BenchmarkTools.@belapsed minima,
reference: src/benchmarking/benchmarking.jl:34). Times are of whatever device
JAX runs on; each row names it.

Usage:
    python benchmarks/sweep.py full  --out bench_full.csv
    python benchmarks/sweep.py parts --out bench_parts.csv
"""

from __future__ import annotations

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import argparse
import csv
import functools
import time

import jax

from tpu_qg.config import ModelConfig
from tpu_qg.constants import DAY, KM, MINUTES
from tpu_qg.models.core import QGModel, _tendencies, init_state
from tpu_qg.ops.spectral import HelmholtzSolver


_sync = jax.block_until_ready


def _bench_cfg(M: int, dtype: str = "float32") -> ModelConfig:
    """The reference's benchmark configuration
    (reference: src/benchmarking/benchmarking.jl:6-26): 4000x4000 km,
    dt=60 min, T=1 model-day, r=1e-7, kick=1e-6."""
    return ModelConfig(
        M=M, P=M, Lx=4000.0 * KM, Ly=4000.0 * KM,
        dt=60.0 * MINUTES, T=1.0 * DAY, r=1e-7, initial_kick=1e-6,
        dtype=dtype,
    )


def _best_of(fn, reps: int) -> float:
    fn()  # warm / compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_full(M_list, reps: int, dtype: str, amortize: int = 500):
    """Full-model time for 1 model-day (24 steps), per M — the reference's
    headline sweep (reference: src/benchmarking/benchmarking.jl:28-41).

    The literal 24-step runs are dominated by the fixed per-dispatch cost at
    small M, so each row also reports the AMORTIZED per-step time from one
    ``amortize``-step jitted chunk and the day-equivalent derived from it."""
    rows = []
    for M in M_list:
        cfg = _bench_cfg(M, dtype)
        model = QGModel(cfg)
        state = init_state(cfg, key=jax.random.PRNGKey(0))
        steps = cfg.total_steps

        def run():
            _sync(model.run(state, steps).zeta)

        t = _best_of(run, reps)

        st2 = model.run(state, 3)        # past the Euler startup

        def run_amortized():
            _sync(model.run(st2, amortize).zeta)

        ta = _best_of(run_amortized, reps) / amortize
        rows.append({"M": M, "device": jax.devices()[0].device_kind,
                     "Time": t,
                     "Time_per_step_amortized": ta,
                     "Day_equivalent_amortized": ta * steps,
                     "gridpoint_steps_per_s": M * M / ta})
        print(f"M = {M}: {t:.6f} s literal; {ta * 1e3:.4f} ms/step "
              f"amortized ({M * M / ta:.3e} gridpoint-steps/s)")
    return rows


def sweep_parts(M_list, reps: int, dtype: str, n_inner: int = 20):
    """Per-part timings: tendency (the reference's evolve_zeta analog),
    elliptic inversion (evolve_psi analog), solver setup (Cholesky
    factorization analog), full step
    (reference: src/benchmarking/julia_bench_parts.jl:30-52).

    Each part runs ``n_inner`` times under one jitted ``lax.scan`` and the
    wall time is divided by n_inner, so the fixed per-dispatch cost does
    not swamp the small-M parts.
    """
    rows = []
    for M in M_list:
        cfg = _bench_cfg(M, dtype)
        model = QGModel(cfg)
        state = init_state(cfg, key=jax.random.PRNGKey(0))
        state = model.run(state, 3)  # past the Euler startup

        def loop(fn):
            def run(x):
                out, _ = jax.lax.scan(lambda c, _: (fn(c), None), x, None,
                                      length=n_inner)
                return out
            return jax.jit(run)

        tend_l = loop(lambda zp: (_tendencies(cfg, zp[0], zp[1]), zp[1]))

        def t_tendency():
            _sync(tend_l((state.zeta, state.psi))[0])

        poisson = HelmholtzSolver(cfg.M, cfg.P, cfg.dx, 0.0)
        helm = HelmholtzSolver(cfg.M, cfg.P, cfg.dx, cfg.S_eig)
        solve_l = loop(lambda z: helm(poisson(z)))

        def t_solve():
            _sync(solve_l(state.zeta[0]))

        def t_step():
            _sync(model.run(state, n_inner).zeta)

        t0 = time.perf_counter()
        HelmholtzSolver(cfg.M, cfg.P, cfg.dx, cfg.S_eig)
        t_setup = time.perf_counter() - t0

        row = {
            "M": M,
            "device": jax.devices()[0].device_kind,
            "tendency": _best_of(t_tendency, reps) / n_inner,
            "inversion_pair": _best_of(t_solve, reps) / n_inner,
            "step": _best_of(t_step, reps) / n_inner,
            "solver_setup": t_setup,
        }
        rows.append(row)
        print(f"M = {M}: " + "  ".join(
            f"{k}={v:.6f}s" for k, v in row.items()
            if k not in ("M", "device")))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["full", "parts"])
    parser.add_argument("--out", default=None)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--sizes", type=int, nargs="*",
                        default=[8, 16, 32, 64, 128, 256])
    args = parser.parse_args(argv)

    from tpu_qg.utils.runtime import enable_x64_if_needed, setup_compile_cache
    setup_compile_cache()
    enable_x64_if_needed(args.dtype)
    rows = (sweep_full if args.mode == "full" else sweep_parts)(
        args.sizes, args.reps, args.dtype)
    if args.out:
        with open(args.out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
