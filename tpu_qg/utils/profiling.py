"""Profiling / tracing hooks.

The reference's tracing is ad-hoc ``@time`` macros (reference:
src/run_model.jl:61-62,124) and BenchmarkTools sweeps. Here:

  * ``trace(...)``       — context manager wrapping ``jax.profiler`` to write a
    TensorBoard-loadable XPlane trace of the wrapped region.
  * ``Timer``            — wall-clock section timer that waits for the
    section's result (``jax.block_until_ready``) before stopping the clock.
  * ``median_call_seconds`` — steady-state time of a jitted chunk.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed region (view with
    TensorBoard's profile plugin or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Named wall-clock sections with forced completion."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f"{k:>24s}: {v:.4f} s ({100 * v / total:5.1f}%)"
                 for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)


def median_call_seconds(run, x, reps: int):
    """Median wall time of ``reps`` calls ``x = run(x)`` after one warm-up
    call (which compiles). Each timed call ends in ``jax.block_until_ready``,
    so the clock sees the device finish, not the enqueue. Returns
    (median seconds, final x)."""
    x = jax.block_until_ready(run(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x = jax.block_until_ready(run(x))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), x


def tendency_update_chunk(cfg, n_steps: int):
    """Jitted ``state -> state`` running ``n_steps`` of the tendency and the
    time update alone, with psi held (no inversion). The carry passes
    through ``lax.optimization_barrier`` each step so that XLA cannot hoist
    the psi stencils out of the loop as loop-invariant."""
    from ..models.core import State, _tendencies, scheme_update

    def body(s, _):
        s = jax.lax.optimization_barrier(s)
        tend = _tendencies(cfg, s.zeta, s.psi)
        zeta, f1, f2 = scheme_update(cfg, s.zeta, s.f1, s.f2, s.step, tend)
        return State(zeta, s.psi, f1, f2, s.step + 1), None

    return jax.jit(lambda s: jax.lax.scan(body, s, None, length=n_steps)[0])


def inversion_chunk(inverter, n_steps: int):
    """Jitted ``(zeta, psi) -> (zeta, psi)`` running ``n_steps`` inversions
    psi = inverter(zeta) alone. The barrier makes each iteration's zeta
    depend on the previous psi, so the inversion is not hoisted out of the
    loop; the values are those of one plain inversion."""
    def body(c, _):
        zeta, _psi = jax.lax.optimization_barrier(c)
        return (zeta, inverter(zeta)), None

    return jax.jit(lambda c: jax.lax.scan(body, c, None, length=n_steps)[0])
