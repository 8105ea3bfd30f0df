"""Long-horizon allclose validation vs the float64 reference twin.

BASELINE config 3's acceptance check: two-layer baroclinic-instability spinup
(the ``spinup-512`` preset), identical random ICs, N steps (target 10k) — the
JAX spectral-inversion path must match the twin (the reference algorithm with
factorized direct solves and pinned gauge) at rtol <= 1e-5 on zeta and on
gauge-normalized psi.

Run:  python -m tpu_qg.validation.allclose --M 512 --steps 10000
(float64 on JAX's default backend; the twin runs on the host).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

TARGET_RTOL = 1e-5


def compare(z_j, p_j, z_t, p_t) -> Tuple[float, float]:
    """(zeta error, psi error) of a JAX state against the twin's, each
    max-abs relative to the twin's max-abs. psi is compared gauge-normalized
    (zero-mean vs the twin's pinned-point constant)."""
    z_j, p_j = np.asarray(z_j, np.float64), np.asarray(p_j, np.float64)
    err_z = np.abs(z_j - z_t).max() / np.abs(z_t).max()
    p_jn = p_j - p_j.mean(axis=(1, 2), keepdims=True)
    p_tn = p_t - p_t.mean(axis=(1, 2), keepdims=True)
    err_p = np.abs(p_jn - p_tn).max() / np.abs(p_tn).max()
    return float(err_z), float(err_p)


def run_check(M: int = 512, P: Optional[int] = None, steps: int = 10000,
              check_every: int = 1000,
              log: Callable[[str], None] = print) -> Dict:
    """Run ``spinup-512`` (at M x P) on JAX's default backend and the twin
    on the host side by side; compare every ``check_every`` steps. Needs
    64-bit mode on."""
    from ..config import preset
    from ..constants import MINUTES
    from ..models.core import QGModel
    from .twin import ReferenceTwin

    P = P or M
    cfg = preset("spinup-512").replace(M=M, P=P, T=steps * 5.0 * MINUTES)
    rng = np.random.default_rng(0)
    psi0 = cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, cfg.M, cfg.P))

    twin = ReferenceTwin(cfg)
    z_t, p_t = twin.init_state(psi0)

    model = QGModel(cfg)
    state = model.init_state(psi_init=psi0)

    t0 = time.perf_counter()
    results = []
    done = 0
    while done < steps:
        chunk = min(check_every, steps - done)
        for _ in range(chunk):
            z_t, p_t = twin.step(z_t, p_t)
        state = model.run(state, chunk)
        done += chunk
        err_z, err_p = compare(state.zeta, state.psi, z_t, p_t)
        results.append({"step": done, "rel_err_zeta": err_z,
                        "rel_err_psi": err_p})
        log(f"step {done:6d}:  rel_err zeta {err_z:.3e}  psi {err_p:.3e}  "
            f"max|zeta| {np.abs(z_t).max():.3e}  "
            f"[{time.perf_counter() - t0:.0f}s]")

    final = results[-1]
    return {
        "config": f"two-layer {M}x{P}, dt=5min, {steps} steps, float64",
        "dtype": str(state.zeta.dtype),
        "rel_err_zeta": final["rel_err_zeta"],
        "rel_err_psi": final["rel_err_psi"],
        "target_rtol": TARGET_RTOL,
        "passed": bool(final["rel_err_zeta"] < TARGET_RTOL
                       and final["rel_err_psi"] < TARGET_RTOL),
        "history": results,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--M", type=int, default=512)
    parser.add_argument("--P", type=int, default=None)
    parser.add_argument("--steps", type=int, default=10000)
    parser.add_argument("--check-every", type=int, default=1000)
    parser.add_argument("--out", default=None, help="write JSON result here")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    verdict = run_check(args.M, args.P, args.steps, args.check_every,
                        log=lambda s: print(s, flush=True))
    print(json.dumps({k: v for k, v in verdict.items() if k != "history"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
    return 0 if verdict["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
