"""Trajectory-accuracy evidence for the multigrid cycle count (round 5).

The multigrid route costs about (tendency + C * V-cycle) per step, so the
cycle count C sets its speed. The solve error at C warm-started cycles is
rho^C x (per-step psi change) — a systematic lag, not noise — so the
right evidence is conserved-quantity drift against the spectral route
over a long f32 run.

Runs the two-layer model at --M for --steps with elliptic_impl=multigrid
at each --cycles value on the (1,1)-mesh halo path (same code path as the
pod route), records per-step zeta error vs the spectral trajectory and
energy/enstrophy drift, writes results/mg_accuracy_<M>_<steps>.json. Runs on
JAX's default backend (JAX_PLATFORMS=cpu for the CPU).

  python scripts/mg_accuracy.py --M 256 --steps 5000 --cycles 1,2,4
"""

import argparse
import json
import os
import sys
import time

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(_SCRIPTS)
for _p in (REPO, _SCRIPTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import jax.numpy as jnp
import numpy as np


def energy_enstrophy(cfg, state):
    from tpu_qg.utils.diagnostics import diagnostics
    d = diagnostics(cfg, state)
    ke = d.get("ke_1", 0.0) + d.get("ke_2", 0.0)
    ens = float(jnp.mean(state.zeta.astype(jnp.float64) ** 2))
    return float(ke), ens


def run_traj(cfg, psi0, steps, sample, mesh=None):
    from tpu_qg.models.core import init_state
    from tpu_qg.parallel import make_mesh, shard_state
    from tpu_qg.parallel.stepper import make_halo_run_fn

    if mesh is None:
        mesh = make_mesh((1, 1))
    # The scanned run fn (not the single-step fn): the multigrid route's
    # extrapolated warm start lives in the scan carry.
    run = make_halo_run_fn(cfg, mesh)
    s = shard_state(init_state(cfg, psi_init=psi0), mesh)
    out = []
    for k in range(steps // sample):
        s = run(s, sample)
        out.append((np.asarray(s.zeta), energy_enstrophy(cfg, s)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--sample", type=int, default=500)
    ap.add_argument("--cycles", default="1,2,4")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    M = args.M

    from tpu_qg.config import ModelConfig
    from tpu_qg.constants import KM, MINUTES, YEAR

    base = dict(
        H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11, Lx=4000.0 * KM,
        Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
        M=M, P=M, visc=100.0, r=1e-7, R_d=40.0 * KM,
        initial_kick=1e-6, dtype=args.dtype)
    cfg_sp = ModelConfig(**base)
    rng = np.random.default_rng(5)
    psi0 = (cfg_sp.initial_kick * cfg_sp.U * cfg_sp.Ly
            * rng.random((2, M, M)))

    t0 = time.perf_counter()
    ref = run_traj(cfg_sp, psi0, args.steps, args.sample)
    print(f"[mgacc] spectral ref done ({time.perf_counter()-t0:.0f} s)",
          flush=True)

    rec = {"M": M, "steps": args.steps, "sample": args.sample,
           "dtype": args.dtype, "variants": {}}
    for c in (int(v) for v in args.cycles.split(",")):
        cfg = ModelConfig(**base, elliptic_impl="multigrid", mg_cycles=c,
                          mg_extrapolate=not args.no_extrapolate)
        t0 = time.perf_counter()
        got = run_traj(cfg, psi0, args.steps, args.sample)
        rows = []
        for (zg, (keg, eng)), (zr, (ker, enr)) in zip(got, ref):
            scale = float(np.abs(zr).max())
            rows.append({
                "zeta_rel_err": float(np.abs(zg - zr).max()) / scale,
                "energy_rel_diff": abs(keg - ker) / max(abs(ker), 1e-300),
                "enstrophy_rel_diff": abs(eng - enr) / max(abs(enr),
                                                           1e-300),
            })
        tag = (f"mg_cycles={c}" if not args.no_extrapolate
               else f"mg_cycles={c}_noextrap")
        rec["variants"][tag] = {
            "wall_s": round(time.perf_counter() - t0, 1),
            "final": rows[-1], "trace": rows}
        print(f"[mgacc] cycles={c}: final {rows[-1]}", flush=True)

    out = args.out or os.path.join(
        REPO, "results", f"mg_accuracy_{M}_{args.steps}.json")
    with open(out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"[mgacc] wrote {out}")


if __name__ == "__main__":
    main()
