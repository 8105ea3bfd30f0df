"""Distributed-multigrid acceptance artifact on the virtual CPU mesh.

Acceptance of the distributed (halo-only) multigrid: the solve must match the spectral inverter to f32-roundoff at 2048^2 AND 8192^2
on (8,1) and (4,2) meshes. 2048^2 runs in CI (tests/test_multigrid.py);
8192^2 is too heavy for the suite (GBs of f32 temporaries on the 2-CPU
host), so this script runs it once and records the evidence.

  python scripts/mg_virtualmesh.py --M 8192 --meshes 8x1,4x2 --cycles 9

Writes results/mg_virtualmesh_<M>.json.
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

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as Pspec  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=8192)
    ap.add_argument("--P", type=int, default=0)
    ap.add_argument("--meshes", default="8x1,4x2")
    ap.add_argument("--cycles", type=int, default=9)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    M, P = args.M, args.P or args.M

    from tpu_qg.constants import KM
    from tpu_qg.ops.spectral import BatchedModalSolver
    from tpu_qg.parallel import make_mesh
    from tpu_qg.parallel.multigrid import DistributedMultigridSolver

    Lx = 4000.0 * KM
    dx = Lx / M
    S_eig = -1.0 / (40.0 * KM) ** 2
    rng = np.random.default_rng(6)
    f = jnp.asarray(rng.standard_normal((2, M, P)).astype(np.float32) * 1e-5)

    t0 = time.perf_counter()
    ref = np.asarray(BatchedModalSolver(M, P, dx, (0.0, S_eig))(f))
    scale = float(np.abs(ref).max())
    rec = {"M": M, "P": P, "dtype": "float32", "cycles": args.cycles,
           "ref_scale": scale,
           "ref_spectral_s": round(time.perf_counter() - t0, 1),
           "meshes": {}}
    print(f"[mg] spectral ref done ({rec['ref_spectral_s']} s), "
          f"scale {scale:.4g}", flush=True)

    for mtag in args.meshes.split(","):
        nx, ny = (int(v) for v in mtag.strip().split("x"))
        mesh = make_mesh((nx, ny))
        dist = DistributedMultigridSolver(
            M, P, dx, (0.0, S_eig), nx, ny, n_cycles=args.cycles)
        solve = jax.jit(jax.shard_map(
            dist, mesh=mesh, in_specs=(Pspec(None, "x", "y"),),
            out_specs=Pspec(None, "x", "y"), check_vma=False))
        t0 = time.perf_counter()
        got = np.asarray(solve(f))
        dt_s = time.perf_counter() - t0
        err = float(np.abs(got - ref).max())
        rec["meshes"][mtag] = {
            "nx": nx, "ny": ny,
            "dist_levels": len(dist.levels),
            "coarse": list(dist.coarse[:2]),
            "max_abs_err": err,
            "rel_err": err / scale,
            "wall_s": round(dt_s, 1),
            "pass_f32_roundoff": err <= 5e-6 * scale,
        }
        print(f"[mg] {mtag}: rel_err {err / scale:.3e} "
              f"({dt_s:.0f} s)", flush=True)
        del got, solve, dist

    out = args.out or os.path.join(REPO, "results",
                                   f"mg_virtualmesh_{M}.json")
    with open(out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"[mg] wrote {out}")


if __name__ == "__main__":
    main()
