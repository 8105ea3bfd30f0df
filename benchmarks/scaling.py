"""Weak/strong scaling harness: grid-points/s per device over a device mesh.

Measures every mesh size from 1 device up to all the devices the process
sees (e.g. the four GPUs of one host). With --fake-devices N it runs the
full sweep on a virtual CPU mesh — correctness/shape validation of the
sharded path, NOT a performance measurement (noted in the output).

Weak scaling: each device keeps a constant (tile_m x tile_p) tile, the global
grid grows with the mesh. Strong scaling: the global grid is fixed.

Usage:
    python benchmarks/scaling.py weak   --tile 2048 --out scaling_weak.csv
    python benchmarks/scaling.py strong --grid 2048 --out scaling_strong.csv
    python benchmarks/scaling.py weak --fake-devices 8   # CPU-mesh dry run
"""

from __future__ import annotations

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import argparse
import csv
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["weak", "strong"])
    parser.add_argument("--tile", type=int, default=1024,
                        help="per-chip tile side for weak scaling")
    parser.add_argument("--grid", type=int, default=2048,
                        help="global grid side for strong scaling")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--impl", default="halo", choices=["halo", "gspmd"])
    parser.add_argument("--fake-devices", type=int, default=0,
                        help="run on a virtual CPU mesh of this size")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import jax

    if args.fake_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.fake_devices)

    from tpu_qg.config import ModelConfig
    from tpu_qg.constants import KM
    from tpu_qg.models.core import QGModel, init_state
    from tpu_qg.parallel import make_mesh, shard_state
    from tpu_qg.parallel.gspmd import make_sharded_run_fn
    from tpu_qg.parallel.stepper import make_halo_run_fn

    n_dev = len(jax.devices())
    mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= n_dev]

    sync = jax.block_until_ready

    rows = []
    base_gps_per_chip = None
    for n in mesh_sizes:
        mesh = make_mesh(devices=jax.devices()[:n])
        mx, my = mesh.devices.shape
        if args.mode == "weak":
            M, P = args.tile * mx, args.tile * my
        else:
            M, P = args.grid, args.grid
        # Distributed-FFT divisibility: M/mx % my == 0 and P % (mx*my) == 0.
        if (M // mx) % my or P % (mx * my):
            print(f"n={n}: mesh {mx}x{my} incompatible with grid {M}x{P}, skipped")
            continue

        cfg = ModelConfig(M=M, P=P, Lx=4000.0 * KM, Ly=4000.0 * KM,
                          dt=60.0, T=3600.0, dtype="float32")
        if n == 1:
            model = QGModel(cfg)
            run = lambda s, k: model.run(s, k)  # noqa: E731
            state = init_state(cfg, key=jax.random.PRNGKey(0))
        else:
            run = (make_halo_run_fn(cfg, mesh) if args.impl == "halo"
                   else make_sharded_run_fn(cfg, mesh))
            state = shard_state(init_state(cfg, key=jax.random.PRNGKey(0)),
                                mesh)

        state = run(state, args.steps)
        sync(state)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            state = run(state, args.steps)
            sync(state)
            best = min(best, time.perf_counter() - t0)
        gps = M * P * args.steps / best
        gps_chip = gps / n
        if base_gps_per_chip is None:
            base_gps_per_chip = gps_chip
        eff = gps_chip / base_gps_per_chip
        rows.append({"devices": n, "mesh": f"{mx}x{my}", "M": M, "P": P,
                     "gridpoint_steps_per_s": gps,
                     "per_chip": gps_chip, "efficiency": eff})
        note = " (VIRTUAL CPU MESH — not a perf number)" if args.fake_devices else ""
        print(f"n={n} ({mx}x{my}) {M}x{P}: {gps:.3e} gps, "
              f"{gps_chip:.3e}/chip, eff {eff:.2f}{note}")

    if args.out and rows:
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
