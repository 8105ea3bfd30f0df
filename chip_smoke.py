#!/usr/bin/env python
"""On-card smoke test of the QG solver: the main path on one NVIDIA GPU,
through the entry points a user calls, at full width, checked against the
repository's references.

Phases (one process; each prints one JSON line with its name, ``ok``, its
numbers and its tolerance):

  device          every JAX device is a GPU; JAX version, device kind, and
                  the card's name and power limit from nvidia-smi
  main_path       ``tpu_qg.run.main``: turbulence-2048 (2048^2, two layers,
                  float32) for one model day with snapshots and a
                  checkpoint, resumed to two days and compared with an
                  uninterrupted two-day run; then the reference's
                  ``production`` preset (512x256) for 300 steps
  accuracy_f32    10 steps at 2048^2 in float32 vs float64 on the card from
                  one initial condition, and the float32 run again under
                  matmul precision "highest" (must be bitwise identical)
  f64_acceptance  spinup-512 in float64 for 200 steps vs the float64
                  reference twin on the host (BASELINE config 3's rule)
  multigrid       MultigridModalInverter (10 cold cycles) vs the spectral
                  PackedModalInverter at 2048^2 float32
  timing          median of 5 chunks of 500 steps at 2048^2 float32: the
                  whole step, the tendency + time update alone, and the
                  inversion alone

``--four-cards`` runs only the path across four cards and what it is
compared with: pod-8192 through ``run_model(mesh=...)`` vs ``QGModel`` on
card 0; pod-8192-mg on four cards vs a (1, 1) mesh on card 0; the GSPMD
sharded step vs the single-card step. Each pair runs in float32 and in
float64 from the same initial data: float64 shows the decomposition exact
to roundoff, float32 that the sharded run is no worse than one card's own
float32 error. It prints the mesh shape, memory in use on each card and
ms/step on the mesh and on one card.

The last line of standard output is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``. The exit code is 0
only when every phase passed. Without a GPU the run stops after the device
phase with ``"ok": false`` and a non-zero exit code; nothing falls back to
the CPU.

    python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import shutil
import sys
import tempfile
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

# Bounds, each with its reason.
# Resume: the resumed run replays the same compiled chunks, so it should be
# bitwise; a separately compiled program may round differently in the last
# bits, which is allowed up to this relative difference.
RESUME_RTOL = 1e-6
# float32 vs float64 after 10 steps: f32 roundoff in the stencils (zeta),
# amplified in psi by the 1/lambda_min of the Poisson symbol.
F32_ZETA_TOL, F32_PSI_TOL = 1e-5, 1e-4
# Multigrid after 10 cold V-cycles vs the spectral inverse: f32 roundoff of
# the converged iteration (the bound of tests/test_multigrid.py at 2048^2).
MG_TOL = 5e-6
# Sharded vs one-card trajectories. In float64 the two agree to roundoff
# amplified by 1/lambda_min (about 1e-12 at 8192^2), so any error of the
# decomposition shows far above this bound.
SHARD_F64_TOL = 1e-9
# In float32 that amplification sets a floor that grows as M^2 (the
# one-card run's own error vs float64 is about 1e-4 in psi at 2048^2): the
# sharded float32 run, measured against the float64 one-card run, may be at
# most this factor worse than the one-card float32 run is.
SHARD_F32_FACTOR = 2.0


def rel_err(got, want) -> float:
    """max|got - want| / max|want|, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close(got, want, tol: float) -> dict:
    e = rel_err(got, want)
    return {"rel_err": e, "tol": tol, "ok": bool(e <= tol)}


def compare_resume(resumed, straight) -> dict:
    """Resumed vs uninterrupted final state: bitwise, or within
    RESUME_RTOL with the reason recorded."""
    names = ("zeta", "psi", "f1", "f2")
    bitwise = all(np.array_equal(np.asarray(getattr(resumed, n)),
                                 np.asarray(getattr(straight, n)))
                  for n in names)
    steps_match = int(resumed.step) == int(straight.step)
    rec = {"bitwise": bitwise, "steps": [int(resumed.step),
                                         int(straight.step)]}
    if bitwise:
        rec["ok"] = steps_match
        return rec
    rel = max(rel_err(getattr(resumed, n), getattr(straight, n))
              for n in names)
    rec.update(max_rel=rel, tol=RESUME_RTOL,
               ok=bool(steps_match and rel <= RESUME_RTOL),
               why=("not bitwise: the resumed process compiled its step "
                    "program anew, and a different fusion or FFT plan "
                    "rounds differently in the last bits"))
    return rec


def check_state(cfg, state) -> dict:
    """Finite fields and CFL < 1."""
    from tpu_qg.utils.diagnostics import diagnostics
    d = diagnostics(cfg, state)
    finite = all(bool(np.isfinite(np.asarray(x)).all())
                 for x in (state.zeta, state.psi))
    return {"finite": finite, "cfl": d["cfl"], "cfl_max": 1.0,
            "ok": bool(finite and d["cfl"] < 1.0)}


def check_run_dir(run_dir: pathlib.Path) -> dict:
    """Snapshots, checkpoints and metadata.json exist."""
    snaps = sorted(p.name for p in run_dir.glob("snap_*.npz"))
    ckpts = sorted(p.name for p in run_dir.glob("checkpoint_*.npz"))
    meta = (run_dir / "metadata.json").exists()
    return {"snapshots": snaps, "checkpoints": ckpts, "metadata": meta,
            "ok": bool(snaps and ckpts and meta)}


def check_quarters(bytes_in_use, state_bytes: int) -> dict:
    """Each card holds about 1/n of the sharded state, and the first card
    holds no more than the others (no unsharded copy left behind)."""
    n = len(bytes_in_use)
    share = state_bytes / n
    slack = 256 * 2 ** 20        # compiled constants, keys, scalars
    each = all(0.9 * share <= b <= 1.5 * share + slack
               for b in bytes_in_use)
    first = bytes_in_use[0] <= 1.5 * max(bytes_in_use[1:]) + slack
    return {"bytes_in_use": list(bytes_in_use), "state_bytes": state_bytes,
            "share": share, "ok": bool(each and first)}


@contextlib.contextmanager
def x64():
    """64-bit mode for the float64 phases only; the others run as a float32
    user's process does."""
    import jax
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


# --------------------------------------------------------------------------
# Phases. Sizes are arguments so the tests can run each at a toy size.


def phase_device(n_cards: int) -> dict:
    import jax
    from tpu_qg.utils.runtime import device_report, gpu_name_and_power_limit
    devs = jax.devices()
    rec = {"jax": jax.__version__, **device_report(),
           "platforms": sorted({d.platform for d in devs}),
           "cards_needed": n_cards}
    if rec["platforms"] != ["gpu"] or len(devs) < n_cards:
        rec["ok"] = False
        return rec
    rec["nvidia_smi"] = gpu_name_and_power_limit().splitlines()
    rec["ok"] = True
    return rec


def phase_main_path(workdir: pathlib.Path, steps: int = 1440,
                    overrides=(), production_steps: int = 300,
                    production_overrides=()) -> dict:
    """turbulence-2048 for ``steps`` (one model day at dt = 60 s) with a
    checkpoint, resumed to 2 * steps, vs an uninterrupted 2 * steps run;
    then production for ``production_steps`` with no output."""
    from tpu_qg.config import preset
    from tpu_qg.run import apply_overrides, main as run_main

    sets = ["--set", *overrides] if overrides else []
    run_dir = workdir / "turbulence-2048"
    common = ["--preset", "turbulence-2048", *sets]
    run_main([*common, "--run-dir", str(run_dir), "--steps", str(steps),
              "--checkpoint-every", str(steps)])
    resumed = run_main([*common, "--run-dir", str(run_dir), "--resume",
                        "--steps", str(2 * steps),
                        "--checkpoint-every", str(steps)])
    straight = run_main([*common, "--steps", str(2 * steps), "--no-save"])

    cfg = apply_overrides(preset("turbulence-2048"), overrides)
    rec = {"resume": compare_resume(resumed, straight),
           "state": check_state(cfg, resumed),
           "files": check_run_dir(run_dir)}

    psets = (["--set", *production_overrides]
             if production_overrides else [])
    prod = run_main(["--preset", "production", *psets, "--steps",
                     str(production_steps), "--no-save"])
    pcfg = apply_overrides(preset("production"), production_overrides)
    rec["production"] = {"steps": int(prod.step), **check_state(pcfg, prod)}
    rec["production"]["ok"] = bool(rec["production"]["ok"]
                                   and int(prod.step) == production_steps)
    rec["ok"] = all(rec[k]["ok"] for k in
                    ("resume", "state", "files", "production"))
    return rec


def phase_accuracy_f32(M: int = 2048, steps: int = 10) -> dict:
    """float32 vs float64 on the card from the same initial data; then the
    float32 run under matmul precision "highest", which must be bitwise
    the default run (no TF32 contraction on the path)."""
    import jax
    import jax.numpy as jnp
    from tpu_qg.config import preset
    from tpu_qg.models.core import QGModel, State, init_state

    with x64():
        cfg32 = preset("turbulence-2048").replace(M=M, P=M)
        cfg64 = cfg32.replace(dtype="float64")
        s32 = init_state(cfg32, key=jax.random.PRNGKey(0))
        s64 = State(*(jnp.asarray(x, jnp.float64) for x in s32[:4]),
                    s32.step)
        out32 = QGModel(cfg32).run(s32, steps)
        out64 = QGModel(cfg64).run(s64, steps)
        with jax.default_matmul_precision("highest"):
            out_hi = QGModel(cfg32).run(s32, steps)
        zeta = close(out32.zeta, out64.zeta, F32_ZETA_TOL)
        psi = close(out32.psi, out64.psi, F32_PSI_TOL)
        bitwise = all(np.array_equal(np.asarray(getattr(out32, n)),
                                     np.asarray(getattr(out_hi, n)))
                      for n in ("zeta", "psi", "f1", "f2"))
    return {"M": M, "steps": steps, "dtypes": [str(out32.zeta.dtype),
                                               str(out64.zeta.dtype)],
            "zeta": zeta, "psi": psi,
            "highest_precision_bitwise": bitwise,
            "ok": bool(zeta["ok"] and psi["ok"] and bitwise
                       and out64.zeta.dtype == jnp.float64)}


def phase_f64_acceptance(M: int = 512, steps: int = 200) -> dict:
    from tpu_qg.validation.allclose import run_check

    with x64():
        v = run_check(M=M, steps=steps, check_every=steps, log=lambda s: None)
    return {"M": M, "steps": steps, "dtype": v["dtype"],
            "rel_err_zeta": v["rel_err_zeta"],
            "rel_err_psi": v["rel_err_psi"], "tol": v["target_rtol"],
            "ok": bool(v["passed"] and v["dtype"] == "float64")}


def phase_multigrid(M: int = 2048, cycles: int = 10) -> dict:
    import jax
    import jax.numpy as jnp
    from tpu_qg.config import preset
    from tpu_qg.models.core import _build_packed_inverter
    from tpu_qg.ops.multigrid import MultigridModalInverter

    cfg = preset("turbulence-2048").replace(M=M, P=M)
    rng = np.random.default_rng(6)
    zeta = jnp.asarray(rng.standard_normal((2, M, M)).astype(np.float32)
                       * 1e-5)
    ref = jax.jit(_build_packed_inverter(cfg))(zeta)
    mg = MultigridModalInverter(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                cfg.P_inv_matrix(),
                                cfg.back_projection_matrix(),
                                n_cycles=cycles)
    got = jax.jit(mg)(zeta)
    return {"M": M, "cycles": cycles, **close(got, ref, MG_TOL)}


def phase_timing(M: int = 2048, steps: int = 500, reps: int = 5) -> dict:
    import jax
    from tpu_qg.config import preset
    from tpu_qg.models.core import QGModel, _build_packed_inverter, init_state
    from tpu_qg.utils.profiling import (inversion_chunk, median_call_seconds,
                                        tendency_update_chunk)

    cfg = preset("turbulence-2048").replace(M=M, P=M)
    model = QGModel(cfg)
    state = model.run(init_state(cfg, key=jax.random.PRNGKey(0)), 3)
    parts = {
        "step": (lambda s: model.run(s, steps), state),
        "tendency_update": (tendency_update_chunk(cfg, steps), state),
        "inversion": (inversion_chunk(_build_packed_inverter(cfg), steps),
                      (state.zeta, state.psi)),
    }
    rec = {"M": M, "steps_per_chunk": steps, "chunks": reps}
    finite = True
    for name, (fn, x0) in parts.items():
        sec, out = median_call_seconds(fn, x0, reps)
        leaf = jax.tree_util.tree_leaves(out)[0]
        finite = finite and bool(np.isfinite(np.asarray(leaf)).all())
        rec[name] = {"ms_per_step": 1e3 * sec / steps,
                     "gridpoint_steps_per_s": M * M * steps / sec}
    rec["finite"] = finite
    rec["ok"] = finite
    return rec


def _sharded_vs(cfg, devices, steps: int, parallel: str, reference: str
                ) -> dict:
    """``steps`` of ``cfg`` through run_model over the default mesh of
    ``devices``, vs the same steps on ``devices[0]`` alone: QGModel
    (reference="model") or a (1, 1) mesh through the same run function
    (reference="mesh11"). Both sides run once in float32 (the preset) and
    once in float64 from the same initial data."""
    import jax
    import jax.numpy as jnp
    from tpu_qg.models.core import QGModel, State, init_state
    from tpu_qg.parallel import make_mesh
    from tpu_qg.parallel.gspmd import make_sharded_run_fn
    from tpu_qg.parallel.stepper import make_halo_run_fn
    from tpu_qg.run import run_model
    from tpu_qg.utils.profiling import median_call_seconds

    mesh = make_mesh(devices=devices, cfg=cfg)
    mesh11 = make_mesh((1, 1), devices=devices[:1])

    def initial(dtype):
        s = init_state(cfg, key=jax.random.PRNGKey(cfg.seed))
        return State(*(jnp.array(x, dtype) for x in s[:4]),
                     jnp.array(s.step))

    def one_card(c):
        if reference == "model":
            return QGModel(c).run(initial(c.dtype), steps)
        return run_model(c, save_results=False, n_steps=steps,
                         verbose=False, mesh=mesh11, parallel_impl=parallel,
                         state=initial(c.dtype))

    out32 = run_model(cfg, save_results=False, n_steps=steps, verbose=False,
                      mesh=mesh, parallel_impl=parallel)
    rec = {"mesh": list(mesh.devices.shape), "steps": steps}
    if devices[0].platform == "gpu":
        state_bytes = sum(x.nbytes for x in out32[:4])
        rec["memory"] = check_quarters(
            [d.memory_stats()["bytes_in_use"] for d in devices], state_bytes)
    ref32 = one_card(cfg)
    with x64():
        cfg64 = cfg.replace(dtype="float64")
        out64 = run_model(cfg64, save_results=False, n_steps=steps,
                          verbose=False, mesh=mesh, parallel_impl=parallel,
                          state=initial("float64"))
        ref64 = one_card(cfg64)
    fields = ("zeta", "psi")
    rec["f64"] = {f: close(getattr(out64, f), getattr(ref64, f),
                           SHARD_F64_TOL) for f in fields}
    rec["f32"] = {}
    for f in fields:
        floor = rel_err(getattr(ref32, f), getattr(ref64, f))
        e = rel_err(getattr(out32, f), getattr(ref64, f))
        rec["f32"][f] = {
            "rel_err_vs_f64": e, "one_card_rel_err_vs_f64": floor,
            "tol": SHARD_F32_FACTOR * floor,
            "pairwise_f32": rel_err(getattr(out32, f), getattr(ref32, f)),
            "ok": bool(e <= SHARD_F32_FACTOR * floor)}
    rec["ok"] = bool(all(rec["f64"][f]["ok"] and rec["f32"][f]["ok"]
                         for f in fields)
                     and rec.get("memory", {"ok": True})["ok"]
                     and int(out32.step) == int(out64.step) == steps)
    del out64, ref64

    # Steady-state time of both sides in float32 (the mesh run donates its
    # state).
    make_run = make_halo_run_fn if parallel == "halo" else make_sharded_run_fn
    run = make_run(cfg, mesh)
    sec, _ = median_call_seconds(lambda s: run(s, steps), out32, 3)
    if reference == "model":
        model = QGModel(cfg)
        sec1, _ = median_call_seconds(lambda s: model.run(s, steps), ref32, 3)
    else:
        run1 = make_run(cfg, mesh11)
        sec1, _ = median_call_seconds(lambda s: run1(s, steps), ref32, 3)
    rec["ms_per_step"] = {"mesh": 1e3 * sec / steps,
                          "one_card": 1e3 * sec1 / steps}
    return rec


def phase_pod_spectral(devices, steps: int = 20, overrides=None) -> dict:
    from tpu_qg.config import preset
    cfg = preset("pod-8192").replace(**(overrides or {}))
    return _sharded_vs(cfg, devices, steps, "halo", "model")


def phase_pod_multigrid(devices, steps: int = 20, overrides=None) -> dict:
    from tpu_qg.config import preset
    cfg = preset("pod-8192-mg").replace(**(overrides or {}))
    return _sharded_vs(cfg, devices, steps, "halo", "mesh11")


def phase_pod_gspmd(devices, steps: int = 2, overrides=None) -> dict:
    from tpu_qg.config import preset
    cfg = preset("pod-8192").replace(**(overrides or {}))
    return _sharded_vs(cfg, devices, steps, "gspmd", "model")


# --------------------------------------------------------------------------


def run_phase(name: str, fn, *args, **kwargs) -> dict:
    """Run one phase and print its JSON line. An exception fails the phase
    (and so the run); it is recorded, not hidden."""
    try:
        rec = fn(*args, **kwargs)
    except Exception as e:   # noqa: BLE001 — reported as a failed phase
        rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc().splitlines()[-8:]}
    rec = {"phase": name, **rec}
    print(json.dumps(rec, default=str), flush=True)
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card path and its references")
    args = parser.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    import jax
    from tpu_qg.utils.runtime import device_report, setup_compile_cache

    setup_compile_cache()
    dev = run_phase("device", phase_device, n_cards)
    recs = [dev]
    if dev["ok"]:
        if args.four_cards:
            devices = jax.devices()[:4]
            recs += [run_phase("pod-8192", phase_pod_spectral, devices),
                     run_phase("pod-8192-mg", phase_pod_multigrid, devices),
                     run_phase("gspmd", phase_pod_gspmd, devices)]
        else:
            runs = REPO / "runs"
            runs.mkdir(exist_ok=True)
            workdir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_",
                                                    dir=runs))
            try:
                recs.append(run_phase("main_path", phase_main_path, workdir))
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            recs += [run_phase("accuracy_f32", phase_accuracy_f32),
                     run_phase("f64_acceptance", phase_f64_acceptance),
                     run_phase("multigrid", phase_multigrid),
                     run_phase("timing", phase_timing)]
        for line in dev["nvidia_smi"]:
            print(f"card: {line}", flush=True)
    ok = all(r["ok"] for r in recs)
    print(json.dumps({"ok": ok, "device": device_report()}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
