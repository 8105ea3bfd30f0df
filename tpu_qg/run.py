"""Run driver + CLI.

Counterpart of the reference's driver layer (reference: src/run_model.jl:55-95
``run_model`` and src/run_model_no_output.jl:3-16 ``run_model_no_output``), with
the gaps the reference leaves filled: resume-from-checkpoint, structured
diagnostics, named config presets instead of hard-coded constants
(reference: src/run_model.jl:97-124).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import jax
import numpy as np

from .config import ModelConfig, preset
from .constants import DAY
from .io import RunReader, RunWriter
from .models.core import QGModel, State
from .utils.diagnostics import diagnostics


def log_model_params(cfg: ModelConfig) -> None:
    """(reference: src/run_model.jl:22-39)."""
    print("Parameters:")
    print(f"Lx = {cfg.Lx}")
    print(f"Ly = {cfg.Ly}")
    print(f"(f_0^2 / N^2): {cfg.ratio_term}")
    print(f"S1 = {cfg.S1_plus}")
    print(f"S2 = {cfg.S2_minus}")
    print(f"Beta_1 = {cfg.beta_1}")
    print(f"Beta_2 = {cfg.beta_2}")
    print(f"M = {cfg.M}")
    print(f"P = {cfg.P}")
    print(f"dt = {cfg.dt}")
    print(f"T = {cfg.T}")
    print(f"U = {cfg.U}")
    print(f"Initial kick = {cfg.initial_kick}")
    print(f"Total steps = {cfg.total_steps}\n")


def run_model(
    cfg: ModelConfig,
    run_dir: Optional[str] = None,
    save_results: bool = True,
    n_steps: Optional[int] = None,
    sample_interval: float = 1.0 * DAY,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    verbose: bool = True,
    state: Optional[State] = None,
    mesh=None,
    parallel_impl: str = "halo",
    checkpoint_mode: str = "auto",
):
    """Run the simulation, optionally streaming snapshots/checkpoints.

    With ``mesh`` set, the grid is domain-decomposed over the device mesh
    (``parallel_impl``: "halo" = shard_map ppermute + distributed FFT,
    "gspmd" = XLA-partitioned global arrays).

    ``checkpoint_mode``: "gathered" writes single-file snapshots and
    checkpoints through process 0 (the reference's single-writer shape,
    src/run_model.jl:86-91); "sharded" writes per-process shard files with
    no full-grid gather (tpu_qg.io sharded scheme); "auto" goes sharded for
    mesh runs at/above 2048² (the gathered path moves 256 MB/field through
    one host at 8192²).

    The reference's sampling cadence quirk — metadata says floor(day/dt) but the
    loop saves every 2*floor(day/dt) (reference: src/run_model.jl:59 vs :7-9) —
    is consciously FIXED here: snapshots go every ``sample_interval`` seconds of
    model time, exactly as the metadata says.
    """
    # Multi-host: every process runs this driver SPMD-style. Collectives
    # (process_allgather for IO) must run on ALL processes; file writes and
    # logging happen on process 0 only (the reference's SGE job was
    # single-host and had no counterpart of this).
    multihost = jax.process_count() > 1
    primary = jax.process_index() == 0
    verbose = verbose and primary

    def to_host(x) -> np.ndarray:
        if multihost and getattr(x, "is_fully_addressable", True) is False:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(x, tiled=True))
        return np.asarray(x)

    def host_state(s: State) -> State:
        """Gathered full-grid copy for checkpointing (collective — call on
        every process)."""
        return State(*(to_host(leaf) for leaf in s))

    if verbose:
        log_model_params(cfg)
        if mesh is not None:
            print(f"Mesh: {tuple(mesh.devices.shape)} (x, y) over "
                  f"{mesh.devices.size} devices\n")

    total = cfg.total_steps if n_steps is None else n_steps
    sample_steps = max(int(sample_interval // cfg.dt), 1)

    model = QGModel(cfg)
    if mesh is not None:
        from .parallel.gspmd import make_sharded_run_fn, shard_state
        from .parallel.stepper import make_halo_run_fn
        if parallel_impl == "halo":
            run_fn = make_halo_run_fn(cfg, mesh)
        else:
            run_fn = make_sharded_run_fn(cfg, mesh)

    if checkpoint_mode not in ("auto", "gathered", "sharded"):
        raise ValueError(f"unknown checkpoint_mode {checkpoint_mode!r}")
    sharded_io = checkpoint_mode == "sharded" or (
        checkpoint_mode == "auto" and mesh is not None
        and cfg.M * cfg.P >= 2048 * 2048)

    save = save_results
    writer = None
    if save:
        if run_dir is None:
            raise ValueError("save_results=True requires run_dir")
        if resume:
            reader = RunReader(run_dir)
            steps_avail = reader.checkpoint_steps()
            if (mesh is not None and steps_avail
                    and reader._shard_files("checkpoint", steps_avail[-1])):
                # Sharded checkpoint + mesh resume: load each device's
                # block straight onto the mesh, no global assembly.
                from .parallel.gspmd import state_sharding
                state = reader.load_checkpoint_sharded(state_sharding(mesh))
            else:
                state = reader.load_checkpoint()
            if verbose:
                print(f"Resumed from step {int(state.step)}")
        if primary or sharded_io:
            writer = RunWriter(run_dir, cfg, sample_interval,
                               write_metadata=primary)

    def save_snapshot(step_no: int, s: State) -> None:
        if sharded_io:
            if writer is not None:
                writer.write_snapshot_sharded(step_no, s.zeta, s.psi)
        else:
            zh, ph = to_host(s.zeta), to_host(s.psi)    # collective
            if writer is not None:
                writer.write_snapshot(step_no, zh, ph)

    def save_checkpoint(s: State) -> None:
        if sharded_io:
            if writer is not None:
                writer.write_checkpoint_sharded(s)
        else:
            hs = host_state(s)                          # collective
            if writer is not None:
                writer.write_checkpoint(hs)

    if state is None:
        state = model.init_state(key=jax.random.PRNGKey(cfg.seed))
        if writer is not None and primary:
            writer.write_snapshot(0, np.asarray(state.zeta), np.asarray(state.psi))

    if mesh is not None:
        from .parallel.gspmd import shard_state
        state = shard_state(state, mesh)

    start_step = int(state.step)
    if verbose:
        print("Running simulation... \n")
    t0 = time.perf_counter()
    done = start_step
    while done < total:
        chunk = min(sample_steps, total - done)
        state = run_fn(state, chunk) if mesh is not None else model.run(state, chunk)
        done += chunk
        if save and done % sample_steps == 0:
            save_snapshot(done, state)
        if save and checkpoint_every and done % checkpoint_every == 0:
            save_checkpoint(state)
        d = diagnostics(cfg, state)
        import math
        if not math.isfinite(d["max_abs_zeta"]):
            # Failure detection: NaN/Inf in the state. Save what we have for
            # post-mortem + restart (the reference would silently write garbage
            # and keep going — SURVEY.md section 5, no failure detection).
            if save:
                save_checkpoint(state)
            raise FloatingPointError(
                f"non-finite state at step {done} (max|zeta|="
                f"{d['max_abs_zeta']}); diagnostics: {d}"
                + (" — emergency checkpoint written" if save else ""))
        if verbose:
            rate = (done - start_step) * cfg.M * cfg.P / (time.perf_counter() - t0)
            print(f"step {done}/{total}  cfl={d['cfl']:.3f}  "
                  f"ke1={d.get('ke_1', float('nan')):.3e}  "
                  f"max|zeta|={d['max_abs_zeta']:.3e}  "
                  f"[{rate:.3e} gridpoint-steps/s]")
    jax.block_until_ready(state.zeta)
    if save:
        save_checkpoint(state)

    return state


def run_model_no_output(cfg: ModelConfig, n_steps: Optional[int] = None) -> State:
    """Pure-compute run for benchmarking (reference: src/run_model_no_output.jl)."""
    return run_model(cfg, save_results=False, n_steps=n_steps, verbose=False)


def apply_overrides(cfg: ModelConfig, settings) -> ModelConfig:
    """Apply ``KEY=VALUE`` config overrides (the ``--set`` option)."""
    overrides = {}
    for kv in settings:
        k, v = kv.split("=", 1)
        field_type = type(getattr(cfg, k))
        overrides[k] = field_type(json.loads(v) if field_type is bool else v)
    return cfg.replace(**overrides) if overrides else cfg


def main(argv=None) -> State:
    """CLI entry point; returns the final state."""
    from .utils.runtime import (device_report, enable_x64_if_needed,
                                setup_compile_cache)

    parser = argparse.ArgumentParser(description="Two-layer QG solver")
    parser.add_argument("--preset", default="production",
                        help="named config preset (see tpu_qg.config.preset)")
    parser.add_argument("--run-dir", default=None, help="output directory")
    parser.add_argument("--steps", type=int, default=None,
                        help="override number of steps")
    parser.add_argument("--resume", action="store_true",
                        help="resume from latest checkpoint in --run-dir")
    parser.add_argument("--checkpoint-every", type=int, default=None)
    parser.add_argument("--checkpoint-mode", default="auto",
                        choices=["auto", "gathered", "sharded"],
                        help="sharded = per-process shard files, no "
                             "full-grid gather (auto: sharded for mesh "
                             "runs at/above 2048^2)")
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--debug-nans", action="store_true",
                        help="enable jax_debug_nans (traps the op that "
                             "produced the first NaN; slow)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process: call jax.distributed.initialize "
                             "with --coordinator, --num-processes and "
                             "--process-id, and shard over all devices")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="jax.distributed coordinator address")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="process count for --distributed")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's id for --distributed")
    parser.add_argument("--mesh", nargs="?", const="auto", default=None,
                        metavar="NX,NY",
                        help="domain-decompose over a device mesh; bare "
                             "--mesh uses all devices in the shape the "
                             "elliptic algorithm prefers")
    parser.add_argument("--parallel", default="halo",
                        choices=["halo", "gspmd"],
                        help="sharded implementation (with --mesh or "
                             "--distributed)")
    parser.add_argument("--set", nargs="*", default=[],
                        metavar="KEY=VALUE", help="config field overrides")
    args = parser.parse_args(argv)

    setup_compile_cache()
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    if args.distributed:
        if None in (args.coordinator, args.num_processes, args.process_id):
            parser.error("--distributed needs --coordinator, "
                         "--num-processes and --process-id")
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id)

    cfg = apply_overrides(preset(args.preset), args.set)
    enable_x64_if_needed(cfg.dtype)

    dev = device_report()
    if jax.process_index() == 0:
        print(f"Devices: platform={dev['platform']} "
              f"device_kind={dev['kind']} count={dev['count']}")

    mesh = None
    if args.distributed or args.mesh:
        from .parallel import make_mesh
        shape = (None if args.mesh in (None, "auto")
                 else tuple(int(v) for v in args.mesh.split(",")))
        # With no explicit shape the mesh follows the elliptic algorithm
        # (parallel.mesh.preferred_mesh_shape).
        mesh = make_mesh(shape, cfg=cfg)

    t0 = time.perf_counter()
    state = run_model(
        cfg,
        run_dir=args.run_dir,
        save_results=not args.no_save and args.run_dir is not None,
        n_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        mesh=mesh,
        parallel_impl=args.parallel,
        checkpoint_mode=args.checkpoint_mode,
    )
    print(f"\n Total runtime: {time.perf_counter() - t0:.2f} s")
    return state


if __name__ == "__main__":
    main()
