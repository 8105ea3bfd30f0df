"""Full shard_map time step: halo-exchange stencils + distributed FFT inversion.

The hand-tuned scaling path (vs the GSPMD path in tpu_qg.parallel.gspmd): each
device advances its (m, p) tile with ppermute halo exchanges for the stencil
radius (1 for zeta, 2 for psi — the del^4 friction needs
Laplacian-of-Laplacian, reference: src/model.jl:140,148) and participates in
the transposed distributed FFT for the modal elliptic inversion (reference
counterpart: src/model.jl:172-199).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import ModelConfig
from ..models.core import State, scheme_update
from ..ops.multigrid import modal_mix
from ..ops.stencils import (arakawa_J_generic, centered_diff_x_generic,
                            laplace_5p_generic)
from .distributed_fft import DistributedHelmholtzSolver
from .halo import exchange_halo, make_padded_shift


def _tend_window(cfg: ModelConfig, zeta_w, psi_w, wind_row):
    """Tendency over one window from halo-carrying slabs: zeta_w (L, q+2, r+2)
    with a 1-deep rim, psi_w (L, q+4, r+4) with a 2-deep rim (the del^4 term)
    -> (L, q, r). wind_row is the window's (1, r) forcing slice or None. The
    windowed form serves both the blocking path (one full-tile window) and the
    overlapped path (interior + four rim windows) with identical arithmetic
    per point (reference: src/model.jl:139-153)."""
    dx = cfg.dx
    dtype = zeta_w.dtype
    s1 = make_padded_shift(1)
    psi_w1 = psi_w[..., 1:-1, 1:-1]                     # (L, q+2, r+2)

    lap_psi_1h = laplace_5p_generic(s1, psi_w, dx)      # (L, q+2, r+2)
    visc_term = cfg.visc * laplace_5p_generic(s1, lap_psi_1h, dx)  # (L, q, r)
    lap_psi = lap_psi_1h[..., 1:-1, 1:-1]               # (L, q, r)
    jac = arakawa_J_generic(s1, zeta_w, psi_w1, dx)
    dpsi_dx = centered_diff_x_generic(s1, psi_w1, dx)

    if cfg.n_layers == 1:
        u_term = cfg.U * centered_diff_x_generic(s1, zeta_w, dx)
        tend = visc_term - jac - cfg.beta * dpsi_dx - u_term - cfg.r * lap_psi
        if wind_row is not None:
            tend = tend + wind_row[None]
        return tend

    betas = jnp.asarray([cfg.beta_1, cfg.beta_2], dtype)[:, None, None]
    u_term = cfg.U * centered_diff_x_generic(s1, zeta_w[0], dx)
    drag = cfg.r * lap_psi[1]
    extra = jnp.stack([u_term, drag])
    tend = visc_term - jac - betas * dpsi_dx - extra
    if wind_row is not None:
        tend = tend.at[0].add(wind_row)
    return tend


def _local_tendencies(cfg: ModelConfig, zeta, psi, ax: str, ay: str):
    """Per-layer RHS on local tiles (reference: src/model.jl:139-153), with
    halo exchange instead of ghost rings. Blocking form: both exchanges
    complete before any stencil work (the equality oracle for the overlapped
    form below)."""
    wind = (_local_wind_forcing(cfg, zeta.dtype, ay)
            if cfg.wind_tau0 != 0.0 else None)
    zeta_pad = exchange_halo(zeta, 1, ax, ay)       # (L, m+2, p+2)
    psi_pad2 = exchange_halo(psi, 2, ax, ay)        # (L, m+4, p+4)
    return _tend_window(cfg, zeta_pad, psi_pad2, wind)


def _local_tendencies_overlapped(cfg: ModelConfig, zeta, psi, ax: str, ay: str):
    """Halo/compute-overlapped RHS (SURVEY.md section 7.7).

    The ppermute exchanges are issued, but the tile INTERIOR (all points at
    least 2 in from the tile edge — the stencil radius) depends only on local
    data, so XLA's latency-hiding scheduler runs the collectives concurrently
    with the interior stencil sweep; only the four rim windows consume the
    exchanged slabs. Identical results to _local_tendencies: every point is
    computed by the same elementwise expression on the same values (the
    distributed analog of overlapping the reference's ghost-ring refresh,
    src/schemes/boundary_conditions.jl:1-13, with interior work).

    Falls back to the blocking form when the tile is too small to have an
    interior (m or p < 8).
    """
    m, p = zeta.shape[-2], zeta.shape[-1]
    if m < 8 or p < 8:
        return _local_tendencies(cfg, zeta, psi, ax, ay)

    wind = (_local_wind_forcing(cfg, zeta.dtype, ay)
            if cfg.wind_tau0 != 0.0 else None)

    def wslice(c, d):
        return None if wind is None else wind[:, c:d]

    zeta_pad = exchange_halo(zeta, 1, ax, ay)       # (L, m+2, p+2)
    psi_pad2 = exchange_halo(psi, 2, ax, ay)        # (L, m+4, p+4)

    # Interior window [2, m-2) x [2, p-2): the tile's own rim is the halo.
    tend_int = _tend_window(cfg, zeta[..., 1:-1, 1:-1], psi, wslice(2, p - 2))

    def rim(a, b, c, d):
        """Tendency over tile window [a, b) x [c, d) from the padded slabs
        (tile row i sits at padded index i+1 for zeta, i+2 for psi)."""
        zw = zeta_pad[..., a:b + 2, c:d + 2]
        pw = psi_pad2[..., a:b + 4, c:d + 4]
        return _tend_window(cfg, zw, pw, wslice(c, d))

    top = rim(0, 2, 0, p)                           # (L, 2, p)
    bot = rim(m - 2, m, 0, p)                       # (L, 2, p)
    left = rim(2, m - 2, 0, 2)                      # (L, m-4, 2)
    right = rim(2, m - 2, p - 2, p)                 # (L, m-4, 2)
    mid = jnp.concatenate([left, tend_int, right], axis=-1)   # (L, m-4, p)
    return jnp.concatenate([top, mid, bot], axis=-2)          # (L, m, p)


def _local_wind_forcing(cfg: ModelConfig, dtype, ay: str):
    """Per-shard slice of the double-gyre forcing (models.core._wind_forcing):
    the y axis is sharded, so each device takes its own columns."""
    import numpy as np
    from jax import lax

    y = np.arange(cfg.P) * cfg.dx
    amp = 2.0 * np.pi * cfg.wind_tau0 / (cfg.rho0 * cfg.H_1 * cfg.Ly)
    full = jnp.asarray(-amp * np.sin(2.0 * np.pi * y / cfg.Ly), dtype)
    ny = lax.axis_size(ay)
    p_local = cfg.P // ny
    j = lax.axis_index(ay)
    return lax.dynamic_slice(full, (j * p_local,), (p_local,))[None, :]


def make_halo_step_fn(cfg: ModelConfig, mesh: Mesh, donate: bool = True,
                      overlap: bool = True, mg_seed: bool = False):
    """Jitted sharded step using explicit halo exchange + distributed
    elliptic solves (transposed FFT or multigrid, per ``elliptic_impl``).

    ``overlap=True`` (default) computes the tile interior concurrently with
    the ppermute halo exchanges; ``overlap=False`` keeps the blocking form
    (the equality oracle). Both produce identical results.
    """
    ax, ay = mesh.axis_names
    nx, ny = mesh.devices.shape
    m, p = cfg.M // nx, cfg.P // ny
    if m * nx != cfg.M or p * ny != cfg.P:
        raise ValueError(f"grid ({cfg.M}, {cfg.P}) does not divide the "
                         f"mesh ({nx}, {ny})")
    tendencies = (_local_tendencies_overlapped if overlap
                  else _local_tendencies)

    mg_solver = mg_inv = None
    if cfg.elliptic_impl == "multigrid":
        # Communication-avoiding inversion (parallel/multigrid.py): halo-only
        # V-cycles warm-started from the previous step's psi; any (nx, ny)
        # mesh. O(halo) traffic per step vs the transposed FFT's O(grid).
        from .multigrid import (DistributedMultigridInverter,
                                DistributedMultigridSolver)
        if cfg.n_layers == 1:
            mg_solver = DistributedMultigridSolver(
                cfg.M, cfg.P, cfg.dx, (0.0,), nx, ny, ax, ay,
                n_cycles=cfg.mg_cycles)
        else:
            mg_inv = DistributedMultigridInverter(
                cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
                cfg.back_projection_matrix(), nx, ny, ax, ay,
                n_cycles=cfg.mg_cycles)
    elif cfg.n_layers == 1:
        solver = DistributedHelmholtzSolver(cfg.M, cfg.P, cfg.dx, (0.0,), ax, ay)
    else:
        solver = DistributedHelmholtzSolver(
            cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig), ax, ay)

    def local_step(state: State, psi_seed=None) -> State:
        tend = tendencies(cfg, state.zeta, state.psi, ax, ay)
        zeta_new, f1_new, f2_new = scheme_update(
            cfg, state.zeta, state.f1, state.f2, state.step, tend)
        seed = state.psi if psi_seed is None else psi_seed
        if mg_inv is not None:
            psi_new = mg_inv(zeta_new, psi_prev=seed)
        elif mg_solver is not None:
            psi_new = mg_solver(zeta_new, x0=seed)
        elif cfg.n_layers == 1:
            psi_new = solver(zeta_new)
        else:
            psi_new = modal_mix(cfg.back_projection_matrix(),
                                solver(modal_mix(cfg.P_inv_matrix(),
                                                 zeta_new)))
        return State(zeta_new, psi_new, f1_new, f2_new, state.step + 1)

    specs = State(
        zeta=P(None, ax, ay),
        psi=P(None, ax, ay),
        f1=P(None, ax, ay),
        f2=P(None, ax, ay),
        step=P(),
    )
    if mg_seed:
        # Two-argument form for the extrapolated-warm-start scan
        # (make_halo_run_fn): the caller supplies the V-cycle seed.
        if mg_inv is None and mg_solver is None:
            raise ValueError("mg_seed=True requires elliptic_impl='multigrid'")
        sharded2 = jax.shard_map(
            local_step, mesh=mesh, in_specs=(specs, P(None, ax, ay)),
            out_specs=specs, check_vma=False)
        return jax.jit(sharded2, donate_argnums=(0,) if donate else ())
    sharded = jax.shard_map(local_step, mesh=mesh, in_specs=(specs,),
                            out_specs=specs, check_vma=False)
    return jax.jit(sharded, donate_argnums=(0,) if donate else ())


def make_halo_run_fn(cfg: ModelConfig, mesh: Mesh, overlap: bool = True):
    """Returns ``run(state, n) -> state``: n halo-path steps under one
    ``lax.scan`` (shard_map composes inside scan), compiled once per n.
    """
    import functools

    if cfg.elliptic_impl == "multigrid" and cfg.mg_extrapolate:
        # Extrapolated warm start: seed the V-cycles with 2 psi_n -
        # psi_{n-1} (linear extrapolation — the solve's lag error scales
        # with the seed error, and the O(dt^2) curvature is ~10x smaller
        # than the O(dt) step change). psi_{n-1} rides the scan carry;
        # the first step of each chunk falls back to the plain seed.
        step2 = make_halo_step_fn(cfg, mesh, donate=False, overlap=overlap,
                                  mg_seed=True)

        @functools.lru_cache(maxsize=None)
        def compiled_x(n: int):
            def run(state: State, prev):
                def body(c, _):
                    s, pm1 = c
                    seed = 2.0 * s.psi - pm1
                    return (step2(s, seed), s.psi), None
                (out, _pm1), _ = jax.lax.scan(body, (state, prev), None,
                                              length=n)
                return out
            # prev aliases state.psi on the first call — donate only
            # the state tuple.
            return jax.jit(run, donate_argnums=(0,))

        # A copy, not state.psi itself: arg 0 is donated and XLA
        # rejects a buffer appearing both donated and plain.
        return lambda state, n: compiled_x(n)(state,
                                              jnp.copy(state.psi))

    # make_halo_step_fn returns a jitted fn; jit-of-jit composes under scan.
    step = make_halo_step_fn(cfg, mesh, donate=False, overlap=overlap)

    @functools.lru_cache(maxsize=None)
    def compiled(n: int):
        def run(state: State) -> State:
            def body(s, _):
                return step(s), None
            out, _ = jax.lax.scan(body, state, None, length=n)
            return out
        return jax.jit(run, donate_argnums=(0,))

    return lambda state, n: compiled(n)(state)
