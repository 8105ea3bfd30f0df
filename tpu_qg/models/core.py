"""Two-layer (and single-layer barotropic) QG model: state, tendencies, stepping.

JAX re-design of the reference's model layer (reference: src/model.jl).
Key architectural differences from the reference, by design:

  * State is an interior-only pytree carried through ``lax.scan`` — no ghost
    ring, no 4-D ring buffers with dead slots. The reference keeps
    (M+2, P+2, 2, 3) arrays (src/model.jl:53-54) of which only time-level 1 of
    zeta/psi is ever read (AB3 history lives in f_store); we carry exactly the
    data the scheme needs: current zeta, current psi, and the two past
    tendencies per layer.
  * The elliptic inversion is spectral (tpu_qg.ops.spectral) instead of sparse
    Cholesky backsolves (reference: src/model.jl:184-192).
  * Euler (first two steps) vs AB3 (after) dispatch (reference:
    src/model.jl:160-170) is a branch-free ``jnp.where`` on the step counter so
    one compiled step function serves the whole run.
  * float32 on the accelerator speed path, float64 (jax_enable_x64) for the
    reference-equivalence path — dtype is a config axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..config import ModelConfig
from ..ops.spectral import HelmholtzSolver
from ..ops.stencils import arakawa_J, centered_diff_x, laplace_5p


class State(NamedTuple):
    """Simulation state (a JAX pytree).

    zeta: (L, M, P) potential-vorticity-like prognostic field.
    psi:  (L, M, P) streamfunction (diagnostic, from elliptic inversion).
    f1:   (L, M, P) tendency of the previous step (the reference's f_store
          slot 2, src/model.jl:101-106,129-136).
    f2:   (L, M, P) tendency two steps back (f_store slot 3). Kept as two
          separate leaves (not a stacked (2, L, M, P) array) so the per-step
          history shift is pure pytree re-binding — XLA aliases the buffers
          instead of copying, unlike the reference's ring-buffer copy.
    step: () int32 — number of completed steps.
    """

    zeta: Array
    psi: Array
    f1: Array
    f2: Array
    step: Array


def _tendencies(cfg: ModelConfig, zeta: Array, psi: Array) -> Array:
    """Per-layer RHS d(zeta)/dt, fused across layers.

    Layer 1 (reference: src/model.jl:139-145, ``zeta_f1``):
        visc*lap(lap(psi)) - J(zeta, psi) - beta_1*d(psi)/dx - U*d(zeta)/dx
    Layer 2 (reference: src/model.jl:147-153, ``zeta_f2``):
        visc*lap(lap(psi)) - J(zeta, psi) - beta_2*d(psi)/dx - r*lap(psi)

    Single-layer barotropic variant: layer-1 form plus bottom drag -r*lap(psi)
    with no layer coupling.
    """
    dx = cfg.dx
    dtype = zeta.dtype
    lap_psi = laplace_5p(psi, dx)              # (L, M, P), used by visc and drag
    visc_term = cfg.visc * laplace_5p(lap_psi, dx)
    jac = arakawa_J(zeta, psi, dx)
    dpsi_dx = centered_diff_x(psi, dx)

    if cfg.n_layers == 1:
        u_term = cfg.U * centered_diff_x(zeta, dx)
        drag = cfg.r * lap_psi
        tend = visc_term - jac - cfg.beta * dpsi_dx - u_term - drag
        if cfg.wind_tau0 != 0.0:
            tend = tend + _wind_forcing(cfg, dtype)[None]
        return tend

    betas = jnp.asarray([cfg.beta_1, cfg.beta_2], dtype)[:, None, None]
    beta_term = betas * dpsi_dx
    # Layer 1: mean-flow advection U d(zeta)/dx; layer 2: bottom drag r*lap(psi).
    u_term = cfg.U * centered_diff_x(zeta[0], dx)
    drag = cfg.r * lap_psi[1]
    extra = jnp.stack([u_term, drag])
    tend = visc_term - jac - beta_term - extra
    if cfg.wind_tau0 != 0.0:
        tend = tend.at[0].add(_wind_forcing(cfg, dtype))
    return tend


def _wind_forcing(cfg: ModelConfig, dtype) -> Array:
    """Double-gyre wind-stress-curl PV forcing on the top layer:
    F(y) = -(2 pi tau_0 / (rho_0 H_1 Ly)) sin(2 pi y / Ly), broadcast over x
    (two counter-rotating gyres on the periodic domain). Extension beyond the
    reference, whose only forcing is the imposed shear U. Shape (1, P)."""
    y = np.arange(cfg.P) * cfg.dx
    amp = 2.0 * np.pi * cfg.wind_tau0 / (cfg.rho0 * cfg.H_1 * cfg.Ly)
    f = -amp * np.sin(2.0 * np.pi * y / cfg.Ly)
    return jnp.asarray(f, dtype)[None, :]


def _invert_psi(cfg: ModelConfig, solvers, zeta: Array) -> Array:
    """Streamfunction from PV: modal decomposition + spectral elliptic solves.

    Reference: ``evolve_psi!`` (src/model.jl:172-199) — project zeta into
    barotropic/baroclinic modes with P_inv, solve Poisson (mode 1) and modified
    Helmholtz (mode 2), project back with P. The reference's back-projection
    quirk P_matrix(H_1, H_1) (src/model.jl:173) is honored via
    cfg.back_projection_matrix().
    """
    from ..ops.spectral import PackedModalInverter
    if isinstance(solvers, PackedModalInverter):
        # Projection, solves, and back-projection all live in the spectral
        # symbols: one complex fft2/ifft2 pair, nothing else.
        return solvers(zeta)

    if cfg.n_layers == 1:
        if isinstance(solvers, tuple):
            return solvers[0](zeta)
        return solvers(zeta)

    (pi11, pi12), (pi21, pi22) = cfg.P_inv_matrix()
    zt1 = pi11 * zeta[0] + pi12 * zeta[1]   # barotropic mode
    zt2 = pi21 * zeta[0] + pi22 * zeta[1]   # baroclinic mode
    if isinstance(solvers, tuple):
        # Per-mode transforms (the GSPMD-partitionable form: XLA's CPU FFT
        # thunk rejects the batched form's layout under sharding).
        poisson, helmholtz = solvers
        pt0, pt1_ = poisson(zt1), helmholtz(zt2)
    else:
        pt = solvers(jnp.stack([zt1, zt2]))  # one batched rfft2/irfft2 pair
        pt0, pt1_ = pt[0], pt[1]
    (p11, p12), (p21, p22) = cfg.back_projection_matrix()
    return jnp.stack([p11 * pt0 + p12 * pt1_, p21 * pt0 + p22 * pt1_])


def _build_packed_inverter(cfg: ModelConfig):
    """PackedModalInverter for the single-complex-fft2 inversion (two-layer,
    zero-mean gauge only — the pin gauge needs the per-mode physical field).
    ``fft_impl="matmul"`` swaps in the matmul-factorized DFT."""
    from ..ops.spectral import PackedModalInverter, PackedModalInverterMatmul
    cls = (PackedModalInverterMatmul if cfg.fft_impl == "matmul"
           else PackedModalInverter)
    return cls(cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
               cfg.back_projection_matrix())


def _build_solvers(cfg: ModelConfig, batched_fft: bool = True):
    from ..ops.spectral import BatchedModalSolver
    if (batched_fft and cfg.n_layers == 2
            and cfg.poisson_gauge == "zero_mean"):
        return _build_packed_inverter(cfg)
    if batched_fft:
        alphas = (0.0,) if cfg.n_layers == 1 else (0.0, cfg.S_eig)
        return BatchedModalSolver(cfg.M, cfg.P, cfg.dx, alphas,
                                  gauge=cfg.poisson_gauge)
    if cfg.n_layers == 1:
        return (HelmholtzSolver(cfg.M, cfg.P, cfg.dx, 0.0,
                                gauge=cfg.poisson_gauge),)
    return (
        HelmholtzSolver(cfg.M, cfg.P, cfg.dx, 0.0, gauge=cfg.poisson_gauge),
        HelmholtzSolver(cfg.M, cfg.P, cfg.dx, cfg.S_eig),
    )


def scheme_update(cfg: ModelConfig, zeta: Array, f1: Array, f2: Array,
                  step: Array, tend: Array) -> Tuple[Array, Array, Array]:
    """Time update from the tendency: returns (zeta_new, f1_new, f2_new).

    euler_ab3 (reference: src/model.jl:155-170): Euler for steps 0 and 1
    (the reference's timestep 1 and 2), AB3 after — a branch-free
    ``jnp.where`` on the step counter; f1 <- this step's tendency, f2 <- the
    previous f1.

    leapfrog_ra (extension beyond the reference, for the BASELINE leapfrog
    configs): f1 carries the Robert-Asselin-filtered zeta of the previous
    level (zeta_bar^{n-1}); f2 is unused and carried through. Step 0 is
    forward Euler with zeta_bar^{-1} := zeta^0.

    Shared by the single-device step and the sharded halo step, so both
    apply the same arithmetic per point."""
    dt = cfg.dt
    if cfg.time_scheme == "leapfrog_ra":
        zeta_prev_f = jnp.where(step == 0, zeta, f1)
        leap = zeta_prev_f + (2.0 * dt) * tend
        euler0 = zeta + dt * tend
        zeta_new = jnp.where(step == 0, euler0, leap)
        # Robert-Asselin filter of the *current* level for the next step.
        zeta_filt = zeta + cfg.ra_filter * (
            zeta_prev_f - 2.0 * zeta + zeta_new)
        return zeta_new, zeta_filt, f2
    ab3 = dt * ((23.0 / 12.0) * tend
                - (16.0 / 12.0) * f1
                + (5.0 / 12.0) * f2)
    euler = dt * tend
    update = jnp.where(step < 2, euler, ab3)
    return zeta + update, tend, f1


def make_step_fn(cfg: ModelConfig, batched_fft: bool = True):
    """Build the single-step transition function ``state -> state``.

    One step = evolve zeta (``scheme_update``) then invert for psi
    (reference: src/model.jl:172-199, called at src/run_model.jl:83-84).

    ``batched_fft=False`` uses per-mode transforms — required under GSPMD
    sharding on the CPU backend.
    """
    solvers = _build_solvers(cfg, batched_fft)

    def step(state: State) -> State:
        tend = _tendencies(cfg, state.zeta, state.psi)
        zeta_new, f1, f2 = scheme_update(cfg, state.zeta, state.f1,
                                         state.f2, state.step, tend)
        psi_new = _invert_psi(cfg, solvers, zeta_new)
        return State(zeta_new, psi_new, f1, f2, state.step + 1)

    return step


def check_dtype_enabled(cfg: ModelConfig) -> None:
    """Refuse a float64 configuration while JAX is in 32-bit mode: JAX
    would otherwise demote every array to float32 with only a warning, and
    a float64 run would silently be a float32 run."""
    if jnp.dtype(cfg.dtype).itemsize == 8 and not jax.config.jax_enable_x64:
        raise ValueError(
            f"dtype={cfg.dtype!r} needs 64-bit mode: call "
            "jax.config.update('jax_enable_x64', True) before creating "
            "any array (tpu_qg.run does this for float64 presets)")


def init_state(cfg: ModelConfig, key: Optional[Array] = None,
               psi_init: Optional[Array] = None) -> State:
    """Initial condition: random streamfunction kick, zeta from its definition.

    Reference: ``initialise_model`` (src/model.jl:36-62) — psi_i = initial_kick
    * U * Ly * uniform[0,1), then zeta from the layer-coupled definition
    (src/model.jl:47-48). The reference's RNG is unseeded Julia rand; for
    reproducibility (and for the allclose check against serialized reference
    trajectories) an explicit ``psi_init`` of shape (L, M, P) can be injected.
    """
    if cfg.n_layers == 2:
        cfg.validate()
    check_dtype_enabled(cfg)
    dtype = jnp.dtype(cfg.dtype)
    L = cfg.n_layers
    shape = (L, cfg.M, cfg.P)

    if psi_init is not None:
        psi = jnp.asarray(psi_init, dtype).reshape(shape)
    elif cfg.ic_type == "vortex":
        # Gaussian vortex dipole (BASELINE config 1's barotropic vortex):
        # two opposite-signed Gaussian streamfunction bumps, periodic-friendly.
        x = (np.arange(cfg.M) + 0.5) * cfg.dx
        y = (np.arange(cfg.P) + 0.5) * cfg.dx
        X, Y = np.meshgrid(x, y, indexing="ij")
        sigma = 0.08 * min(cfg.Lx, cfg.Ly)
        amp = cfg.initial_kick * (abs(cfg.U) or 1.0) * cfg.Ly

        def bump(cx, cy, s):
            return s * np.exp(-(((X - cx) ** 2 + (Y - cy) ** 2)
                                / (2.0 * sigma ** 2)))

        field = (bump(0.35 * cfg.Lx, 0.5 * cfg.Ly, amp)
                 + bump(0.65 * cfg.Lx, 0.5 * cfg.Ly, -amp))
        psi = jnp.broadcast_to(jnp.asarray(field, dtype), shape)
    else:
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        amp = cfg.initial_kick * (cfg.U if cfg.U != 0.0 else 1.0) * cfg.Ly
        psi = amp * jax.random.uniform(key, shape, dtype=dtype)

    return _init_finish(cfg, psi)


@functools.partial(jax.jit, static_argnums=(0,))
def _init_finish(cfg: ModelConfig, psi: Array) -> State:
    """zeta-from-psi plus history zeros in one compiled program."""
    dtype = psi.dtype
    if cfg.n_layers == 1:
        zeta = laplace_5p(psi, cfg.dx)
    else:
        lap = laplace_5p(psi, cfg.dx)
        z1 = lap[0] + cfg.S1_plus * (psi[1] - psi[0])
        z2 = lap[1] + cfg.S2_minus * (psi[0] - psi[1])
        zeta = jnp.stack([z1, z2])
    zero = jnp.zeros(psi.shape, dtype)
    return State(zeta, psi, zero, zero, jnp.asarray(0, jnp.int32))


@functools.partial(jax.jit, static_argnums=(0, 2))
def _run_scan(step_fn, state: State, n_steps: int) -> State:
    def body(s, _):
        return step_fn(s), None
    out, _ = jax.lax.scan(body, state, None, length=n_steps)
    return out


class QGModel:
    """Convenience wrapper bundling config, jitted step, and multi-step runs.

    The counterpart of the reference's driver-facing surface
    (BaroclinicModel + initialise_model + evolve_zeta!/evolve_psi!).
    """

    def __init__(self, cfg: ModelConfig):
        check_dtype_enabled(cfg)
        self.cfg = cfg
        self._step_fn = make_step_fn(cfg)
        self.step = jax.jit(self._step_fn)

    def init_state(self, key: Optional[Array] = None,
                   psi_init: Optional[Array] = None) -> State:
        return init_state(self.cfg, key=key, psi_init=psi_init)

    def run(self, state: State, n_steps: int) -> State:
        """Advance ``n_steps`` steps under one compiled ``lax.scan``."""
        return _run_scan(self._step_fn, state, n_steps)

    def run_trajectory(self, state: State, n_steps: int, sample_every: int
                       ) -> Tuple[State, Array, Array]:
        """Advance n_steps, returning (final_state, zeta_samples, psi_samples)
        sampled every ``sample_every`` steps (scan-of-scans: the inner scan is
        one sampling interval)."""
        assert n_steps % sample_every == 0
        n_chunks = n_steps // sample_every

        def outer(s, _):
            s = _run_scan(self._step_fn, s, sample_every)
            return s, (s.zeta, s.psi)

        final, (zs, ps) = jax.lax.scan(outer, state, None, length=n_chunks)
        return final, zs, ps
