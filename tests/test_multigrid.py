"""Multigrid elliptic solver tests: exact-system agreement with the
spectral inverter (same discrete 5-point operator — reference counterpart
src/schemes/laplacian.jl:60-75), convergence factor, MMS convergence order,
and the distributed (halo-only) form on (8,1) and (4,2) virtual meshes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR


def qg_cfg(**kw):
    base = dict(
        H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11, Lx=4000.0 * KM,
        Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
        M=128, P=128, visc=100.0, r=1e-7, R_d=40.0 * KM,
        initial_kick=1e-6, dtype="float64",
    )
    base.update(kw)
    return ModelConfig(**base)


def _rhs(cfg, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2, cfg.M, cfg.P)).astype(dtype)
    return jnp.asarray(f * 1e-5)


def test_vcycle_contraction_factor():
    """Per-V(2,2)-cycle residual contraction must be at the damped-Jacobi
    textbook level (~0.15) for the 5-point operator (this is what makes 8
    cold-start cycles reach f32 roundoff: 0.15^8 ~ 2.6e-7)."""
    from tpu_qg.ops.multigrid import MultigridSolver

    cfg = qg_cfg(M=256, P=256)
    f = _rhs(cfg)
    f = f - jnp.mean(f, axis=(-2, -1), keepdims=True)
    mg = MultigridSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig), n_cycles=1)
    u = jnp.zeros_like(f)
    norms = [np.asarray(mg.residual_norm(u, f))]
    for _ in range(5):
        u = mg._vcycle(0, u, f)
        norms.append(np.asarray(mg.residual_norm(u, f)))
    rates = [norms[i + 1] / norms[i] for i in range(1, 5)]
    assert max(float(r.max()) for r in rates) < 0.17, rates


def test_multigrid_matches_spectral_f64():
    """Converged MG solves the IDENTICAL linear system as the spectral
    inverse symbol (same discrete eigenvalues): float64 agreement to 1e-10
    relative."""
    from tpu_qg.ops.multigrid import MultigridSolver
    from tpu_qg.ops.spectral import BatchedModalSolver

    cfg = qg_cfg(M=128, P=256)
    f = _rhs(cfg, seed=1)
    spectral = BatchedModalSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig))
    ref = np.asarray(spectral(f))
    mg = MultigridSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig),
                         n_cycles=14)
    got = np.asarray(mg(f))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10 * scale)


def test_multigrid_matches_spectral_f32():
    """f32 agreement to f32 roundoff (the production dtype)."""
    from tpu_qg.ops.multigrid import MultigridSolver
    from tpu_qg.ops.spectral import BatchedModalSolver

    cfg = qg_cfg(M=256, P=128, dtype="float32")
    f = _rhs(cfg, seed=2, dtype=np.float32)
    spectral = BatchedModalSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig))
    ref = np.asarray(spectral(f))
    mg = MultigridSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig),
                         n_cycles=8)
    got = np.asarray(mg(f))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)


def test_multigrid_warm_start():
    """A warm start from a nearby solution reaches the same tolerance in
    half the cycles (the time-stepping advantage)."""
    from tpu_qg.ops.multigrid import MultigridSolver
    from tpu_qg.ops.spectral import BatchedModalSolver

    cfg = qg_cfg(M=128, P=128, dtype="float32")
    f = _rhs(cfg, seed=3, dtype=np.float32)
    spectral = BatchedModalSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig))
    ref = jnp.asarray(np.asarray(spectral(f)))
    # Perturb the exact solution by ~1% — the size of a timestep's change.
    x0 = ref * (1.0 + 1e-2)
    mg = MultigridSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig), n_cycles=4)
    got = np.asarray(mg(f, x0=x0))
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                               atol=2e-6 * scale)


def test_multigrid_mms_convergence():
    """Method-of-manufactured-solutions second-order convergence, the
    reference's Helmholtz testset style (reference: src/test.jl:150-193,
    slope asserted in (1.7, 2.3))."""
    from tpu_qg.ops.multigrid import MultigridSolver

    errs, hs = [], []
    for M in (32, 64, 128):
        L = 1.0
        dx = L / M
        x = (np.arange(M) + 0.5) * dx
        X, Y = np.meshgrid(x, x, indexing="ij")
        alpha = -3.0
        u_true = np.sin(2 * np.pi * X) * np.cos(4 * np.pi * Y)
        f = (-(2 * np.pi) ** 2 - (4 * np.pi) ** 2 + alpha) * u_true
        mg = MultigridSolver(M, M, dx, (alpha,), n_cycles=12,
                             coarse_cutoff=8)
        got = np.asarray(mg(jnp.asarray(f[None])))[0]
        errs.append(np.abs(got - u_true).max())
        hs.append(dx)
    slope = np.polyfit(np.log(hs), np.log(errs), 1)[0]
    assert 1.7 < slope < 2.3, (slope, errs)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_distributed_multigrid_matches_single_device(mesh_shape):
    """The distributed V-cycle (halo exchanges + gathered coarse solve)
    agrees with the single-device solver and the spectral reference on any
    2-D mesh."""
    from jax.sharding import PartitionSpec as Pspec

    from tpu_qg.ops.multigrid import MultigridSolver
    from tpu_qg.ops.spectral import BatchedModalSolver
    from tpu_qg.parallel import make_mesh
    from tpu_qg.parallel.multigrid import DistributedMultigridSolver

    nx, ny = mesh_shape
    cfg = qg_cfg(M=256, P=256)
    f = _rhs(cfg, seed=5)
    ref = np.asarray(BatchedModalSolver(cfg.M, cfg.P, cfg.dx,
                                        (0.0, cfg.S_eig))(f))
    single = np.asarray(MultigridSolver(
        cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig), n_cycles=12,
        coarse_cutoff=64)(f))

    mesh = make_mesh(mesh_shape)
    dist = DistributedMultigridSolver(
        cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig), nx, ny, n_cycles=12)
    solve = jax.jit(jax.shard_map(
        dist, mesh=mesh, in_specs=(Pspec(None, "x", "y"),),
        out_specs=Pspec(None, "x", "y"), check_vma=False))
    got = np.asarray(solve(f))

    scale = np.abs(ref).max()
    # Same levels, same arithmetic -> agree with the single-device MG far
    # below the MG <-> spectral convergence gap.
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_distributed_multigrid_2048_f32(mesh_shape):
    """The distributed multigrid solve matches the spectral inverter to f32
    roundoff at 2048^2 on (8,1) and (4,2) virtual meshes (the 8192^2 leg
    runs as a standalone artifact, results/mg_virtualmesh_8192.json — too
    heavy for CI)."""
    from jax.sharding import PartitionSpec as Pspec

    from tpu_qg.ops.spectral import BatchedModalSolver
    from tpu_qg.parallel import make_mesh
    from tpu_qg.parallel.multigrid import DistributedMultigridSolver

    nx, ny = mesh_shape
    cfg = qg_cfg(M=2048, P=2048, dtype="float32")
    f = _rhs(cfg, seed=6, dtype=np.float32)
    ref = np.asarray(BatchedModalSolver(cfg.M, cfg.P, cfg.dx,
                                        (0.0, cfg.S_eig))(f))
    mesh = make_mesh(mesh_shape)
    dist = DistributedMultigridSolver(
        cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig), nx, ny, n_cycles=9)
    solve = jax.jit(jax.shard_map(
        dist, mesh=mesh, in_specs=(Pspec(None, "x", "y"),),
        out_specs=Pspec(None, "x", "y"), check_vma=False))
    got = np.asarray(solve(f))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 * scale)


def test_distributed_multigrid_inverter_matches_model():
    """DistributedMultigridInverter (any-mesh modal inversion) reproduces
    the model's spectral inversion on a (2, 4) mesh, warm start included."""
    from jax.sharding import PartitionSpec as Pspec

    from tpu_qg.models.core import _build_solvers, _invert_psi, init_state
    from tpu_qg.parallel import make_mesh
    from tpu_qg.parallel.multigrid import DistributedMultigridInverter

    cfg = qg_cfg(M=128, P=256)
    state = init_state(cfg, key=jax.random.PRNGKey(1))
    ref = np.asarray(_invert_psi(cfg, _build_solvers(cfg), state.zeta))

    mesh = make_mesh((2, 4))
    inv = DistributedMultigridInverter(
        cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix(), nx=2, ny=4, n_cycles=12)
    solve = jax.jit(jax.shard_map(
        inv, mesh=mesh, in_specs=(Pspec(None, "x", "y"),),
        out_specs=Pspec(None, "x", "y"), check_vma=False))
    got = np.asarray(solve(state.zeta))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * scale)

    # Warm start from the exact answer: 3 cycles suffice.
    inv_w = DistributedMultigridInverter(
        cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix(), nx=2, ny=4, n_cycles=3)
    solve_w = jax.jit(jax.shard_map(
        inv_w, mesh=mesh,
        in_specs=(Pspec(None, "x", "y"), Pspec(None, "x", "y")),
        out_specs=Pspec(None, "x", "y"), check_vma=False))
    got_w = np.asarray(solve_w(state.zeta, jnp.asarray(ref)))
    np.testing.assert_allclose(got_w, ref, rtol=0, atol=1e-9 * scale)


def test_halo_step_multigrid_elliptic_trajectory():
    """elliptic_impl='multigrid' routes the sharded halo stepper through
    the warm-started distributed V-cycles; a 10-step trajectory on a (2,4)
    mesh matches the single-device spectral trajectory (same discrete
    system — multigrid only changes the algorithm)."""
    from tpu_qg.models.core import QGModel
    from tpu_qg.parallel import make_mesh, shard_state
    from tpu_qg.parallel.stepper import make_halo_step_fn

    cfg = qg_cfg(M=256, P=256)   # (2,4) mesh -> 2 distributed levels + gather
    model = QGModel(cfg)
    rng = np.random.default_rng(11)
    psi0 = cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, 256, 256))
    ref = model.run(model.init_state(psi_init=psi0), 10)

    cfg_mg = cfg.replace(elliptic_impl="multigrid", mg_cycles=10)
    mesh = make_mesh((2, 4))
    step = make_halo_step_fn(cfg_mg, mesh, donate=False)
    s = shard_state(QGModel(cfg_mg).init_state(psi_init=psi0), mesh)
    for _ in range(10):
        s = step(s)
    assert int(s.step) == 10
    for name in ("zeta", "psi"):
        a = np.asarray(getattr(s, name))
        b = np.asarray(getattr(ref, name))
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * scale,
                                   err_msg=name)


def test_halo_run_fn_mg_extrapolated_trajectory():
    """The extrapolated-warm-start scan (make_halo_run_fn with
    mg_extrapolate, psi_{n-1} in the carry) matches the single-device
    spectral trajectory, and at few cycles it is MORE accurate than the
    plain warm start (the lag source shrinks from O(dt) to O(dt^2))."""
    from tpu_qg.models.core import QGModel
    from tpu_qg.parallel import make_mesh, shard_state
    from tpu_qg.parallel.stepper import make_halo_run_fn

    cfg = qg_cfg(M=128, P=128)
    model = QGModel(cfg)
    rng = np.random.default_rng(13)
    psi0 = cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, 128, 128))
    ref = model.run(model.init_state(psi_init=psi0), 20)
    mesh = make_mesh((2, 4))

    def run_mg(cycles, extrap):
        c = cfg.replace(elliptic_impl="multigrid", mg_cycles=cycles,
                        mg_extrapolate=extrap)
        run = make_halo_run_fn(c, mesh)
        s = shard_state(QGModel(c).init_state(psi_init=psi0), mesh)
        return run(s, 20)

    out = run_mg(10, True)
    assert int(out.step) == 20
    scale = np.abs(np.asarray(ref.zeta)).max()
    np.testing.assert_allclose(np.asarray(out.zeta), np.asarray(ref.zeta),
                               rtol=0, atol=1e-7 * scale)

    # At 20 early steps from a 1e-6 kick the per-step psi change is so
    # small that BOTH warm starts converge to f64 roundoff — the
    # extrapolation's accuracy payoff is measured at statistical
    # equilibrium instead (5000 steps f32: energy bias 1.8e-4 -> 2.1e-6
    # at C=2, results/mg_accuracy_256_5000_extrap.json). Here: both
    # variants track the spectral trajectory.
    err_x = np.abs(np.asarray(run_mg(2, True).zeta)
                   - np.asarray(ref.zeta)).max()
    err_p = np.abs(np.asarray(run_mg(2, False).zeta)
                   - np.asarray(ref.zeta)).max()
    scale = np.abs(np.asarray(ref.zeta)).max()
    assert err_x < 1e-4 * scale and err_p < 1e-4 * scale, (err_x, err_p)


def test_multigrid_modal_inverter_matches_model():
    """MultigridModalInverter reproduces the model's spectral modal
    inversion (projection quirk included) on a two-layer state."""
    from tpu_qg.models.core import _build_solvers, _invert_psi, init_state
    from tpu_qg.ops.multigrid import MultigridModalInverter

    cfg = qg_cfg(M=128, P=128)
    state = init_state(cfg, key=jax.random.PRNGKey(0))
    zeta = state.zeta
    ref = np.asarray(_invert_psi(cfg, _build_solvers(cfg), zeta))
    inv = MultigridModalInverter(cfg.M, cfg.P, cfg.dx, cfg.S_eig,
                                 cfg.P_inv_matrix(),
                                 cfg.back_projection_matrix(), n_cycles=14)
    got = np.asarray(inv(zeta))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * scale)
