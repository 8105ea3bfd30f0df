"""Spectral elliptic solver tests: MMS convergence (reference: src/test.jl:105-193)
and exact agreement with the direct factorized solve of the same operator."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_qg.ops.operators import FactorizedSolver
from tpu_qg.ops.spectral import (HelmholtzSolver, periodic_laplacian_eigenvalues,
                                 solve_helmholtz, solve_poisson)
from tpu_qg.ops.stencils import laplace_5p


def _fit_slope(Ms, errs):
    return np.polyfit(np.log(np.asarray(Ms, float)), np.log(errs), 1)[0]


def _mms_fields(M, Lx=3.0, Ly=3.0, alpha=0.0):
    """u = sin(2 pi x / Lx) cos(2 pi y / Ly), f = (lap + alpha) u analytically
    (reference: src/test.jl:115-118,161-164)."""
    dx = Lx / M
    x = np.arange(M) * dx
    X, Y = np.meshgrid(x, x, indexing="ij")
    u = np.sin(2 * np.pi * X / Lx) * np.cos(2 * np.pi * Y / Ly)
    f = -(np.pi ** 2) * (u * (4 / Ly ** 2 + 4 / Lx ** 2)) + alpha * u
    return dx, u, f


def test_poisson_mms_convergence():
    """Second-order convergence band 1.7 < -slope < 2.3
    (reference: src/test.jl:105-148)."""
    Ms = [8, 16, 32, 64]
    errs = []
    for M in Ms:
        dx, u_true, f = _mms_fields(M)
        u = np.asarray(solve_poisson(jnp.asarray(f), dx))
        errs.append(dx * np.linalg.norm(u - u_true))
    slope = -_fit_slope(Ms, errs)
    assert 1.7 < slope < 2.3


def test_helmholtz_mms_convergence():
    """alpha = -3 modified Helmholtz (reference: src/test.jl:150-193)."""
    Ms = [8, 16, 32, 64]
    errs = []
    alpha = -3.0
    for M in Ms:
        dx, u_true, f = _mms_fields(M, alpha=alpha)
        u = np.asarray(solve_helmholtz(jnp.asarray(f), dx, alpha))
        errs.append(dx * np.linalg.norm(u - u_true))
    slope = -_fit_slope(Ms, errs)
    assert 1.7 < slope < 2.3


def test_spectral_matches_direct_helmholtz():
    """Same discrete operator, different algorithm: the spectral solve must
    match the factorized sparse solve to roundoff, including on non-square
    grids (validates the discrete-eigenvalue choice)."""
    rng = np.random.default_rng(0)
    for (M, P) in [(16, 16), (32, 16), (24, 40)]:
        dx = 0.21
        alpha = -3.7
        f = rng.standard_normal((M, P))
        direct = FactorizedSolver(M, P, dx, alpha).solve(f)
        spectral = np.asarray(solve_helmholtz(jnp.asarray(f), dx, alpha))
        np.testing.assert_allclose(spectral, direct, rtol=0, atol=1e-10)


def test_spectral_matches_direct_poisson_up_to_gauge():
    """Poisson: pinned-point gauge (reference) vs zero-mean gauge (spectral)
    differ by a constant for a compatible (zero-mean) RHS; with gauge="pin" the
    spectral solution matches the reference solve pointwise."""
    rng = np.random.default_rng(1)
    M, P, dx = 32, 24, 0.13
    f = rng.standard_normal((M, P))
    f -= f.mean()  # compatible RHS
    direct = FactorizedSolver(M, P, dx, 0.0).solve(f)
    zm = np.asarray(solve_poisson(jnp.asarray(f), dx))
    assert abs(zm.mean()) < 1e-12
    np.testing.assert_allclose(zm - zm.mean() - (direct - direct.mean()),
                               0.0, atol=1e-10)
    pinned = np.asarray(solve_poisson(jnp.asarray(f), dx, gauge="pin"))
    np.testing.assert_allclose(pinned, direct - direct[0, 0], atol=1e-10)
    np.testing.assert_allclose(direct[0, 0], 0.0, atol=1e-10)


def test_solve_then_apply_roundtrip():
    """laplace_5p(solve_poisson(f)) == f - mean(f): the solver inverts exactly
    the stencil operator used by the dynamics."""
    rng = np.random.default_rng(2)
    M, P, dx = 40, 24, 0.37
    f = rng.standard_normal((M, P))
    u = solve_poisson(jnp.asarray(f), dx)
    back = np.asarray(laplace_5p(u, dx))
    np.testing.assert_allclose(back, f - f.mean(), atol=1e-9)

    alpha = -2.2
    uh = solve_helmholtz(jnp.asarray(f), dx, alpha)
    backh = np.asarray(laplace_5p(uh, dx) + alpha * uh)
    np.testing.assert_allclose(backh, f, atol=1e-9)


def test_eigenvalues_match_operator():
    """The tabulated symbol equals the action of laplace_5p on DFT modes."""
    M, P, dx = 16, 12, 0.5
    lam = periodic_laplacian_eigenvalues(M, P, dx)
    x = np.arange(M)
    y = np.arange(P)
    for k, l in [(0, 0), (1, 0), (3, 5), (M // 2, P // 2)]:
        mode = np.cos(2 * np.pi * (k * x[:, None] / M + l * y[None, :] / P))
        applied = np.asarray(laplace_5p(jnp.asarray(mode), dx))
        np.testing.assert_allclose(applied, lam[k, l] * mode, atol=1e-10)


def test_cached_solver_batched():
    """HelmholtzSolver broadcasts over leading (layer) axes."""
    rng = np.random.default_rng(3)
    M, P, dx = 16, 16, 0.4
    f = rng.standard_normal((2, M, P))
    solver = HelmholtzSolver(M, P, dx, -1.0)
    out = np.asarray(solver(jnp.asarray(f)))
    for layer in range(2):
        single = np.asarray(solver(jnp.asarray(f[layer])))
        np.testing.assert_allclose(out[layer], single, atol=1e-12)


def test_function_rhs_solver():
    """Function-RHS convenience variant (reference: src/schemes/laplacian.jl:89-98)."""
    from tpu_qg.ops.spectral import RectangularDomain, solve_helmholtz_fn

    Lx = Ly = 3.0
    alpha = -3.0
    M = P = 32
    dx = Lx / M

    def u(x, y):
        return np.sin(2 * np.pi * x / Lx) * np.cos(2 * np.pi * y / Ly)

    def f(x, y):
        return -(np.pi ** 2) * (u(x, y) * (4 / Ly ** 2 + 4 / Lx ** 2)) + alpha * u(x, y)

    dom = RectangularDomain(0.0, Lx, 0.0, Ly)
    num = np.asarray(solve_helmholtz_fn(M, P, dx, f, alpha, dom))
    x = np.arange(M) * dx
    true = np.array([[u(xi, yj) for yj in x] for xi in x])
    err = dx * np.linalg.norm(num - true)
    assert err < 0.05  # second-order accurate at M=32


class TestPackedModalInverter:
    """The packed single-complex-fft2 inversion must match the explicit
    project -> solve -> back-project chain to roundoff."""

    def _reference_chain(self, cfg, zeta):
        from tpu_qg.ops.spectral import BatchedModalSolver
        (pi11, pi12), (pi21, pi22) = cfg.P_inv_matrix()
        zt = jnp.stack([pi11 * zeta[0] + pi12 * zeta[1],
                        pi21 * zeta[0] + pi22 * zeta[1]])
        solver = BatchedModalSolver(cfg.M, cfg.P, cfg.dx, (0.0, cfg.S_eig))
        pt = solver(zt)
        (p11, p12), (p21, p22) = cfg.back_projection_matrix()
        return jnp.stack([p11 * pt[0] + p12 * pt[1],
                          p21 * pt[0] + p22 * pt[1]])

    def _check(self, compat, dtype, M=64, P=96):
        from tpu_qg.config import ModelConfig
        from tpu_qg.constants import KM
        from tpu_qg.models.core import _build_packed_inverter

        cfg = ModelConfig(M=M, P=P, Lx=4000.0 * KM, Ly=6000.0 * KM,
                          dt=60.0, T=3600.0, dtype=dtype,
                          compat_reference_P=compat)
        rng = np.random.default_rng(7)
        zeta = jnp.asarray(rng.standard_normal((2, M, P)), cfg.dtype)
        want = np.asarray(self._reference_chain(cfg, zeta))
        got = np.asarray(_build_packed_inverter(cfg)(zeta))
        tol = 1e-12 if dtype == "float64" else 1e-5
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())

    def test_matches_chain_f64_compat(self):
        self._check(True, "float64")

    def test_matches_chain_f64_fixed_P(self):
        self._check(False, "float64")

    def test_matches_chain_f32(self):
        self._check(True, "float32")

    def test_residual_of_solution(self):
        """psi from the packed inverter satisfies the coupled discrete system:
        lap(psi_i) + S-coupling == zeta (up to the barotropic-mean gauge)."""
        from tpu_qg.config import ModelConfig
        from tpu_qg.constants import KM
        from tpu_qg.models.core import _build_packed_inverter
        from tpu_qg.ops.stencils import laplace_5p

        cfg = ModelConfig(M=48, P=64, Lx=4000.0 * KM, Ly=5333.0 * KM,
                          dt=60.0, T=3600.0, dtype="float64",
                          compat_reference_P=False)
        rng = np.random.default_rng(3)
        zeta = jnp.asarray(rng.standard_normal((2, 48, 64)), jnp.float64)
        psi = _build_packed_inverter(cfg)(zeta)
        lap = laplace_5p(psi, cfg.dx)
        z1 = lap[0] + cfg.S1_plus * (psi[1] - psi[0])
        z2 = lap[1] + cfg.S2_minus * (psi[0] - psi[1])
        got = np.stack([np.asarray(z1), np.asarray(z2)])
        # The zero-mean gauge kills the barotropic mean of zeta: compare
        # after removing each input field's projection onto that kernel mode.
        want = np.asarray(zeta)
        a, b = cfg.S1_plus, cfg.S2_minus
        bt_mean = (b * want[0].mean() + a * want[1].mean()) / (a + b)
        want = want - bt_mean
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 2e-6)])
@pytest.mark.parametrize("M,P", [(16, 16), (32, 48), (48, 32), (64, 64),
                                 (30, 42)])
def test_packed_inverter_matches_sparse_direct(M, P, dtype, tol):
    """The packed inversion (the single-device default, cuFFT on the GPU)
    against sparse direct solves of the same discrete operators in
    float64 (pinned-point gauge; psi compared gauge-normalized)."""
    from tpu_qg.config import ModelConfig
    from tpu_qg.constants import KM
    from tpu_qg.ops.spectral import PackedModalInverter

    cfg = ModelConfig(M=M, P=P, Lx=4000.0 * KM, Ly=4000.0 * KM * P / M,
                      dtype=dtype)
    rng = np.random.default_rng(M * P)
    zeta = rng.standard_normal((2, M, P)) * 1e-5
    zeta -= zeta.mean(axis=(1, 2), keepdims=True)
    got = np.asarray(PackedModalInverter(
        M, P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix())(jnp.asarray(zeta, dtype)))
    assert got.dtype == np.dtype(dtype)

    (q11, q12), (q21, q22) = cfg.P_inv_matrix()
    m1 = FactorizedSolver(M, P, cfg.dx, 0.0).solve(q11 * zeta[0]
                                                   + q12 * zeta[1])
    m2 = FactorizedSolver(M, P, cfg.dx, cfg.S_eig).solve(q21 * zeta[0]
                                                         + q22 * zeta[1])
    (b11, b12), (b21, b22) = cfg.back_projection_matrix()
    want = np.stack([b11 * m1 + b12 * m2, b21 * m1 + b22 * m2])
    got = got - got.mean(axis=(1, 2), keepdims=True)
    want = want - want.mean(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
