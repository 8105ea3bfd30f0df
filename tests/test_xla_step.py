"""The XLA step against an independent float64 NumPy stepper.

The NumPy side uses the reference twin's stencils (tpu_qg.validation.twin)
and sparse direct solves of the same discrete operators
(tpu_qg.ops.operators.FactorizedSolver, pinned-point gauge), and implements
both time schemes, the wind forcing and the single-layer variant. It
covers the schemes and shapes the fused-kernel tests used to: square and
non-power-of-two rectangles, two-layer, wind-driven and barotropic.
Also: the elementwise modal mixing against a plain contraction."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models import QGModel
from tpu_qg.ops.multigrid import modal_mix
from tpu_qg.ops.operators import FactorizedSolver
from tpu_qg.validation.twin import _arakawa, _cd_x, _lap


def _cfg(variant, scheme, M, P):
    dx = 4000.0 * KM / M
    kw = dict(M=M, P=P, Lx=M * dx, Ly=P * dx, dt=60.0 * MINUTES,
              T=1.0 * YEAR, visc=100.0, r=1e-7, R_d=40.0 * KM,
              dtype="float64", time_scheme=scheme)
    if variant == "wind":
        kw["wind_tau0"] = 0.1
    if variant == "barotropic":
        kw.update(n_layers=1, U=0.0)
    return ModelConfig(**kw)


class NumpyStepper:
    """Float64 NumPy stepper: twin stencils, direct sparse solves."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.poisson = FactorizedSolver(cfg.M, cfg.P, cfg.dx, 0.0)
        if cfg.n_layers == 2:
            self.helmholtz = FactorizedSolver(cfg.M, cfg.P, cfg.dx,
                                              cfg.S_eig)
        y = np.arange(cfg.P) * cfg.dx
        amp = 2.0 * np.pi * cfg.wind_tau0 / (cfg.rho0 * cfg.H_1 * cfg.Ly)
        self.wind = -amp * np.sin(2.0 * np.pi * y / cfg.Ly)[None, :]

    def tendency(self, zeta, psi):
        c, dx = self.cfg, self.cfg.dx
        out = []
        for k in range(c.n_layers):
            t = (c.visc * _lap(_lap(psi[k], dx), dx)
                 - _arakawa(zeta[k], psi[k], dx))
            if c.n_layers == 1:
                t = (t - c.beta * _cd_x(psi[k], dx)
                     - c.U * _cd_x(zeta[k], dx) - c.r * _lap(psi[k], dx))
            elif k == 0:
                t = t - c.beta_1 * _cd_x(psi[k], dx) - c.U * _cd_x(zeta[k], dx)
            else:
                t = t - c.beta_2 * _cd_x(psi[k], dx) - c.r * _lap(psi[k], dx)
            if k == 0 and c.wind_tau0 != 0.0:
                t = t + self.wind
            out.append(t)
        return np.stack(out)

    def invert(self, zeta):
        c = self.cfg
        if c.n_layers == 1:
            return self.poisson.solve(zeta[0])[None]
        (q11, q12), (q21, q22) = c.P_inv_matrix()
        m1 = self.poisson.solve(q11 * zeta[0] + q12 * zeta[1])
        m2 = self.helmholtz.solve(q21 * zeta[0] + q22 * zeta[1])
        (b11, b12), (b21, b22) = c.back_projection_matrix()
        return np.stack([b11 * m1 + b12 * m2, b21 * m1 + b22 * m2])

    def run(self, zeta, psi, n):
        c, dt = self.cfg, self.cfg.dt
        f1 = f2 = np.zeros_like(zeta)
        for step in range(n):
            tend = self.tendency(zeta, psi)
            if c.time_scheme == "leapfrog_ra":
                prev = zeta if step == 0 else f1
                new = zeta + dt * tend if step == 0 else prev + 2 * dt * tend
                f1 = zeta + c.ra_filter * (prev - 2.0 * zeta + new)
            else:
                if step < 2:
                    new = zeta + dt * tend
                else:
                    new = zeta + dt * ((23.0 / 12.0) * tend
                                       - (16.0 / 12.0) * f1
                                       + (5.0 / 12.0) * f2)
                f1, f2 = tend, f1
            zeta = new
            psi = self.invert(zeta)
        return zeta, psi


def _gauge(psi):
    return psi - psi.mean(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("M,P", [(32, 32), (48, 40), (40, 24)])
@pytest.mark.parametrize("variant", ["two-layer", "wind", "barotropic"])
@pytest.mark.parametrize("scheme", ["euler_ab3", "leapfrog_ra"])
def test_xla_step_matches_numpy_f64(scheme, variant, M, P):
    cfg = _cfg(variant, scheme, M, P)
    rng = np.random.default_rng(M + P)
    psi0 = 40.0 * rng.standard_normal((cfg.n_layers, M, P))
    model = QGModel(cfg)
    state = model.init_state(psi_init=psi0)
    out = model.run(state, 12)
    assert out.zeta.dtype == jnp.float64 and int(out.step) == 12

    z_np, p_np = NumpyStepper(cfg).run(np.asarray(state.zeta), psi0, 12)
    zscale = np.abs(z_np).max()
    np.testing.assert_allclose(np.asarray(out.zeta), z_np, rtol=0,
                               atol=1e-9 * zscale)
    p_jn, p_nn = _gauge(np.asarray(out.psi)), _gauge(p_np)
    np.testing.assert_allclose(p_jn, p_nn, rtol=0,
                               atol=1e-9 * np.abs(p_nn).max())


def _matrices():
    cfg = ModelConfig()
    rng = np.random.default_rng(0)
    return {
        "P_inv": np.asarray(cfg.P_inv_matrix()),
        "P_back_compat": np.asarray(cfg.back_projection_matrix()),
        "P_back_inv": np.linalg.inv(np.asarray(cfg.back_projection_matrix())),
        "P_exact": np.asarray(cfg.replace(
            compat_reference_P=False).back_projection_matrix()),
        "random_3x3": rng.standard_normal((3, 3)),
    }


@pytest.mark.parametrize("name", sorted(_matrices()))
def test_modal_mix_matches_contraction(name):
    """modal_mix is the contraction out[a] = sum_b mat[a, b] x[b], written
    elementwise (no dot, hence no TF32 on the GPU), at the input's dtype."""
    mat = _matrices()[name]
    K = mat.shape[0]
    rng = np.random.default_rng(K)
    x = rng.standard_normal((K, 8, 12))
    got = modal_mix(mat, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got),
                               np.einsum("ab,bmp->amp", mat, x),
                               rtol=1e-14, atol=1e-14)
    got32 = modal_mix(mat, jnp.asarray(x, jnp.float32))
    assert got32.dtype == jnp.float32
    assert "dot" not in jax.jit(lambda v: modal_mix(mat, v)).lower(
        jnp.asarray(x, jnp.float32)).as_text()
