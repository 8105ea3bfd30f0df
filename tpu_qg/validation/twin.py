"""Float64 NumPy twin of the reference algorithm — the equivalence oracle.

Implements exactly the algorithm of the reference (Arakawa + 5-point stencils,
Euler->AB3, modal inversion via *factorized sparse direct solves* in the
reference's pinned-point Poisson gauge, including the P_matrix(H_1, H_1)
back-projection quirk, reference: src/model.jl:173) but in NumPy/SciPy. It is
the serialized-golden-trajectory generator the JAX path is checked against
(SURVEY.md section 7.4): the JAX spectral path must match this twin allclose in
float64, which transitively matches the Julia reference up to
Cholesky-vs-LU roundoff.

Deliberately simple and allocation-happy — it is a correctness oracle, not a
performance path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..ops.operators import FactorizedSolver


def _lap(u: np.ndarray, dx: float) -> np.ndarray:
    """5-point periodic Laplacian (reference: src/schemes/laplacian.jl:15-27)."""
    return (
        np.roll(u, 1, 0) + np.roll(u, -1, 0) - 4.0 * u
        + np.roll(u, 1, 1) + np.roll(u, -1, 1)
    ) / (dx * dx)


def _cd_x(u: np.ndarray, dx: float) -> np.ndarray:
    """Centred x-difference (reference: src/model.jl:64-80)."""
    return (np.roll(u, -1, 0) - np.roll(u, 1, 0)) * (0.5 / dx)


def _arakawa(zeta: np.ndarray, psi: np.ndarray, dx: float) -> np.ndarray:
    """Arakawa Jacobian (reference: src/schemes/arakawa.jl:7-62)."""
    zxp, zxm = np.roll(zeta, -1, 0), np.roll(zeta, 1, 0)
    zyp, zym = np.roll(zeta, -1, 1), np.roll(zeta, 1, 1)
    pxp, pxm = np.roll(psi, -1, 0), np.roll(psi, 1, 0)
    pyp, pym = np.roll(psi, -1, 1), np.roll(psi, 1, 1)
    pxpyp, pxpym = np.roll(pxp, -1, 1), np.roll(pxp, 1, 1)
    pxmyp, pxmym = np.roll(pxm, -1, 1), np.roll(pxm, 1, 1)
    zxpyp, zxpym = np.roll(zxp, -1, 1), np.roll(zxp, 1, 1)
    zxmyp, zxmym = np.roll(zxm, -1, 1), np.roll(zxm, 1, 1)

    j_pp = (zxp - zxm) * (pyp - pym) - (zyp - zym) * (pxp - pxm)
    j_pt = (zxp * (pxpyp - pxpym) - zxm * (pxmyp - pxmym)
            - zyp * (pxpyp - pxmyp) + zym * (pxpym - pxmym))
    j_tp = (zxpyp * (pyp - pxp) - zxmym * (pxm - pym)
            - zxmyp * (pyp - pxm) + zxpym * (pxp - pym))
    return (j_pp + j_pt + j_tp) / (12.0 * dx * dx)


class ReferenceTwin:
    """Step-for-step float64 replica of the reference's evolve_zeta!/evolve_psi!
    loop (reference: src/run_model.jl:82-92)."""

    def __init__(self, cfg: ModelConfig):
        assert cfg.n_layers == 2, "the twin replicates the two-layer reference"
        self.cfg = cfg
        self.dx = cfg.dx
        self.poisson = FactorizedSolver(cfg.M, cfg.P, self.dx, 0.0)
        self.helmholtz = FactorizedSolver(cfg.M, cfg.P, self.dx, cfg.S_eig)
        # f_store slots: [layer][age] with age 0 = most recent stored tendency.
        self.f_store = np.zeros((2, 3, cfg.M, cfg.P))
        self.step_count = 0

    def init_state(self, psi_init: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """zeta from psi by definition (reference: src/model.jl:36-62)."""
        cfg = self.cfg
        psi = np.asarray(psi_init, np.float64).copy()
        zeta = np.empty_like(psi)
        zeta[0] = _lap(psi[0], self.dx) + cfg.S1_plus * (psi[1] - psi[0])
        zeta[1] = _lap(psi[1], self.dx) + cfg.S2_minus * (psi[0] - psi[1])
        return zeta, psi

    def _tendency(self, layer: int, zeta: np.ndarray, psi: np.ndarray
                  ) -> np.ndarray:
        cfg, dx = self.cfg, self.dx
        visc_term = cfg.visc * _lap(_lap(psi, dx), dx)
        j_term = _arakawa(zeta, psi, dx)
        if layer == 0:  # reference zeta_f1 (src/model.jl:139-145)
            return (visc_term - j_term - cfg.beta_1 * _cd_x(psi, dx)
                    - cfg.U * _cd_x(zeta, dx))
        # reference zeta_f2 (src/model.jl:147-153)
        return (visc_term - j_term - cfg.beta_2 * _cd_x(psi, dx)
                - cfg.r * _lap(psi, dx))

    def step(self, zeta: np.ndarray, psi: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        self.step_count += 1
        zeta_new = np.empty_like(zeta)
        # evolve_zeta! (reference: src/model.jl:155-170)
        for layer in (0, 1):
            f1 = self._tendency(layer, zeta[layer], psi[layer])
            self.f_store[layer, 1:] = self.f_store[layer, :-1]
            self.f_store[layer, 0] = f1
            if self.step_count <= 2:
                zeta_new[layer] = zeta[layer] + cfg.dt * f1
            else:
                f2 = self.f_store[layer, 1]
                f3 = self.f_store[layer, 2]
                zeta_new[layer] = zeta[layer] + cfg.dt * (
                    (23.0 / 12.0) * f1 - (16.0 / 12.0) * f2 + (5.0 / 12.0) * f3)

        # evolve_psi! (reference: src/model.jl:172-199)
        (pi11, pi12), (pi21, pi22) = cfg.P_inv_matrix()
        zt1 = pi11 * zeta_new[0] + pi12 * zeta_new[1]
        zt2 = pi21 * zeta_new[0] + pi22 * zeta_new[1]
        pt1 = self.poisson.solve(zt1)
        pt2 = self.helmholtz.solve(zt2)
        (p11, p12), (p21, p22) = cfg.back_projection_matrix()
        psi_new = np.stack([p11 * pt1 + p12 * pt2, p21 * pt1 + p22 * pt2])
        return zeta_new, psi_new

    def run(self, psi_init: np.ndarray, n_steps: int,
            sample_every: Optional[int] = None):
        """Run n_steps; if sample_every is set, also return sampled
        (zeta, psi) trajectories."""
        zeta, psi = self.init_state(psi_init)
        samples = []
        for i in range(n_steps):
            zeta, psi = self.step(zeta, psi)
            if sample_every and (i + 1) % sample_every == 0:
                samples.append((zeta.copy(), psi.copy()))
        if sample_every:
            return zeta, psi, samples
        return zeta, psi
