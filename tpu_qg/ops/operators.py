"""Explicit sparse operator construction (validation / test parity layer).

Parity with the reference's Kronecker-assembled sparse operators
(reference: src/schemes/laplacian.jl:30-58) and its Cholesky solve path
(reference: src/schemes/laplacian.jl:60-111). These run on the host with
scipy.sparse and exist so that

  * the structural property tests of the reference (symmetry, definiteness,
    exact small matrices — reference: src/test.jl:219-276) carry over, and
  * the spectral solver can be validated against a direct factorized solve
    of the *same* discrete operator.

They are never on the device hot path.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def laplacian_1d(N: int) -> sp.csc_matrix:
    """Unscaled 1-D Dirichlet-style tridiagonal Laplacian
    (reference: src/schemes/laplacian.jl:30-32)."""
    return sp.diags(
        [np.ones(N - 1), -2.0 * np.ones(N), np.ones(N - 1)], [-1, 0, 1]
    ).tocsc()


def laplacian_2d(M: int, P: int) -> sp.csc_matrix:
    """2-D Laplacian via Kronecker sum (reference: src/schemes/laplacian.jl:34-38).

    Column-major (Fortran) vec convention to match the reference's Julia
    ``vec``/``reshape``: kron(I_P, Dx) + kron(Dy, I_M)."""
    Dx = laplacian_1d(M)
    Dy = laplacian_1d(P)
    return (sp.kron(sp.identity(P), Dx) + sp.kron(Dy, sp.identity(M))).tocsc()


def laplacian_1d_periodic(N: int) -> sp.csc_matrix:
    """1-D periodic Laplacian: tridiagonal plus wrap corners
    (reference: src/schemes/laplacian.jl:40-45)."""
    lap = laplacian_1d(N).tolil()
    lap[0, N - 1] = 1.0
    lap[N - 1, 0] = 1.0
    return lap.tocsc()


def laplacian_2d_doubly_periodic(M: int, P: int) -> sp.csc_matrix:
    """2-D doubly-periodic Laplacian via Kronecker sum
    (reference: src/schemes/laplacian.jl:47-51)."""
    Dx = laplacian_1d_periodic(M)
    Dy = laplacian_1d_periodic(P)
    return (sp.kron(sp.identity(P), Dx) + sp.kron(Dy, sp.identity(M))).tocsc()


def construct_spA(M: int, P: int, dx: float, alpha: float) -> sp.csc_matrix:
    """System matrix A = dx^-2 (L_periodic + alpha dx^2 I) for the modified
    Helmholtz problem (reference: src/schemes/laplacian.jl:53-58)."""
    A = laplacian_2d_doubly_periodic(M, P) + alpha * dx * dx * sp.identity(M * P)
    return (A / (dx * dx)).tocsc()


def gauge_fixed_poisson_matrix(M: int, P: int, dx: float) -> sp.csc_matrix:
    """-A with the first row/column replaced by an identity row — the
    reference's pinned-point gauge fix making the singular periodic Poisson
    system positive-definite (reference: src/schemes/laplacian.jl:66-75)."""
    A = (-construct_spA(M, P, dx, 0.0)).tolil()
    A[:, 0] = 0.0
    A[0, :] = 0.0
    A[0, 0] = 1.0
    return A.tocsc()


class FactorizedSolver:
    """Host-side cached direct solve of the same systems the reference
    factorizes once per run (reference: src/schemes/laplacian.jl:60-75,
    src/run_model.jl:61-62). Used as the validation oracle for the spectral
    solver and by the float64 reference twin."""

    def __init__(self, M: int, P: int, dx: float, alpha: float):
        self.M, self.P = M, P
        if alpha == 0.0:
            A = gauge_fixed_poisson_matrix(M, P, dx)
            self.pin = True
        else:
            A = (-construct_spA(M, P, dx, alpha)).tocsc()
            self.pin = False
        self._lu = spla.splu(A)

    def solve(self, f: np.ndarray) -> np.ndarray:
        """Solve (lap + alpha) u = f for an interior (M, P) field f, matching
        the reference's sign/vec conventions: b = -vec(f) column-major, with
        b[0] = 0 in the pinned Poisson case (reference: src/model.jl:185-192)."""
        b = -f.reshape(-1, order="F").astype(np.float64).copy()
        if self.pin:
            b[0] = 0.0
        u = self._lu.solve(b)
        return u.reshape((self.M, self.P), order="F")


def sp_solve_modified_helmholtz(f: np.ndarray, dx: float, alpha: float) -> np.ndarray:
    """One-shot direct modified-Helmholtz solve on an interior (M, P) RHS
    (reference: src/schemes/laplacian.jl:78-86)."""
    M, P = f.shape
    return FactorizedSolver(M, P, dx, alpha).solve(f)


def sp_solve_poisson(f: np.ndarray, dx: float) -> np.ndarray:
    """One-shot direct pinned-gauge Poisson solve
    (reference: src/schemes/laplacian.jl:100-111)."""
    M, P = f.shape
    return FactorizedSolver(M, P, dx, 0.0).solve(f)
