"""Geometric multigrid for the doubly-periodic 5-point Poisson/Helmholtz.

The communication-avoiding counterpart of the spectral inversion
(tpu_qg.ops.spectral): the transposed-FFT distributed solve moves the whole
field through all_to_all transposes every step. A geometric V-cycle on the
SAME discrete operator touches only O(1-cell halo) data per smoothing sweep,
so its distributed form (tpu_qg.parallel.multigrid) communicates a few
perimeter slabs per cycle instead of the full grid — the structural fix
BASELINE.json names.

Reference counterpart: the per-step elliptic solve — cached sparse Cholesky
backsolves of the SAME 5-point matrix (reference: src/schemes/laplacian.jl:60-75,
applied at src/model.jl:184-192). Because smoothing, residual, and coarse
solves all discretize (lap + alpha) with the standard 5-point stencil at
spacing 2^l * dx, the converged iterate solves the identical linear system
as the reference's factorization and the spectral inverter — multigrid is a
different *algorithm*, not a different *answer*.

Components (all shift-generic: the same bodies drive single-device
``jnp.roll`` and the sharded halo-padded shifts):

  * damped-Jacobi smoother (omega = 4/5 — the classic optimal 2-D 5-point
    smoothing weight; purely elementwise + 4 shifts, no red/black masking)
  * full-weighting restriction (period-preserving 9-point average)
  * bilinear prolongation (its transpose)
  * V(nu1, nu2)-cycles recursed to a small coarse grid solved spectrally
    with the discrete eigenvalues (tpu_qg.ops.spectral convention)

Gauge: the periodic Poisson problem (alpha == 0) is singular; this module
returns the zero-mean solution (the spectral-natural gauge — see
ops/spectral.py module docstring for the comparison with the reference's
pinned-point gauge).
"""

from __future__ import annotations

import functools
import operator
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


from .stencils import roll_shift


# ---------------------------------------------------------------------------
# Shift-generic level ops (stencils.py convention: every term including the
# center goes through shift(u, di, dj), so a halo-padded array + padded
# shift produces interior-shaped results — see tpu_qg/parallel/halo.py)


def apply_helmholtz(u: Array, dx: float, alpha, shift=roll_shift) -> Array:
    """(lap_5p + alpha) u at spacing dx; ``alpha`` may be a scalar or a
    per-mode vector broadcast over leading axes ((K, 1, 1)-shaped).

    DIFFERENCE form: sum of (neighbor - center), NOT sum(neighbors) - 4c.
    The two are algebraically equal; in f32 the latter rounds each add at
    eps*|4u| and the inverse operator amplifies that as 1/lambda_min low-k
    noise (~3e-4 relative at 2048^2 — observed as a V-cycle convergence
    plateau), while the difference form rounds at eps*|local difference|
    and the f32 solve then matches the spectral inverse to ~1e-6 relative.
    """
    inv_dx2 = 1.0 / (dx * dx)
    c = shift(u, 0, 0)
    lap = (((shift(u, 1, 0) - c) + (shift(u, -1, 0) - c))
           + ((shift(u, 0, 1) - c) + (shift(u, 0, -1) - c))) * inv_dx2
    return lap + alpha * c


def jacobi_smooth(u: Array, f: Array, dx: float, alpha, omega: float = 0.8,
                  shift=roll_shift) -> Array:
    """One damped-Jacobi sweep on (lap + alpha) u = f (``f`` interior-
    shaped; ``u`` may be halo-padded when ``shift`` is a padded shift),
    in residual-correction form (u' = u + omega (f - A u) / diag) so the
    cancellation-robust ``apply_helmholtz`` carries the stencil."""
    inv_dx2 = 1.0 / (dx * dx)
    diag = -4.0 * inv_dx2 + alpha
    c = shift(u, 0, 0)
    return c + omega * (f - apply_helmholtz(u, dx, alpha, shift)) / diag


_FW_KERNEL = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0


def _even_selector(block: int, dtype) -> Array:
    """(block, block//2) 0/1 matrix selecting even indices within a block,
    built from iotas at trace time."""
    r = jax.lax.broadcasted_iota(jnp.int32, (block, block // 2), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (block, block // 2), 1)
    return (r == 2 * c).astype(dtype)


def _halve_last(w: Array, block: int = 128) -> Array:
    """Even-index subsample of the LAST axis via a block-diagonal factored
    matmul: the axis viewed (..., p/block, block) hits a tiny
    (block, block/2) selector — even-index selection never crosses a block,
    so the dense (p, p/2) matrix factors exactly. O(p * block) flops. The
    selector is 0/1 at HIGHEST precision, so the result is exact."""
    *lead, p = w.shape
    block = min(block, p)
    sel = _even_selector(block, w.dtype)
    v = w.reshape(*lead, p // block, block)
    return jnp.einsum("...ab,bc->...ac", v, sel,
                      precision=jax.lax.Precision.HIGHEST).reshape(
                          *lead, p // 2)


def _halve_second_last(w: Array, block: int = 128) -> Array:
    """Even-index subsample of the SECOND-TO-LAST axis: transpose
    sandwich around the last-axis halving."""
    t = jnp.swapaxes(w, -1, -2)
    return jnp.swapaxes(_halve_last(t, block), -1, -2)


def _restrict_separable(w_rows_cols_weighted: Array) -> Array:
    """Subsample both axes of an already-[1,2,1]-weighted field."""
    return _halve_last(_halve_second_last(w_rows_cols_weighted))


def restrict_full_weighting(r: Array, shift=roll_shift) -> Array:
    """Full-weighting restriction to the half-resolution grid (coarse point
    (i, j) sits at fine (2i, 2j); periodic).

    Single-device path: the separable [1,2,1]/4 filters as rolls, then
    even-index subsampling as block-diagonal factored matmuls (selection
    within a 128 block never crosses blocks, so the (p, p/2) selector
    factors into I_{p/128} (x) S_128). The selectors are 0/1 matrices at
    HIGHEST precision, so the result is exact (identical values to the
    9-point stencil form).
    """
    if shift is roll_shift:
        wx = 0.25 * (shift(r, 1, 0) + shift(r, -1, 0)) + 0.5 * r
        w = 0.25 * (shift(wx, 0, 1) + shift(wx, 0, -1)) + 0.5 * wx
        return _restrict_separable(w)
    w = (4.0 * shift(r, 0, 0)
         + 2.0 * (shift(r, 1, 0) + shift(r, -1, 0)
                  + shift(r, 0, 1) + shift(r, 0, -1))
         + shift(r, 1, 1) + shift(r, 1, -1)
         + shift(r, -1, 1) + shift(r, -1, -1)) * (1.0 / 16.0)
    return w[..., ::2, ::2]


def restrict_full_weighting_padded(r_pad: Array) -> Array:
    """Full-weighting restriction of a 1-halo-padded (..., m+2, p+2) block
    (the sharded form: the halo replaces the periodic rolls; the factored
    subsample then runs on the interior-shaped weighted field)."""
    # Row filter on the full column extent (so the column filter sees its
    # y-halo), then the column filter, then the factored subsample.
    cy = r_pad[..., 1:-1, :]
    wxy = 0.25 * (r_pad[..., 2:, :] + r_pad[..., :-2, :]) + 0.5 * cy
    w = 0.25 * (wxy[..., 2:] + wxy[..., :-2]) + 0.5 * wxy[..., 1:-1]
    return _restrict_separable(w)


def _interleave_last(a: Array, b: Array, block: int = 64) -> Array:
    """out[..., 2j] = a[..., j], out[..., 2j+1] = b[..., j] via factored
    block-diagonal 0/1 expansion matmuls at HIGHEST precision (exact)."""
    *lead, q = a.shape
    block = min(block, q)
    r = jax.lax.broadcasted_iota(jnp.int32, (block, 2 * block), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (block, 2 * block), 1)
    E = (c == 2 * r).astype(a.dtype)
    O = (c == 2 * r + 1).astype(a.dtype)
    hi = jax.lax.Precision.HIGHEST
    va = a.reshape(*lead, q // block, block)
    vb = b.reshape(*lead, q // block, block)
    out = (jnp.einsum("...ab,bc->...ac", va, E, precision=hi)
           + jnp.einsum("...ab,bc->...ac", vb, O, precision=hi))
    return out.reshape(*lead, 2 * q)


def prolong_bilinear(uc: Array, shift=roll_shift) -> Array:
    """Bilinear prolongation to the double-resolution grid (transpose of
    full weighting up to the standard factor).

    Single-device path: separable — last-axis interleave (center,
    avg-right) via factored expansion matmuls, then the row interleave as
    the same op inside a transpose sandwich. Same values as the stacked
    form (fine[2i+1, 2j+1] composes to the 4-point average)."""
    if shift is roll_shift:
        right = shift(uc, 0, 1)
        wide = _interleave_last(uc, 0.5 * (uc + right))   # (..., mc, 2pc)
        down = shift(wide, 1, 0)                          # row i+1
        t = jnp.swapaxes(wide, -1, -2)
        td = jnp.swapaxes(0.5 * (wide + down), -1, -2)
        return jnp.swapaxes(_interleave_last(t, td), -1, -2)
    ctr = shift(uc, 0, 0)
    up = shift(uc, 1, 0)
    right = shift(uc, 0, 1)
    diag = shift(uc, 1, 1)
    a = ctr                                 # fine[2i,   2j]
    b = 0.5 * (ctr + up)                    # fine[2i+1, 2j]
    c = 0.5 * (ctr + right)                 # fine[2i,   2j+1]
    d = 0.25 * (ctr + up + right + diag)    # fine[2i+1, 2j+1]
    *lead, mc, pc = ctr.shape
    row_even = jnp.stack([a, c], axis=-1).reshape(*lead, mc, 2 * pc)
    row_odd = jnp.stack([b, d], axis=-1).reshape(*lead, mc, 2 * pc)
    return jnp.stack([row_even, row_odd], axis=-2).reshape(
        *lead, 2 * mc, 2 * pc)


# ---------------------------------------------------------------------------
# Coarse solve (spectral, discrete eigenvalues — tiny grids only)


def _coarse_spectral_solve(f: Array, M: int, P: int, dx: float,
                           alphas: Sequence[float]) -> Array:
    """Direct solve of (lap_5p + alpha_k) u_k = f_k on the (K, M, P) coarse
    grid via the discrete-eigenvalue inverse symbol (ops/spectral.py
    convention; zero-mean gauge for singular alpha == 0)."""
    k = np.arange(M)
    l = np.arange(P // 2 + 1)
    lam_x = (2.0 * np.cos(2.0 * np.pi * k / M) - 2.0) / (dx * dx)
    lam_y = (2.0 * np.cos(2.0 * np.pi * l / P) - 2.0) / (dx * dx)
    dtype = f.dtype
    f_hat = jnp.fft.rfft2(f, axes=(-2, -1))
    outs = []
    for i, a in enumerate(alphas):
        lam = (jnp.asarray(lam_x, dtype)[:, None]
               + jnp.asarray(lam_y, dtype)[None, :]
               + jnp.asarray(a, dtype))
        if a == 0.0:
            lam = lam.at[0, 0].set(1.0)
            inv = (1.0 / lam).at[0, 0].set(0.0)
        else:
            inv = 1.0 / lam
        outs.append(f_hat[i] * inv)
    u = jnp.fft.irfft2(jnp.stack(outs), s=(M, P), axes=(-2, -1))
    return u.astype(dtype)


# ---------------------------------------------------------------------------
# Single-device V-cycle solver


class MultigridSolver:
    """Batched V-cycle solver for (lap_5p + alpha_k) u_k = f_k, k stacked on
    the leading axis (K, M, P) — both QG modal solves (Poisson alpha=0 +
    modified Helmholtz alpha=S_eig) ride one cycle.

    ``n_cycles`` V(nu1, nu2)-cycles from ``x0`` (or zero). The measured
    per-cycle residual contraction is ~0.13-0.16 (tests/test_multigrid.py),
    so 8 cycles reach the f32 roundoff plateau from a cold start; a warm
    start from the previous timestep's psi needs ~4.
    """

    def __init__(self, M: int, P: int, dx: float, alphas: Sequence[float],
                 n_cycles: int = 8, nu1: int = 2, nu2: int = 2,
                 omega: float = 0.8, coarse_cutoff: int = 32):
        self.M, self.P, self.dx = M, P, dx
        self.alphas = tuple(float(a) for a in alphas)
        self.n_cycles, self.nu1, self.nu2 = n_cycles, nu1, nu2
        self.omega = omega
        # Level l has spacing dx * 2^l and extents (M >> l, P >> l);
        # coarsen while both extents are even and above the cutoff.
        levels = []
        m, p, h = M, P, dx
        while m % 2 == 0 and p % 2 == 0 and min(m, p) > coarse_cutoff:
            levels.append((m, p, h))
            m, p, h = m // 2, p // 2, h * 2.0
        self.levels = levels            # fine -> next-to-coarsest
        self.coarse = (m, p, h)

    def _alpha_col(self, dtype):
        return jnp.asarray(self.alphas, dtype).reshape(-1, 1, 1)

    def _smooth(self, lvl: int, u: Array, f: Array, nu: int) -> Array:
        """nu damped-Jacobi sweeps at a level."""
        _, _, h = self.levels[lvl]
        a = self._alpha_col(u.dtype)
        for _ in range(nu):
            u = jacobi_smooth(u, f, h, a, self.omega)
        return u

    def _vcycle(self, lvl: int, u: Array, f: Array) -> Array:
        if lvl == len(self.levels):
            m, p, h = self.coarse
            return _coarse_spectral_solve(f, m, p, h, self.alphas)
        _, _, h = self.levels[lvl]
        u = self._smooth(lvl, u, f, self.nu1)
        r = f - apply_helmholtz(u, h, self._alpha_col(u.dtype))
        rc = restrict_full_weighting(r)
        ec = self._vcycle(lvl + 1, jnp.zeros_like(rc), rc)
        u = u + prolong_bilinear(ec)
        return self._smooth(lvl, u, f, self.nu2)

    def __call__(self, f: Array, x0: Optional[Array] = None) -> Array:
        """Solve to ``n_cycles`` V-cycles; zero-mean gauge applied to
        singular (alpha == 0) components of both RHS (compatibility) and
        solution."""
        singular = jnp.asarray([a == 0.0 for a in self.alphas],
                               f.dtype).reshape(-1, 1, 1)
        f = f - singular * jnp.mean(f, axis=(-2, -1), keepdims=True)
        u = jnp.zeros_like(f) if x0 is None else x0
        for _ in range(self.n_cycles):
            u = self._vcycle(0, u, f)
        return u - singular * jnp.mean(u, axis=(-2, -1), keepdims=True)

    def residual_norm(self, u: Array, f: Array) -> Array:
        a = self._alpha_col(u.dtype)
        r = f - apply_helmholtz(u, self.dx, a)
        return jnp.sqrt(jnp.mean(r * r, axis=(-2, -1)))


def modal_mix(mat, x: Array) -> Array:
    """out[a] = sum_b mat[a][b] * x[b] for a small static matrix and a
    (K, M, P) stack, written as elementwise combinations. A contraction
    (einsum) would let the GPU run a float32 product in TF32; these are
    plain multiply-adds at the array's own precision."""
    K = len(mat)
    return jnp.stack([
        functools.reduce(operator.add,
                         [float(mat[i][j]) * x[j] for j in range(K)])
        for i in range(K)])


class MultigridModalInverter:
    """Full two-layer inversion (zeta -> psi) by multigrid: modal projection
    P^{-1}, batched V-cycles on (Poisson, Helmholtz), back-projection P.
    Same operator, same zero-mean gauge, same call signature family as the
    spectral inverters (reference chain: src/model.jl:172-199) — drop-in
    for correctness, communication-avoiding in its distributed form.

    ``warm_start=True`` lets the caller pass the previous step's psi; the
    modal projection of it seeds the V-cycles (the elliptic solution moves
    O(dt) per step, cutting cycles ~2x for the same tolerance).
    """

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back, n_cycles: int = 8, nu1: int = 2,
                 nu2: int = 2):
        self.solver = MultigridSolver(M, P, dx, (0.0, float(alpha2)),
                                      n_cycles=n_cycles, nu1=nu1, nu2=nu2)
        self.P_inv = np.asarray(P_inv)
        self.P_back = np.asarray(P_back)
        # Warm-start projection: psi = P_back @ modes, so the seed is
        # P_back^{-1} @ psi_prev — NOT P_inv @ psi_prev, which differs
        # whenever the reference's P(H1, H1) back-projection quirk is on
        # (compat_reference_P; see SURVEY.md section 0.1).
        self.P_back_inv = np.linalg.inv(self.P_back)

    def __call__(self, zeta: Array, psi_prev: Optional[Array] = None) -> Array:
        x0 = (None if psi_prev is None
              else modal_mix(self.P_back_inv, psi_prev))
        modes = self.solver(modal_mix(self.P_inv, zeta), x0=x0)
        return modal_mix(self.P_back, modes)
