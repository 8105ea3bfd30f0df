"""Distributed geometric multigrid: the communication-avoiding elliptic solve.

The transposed-FFT inversion moves the whole field through all_to_alls
every step; a solve whose traffic is O(halo), not O(grid), avoids that.
This module is that solve: the V-cycle of tpu_qg.ops.multigrid
run on shard_map-local tiles with 1-cell ppermute halo exchanges
(tpu_qg.parallel.halo) at every level, and a tiny gathered coarse grid
solved redundantly on every device (deterministic replica — no broadcast).

Per-V-cycle traffic per device at level 0 extents (m_loc, p_loc):
roughly (nu1 + nu2 + 2) halo exchanges of perimeter slabs, summed over
levels (factor ~4/3) — at 8192^2 on 8 devices that is ~2 MB/cycle/device vs
the transposed FFT's ~192 MB/step/device of all_to_all payload. It works on
ANY (nx, ny) mesh: only tile-evenness gates coarsening, and the gather
cutoff absorbs ragged cases.

Reference counterpart: the per-step elliptic solve
(src/schemes/laplacian.jl:60-75 via src/model.jl:184-192) — same 5-point
system, communication-avoiding algorithm.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from ..ops.multigrid import (_coarse_spectral_solve, apply_helmholtz,
                             jacobi_smooth, modal_mix, prolong_bilinear,
                             restrict_full_weighting_padded)
from .halo import exchange_halo, make_padded_shift

_shift1 = make_padded_shift(1)


class DistributedMultigridSolver:
    """shard_map body solving (lap_5p + alpha_k) u_k = f_k on local
    (K, M/nx, P/ny) tiles of a (axis_x, axis_y) mesh.

    Usage:

        solve = jax.jit(jax.shard_map(
            DistributedMultigridSolver(M, P, dx, (0.0, S_eig), nx, ny),
            mesh=mesh, in_specs=(P(None, "x", "y"),),
            out_specs=P(None, "x", "y"), check_vma=False))

    Levels coarsen while both LOCAL tile extents stay even and the global
    extent stays above ``gather_cutoff``; below that the residual is
    all_gathered (a few kB) and solved spectrally on every device with the
    discrete eigenvalues, each device slicing back its own tile.
    """

    def __init__(self, M: int, P: int, dx: float, alphas: Sequence[float],
                 nx: int, ny: int, axis_x: str = "x", axis_y: str = "y",
                 n_cycles: int = 8, nu1: int = 2, nu2: int = 2,
                 omega: float = 0.8, gather_cutoff: int = 64):
        if M % nx or P % ny:
            raise ValueError(f"grid ({M}, {P}) not divisible by mesh "
                             f"({nx}, {ny})")
        self.M, self.P, self.dx = M, P, dx
        self.alphas = tuple(float(a) for a in alphas)
        self.nx, self.ny = nx, ny
        self.ax, self.ay = axis_x, axis_y
        self.n_cycles, self.nu1, self.nu2 = n_cycles, nu1, nu2
        self.omega = omega
        levels = []
        m, p, h = M, P, dx
        mloc, ploc = M // nx, P // ny
        while (mloc % 2 == 0 and ploc % 2 == 0
               and min(m, p) > gather_cutoff):
            levels.append((m, p, h))
            m, p, h = m // 2, p // 2, h * 2.0
            mloc, ploc = mloc // 2, ploc // 2
        self.levels = levels
        self.coarse = (m, p, h)             # gathered level (global extents)
        self.coarse_loc = (mloc, ploc)

    # -- helpers -----------------------------------------------------------

    def _alpha_col(self, dtype):
        return jnp.asarray(self.alphas, dtype).reshape(-1, 1, 1)

    def _pad1(self, u: Array) -> Array:
        return exchange_halo(u, 1, self.ax, self.ay)

    def _mean(self, f: Array) -> Array:
        """Global per-mode mean of an interior-local (K, m, p) block."""
        s = jnp.sum(f, axis=(-2, -1), keepdims=True)
        return lax.psum(s, (self.ax, self.ay)) / (self.M * self.P)

    # -- gathered coarse solve --------------------------------------------

    def _coarse_solve(self, f_loc: Array) -> Array:
        m, p, h = self.coarse
        mloc, ploc = self.coarse_loc
        K = f_loc.shape[0]
        g = f_loc
        if self.nx > 1:
            g = lax.all_gather(g, self.ax, axis=0)      # (nx, K, mloc, ploc)
            g = jnp.moveaxis(g, 0, 1).reshape(K, m, ploc)
        if self.ny > 1:
            g = lax.all_gather(g, self.ay, axis=0)      # (ny, K, m, ploc)
            g = jnp.moveaxis(g, 0, 2).reshape(K, m, p)
        u_g = _coarse_spectral_solve(g, m, p, h, self.alphas)
        ix = lax.axis_index(self.ax)
        iy = lax.axis_index(self.ay)
        zero = jnp.zeros((), ix.dtype)
        return lax.dynamic_slice(u_g, (zero, ix * mloc, iy * ploc),
                                 (K, mloc, ploc))

    # -- V-cycle -----------------------------------------------------------

    def _vcycle(self, lvl: int, u: Array, f: Array) -> Array:
        if lvl == len(self.levels):
            return self._coarse_solve(f)
        _, _, h = self.levels[lvl]
        a = self._alpha_col(u.dtype)
        for _ in range(self.nu1):
            u = jacobi_smooth(self._pad1(u), f, h, a, self.omega,
                              shift=_shift1)
        r = f - apply_helmholtz(self._pad1(u), h, a, shift=_shift1)
        rc = restrict_full_weighting_padded(self._pad1(r))
        ec = self._vcycle(lvl + 1, jnp.zeros_like(rc), rc)
        u = u + prolong_bilinear(self._pad1(ec), shift=_shift1)
        for _ in range(self.nu2):
            u = jacobi_smooth(self._pad1(u), f, h, a, self.omega,
                              shift=_shift1)
        return u

    def __call__(self, f: Array, x0: Optional[Array] = None) -> Array:
        singular = jnp.asarray([a == 0.0 for a in self.alphas],
                               f.dtype).reshape(-1, 1, 1)
        f = f - singular * self._mean(f)
        u = jnp.zeros_like(f) if x0 is None else x0
        for _ in range(self.n_cycles):
            u = self._vcycle(0, u, f)
        return u - singular * self._mean(u)


class DistributedMultigridInverter:
    """Full two-layer modal inversion (zeta -> psi) as a shard_map body:
    local P^{-1} projection, distributed batched V-cycles (Poisson +
    Helmholtz share every halo exchange), local back-projection.
    Drop-in distributed counterpart of MultigridModalInverter; works on
    any (nx, ny) mesh."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back, nx: int, ny: int,
                 axis_x: str = "x", axis_y: str = "y",
                 n_cycles: int = 8, nu1: int = 2, nu2: int = 2):
        self.solver = DistributedMultigridSolver(
            M, P, dx, (0.0, float(alpha2)), nx, ny, axis_x, axis_y,
            n_cycles=n_cycles, nu1=nu1, nu2=nu2)
        self.P_inv = np.asarray(P_inv)
        self.P_back = np.asarray(P_back)
        # psi = P_back @ modes, so warm-start seeds are P_back^{-1} @
        # psi_prev (P_inv differs under the compat_reference_P quirk —
        # see ops/multigrid.MultigridModalInverter).
        self.P_back_inv = np.linalg.inv(self.P_back)

    def __call__(self, zeta: Array,
                 psi_prev: Optional[Array] = None) -> Array:
        x0 = (None if psi_prev is None
              else modal_mix(self.P_back_inv, psi_prev))
        modes = self.solver(modal_mix(self.P_inv, zeta), x0=x0)
        return modal_mix(self.P_back, modes)
