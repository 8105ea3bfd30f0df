"""Distributed spectral Helmholtz/Poisson solve via transposed FFTs.

The multi-device counterpart of tpu_qg.ops.spectral (which itself replaces the
reference's cached sparse Cholesky backsolves, reference:
src/schemes/laplacian.jl:60-75): on an (nx, ny) device mesh holding (m, p)
tiles of the global (M, P) grid, the solve is

  1. ``all_to_all`` over the y-ring     -> tiles become (m/ny, P) row strips
  2. local FFT along y
  3. ``all_to_all`` over the flattened (x, y) axes
                                        -> strips become (M, P/(nx*ny)) column strips
  4. local FFT along x, pointwise multiply by the inverse discrete symbol
     (same eigenvalues as tpu_qg.ops.spectral), local IFFT along x
  5. inverse transposes of (3) and (1), local IFFT along y

All data movement is all_to_all over the device interconnect (NCCL over
NVLink on a GPU host); all compute is local FFTs — the standard transposed
distributed FFT (SURVEY.md section 7.7). The transforms are complex to
complex, as in tpu_qg.ops.spectral (its module docstring says why): the
column strips divide evenly, at twice the bytes a real-to-complex y
transform would move through the big xy all_to_all.

Must be called inside shard_map over a mesh with axes (axis_x, axis_y).
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np
from jax import Array, lax


def transposes_divide(M: int, P: int, nx: int, ny: int) -> bool:
    """Whether an (nx, ny) mesh admits the transposes above: the tile rows
    (M/nx) split over the y-ring and P splits over all nx*ny devices."""
    return M % nx == 0 and (M // nx) % ny == 0 and P % (nx * ny) == 0


class DistributedHelmholtzSolver:
    """Batched multi-mode solve: (lap + alpha_k) u_k = f_k for local tiles
    f of shape (K, m, p), K = len(alphas). alpha_k == 0 selects the zero-mean
    Poisson gauge for that mode."""

    def __init__(self, M: int, P: int, dx: float, alphas: Sequence[float],
                 axis_x: str = "x", axis_y: str = "y"):
        self.M, self.P, self.dx = M, P, dx
        self.alphas = tuple(alphas)
        self.ax, self.ay = axis_x, axis_y
        k = np.arange(M)
        l = np.arange(P)
        self.lam_x = (2.0 * np.cos(2.0 * np.pi * k / M) - 2.0) / (dx * dx)
        self.lam_y = (2.0 * np.cos(2.0 * np.pi * l / P) - 2.0) / (dx * dx)

    def _inv_symbol(self, col_offset, width: int, dtype) -> Array:
        """(K, M, width) inverse symbol for the local column strip starting
        at traced ``col_offset``."""
        lam_x = jnp.asarray(self.lam_x, dtype)[None, :, None]
        lam_y = lax.dynamic_slice(jnp.asarray(self.lam_y, dtype),
                                  (col_offset,), (width,))[None, None, :]
        alphas = jnp.asarray(self.alphas, dtype)[:, None, None]
        denom = lam_x + lam_y + alphas

        # Zero-mean gauge for singular (alpha == 0) modes: zero out the
        # global (0, 0) Fourier coefficient.
        rows0 = (jnp.arange(self.M) == 0)[None, :, None]
        cols0 = (col_offset + jnp.arange(width) == 0)[None, None, :]
        singular = (alphas == 0.0) & rows0 & cols0
        denom = jnp.where(singular, 1.0, denom)
        return jnp.where(singular, 0.0, 1.0 / denom)

    def __call__(self, f: Array) -> Array:
        nx = lax.axis_size(self.ax)
        ny = lax.axis_size(self.ay)
        n = nx * ny
        K, m, p = f.shape
        assert K == len(self.alphas)
        if not (m * nx == self.M and p * ny == self.P
                and transposes_divide(self.M, self.P, nx, ny)):
            raise ValueError(
                f"grid ({self.M}, {self.P}) on mesh ({nx}, {ny}): tile rows "
                "must divide by ny and P by nx*ny for the transposes")

        # (1) y-transpose: (K, m, p) -> (K, m/ny, P) — moves REAL data.
        g = f
        if ny > 1:
            g = lax.all_to_all(g, self.ay, split_axis=1, concat_axis=2, tiled=True)
        # (2) FFT along y: (K, m/ny, P) complex.
        gh = jnp.fft.fft(g, axis=2)
        # (3) xy-transpose: (K, m/ny, P) -> (K, M, P/n)
        if n > 1:
            gh = lax.all_to_all(gh, (self.ax, self.ay), split_axis=2,
                                concat_axis=1, tiled=True)
        # (4) FFT along x, apply inverse symbol, IFFT along x.
        w = self.P // n
        q = lax.axis_index((self.ax, self.ay)) if n > 1 else 0
        uh = jnp.fft.fft(gh, axis=1)
        uh = uh * self._inv_symbol(q * w, w, f.dtype)
        u = jnp.fft.ifft(uh, axis=1)
        # (5) inverse transposes, inverse FFT along y.
        if n > 1:
            u = lax.all_to_all(u, (self.ax, self.ay), split_axis=1,
                               concat_axis=2, tiled=True)
        u = jnp.fft.ifft(u, axis=2).real
        if ny > 1:
            u = lax.all_to_all(u, self.ay, split_axis=2, concat_axis=1, tiled=True)
        return u.astype(f.dtype)
