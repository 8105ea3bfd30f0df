"""Periodic finite-difference stencils as circular-shift expressions.

JAX re-design of the reference's ghost-ring stencil sweeps:
- 5-point Laplacian            (reference: src/schemes/laplacian.jl:15-27)
- centred x-difference         (reference: src/model.jl:64-80)
- Arakawa (1966) Jacobian      (reference: src/schemes/arakawa.jl:7-62)

The reference allocates a fresh array per op and runs serial @inbounds loops over
the interior, then refreshes a ghost ring. Here every stencil is a pure jnp
expression over circular shifts of interior-only (M, P) arrays, and XLA fuses
the shift+arith chains into a handful of elementwise kernels. On the interior, results are bit-identical in float64 to the
reference's ghost-ring formulation because the ghost cells always hold exact
periodic copies of the interior.

Axis convention (matches the reference): axis 0 = x (M nodes), axis 1 = y (P
nodes), same spacing dx in both directions (reference: src/run_model.jl:107-108).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
from jax import Array

# A shift primitive: shift(u, di, dj) returns the array whose [i, j] entry is
# u[i+di, j+dj]. Two implementations exist:
#   * roll_shift  — periodic wrap on a full-domain array (single device);
#     under GSPMD partitioning XLA lowers these rolls to collective permutes
#     of the boundary slabs automatically.
#   * padded_shift (tpu_qg.parallel.halo) — static slice into a halo-padded
#     local block (shard_map path).
Shift = Callable[[Array, int, int], Array]


def roll_shift(u: Array, di: int, dj: int) -> Array:
    """Periodic shift: result[i, j] = u[i+di, j+dj] with wrap-around."""
    if di:
        u = jnp.roll(u, -di, axis=-2)
    if dj:
        u = jnp.roll(u, -dj, axis=-1)
    return u


def laplace_5p_generic(shift: Shift, u: Array, dx: float) -> Array:
    """Five-point Laplacian over an arbitrary shift primitive
    (reference: src/schemes/laplacian.jl:15-27)."""
    inv_dx2 = 1.0 / (dx * dx)
    return (shift(u, -1, 0) + shift(u, 1, 0) - 4.0 * shift(u, 0, 0)
            + shift(u, 0, -1) + shift(u, 0, 1)) * inv_dx2


def centered_diff_x_generic(shift: Shift, u: Array, dx: float) -> Array:
    """Centred x-difference over an arbitrary shift primitive
    (reference: src/model.jl:64-80, ``cd``)."""
    return (0.5 / dx) * (shift(u, 1, 0) - shift(u, -1, 0))


def laplace_5p(u: Array, dx: float) -> Array:
    """Five-point Laplacian with doubly-periodic BCs.

    (u[i-1,j] + u[i+1,j] - 4 u[i,j] + u[i,j-1] + u[i,j+1]) / dx^2
    (reference: src/schemes/laplacian.jl:15-27).
    """
    return laplace_5p_generic(roll_shift, u, dx)


def centered_diff_x(u: Array, dx: float) -> Array:
    """Centred difference in x: (u[i+1,j] - u[i-1,j]) / (2 dx)
    (reference: src/model.jl:64-80, ``cd``)."""
    return centered_diff_x_generic(roll_shift, u, dx)


def arakawa_J_generic(shift: Shift, zeta: Array, psi: Array, dx: float) -> Array:
    """Arakawa Jacobian over an arbitrary shift primitive
    (reference: src/schemes/arakawa.jl:7-62)."""
    z_xp, z_xm = shift(zeta, 1, 0), shift(zeta, -1, 0)
    z_yp, z_ym = shift(zeta, 0, 1), shift(zeta, 0, -1)
    p_xp, p_xm = shift(psi, 1, 0), shift(psi, -1, 0)
    p_yp, p_ym = shift(psi, 0, 1), shift(psi, 0, -1)
    p_xpyp = shift(psi, 1, 1)
    p_xpym = shift(psi, 1, -1)
    p_xmyp = shift(psi, -1, 1)
    p_xmym = shift(psi, -1, -1)
    z_xpyp = shift(zeta, 1, 1)
    z_xpym = shift(zeta, 1, -1)
    z_xmyp = shift(zeta, -1, 1)
    z_xmym = shift(zeta, -1, -1)

    # J++ : centred flux form (reference: src/schemes/arakawa.jl:7-20).
    j_pp = (z_xp - z_xm) * (p_yp - p_ym) - (z_yp - z_ym) * (p_xp - p_xm)

    # J+x (reference: src/schemes/arakawa.jl:22-38).
    j_pt = (
        z_xp * (p_xpyp - p_xpym)
        - z_xm * (p_xmyp - p_xmym)
        - z_yp * (p_xpyp - p_xmyp)
        + z_ym * (p_xpym - p_xmym)
    )

    # Jx+ (reference: src/schemes/arakawa.jl:40-56).
    j_tp = (
        z_xpyp * (p_yp - p_xp)
        - z_xmym * (p_xm - p_ym)
        - z_xmyp * (p_yp - p_xm)
        + z_xpym * (p_xp - p_ym)
    )

    return (j_pp + j_pt + j_tp) / (12.0 * dx * dx)


def arakawa_J(zeta: Array, psi: Array, dx: float) -> Array:
    """Arakawa (1966) energy- and enstrophy-conserving Jacobian J(zeta, psi).

    Average of the three second-order discretizations
    (J++ + J+x + Jx+) / (12 dx^2) over a 9-point stencil
    (reference: src/schemes/arakawa.jl:7-62).
    """
    return arakawa_J_generic(roll_shift, zeta, psi, dx)
