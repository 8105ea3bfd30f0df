"""Ghost-ring utilities for reference-format interoperability.

The compute path stores interior-only (M, P) arrays (periodicity via
circular shifts / halo exchange), so these helpers exist purely for I/O parity
and for validating against the reference's (M+2)x(P+2) ghost-ring layout
(reference: src/schemes/boundary_conditions.jl:1-22).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def add_ghost_ring(u: Array) -> Array:
    """Embed an interior (..., M, P) array into (..., M+2, P+2) with periodic
    ghost cells (reference: src/schemes/boundary_conditions.jl:15-22,
    ``add_doubly_periodic_boundaries``)."""
    return jnp.pad(u, [(0, 0)] * (u.ndim - 2) + [(1, 1), (1, 1)], mode="wrap")


def strip_ghost_ring(u: Array) -> Array:
    """Drop the one-cell ghost ring: (..., M+2, P+2) -> (..., M, P)."""
    return u[..., 1:-1, 1:-1]


def update_ghost_ring(u: Array) -> Array:
    """Refresh the ghost ring of an (..., M+2, P+2) array from its interior
    (functional analog of the reference's in-place
    ``update_doubly_periodic_bc!``, src/schemes/boundary_conditions.jl:1-13)."""
    return add_ghost_ring(strip_ghost_ring(u))
