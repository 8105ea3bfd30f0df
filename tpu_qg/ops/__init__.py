"""Numerical kernels (the counterpart of the reference's src/schemes/).

All ops here work on *interior-only* (M, P) arrays with implicit doubly-periodic
boundary conditions via circular shifts — the reference's (M+2)x(P+2) ghost ring
(reference: src/schemes/boundary_conditions.jl) is not a storage concept on a
single chip; it reappears as halo exchange in tpu_qg.parallel for sharded grids.
"""

from .stencils import arakawa_J, centered_diff_x, laplace_5p  # noqa: F401
from .spectral import HelmholtzSolver, solve_helmholtz, solve_poisson  # noqa: F401
from . import boundary, operators  # noqa: F401
