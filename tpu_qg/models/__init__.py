"""Model layer: state container, tendencies, time stepping, elliptic inversion.

Counterpart of the reference's src/model.jl.
"""

from .core import QGModel, State, init_state, make_step_fn  # noqa: F401
