"""Parallel layer: device meshes, sharded stepping, halo exchange.

The reference is a single-core sequential program with no parallelism of any
kind (SURVEY.md section 2, parallelism inventory). This package is the
counterpart created from scratch: 2-D spatial domain decomposition
of the (M, P) grid over a ``jax.sharding.Mesh`` — the structural analog of
DP+SP for this workload — with two implementations:

  * ``gspmd``     — global-array programming: jit + sharding constraints; XLA
    partitions the rolls into collective permutes and handles the FFT. The
    simple, always-correct path.
  * ``halo``      — explicit shard_map halo exchange via ``jax.lax.ppermute``
    with a transposed distributed FFT (``all_to_all``) for the elliptic solve.
    The tuned scaling path.
"""

from .mesh import make_mesh  # noqa: F401
from .gspmd import make_sharded_step_fn, shard_state  # noqa: F401
from .stepper import make_halo_step_fn  # noqa: F401
