"""tpu_qg — two-layer quasi-geostrophic ocean solver in JAX.

A JAX/XLA framework with the capabilities of the reference Julia code
(JSLeadbetter/julia-ocean-modelling): the Phillips two-layer QG
baroclinic-instability model on a doubly-periodic beta-plane — Arakawa
Jacobian advection, Euler->AB3 stepping, modal Poisson/Helmholtz
streamfunction inversion — re-designed for accelerators rather than ported.
It runs on NVIDIA GPUs (one card or several) and on the CPU.

Layer map (mirrors SURVEY.md section 1):
    tpu_qg.ops       — numerical kernels (stencils, spectral and multigrid solves)
    tpu_qg.models    — physics/model layer (state, tendencies, stepping)
    tpu_qg.parallel  — device-mesh sharding, halo exchange, distributed solves
    tpu_qg.run       — drivers / CLI
    tpu_qg.io        — snapshots, checkpoints, resume
    tpu_qg.utils     — diagnostics, profiling, process set-up
    tpu_qg.validation — float64 NumPy twin of the reference (allclose oracle)
"""

__version__ = "0.1.0"

from .config import ModelConfig, preset  # noqa: F401
from .models.core import QGModel, State, init_state, make_step_fn  # noqa: F401
