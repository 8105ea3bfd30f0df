"""The generic halo stepper — the path the multi-card presets run — against
the single-device step, over mesh shapes and model variants, on the
virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models import QGModel, init_state
from tpu_qg.models.core import make_step_fn
from tpu_qg.parallel import make_mesh, shard_state
from tpu_qg.parallel.stepper import make_halo_run_fn

VARIANTS = {
    "ab3": dict(),
    "leapfrog-wind": dict(time_scheme="leapfrog_ra", wind_tau0=0.1),
    "barotropic": dict(n_layers=1, U=0.0),
    "multigrid": dict(M=128, P=128, elliptic_impl="multigrid", mg_cycles=10),
}


def _cfg(**kw):
    base = dict(M=64, P=64, Lx=4000.0 * KM, Ly=4000.0 * KM,
                dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1, visc=100.0, r=1e-7,
                R_d=40.0 * KM, initial_kick=1e-6, dtype="float64")
    base.update(kw)
    return ModelConfig(**base)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh_shape", [(4, 1), (1, 4), (2, 2), (2, 1),
                                        (8, 1)])
def test_halo_run_matches_single_device(mesh_shape, variant):
    """Five steps through make_halo_run_fn (what run_model(mesh=...) runs)
    agree with the single-device per-mode step. The spectral route solves
    the same system with the same transforms: f64 roundoff. Multigrid
    iterates to convergence (10 cycles): 1e-7."""
    cfg = _cfg(**VARIANTS[variant])
    rng = np.random.default_rng(3)
    amp = cfg.initial_kick * 0.1 * cfg.Ly
    psi0 = amp * rng.random((cfg.n_layers, cfg.M, cfg.P))

    step = jax.jit(make_step_fn(cfg.replace(elliptic_impl="spectral"),
                                batched_fft=False))
    ref = init_state(cfg, psi_init=psi0)
    for _ in range(5):
        ref = step(ref)

    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    run = make_halo_run_fn(cfg, mesh)
    out = run(shard_state(QGModel(cfg).init_state(psi_init=psi0), mesh), 5)
    assert int(out.step) == 5
    assert tuple(out.zeta.sharding.spec) == (None, "x", "y")
    tol = 1e-7 if variant == "multigrid" else 1e-12
    for name in ("zeta", "psi"):
        a, b = np.asarray(getattr(out, name)), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(),
                                   err_msg=name)
