"""End-to-end model tests: JAX path vs float64 reference twin, and regression
properties the reference lacks (SURVEY.md section 4 gap-filling)."""

import jax
import numpy as np
import pytest

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models import QGModel, init_state
from tpu_qg.validation import ReferenceTwin


def small_cfg(**kw):
    base = dict(
        H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11,
        Lx=4000.0 * KM, Ly=4000.0 * KM,
        dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
        M=32, P=32, visc=100.0, r=1e-7, R_d=40.0 * KM,
        initial_kick=1e-6, dtype="float64",
    )
    base.update(kw)
    return ModelConfig(**base)


def _psi_init(cfg, seed=0):
    rng = np.random.default_rng(seed)
    amp = cfg.initial_kick * cfg.U * cfg.Ly
    return amp * rng.random((2, cfg.M, cfg.P))


def test_allclose_vs_reference_twin_500_steps():
    """The jitted spectral-inversion scan matches the float64 NumPy twin (the
    reference algorithm with factorized direct solves, pinned gauge, and the
    P(H_1, H_1) quirk) to tight tolerance after 500 AB3 steps from identical
    ICs. This is the miniature of BASELINE config 3's 10k-step allclose."""
    cfg = small_cfg()
    psi0 = _psi_init(cfg)

    twin = ReferenceTwin(cfg)
    z_ref, p_ref = twin.run(psi0, 500)

    model = QGModel(cfg)
    state = model.init_state(psi_init=psi0)
    out = model.run(state, 500)

    np.testing.assert_allclose(np.asarray(out.zeta), z_ref, rtol=1e-5, atol=1e-18)
    # psi differs by the Poisson gauge constant per layer; compare mean-removed.
    p_ours = np.asarray(out.psi)
    p_ours = p_ours - p_ours.mean(axis=(1, 2), keepdims=True)
    p_ref = p_ref - p_ref.mean(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(p_ours, p_ref, rtol=1e-5, atol=1e-12)


def test_pin_gauge_matches_twin_psi_pointwise():
    """With poisson_gauge='pin', even psi matches the twin pointwise."""
    cfg = small_cfg(poisson_gauge="pin")
    psi0 = _psi_init(cfg, seed=1)
    twin = ReferenceTwin(cfg)
    z_ref, p_ref = twin.run(psi0, 100)
    model = QGModel(cfg)
    out = model.run(model.init_state(psi_init=psi0), 100)
    np.testing.assert_allclose(np.asarray(out.psi), p_ref, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.zeta), z_ref, rtol=1e-6, atol=1e-18)


def test_init_state_matches_reference_definition():
    """zeta_i = lap(psi_i) + S_i (psi_other - psi_i) at t=0
    (reference: src/model.jl:47-48)."""
    cfg = small_cfg()
    psi0 = _psi_init(cfg, seed=2)
    state = init_state(cfg, psi_init=psi0)
    twin = ReferenceTwin(cfg)
    z_ref, _ = twin.init_state(psi0)
    np.testing.assert_allclose(np.asarray(state.zeta), z_ref, atol=1e-18)


def test_euler_then_ab3_switch():
    """Steps 1-2 are Euler, step 3+ AB3 (reference: src/model.jl:160-170): a
    3-step run must equal the twin step-for-step."""
    cfg = small_cfg()
    psi0 = _psi_init(cfg, seed=3)
    twin = ReferenceTwin(cfg)
    zeta, psi = twin.init_state(psi0)
    model = QGModel(cfg)
    state = model.init_state(psi_init=psi0)
    for i in range(3):
        zeta, psi = twin.step(zeta, psi)
        state = model.step(state)
        np.testing.assert_allclose(np.asarray(state.zeta), zeta, rtol=1e-9,
                                   atol=1e-19, err_msg=f"step {i+1}")


def test_run_trajectory_sampling():
    cfg = small_cfg()
    model = QGModel(cfg)
    state = model.init_state(psi_init=_psi_init(cfg, seed=4))
    final, zs, ps = model.run_trajectory(state, 20, 5)
    assert zs.shape == (4, 2, cfg.M, cfg.P)
    assert ps.shape == (4, 2, cfg.M, cfg.P)
    assert int(final.step) == 20
    # last sample == final state
    np.testing.assert_array_equal(np.asarray(zs[-1]), np.asarray(final.zeta))


def test_mean_zeta_invariant():
    """All tendency terms are discrete divergences: the domain mean of zeta is
    conserved exactly (the property that keeps the barotropic-mode Poisson RHS
    compatible; see SURVEY.md section 0 quirk 3 discussion)."""
    cfg = small_cfg()
    model = QGModel(cfg)
    state = model.init_state(psi_init=_psi_init(cfg, seed=5))
    m0 = np.asarray(state.zeta).mean(axis=(1, 2))
    out = model.run(state, 200)
    m1 = np.asarray(out.zeta).mean(axis=(1, 2))
    np.testing.assert_allclose(m0, m1, rtol=0, atol=1e-17)


def test_barotropic_model_runs():
    """Single-layer barotropic QG (BASELINE config 1): zeta = lap(psi),
    Poisson-only inversion."""
    cfg = small_cfg(n_layers=1, U=0.0, M=64, P=64, r=0.0)
    model = QGModel(cfg)
    state = model.init_state(key=jax.random.PRNGKey(0))
    assert state.zeta.shape == (1, 64, 64)
    out = model.run(state, 50)
    assert np.isfinite(np.asarray(out.zeta)).all()
    # inversion consistency: lap(psi) == zeta - mean(zeta)
    from tpu_qg.ops.stencils import laplace_5p
    lap = np.asarray(laplace_5p(out.psi, cfg.dx))
    z = np.asarray(out.zeta)
    np.testing.assert_allclose(lap, z - z.mean(axis=(1, 2), keepdims=True),
                               atol=1e-18 + 1e-8 * np.abs(z).max())


def test_float32_path_runs_and_tracks_f64():
    """The f32 speed path stays close to f64 over a short horizon."""
    cfg64 = small_cfg()
    cfg32 = small_cfg(dtype="float32")
    psi0 = _psi_init(cfg64, seed=6)
    out64 = QGModel(cfg64).run(init_state(cfg64, psi_init=psi0), 20)
    out32 = QGModel(cfg32).run(init_state(cfg32, psi_init=psi0), 20)
    z64 = np.asarray(out64.zeta)
    z32 = np.asarray(out32.zeta, np.float64)
    denom = np.abs(z64).max()
    assert np.abs(z32 - z64).max() / denom < 1e-4


def test_rectangular_grid():
    """Non-square M != P grids work end to end (production is 512x256)."""
    cfg = small_cfg(M=32, P=16, Lx=4000.0 * KM, Ly=2000.0 * KM)
    psi0 = _psi_init(cfg, seed=7)
    twin = ReferenceTwin(cfg)
    z_ref, _ = twin.run(psi0, 50)
    out = QGModel(cfg).run(init_state(cfg, psi_init=psi0), 50)
    np.testing.assert_allclose(np.asarray(out.zeta), z_ref, rtol=1e-6, atol=1e-18)


def test_random_init_reproducible():
    cfg = small_cfg()
    s1 = init_state(cfg, key=jax.random.PRNGKey(42))
    s2 = init_state(cfg, key=jax.random.PRNGKey(42))
    np.testing.assert_array_equal(np.asarray(s1.psi), np.asarray(s2.psi))
