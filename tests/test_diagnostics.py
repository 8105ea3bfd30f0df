"""Diagnostics and profiling utility tests."""

import numpy as np

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models import QGModel, init_state
from tpu_qg.utils.diagnostics import cfl_number, diagnostics, energy, enstrophy
from tpu_qg.utils.profiling import Timer


def _cfg():
    return ModelConfig(
        M=32, P=32, Lx=4000.0 * KM, Ly=4000.0 * KM,
        dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1, visc=100.0, r=1e-7,
        R_d=40.0 * KM, initial_kick=1e-6, dtype="float64",
    )


def test_energy_enstrophy_shapes_and_positivity():
    cfg = _cfg()
    state = init_state(_cfg())
    ke = np.asarray(energy(cfg, state.psi))
    ens = np.asarray(enstrophy(state.zeta))
    assert ke.shape == (2,) and ens.shape == (2,)
    assert (ke >= 0).all() and (ens >= 0).all()


def test_energy_analytic():
    """KE of psi = sin(kx) on a periodic grid: 0.5*mean((k_eff cos)^2)."""
    import jax.numpy as jnp

    cfg = _cfg()
    x = np.arange(cfg.M) * cfg.dx
    k = 2 * np.pi / cfg.Lx
    psi = np.broadcast_to(np.sin(k * x)[:, None], (2, cfg.M, cfg.P))
    ke = np.asarray(energy(cfg, jnp.asarray(psi)))
    # centred difference of sin(kx) has effective wavenumber sin(k dx)/dx
    k_eff = np.sin(k * cfg.dx) / cfg.dx
    expected = 0.5 * 0.5 * k_eff ** 2  # mean(cos^2) = 1/2
    np.testing.assert_allclose(ke, expected, rtol=1e-12)


def test_diagnostics_dict_and_cfl():
    cfg = _cfg()
    model = QGModel(cfg)
    state = model.run(init_state(cfg), 5)
    d = diagnostics(cfg, state)
    assert d["step"] == 5
    assert d["cfl"] >= 0 and np.isfinite(d["cfl"])
    assert set(d) >= {"cfl", "max_abs_zeta", "ke_1", "ke_2",
                      "enstrophy_1", "enstrophy_2"}
    assert float(cfl_number(cfg, state.psi)) == d["cfl"]


def test_timer_and_roofline():
    cfg = _cfg()
    t = Timer()
    with t.section("a"):
        sum(range(1000))
    assert "a" in t.times and t.times["a"] > 0
    assert "a" in t.report()
    # A section given a device result stops the clock only once the result
    # is ready; no bandwidth estimate is made without a device table.
    from tpu_qg.utils import profiling
    state = init_state(cfg, psi_init=np.zeros((2, cfg.M, cfg.P)))
    with t.section("b", result=state.zeta):
        pass
    assert t.times["b"] > 0
    assert not hasattr(profiling, "roofline_report")


def test_energy_spectrum_parseval():
    """sum_k E(k) equals the discrete KE quadratic form -0.5<psi lap psi>."""
    import jax.numpy as jnp
    from tpu_qg.ops.stencils import laplace_5p
    from tpu_qg.utils.diagnostics import energy_spectrum

    cfg = _cfg().replace(M=64, P=48, Ly=3000.0 * 1000.0)
    rng = np.random.default_rng(0)
    psi = rng.standard_normal((2, 64, 48))
    k, E = energy_spectrum(cfg, psi)
    ke = -0.5 * np.asarray(
        laplace_5p(jnp.asarray(psi), cfg.dx) * psi).mean(axis=(1, 2))
    np.testing.assert_allclose(E.sum(axis=1), ke, rtol=1e-12)
    assert (k > 0).all() and E.shape[0] == 2
