"""Matmul-factorized DFT (tpu_qg.ops.matmul_fft) vs jnp.fft oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM
from tpu_qg.ops.matmul_fft import FactoredFFT, MatmulFFT2, freq_order, split_factor


def _randc(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape)
                       + 1j * rng.standard_normal(shape), jnp.complex64)


@pytest.mark.parametrize("N", [16, 128, 256, 2048, 96])
def test_forward_matches_fft(N):
    f = FactoredFFT(N)
    x = _randc((3, N), seed=N)
    got = np.asarray(f.forward(x, axis=-1))
    ref = np.asarray(jnp.fft.fft(x, axis=-1))[:, freq_order(N)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("N", [128, 2048])
def test_roundtrip(N):
    f = FactoredFFT(N)
    x = _randc((2, N), seed=N + 1)
    back = np.asarray(f.inverse(f.forward(x, axis=-1), axis=-1))
    np.testing.assert_allclose(back, np.asarray(x), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(x)).max())


def test_forward_axis_minus2():
    N = 256
    f = FactoredFFT(N)
    x = _randc((N, 64), seed=7)
    got = np.asarray(f.forward(x, axis=-2))
    ref = np.asarray(jnp.fft.fft(x, axis=-2))[freq_order(N), :]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("N", [16, 96, 2048])
def test_negate_spectrum(N):
    f = FactoredFFT(N)
    X = _randc((N,), seed=N + 2)
    got = np.asarray(f.negate_spectrum(X, axis=-1))
    # Oracle: map slots to frequencies, negate, map back.
    order = freq_order(N)
    inv_order = np.argsort(order)
    Xnat = np.asarray(X)[inv_order]                   # natural order
    Xneg_nat = Xnat[(-np.arange(N)) % N]
    ref = Xneg_nat[order]
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)


def test_fft2_matches():
    M, P = 256, 128
    f2 = MatmulFFT2(M, P)
    x = _randc((M, P), seed=11)
    got = np.asarray(f2.forward(x))
    ref = np.asarray(jnp.fft.fft2(x))
    ref = ref[np.ix_(freq_order(M), freq_order(P))]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    back = np.asarray(f2.inverse(f2.forward(x)))
    np.testing.assert_allclose(back, np.asarray(x), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(x)).max())


def test_split_factor():
    assert split_factor(2048) == (128, 16)
    assert split_factor(128) == (128, 1)
    assert split_factor(96) == (96, 1)
    assert split_factor(512) == (128, 4)


def test_packed_inverter_mxu_matches_fft_version():
    from tpu_qg.ops.spectral import PackedModalInverter, PackedModalInverterMatmul

    cfg = ModelConfig(M=256, P=128, Lx=4000.0 * KM, Ly=2000.0 * KM,
                      dt=60.0, T=3600.0, dtype="float32")
    args = (cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
            cfg.back_projection_matrix())
    ref_inv = PackedModalInverter(*args)
    mxu_inv = PackedModalInverterMatmul(*args)

    rng = np.random.default_rng(3)
    zeta = jnp.asarray(rng.standard_normal((2, cfg.M, cfg.P)), jnp.float32)
    ref = np.asarray(jax.jit(ref_inv)(zeta))
    got = np.asarray(jax.jit(mxu_inv)(zeta))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
