"""Matmul-factorized DFT for the elliptic inversion.

The inversion only needs a *diagonalizing* transform, not the standard-order
FFT. A radix-(N1, N2) Cooley-Tukey factorization (decimation n = n1 + N1*n2)
expresses the N-point DFT as two batched small matmuls plus a twiddle
multiply (elementwise, fused by XLA):

    X[k2 + N2 k1] = sum_{n1} W_N^{n1 k2} W_{N1}^{n1 k1}
                    [ sum_{n2} x[n1 + N1 n2] W_{N2}^{n2 k2} ]

Layout discipline: the input reshapes to (..., n2, n1); the first matmul
contracts n2 (axis -2), the second contracts n1 (axis -1) — both are natural
stationary-matrix batched GEMMs, no transposes anywhere (an earlier
tensordot/moveaxis formulation spent 3.6x the XLA-FFT time in relayouts).

We keep the output in PERMUTED order — slot j = k2*N1 + k1 holds frequency
k2 + N2*k1 (`freq_order`) — and never pay the digit-reversal transpose: the
inverse transform consumes the same order, and spectral symbols are simply
evaluated at the permuted frequencies.

This exists purely as a speed alternative to jnp.fft inside
tpu_qg.ops.spectral.PackedModalInverter (reference counterpart: the cached
sparse Cholesky backsolves, src/schemes/laplacian.jl:60-75); the jnp.fft path
remains the default/oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

# Full float32 products: a lower precision lets the GPU run the DFT stages
# in TF32 (about three decimal digits), which the 1/lambda Poisson symbol
# then amplifies at low k.
_PREC = jax.lax.Precision.HIGHEST


def split_factor(N: int) -> tuple[int, int]:
    """N = N1 * N2 with N1 the largest divisor <= 128."""
    best = 1
    for f in range(1, min(128, N) + 1):
        if N % f == 0:
            best = f
    return best, N // best


def freq_order(N: int) -> np.ndarray:
    """freq_order(N)[j] = the frequency held in permuted slot j = k2*N1 + k1."""
    N1, N2 = split_factor(N)
    k2 = np.arange(N2)[:, None]
    k1 = np.arange(N1)[None, :]
    return (k2 + N2 * k1).reshape(N1 * N2)


def _dft(N: int, sign: int, dtype) -> np.ndarray:
    k = np.arange(N)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / N).astype(dtype)


def _twiddle(N2: int, N1: int, sign: int, dtype) -> np.ndarray:
    """tw[k2, n1] = W_N^{sign * n1 k2}, N = N1 * N2."""
    k2 = np.arange(N2)[:, None]
    n1 = np.arange(N1)[None, :]
    return np.exp(sign * 2j * np.pi * k2 * n1 / (N1 * N2)).astype(dtype)


class FactoredFFT:
    """Forward/inverse N-point DFT along the last or second-to-last axis,
    permuted spectral order (slot k2*N1 + k1 holds frequency k2 + N2*k1).

    forward: natural-order samples -> permuted-order spectrum (sign -1).
    inverse: permuted-order spectrum -> natural-order samples (sign +1, 1/N).
    """

    def __init__(self, N: int, dtype=np.complex64):
        self.N = N
        self.N1, self.N2 = split_factor(N)
        self.F1f = _dft(self.N1, -1, dtype)           # (k1, n1)
        self.F2f = _dft(self.N2, -1, dtype)           # (k2, n2)
        self.twf = _twiddle(self.N2, self.N1, -1, dtype)
        self.F1i = _dft(self.N1, +1, dtype) / self.N1
        self.F2i = _dft(self.N2, +1, dtype) / self.N2
        self.twi = _twiddle(self.N2, self.N1, +1, dtype)

    # -- shape plumbing -----------------------------------------------------
    def _split(self, x: Array, axis: int):
        """axis of length N -> (N2, N1) pair at (axis, axis+1)."""
        shape = list(x.shape)
        shape[axis:axis + 1] = [self.N2, self.N1]
        return x.reshape(shape)

    def _merge(self, x: Array, axis: int):
        shape = list(x.shape)
        shape[axis:axis + 2] = [self.N]
        return x.reshape(shape)

    @staticmethod
    def _bcast(m, ndim: int, a: int):
        """Reshape a 2-D constant to sit at axes (a, a+1) of an ndim tensor."""
        return jnp.asarray(m).reshape(
            (1,) * a + m.shape + (1,) * (ndim - a - 2))

    # -- transforms ----------------------------------------------------------
    def forward(self, x: Array, axis: int = -1) -> Array:
        """x natural order along ``axis`` (-1 or -2) -> permuted spectrum."""
        axis = axis % x.ndim
        y = self._split(x, axis)                      # (..., n2, n1[, P])
        a = axis
        if a == y.ndim - 2:                           # transform last axis
            # contract n2 at -2:  (k2, n2) x (..., n2, n1) -> (..., k2, n1)
            y = jnp.einsum("kn,...na->...ka", jnp.asarray(self.F2f), y,
                           precision=_PREC)
            y = y * self._bcast(self.twf, y.ndim, a)
            # contract n1 at -1:  (..., k2, n1) x (k1, n1) -> (..., k2, k1)
            y = jnp.einsum("...cn,kn->...ck", y, jnp.asarray(self.F1f),
                           precision=_PREC)
        elif a == y.ndim - 3:                         # transform -2 axis
            y = jnp.einsum("kn,...nap->...kap", jnp.asarray(self.F2f), y,
                           precision=_PREC)
            y = y * self._bcast(self.twf, y.ndim, a)
            y = jnp.einsum("...cnp,kn->...ckp", y, jnp.asarray(self.F1f),
                           precision=_PREC)
        else:
            raise ValueError("forward: axis must be -1 or -2")
        return self._merge(y, axis)

    def inverse(self, X: Array, axis: int = -1) -> Array:
        """Permuted-order spectrum along ``axis`` (-1 or -2) -> natural order."""
        axis = axis % X.ndim
        y = self._split(X, axis)                      # (..., k2, k1[, P])
        a = axis
        if a == y.ndim - 2:
            y = jnp.einsum("...ck,nk->...cn", y, jnp.asarray(self.F1i),
                           precision=_PREC)           # (..., k2, n1)
            y = y * self._bcast(self.twi, y.ndim, a)
            y = jnp.einsum("nc,...ca->...na", jnp.asarray(self.F2i), y,
                           precision=_PREC)           # (..., n2, n1)
        elif a == y.ndim - 3:
            y = jnp.einsum("...ckp,nk->...cnp", y, jnp.asarray(self.F1i),
                           precision=_PREC)
            y = y * self._bcast(self.twi, y.ndim, a)
            y = jnp.einsum("nc,...cap->...nap", jnp.asarray(self.F2i), y,
                           precision=_PREC)
        else:
            raise ValueError("inverse: axis must be -1 or -2")
        return self._merge(y, axis)

    def negate_spectrum(self, X: Array, axis: int = -1) -> Array:
        """X(k) -> X(-k mod N) in the permuted order, via structured flips
        on the (k2, k1) view (no gather): -(k2 + N2 k1) corresponds to
        k2' = (-k2) % N2 and k1' = (N1-1-k1) for k2 > 0, (-k1) % N1 for
        k2 == 0."""
        axis = axis % X.ndim
        y = self._split(X, axis)
        a = axis
        # k2 -> (-k2) % N2: flip then roll by one (slot 0 stays).
        y = jnp.roll(jnp.flip(y, axis=a), 1, axis=a)
        # k1 -> N1-1-k1 everywhere ...
        y = jnp.flip(y, axis=a + 1)
        # ... except the k2 == 0 plane, which needs (-k1) % N1 = roll(flip).
        idx = [slice(None)] * y.ndim
        idx[a] = slice(0, 1)
        plane = jnp.roll(y[tuple(idx)], 1, axis=a + 1)
        y = jax.lax.dynamic_update_slice_in_dim(y, plane, 0, axis=a)
        return self._merge(y, axis)


class MatmulFFT2:
    """2-D DFT over the last two axes with permuted spectral order on both."""

    def __init__(self, M: int, P: int, dtype=np.complex64):
        self.fx = FactoredFFT(M, dtype)
        self.fy = FactoredFFT(P, dtype)

    def forward(self, x: Array) -> Array:
        return self.fx.forward(self.fy.forward(x, axis=-1), axis=-2)

    def inverse(self, X: Array) -> Array:
        return self.fx.inverse(self.fy.inverse(X, axis=-1), axis=-2)

    def negate_spectrum(self, X: Array) -> Array:
        return self.fx.negate_spectrum(
            self.fy.negate_spectrum(X, axis=-1), axis=-2)


@functools.lru_cache(maxsize=None)
def _cached_fft2(M: int, P: int) -> MatmulFFT2:
    return MatmulFFT2(M, P)
