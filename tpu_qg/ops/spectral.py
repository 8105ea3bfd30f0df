"""Spectral (fft2) elliptic inversion with the *discrete* 5-point eigenvalues.

Accelerator replacement for the reference's pre-factorized sparse Cholesky
backsolves (reference: src/schemes/laplacian.jl:60-75, used per-step at
src/model.jl:184-192). A direct sparse factorization is hostile to an
accelerator (serial triangular solves, scattered memory); the doubly-periodic
5-point Laplacian is diagonal in the DFT basis, so Poisson / modified-Helmholtz
solves become one fft2, a pointwise multiply, and one ifft2 — O(N log N),
and cuFFT on the GPU.

The transforms are complex-to-complex throughout. On the H100 the float32
real-to-complex pair (rfft2/irfft2) returned solutions whose high-wavenumber
part was 30-50x less accurate than the complex pair's at 2048^2-8192^2
(lap(psi) vs float64: 5.8e-5 vs 1.0e-6 at 8192^2), and the stencils of the
next step amplify exactly that part; on the CPU the two agree.

Crucially we divide by the eigenvalues of the *discrete* operator,

    lambda[k, l] = (2 cos(2 pi k / M) - 2 + 2 cos(2 pi l / P) - 2) / dx^2,

not the continuous symbol -(k^2 + l^2), so the solve matches the reference's
sparse solve (same matrix, different algorithm) to roundoff, including the
finite-difference dispersion error.

Gauge note: the periodic Poisson problem is singular (kernel = constants). The
reference pins one unknown to zero (reference: src/schemes/laplacian.jl:70-74,
src/model.jl:185); spectrally we zero the (0, 0) mode, i.e. return the zero-mean
solution. Both are valid gauges differing by a constant when the RHS is
compatible (zero-mean); ``gauge="pin"`` additionally subtracts u[0, 0] to
emulate the reference pointwise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


@dataclasses.dataclass(frozen=True)
class RectangularDomain:
    """Domain bounding box (reference: src/schemes/laplacian.jl:6-11)."""

    x1: float
    x2: float
    y1: float
    y2: float


def periodic_laplacian_eigenvalues(M: int, P: int, dx: float) -> np.ndarray:
    """Eigenvalues of the doubly-periodic discrete 5-point Laplacian on the
    rfft2 grid: shape (M, P // 2 + 1)."""
    k = np.arange(M)
    l = np.arange(P // 2 + 1)
    lam_x = (2.0 * np.cos(2.0 * np.pi * k / M) - 2.0) / (dx * dx)
    lam_y = (2.0 * np.cos(2.0 * np.pi * l / P) - 2.0) / (dx * dx)
    return lam_x[:, None] + lam_y[None, :]


def _eig_factors(M: int, P: int, dx: float):
    """1-D eigenvalue factors lam_x (M,), lam_y (P,) of the discrete
    Laplacian on the full fft grid — kept 1-D so the compiled program embeds
    only O(M + P) constants; the 2-D symbol is formed symbolically at trace
    time (a full (M, P) constant at 8192^2 is ~270 MB of HLO)."""
    k = np.arange(M)
    l = np.arange(P)
    lam_x = (2.0 * np.cos(2.0 * np.pi * k / M) - 2.0) / (dx * dx)
    lam_y = (2.0 * np.cos(2.0 * np.pi * l / P) - 2.0) / (dx * dx)
    return lam_x, lam_y


def _fft2(f: Array) -> Array:
    """Complex 2-D FFT over the last two axes, as two 1-D transforms: the
    same transform as ``jnp.fft.fft2``, in the form XLA's CPU backend also
    runs under GSPMD sharding (its fused 2-D FFT there rejects the
    partitioned layout)."""
    return jnp.fft.fft(jnp.fft.fft(f, axis=-1), axis=-2)


def _ifft2(f_hat: Array) -> Array:
    """Inverse of ``_fft2``."""
    return jnp.fft.ifft(jnp.fft.ifft(f_hat, axis=-2), axis=-1)


def _inv_symbol_2d(lam_x, lam_y, alpha: float, dtype) -> Array:
    """Symbolic (M, P) inverse symbol 1/(lam + alpha); for the singular
    alpha == 0 case the (0, 0) entry is set to 0 (zero-mean gauge)."""
    lam = (jnp.asarray(lam_x, dtype)[:, None]
           + jnp.asarray(lam_y, dtype)[None, :] + jnp.asarray(alpha, dtype))
    if alpha == 0.0:
        lam = lam.at[0, 0].set(1.0)
        inv = 1.0 / lam
        return inv.at[0, 0].set(0.0)
    return 1.0 / lam


class HelmholtzSolver:
    """Cached inverse-symbol solver for (laplacian + alpha) u = f.

    The counterpart of the reference's cached Cholesky factorizations
    (reference: src/schemes/laplacian.jl:60-75): construct once per (M, P, dx,
    alpha), apply every step. ``alpha=0`` gives the (gauge-fixed) Poisson solve.
    """

    def __init__(self, M: int, P: int, dx: float, alpha: float,
                 gauge: str = "zero_mean"):
        self.M, self.P, self.dx, self.alpha = M, P, dx, alpha
        self.gauge = gauge
        self.lam_x, self.lam_y = _eig_factors(M, P, dx)

    def __call__(self, f: Array) -> Array:
        """Solve (lap + alpha) u = f for u on an interior-only (..., M, P) array."""
        f_hat = _fft2(f)
        inv = _inv_symbol_2d(self.lam_x, self.lam_y, self.alpha,
                             f_hat.real.dtype)
        u = _ifft2(f_hat * inv).real.astype(f.dtype)
        if self.alpha == 0.0 and self.gauge == "pin":
            # Emulate the reference's pinned-point gauge (psi[0, 0] == 0).
            u = u - u[..., 0:1, 0:1]
        return u


class BatchedModalSolver:
    """Solve K independent (lap + alpha_k) u_k = f_k problems in ONE
    fft2/ifft2 pair over a stacked (K, M, P) input — one batched transform
    instead of per-mode HelmholtzSolver calls in the two-layer inversion
    (reference counterpart: the two backsolves in src/model.jl:184-192)."""

    def __init__(self, M: int, P: int, dx: float, alphas, gauge: str = "zero_mean"):
        self.M, self.P = M, P
        self.gauge = gauge
        self.alphas = tuple(alphas)
        self.lam_x, self.lam_y = _eig_factors(M, P, dx)

    def __call__(self, f: Array) -> Array:
        f_hat = _fft2(f)
        inv = jnp.stack([
            _inv_symbol_2d(self.lam_x, self.lam_y, a, f_hat.real.dtype)
            for a in self.alphas])
        u = _ifft2(f_hat * inv).real.astype(f.dtype)
        if self.gauge == "pin":
            for i, a in enumerate(self.alphas):
                if a == 0.0:
                    u = u.at[i].add(-u[i, 0, 0])
        return u


class PackedModalInverter:
    """Full two-layer inversion (zeta -> psi) in ONE complex fft2/ifft2 pair.

    The whole chain the reference performs in ``evolve_psi!`` (reference:
    src/model.jl:172-199) — modal projection P^{-1}, Poisson + modified-
    Helmholtz solves, back-projection P — is linear, so it is a single 2x2
    matrix G(k) = P_back @ diag(1/(lam+alpha_m)) @ P_inv acting per wavenumber
    on the layer spectra. Packing the two real layers as one complex field
    w = zeta_1 + i zeta_2 and Hermitian-splitting in spectral space
    (Z_m(k) from W(k) and conj(W(-k))) turns the entire inversion into

        W  = fft2(zeta_1 + i zeta_2)
        V  = A(k) W + B(k) conj(W(-k))
        psi_1 + i psi_2 = ifft2(V)

    with precomputed complex symbols A, B. Versus the batched solver
    this removes the physical-space modal projection and back-projection
    passes entirely, and replaces two half-spectrum transforms per direction with one full complex
    transform (identical flop count, fewer dispatches).

    Derivation: with Z1 = (W + W̄⁻)/2, Z2 = -i(W - W̄⁻)/2 (W̄⁻(k) := conj(W(-k)))
    and V = psi1_hat + i psi2_hat = c1(k) Z1 + c2(k) Z2 where
    c1 = u q11 inv1 + v q21 inv2, c2 = u q12 inv1 + v q22 inv2,
    u = p11 + i p21, v = p12 + i p22 (P_back = [[p11,p12],[p21,p22]],
    P_inv = [[q11,q12],[q21,q22]]), collecting W and W̄⁻ terms gives
    A = u(q11 - i q12)/2 inv1 + v(q21 - i q22)/2 inv2 and
    B = u(q11 + i q12)/2 inv1 + v(q21 + i q22)/2 inv2.

    Gauge: zero-mean only (inv1[0,0] = 0 removes the barotropic mean — the
    spectral-natural gauge; see module docstring).
    """

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back):
        self.M, self.P = M, P
        self.alpha2 = alpha2
        # 1-D eigenvalue factors; 2-D symbols are formed symbolically at
        # trace time (O(M + P) constants in the HLO).
        self.lam_x, self.lam_y = _eig_factors(M, P, dx)
        (q11, q12), (q21, q22) = P_inv
        (p11, p12), (p21, p22) = P_back
        u = p11 + 1j * p21
        v = p12 + 1j * p22
        self.a1 = complex(u * (q11 - 1j * q12) / 2.0)
        self.a2 = complex(v * (q21 - 1j * q22) / 2.0)
        self.b1 = complex(u * (q11 + 1j * q12) / 2.0)
        self.b2 = complex(v * (q21 + 1j * q22) / 2.0)

    def _symbols(self, real_dtype):
        cdtype = jnp.complex128 if real_dtype == jnp.float64 else jnp.complex64
        lam = (jnp.asarray(self.lam_x, real_dtype)[:, None]
               + jnp.asarray(self.lam_y, real_dtype)[None, :])
        inv1 = jnp.where(lam == 0.0, 0.0, 1.0 / jnp.where(lam == 0.0, 1.0, lam))
        inv2 = 1.0 / (lam + jnp.asarray(self.alpha2, real_dtype))
        A = (jnp.asarray(self.a1, cdtype) * inv1
             + jnp.asarray(self.a2, cdtype) * inv2)
        B = (jnp.asarray(self.b1, cdtype) * inv1
             + jnp.asarray(self.b2, cdtype) * inv2)
        return A, B

    def __call__(self, zeta: Array) -> Array:
        """(2, M, P) real zeta -> (2, M, P) real psi."""
        w = jax.lax.complex(zeta[0], zeta[1])
        W = jnp.fft.fft2(w, axes=(-2, -1))
        A, B = self._symbols(zeta.dtype)
        # conj(W(-k)): reverse both axes then roll by one (index 0 fixed).
        W_rev = jnp.roll(jnp.flip(jnp.conj(W), axis=(-2, -1)), (1, 1),
                         axis=(-2, -1))
        v = jnp.fft.ifft2(A * W + B * W_rev, axes=(-2, -1))
        return jnp.stack([v.real, v.imag]).astype(zeta.dtype)


class PackedModalInverterMatmul(PackedModalInverter):
    """PackedModalInverter with the fft2/ifft2 pair replaced by the
    matmul-factorized DFT (tpu_qg.ops.matmul_fft): the transforms become
    batched matmuls + twiddles and the spectral order stays permuted end
    to end — the symbols A, B are simply evaluated at the permuted
    frequencies, and conj(W(-k)) is structured flips on the (k1, k2) view.
    Off the default route; same math and gauge as the parent."""

    def __init__(self, M: int, P: int, dx: float, alpha2: float,
                 P_inv, P_back):
        super().__init__(M, P, dx, alpha2, P_inv, P_back)
        from .matmul_fft import MatmulFFT2, freq_order
        self._fft2 = MatmulFFT2(M, P)
        # Permute the 1-D eigenvalue factors into the transform's slot order.
        self.lam_x = self.lam_x[freq_order(M)]
        self.lam_y = self.lam_y[freq_order(P)]

    def __call__(self, zeta: Array) -> Array:
        w = jax.lax.complex(zeta[0], zeta[1])
        W = self._fft2.forward(w)
        A, B = self._symbols(zeta.dtype)
        W_rev = jnp.conj(self._fft2.negate_spectrum(W))
        v = self._fft2.inverse(A * W + B * W_rev)
        return jnp.stack([v.real, v.imag]).astype(zeta.dtype)


@functools.partial(jax.jit, static_argnames=("M", "P", "dx", "alpha", "gauge"))
def _solve(f, M, P, dx, alpha, gauge):
    return HelmholtzSolver(M, P, dx, alpha, gauge=gauge)(f)


def solve_helmholtz(f: Array, dx: float, alpha: float) -> Array:
    """One-shot modified-Helmholtz solve (lap + alpha) u = f, doubly periodic.

    Convenience parity with the reference's non-cached
    ``sp_solve_modified_helmholtz`` (reference: src/schemes/laplacian.jl:78-86).
    """
    M, P = f.shape[-2], f.shape[-1]
    return _solve(f, M, P, float(dx), float(alpha), "zero_mean")


def solve_poisson(f: Array, dx: float, gauge: str = "zero_mean") -> Array:
    """One-shot Poisson solve lap u = f, doubly periodic
    (reference: src/schemes/laplacian.jl:100-111, ``sp_solve_poisson``)."""
    M, P = f.shape[-2], f.shape[-1]
    return _solve(f, M, P, float(dx), 0.0, gauge)


def solve_helmholtz_fn(M: int, P: int, dx: float,
                       f_rhs: Callable[[float, float], float], alpha: float,
                       domain: RectangularDomain) -> Array:
    """Function-RHS modified-Helmholtz solve: sample f(x, y) on the periodic
    interior grid, then solve (reference: src/schemes/laplacian.jl:89-98 — the
    reference inflates on a ghost-extended grid; the interior sample points
    x_i = x1 + i*dx, y_j = y1 + j*dx for i in 0..M-1 are identical)."""
    xs = domain.x1 + dx * np.arange(M)
    ys = domain.y1 + dx * np.arange(P)
    b = np.asarray([[f_rhs(x, y) for y in ys] for x in xs])
    return solve_helmholtz(jnp.asarray(b), dx, alpha)
