"""Plain reference of the two-layer QG step, independent of the program.

Written from the reference model's equations (JSLeadbetter/julia-ocean-
modelling, src/model.jl): the five-point Laplacian, the centred x
difference and the Arakawa (1966) Jacobian as periodic rolls; the layer
tendencies with biharmonic friction, shear-modified beta, the imposed
shear U on layer 1 and bottom drag on layer 2; Euler for the first two
steps and AB3 after; and the modal inversion: project with P^-1, solve a
Poisson (mode 1, zero-mean gauge) and a modified Helmholtz problem (mode 2)
with the discrete Laplacian's eigenvalues, project back with the
reference's P(H_1, H_1). Every constant is derived here from the numbers in
the configuration file; nothing is imported from ``tpu_qg``.

It runs in the precision it is given: float64 is the reference, and a lower
one (bfloat16) is the control that the comparison must refuse. bfloat16
fields go through the FFT in float32, the narrowest type the FFT takes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Physics(NamedTuple):
    """Constants of one configuration, derived from its ``model`` block."""

    M: int
    P: int
    dx: float
    dt: float
    U: float
    visc: float
    r: float
    beta_1: float
    beta_2: float
    alpha_2: float          # -1 / R_d^2, the baroclinic mode's shift
    p_inv: tuple            # ((q11, q12), (q21, q22))
    p_back: tuple           # ((p11, p12), (p21, p22))


def physics(model: dict) -> Physics:
    """Derived parameters (reference: src/model.jl:82-121)."""
    H1, H2 = model["H_1"], model["H_2"]
    ratio = 0.5 * (H1 + H2) / (model["R_d"] ** 2 * (1.0 / H1 + 1.0 / H2))
    s1 = 2.0 * ratio / (H1 * (H1 + H2))
    s2 = 2.0 * ratio / (H2 * (H1 + H2))
    inv = 1.0 / (s1 + s2)
    p_inv = ((inv * s2, inv * s1), (-inv * s2, inv * s2))
    # The reference builds the back-projection as P_matrix(H_1, H_1)
    # (src/model.jl:173); compat_reference_P keeps that.
    h2_back = H1 if model["compat_reference_P"] else H2
    p_back = ((1.0, -h2_back / H1), (1.0, 1.0))
    return Physics(
        M=model["M"], P=model["P"], dx=model["Lx"] / model["M"],
        dt=model["dt"], U=model["U"], visc=model["visc"], r=model["r"],
        beta_1=model["beta"] + s1 * model["U"],
        beta_2=model["beta"] - s2 * model["U"],
        alpha_2=-1.0 / model["R_d"] ** 2, p_inv=p_inv, p_back=p_back)


def _shift(u, di: int, dj: int):
    """u[i + di, j + dj] with periodic wrap."""
    return jnp.roll(u, (-di, -dj), axis=(-2, -1))


def laplacian(u, dx: float):
    return (_shift(u, 1, 0) + _shift(u, -1, 0) + _shift(u, 0, 1)
            + _shift(u, 0, -1) - 4.0 * u) / (dx * dx)


def ddx(u, dx: float):
    return (_shift(u, 1, 0) - _shift(u, -1, 0)) / (2.0 * dx)


def jacobian(z, p, dx: float):
    """Arakawa (1966): the mean of J++, J+x and Jx+ on the 9-point stencil."""
    s = _shift
    j_pp = ((s(z, 1, 0) - s(z, -1, 0)) * (s(p, 0, 1) - s(p, 0, -1))
            - (s(z, 0, 1) - s(z, 0, -1)) * (s(p, 1, 0) - s(p, -1, 0)))
    j_px = (s(z, 1, 0) * (s(p, 1, 1) - s(p, 1, -1))
            - s(z, -1, 0) * (s(p, -1, 1) - s(p, -1, -1))
            - s(z, 0, 1) * (s(p, 1, 1) - s(p, -1, 1))
            + s(z, 0, -1) * (s(p, 1, -1) - s(p, -1, -1)))
    j_xp = (s(z, 1, 1) * (s(p, 0, 1) - s(p, 1, 0))
            - s(z, -1, -1) * (s(p, -1, 0) - s(p, 0, -1))
            - s(z, -1, 1) * (s(p, 0, 1) - s(p, -1, 0))
            + s(z, 1, -1) * (s(p, 1, 0) - s(p, 0, -1)))
    return (j_pp + j_px + j_xp) / (12.0 * dx * dx)


def tendency(ph: Physics, zeta, psi):
    """d zeta / dt per layer (reference: src/model.jl:139-153)."""
    dx = ph.dx
    out = []
    for k, beta in enumerate((ph.beta_1, ph.beta_2)):
        z, p = zeta[k], psi[k]
        t = (ph.visc * laplacian(laplacian(p, dx), dx) - jacobian(z, p, dx)
             - beta * ddx(p, dx))
        t = t - (ph.U * ddx(z, dx) if k == 0 else ph.r * laplacian(p, dx))
        out.append(t)
    return jnp.stack(out).astype(zeta.dtype)


def _eigenvalues(ph: Physics, dtype):
    """The discrete Laplacian's eigenvalues, formed from 1-D constants so
    that the compiled program does not embed an (M, P) table."""
    kx = 2.0 * np.cos(2.0 * np.pi * np.arange(ph.M) / ph.M) - 2.0
    ky = 2.0 * np.cos(2.0 * np.pi * np.arange(ph.P) / ph.P) - 2.0
    kx, ky = jnp.asarray(kx, dtype), jnp.asarray(ky, dtype)
    return (kx[:, None] + ky[None, :]) / (ph.dx * ph.dx)


def invert(ph: Physics, zeta):
    """psi from zeta by modes (reference: src/model.jl:172-199)."""
    fdt = jnp.float64 if zeta.dtype == jnp.float64 else jnp.float32
    (q11, q12), (q21, q22) = ph.p_inv
    (p11, p12), (p21, p22) = ph.p_back
    m1 = q11 * zeta[0] + q12 * zeta[1]
    m2 = q21 * zeta[0] + q22 * zeta[1]
    lam = _eigenvalues(ph, fdt)
    zero = lam == 0.0
    inv1 = jnp.where(zero, 0.0, 1.0 / jnp.where(zero, 1.0, lam))
    inv2 = 1.0 / (lam + ph.alpha_2)

    def solve(f, inv_symbol):
        f_hat = jnp.fft.fft2(f.astype(fdt))
        return jnp.fft.ifft2(f_hat * inv_symbol).real.astype(zeta.dtype)

    s1, s2 = solve(m1, inv1), solve(m2, inv2)
    return jnp.stack([p11 * s1 + p12 * s2, p21 * s1 + p22 * s2]
                     ).astype(zeta.dtype)


def step(ph: Physics, state):
    """One step on (zeta, psi, f1, f2, n): Euler for n < 2, AB3 after."""
    zeta, psi, f1, f2, n = state
    t = tendency(ph, zeta, psi)
    ab3 = (23.0 / 12.0) * t - (16.0 / 12.0) * f1 + (5.0 / 12.0) * f2
    dz = ph.dt * jnp.where(n < 2, t, ab3)
    zeta = (zeta + dz).astype(zeta.dtype)
    return (zeta, invert(ph, zeta), t, f1, n + 1)


@functools.partial(jax.jit, static_argnums=(0, 2))
def run(ph: Physics, state, n_steps: int):
    """``n_steps`` steps from ``state`` (arrays of one dtype plus a step
    counter); returns the state after them."""
    def body(s, _):
        return step(ph, s), None
    out, _ = jax.lax.scan(body, state, None, length=n_steps)
    return out


def from_host(fields, n: int, dtype, device=None):
    """A reference state from host arrays (zeta, psi, f1, f2) and a step."""
    put = functools.partial(jax.device_put, device=device)
    return tuple(put(jnp.asarray(np.asarray(f), dtype)) for f in fields) + (
        put(jnp.asarray(n, jnp.int32)),)


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole field, in float64."""
    got = jnp.asarray(got, jnp.float64)
    want = jnp.asarray(want, jnp.float64)
    return float(jnp.linalg.norm((got - want).ravel())
                 / jnp.linalg.norm(want.ravel()))
