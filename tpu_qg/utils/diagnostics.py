"""Physics diagnostics: energy, enstrophy, CFL — jitted reductions.

The reference has no conservation diagnostics at all (its ``update_max/min``
helpers are dead code, reference: src/run_model.jl:41-53); validation of full
runs was done visually (SURVEY.md section 4). These are the structured
per-interval scalars this build logs instead — cheap on the device as fused
reductions.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
from jax import Array

from ..config import ModelConfig
from ..ops.stencils import centered_diff_x


def _grad_sq(psi: Array, dx: float) -> Array:
    """|grad psi|^2 with centred differences, per layer."""
    dpx = centered_diff_x(psi, dx)
    dpy = jnp.swapaxes(centered_diff_x(jnp.swapaxes(psi, -1, -2), dx), -1, -2)
    return dpx * dpx + dpy * dpy


def energy(cfg: ModelConfig, psi: Array) -> Array:
    """Kinetic energy per layer: 0.5 * mean(|grad psi|^2), shape (L,)."""
    return 0.5 * jnp.mean(_grad_sq(psi, cfg.dx), axis=(-2, -1))


def enstrophy(zeta: Array) -> Array:
    """Potential enstrophy per layer: 0.5 * mean(zeta^2), shape (L,)."""
    return 0.5 * jnp.mean(zeta * zeta, axis=(-2, -1))


def cfl_number(cfg: ModelConfig, psi: Array) -> Array:
    """Advective CFL: max(|u|) * dt / dx with u = |grad psi| (plus the mean
    flow U on layer 1)."""
    speed = jnp.sqrt(jnp.max(_grad_sq(psi, cfg.dx)))
    return (speed + abs(cfg.U)) * cfg.dt / cfg.dx


@jax.jit
def _max_abs(x):
    return jnp.max(jnp.abs(x))


def energy_spectrum(cfg: ModelConfig, psi: Array):
    """Isotropic kinetic-energy spectrum per layer.

    E(k) summed over circular wavenumber-magnitude bins, using the discrete
    Laplacian symbol so that sum(E) equals the discrete KE. Returns
    (k_bins [1/m], E [L, n_bins]). Host-side analysis helper (np)."""
    import numpy as np

    psi = np.asarray(psi)
    L_ax, M, P = psi.shape
    psi_hat = np.fft.rfft2(psi, axes=(-2, -1)) / (M * P)
    # discrete |grad|^2 symbol = -lambda
    from ..ops.spectral import periodic_laplacian_eigenvalues
    lam = -periodic_laplacian_eigenvalues(M, P, cfg.dx)  # >= 0
    # rfft double-counts interior columns once unfolded; weight them x2.
    w = np.full(lam.shape, 2.0)
    w[:, 0] = 1.0
    if P % 2 == 0:
        w[:, -1] = 1.0
    E2d = 0.5 * lam[None] * np.abs(psi_hat) ** 2 * w[None]

    kx = np.fft.fftfreq(M, d=cfg.dx) * 2.0 * np.pi
    ky = np.fft.rfftfreq(P, d=cfg.dx) * 2.0 * np.pi
    kmag = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    dk = 2.0 * np.pi / max(cfg.Lx, cfg.Ly)
    n_bins = int(kmag.max() / dk) + 1
    idx = np.minimum((kmag / dk).astype(int), n_bins - 1)
    E = np.zeros((L_ax, n_bins))
    for layer in range(L_ax):
        np.add.at(E[layer], idx.ravel(), E2d[layer].ravel())
    k_bins = (np.arange(n_bins) + 0.5) * dk
    return k_bins, E


@functools.partial(jax.jit, static_argnums=(0,))
def _diag_arrays(cfg: ModelConfig, zeta: Array, psi: Array):
    """All diagnostic reductions in one compiled program (one dispatch
    instead of one per reduction)."""
    return (energy(cfg, psi), enstrophy(zeta), cfl_number(cfg, psi),
            jnp.max(jnp.abs(zeta)))


def diagnostics(cfg: ModelConfig, state) -> Dict[str, float]:
    """Scalar diagnostic dict for logging (host-side)."""
    ke, ens, cfl, mz = _diag_arrays(cfg, state.zeta, state.psi)
    out = {
        "step": int(state.step),
        "cfl": float(cfl),
        "max_abs_zeta": float(mz),
    }
    for i in range(ke.shape[0]):
        out[f"ke_{i + 1}"] = float(ke[i])
        out[f"enstrophy_{i + 1}"] = float(ens[i])
    return out
