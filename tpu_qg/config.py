"""Model configuration and derived physical parameters.

The reference's configuration "system" is the immutable ``BaroclinicModel`` struct
(reference: src/model.jl:12-34) plus hard-coded constants in each entry script
(reference: src/run_model.jl:97-116). Here it is a frozen dataclass that is a valid
JAX static argument (hashable), with the derived stratification/beta parameters
(reference: src/model.jl:108-121) as cached properties, and named presets mirroring
the BASELINE.json configs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .constants import DAY, KM, MINUTES, YEAR


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Two-layer quasi-geostrophic model configuration.

    Field-for-field parity with the reference's ``BaroclinicModel``
    (reference: src/model.jl:12-30); numerics options are appended at the end.
    """

    # --- physical configuration (reference: src/model.jl:13-29) ---
    H_1: float = 1.0 * KM       # Height of the first (top) layer [m].
    H_2: float = 2.0 * KM       # Height of the second (bottom) layer [m].
    beta: float = 2e-11         # Planetary vorticity gradient [1/(m s)].
    Lx: float = 4000.0 * KM     # Domain length in x [m].
    Ly: float = 2000.0 * KM     # Domain width in y [m].
    dt: float = 5.0 * MINUTES   # Timestep [s].
    T: float = 8.0 * YEAR       # Total integration time [s].
    U: float = 0.1              # Mean zonal flow of the top layer [m/s].
    M: int = 512                # Number of grid nodes in x.
    P: int = 256                # Number of grid nodes in y.
    visc: float = 100.0         # Viscosity for the del^4 friction [m^2/s].
    r: float = 1e-8             # Bottom (Ekman) friction coefficient [1/s].
    R_d: float = 40.0 * KM      # Deformation radius [m].
    initial_kick: float = 1e-2  # Amplitude scale of the random initial psi.

    # --- numerics options (new in this framework) ---
    dtype: str = "float32"          # "float32" | "float64" (needs jax_enable_x64)
    # Reproduce the reference's inconsistent back-projection P_matrix(H_1, H_1)
    # (reference: src/model.jl:173 — quirk: P built with H_1 twice). Required for
    # trajectory equivalence whenever H_1 != H_2.
    compat_reference_P: bool = True
    # Poisson gauge: "zero_mean" (spectral-natural) or "pin" (emulates the
    # reference's pinned-point gauge, reference: src/schemes/laplacian.jl:70-74,
    # by subtracting the value at grid point (0, 0) so psi_tilde_1[0,0] == 0).
    poisson_gauge: str = "zero_mean"
    n_layers: int = 2               # 2 = Phillips two-layer; 1 = barotropic.
    seed: int = 0                   # PRNG seed for the initial condition.
    # Time scheme: "euler_ab3" = the reference's Euler(2 steps)->AB3
    # (reference: src/model.jl:123-136); "leapfrog_ra" = leapfrog with a
    # Robert-Asselin filter (an extension beyond the reference, for the
    # BASELINE leapfrog configs).
    time_scheme: str = "euler_ab3"
    ra_filter: float = 0.06         # Robert-Asselin filter coefficient.
    # Wind-stress curl forcing amplitude tau_0 [N/m^2] for a double-gyre:
    # layer-1 PV forcing -(2 pi tau_0 / (rho_0 H_1 Ly)) * sin(2 pi y / Ly)
    # (two counter-rotating gyres on the doubly-periodic domain). 0 disables.
    # Extension beyond the reference (its only forcing is the imposed shear U).
    wind_tau0: float = 0.0
    rho0: float = 1025.0            # Reference seawater density [kg/m^3].
    # Initial condition: "random" = the reference's noise kick
    # (reference: src/model.jl:41-42); "vortex" = Gaussian vortex dipole
    # (BASELINE config 1's barotropic vortex).
    ic_type: str = "random"
    # Transform backend for the packed modal inversion: "xla" = jnp.fft
    # (cuFFT on the GPU; the default and the oracle), "matmul" = the
    # matmul-factorized DFT (ops/matmul_fft.py), kept off the default route.
    fft_impl: str = "xla"

    # Elliptic inversion algorithm for the SHARDED halo stepper
    # (parallel/stepper.py): "spectral" = transposed distributed FFT
    # (all_to_all transposes — O(grid) traffic per step); "multigrid" =
    # distributed geometric V-cycles (parallel/multigrid.py — O(halo)
    # traffic, the communication-avoiding pod-scale route; works on any
    # (nx, ny) mesh). Identical linear system either way (same discrete
    # 5-point eigenvalues); multigrid is iterative — mg_cycles warm-started
    # V(2,2)-cycles per step (each ~0.15x residual contraction; the warm
    # start seeds from the previous step's psi). Single-device steps always
    # use the spectral route.
    elliptic_impl: str = "spectral"
    mg_cycles: int = 4
    # Extrapolated warm start for the multigrid route (scan runs only,
    # parallel/stepper.make_halo_run_fn): seed the V-cycles with
    # 2 psi_n - psi_{n-1} instead of psi_n. The solve's steady-state lag
    # error is rho^C x (seed error); linear extrapolation replaces the
    # O(dt) per-step psi change with its O(dt^2) curvature (~10x smaller
    # at production dt), buying ~1 cycle of accuracy for free. psi_{n-1}
    # rides the scan carry — State and checkpoints are unchanged (a
    # resumed run's first step falls back to the plain warm start).
    mg_extrapolate: bool = True

    def __post_init__(self):
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.poisson_gauge not in ("zero_mean", "pin"):
            raise ValueError(f"unsupported poisson_gauge {self.poisson_gauge!r}")
        if self.n_layers not in (1, 2):
            raise ValueError("n_layers must be 1 or 2")
        if self.time_scheme not in ("euler_ab3", "leapfrog_ra"):
            raise ValueError(f"unsupported time_scheme {self.time_scheme!r}")
        if self.ic_type not in ("random", "vortex"):
            raise ValueError(f"unsupported ic_type {self.ic_type!r}")
        if self.fft_impl not in ("xla", "matmul"):
            raise ValueError(f"unsupported fft_impl {self.fft_impl!r}")
        if self.elliptic_impl not in ("spectral", "multigrid"):
            raise ValueError(
                f"unsupported elliptic_impl {self.elliptic_impl!r}")

    # --- derived geometry ---
    @property
    def H(self) -> float:
        """Total depth (reference: src/model.jl:33-34 computes H = H_1 + H_2)."""
        return self.H_1 + self.H_2

    @property
    def dx(self) -> float:
        """Grid spacing; the reference requires dy == dx (src/run_model.jl:107-108)."""
        return self.Lx / self.M

    @property
    def total_steps(self) -> int:
        """floor(T / dt) (reference: src/run_model.jl:9,64)."""
        return int(math.floor(self.T / self.dt))

    # --- derived stratification / beta parameters (reference: src/model.jl:108-121) ---
    @property
    def ratio_term(self) -> float:
        """(f_0/N_0)^2 (reference: src/model.jl:109-111)."""
        return 0.5 * (self.H_1 + self.H_2) / (
            (self.R_d ** 2) * ((1.0 / self.H_1) + (1.0 / self.H_2))
        )

    @property
    def S1_plus(self) -> float:
        """Top-layer stretching coefficient (reference: src/model.jl:113)."""
        return (2.0 * self.ratio_term) / (self.H_1 * (self.H_1 + self.H_2))

    @property
    def S2_minus(self) -> float:
        """Bottom-layer stretching coefficient (reference: src/model.jl:114)."""
        return (2.0 * self.ratio_term) / (self.H_2 * (self.H_1 + self.H_2))

    @property
    def beta_1(self) -> float:
        """Shear-modified beta, top layer (reference: src/model.jl:117)."""
        return self.beta + self.S1_plus * self.U

    @property
    def beta_2(self) -> float:
        """Shear-modified beta, bottom layer (reference: src/model.jl:118)."""
        return self.beta - self.S2_minus * self.U

    @property
    def S_eig(self) -> float:
        """Non-zero eigenvalue of the stretching matrix, -1/R_d^2
        (reference: src/model.jl:121). Identity: -S1_plus - S2_minus == S_eig
        (reference: src/test.jl:43)."""
        return -1.0 / self.R_d ** 2

    # --- modal transform matrices (reference: src/model.jl:82-99) ---
    def P_matrix(self, H_1: Optional[float] = None, H_2: Optional[float] = None):
        """Eigenvector matrix of the stretching matrix, [[1, -H_2/H_1], [1, 1]]
        (reference: src/model.jl:83-87). Returned as a nested tuple (static)."""
        H_1 = self.H_1 if H_1 is None else H_1
        H_2 = self.H_2 if H_2 is None else H_2
        return ((1.0, -H_2 / H_1), (1.0, 1.0))

    def P_inv_matrix(self):
        """Inverse eigenvector matrix 1/(a+b) * [[b, a], [-b, b]] with
        a = S1_plus, b = S2_minus (reference: src/model.jl:90-99).

        Note the reference's P_inv[2,2] is ``b`` (not ``a``); it is a true inverse
        of P_matrix(H_1, H_2) only because b/a == H_1/H_2 exactly (both equal
        2*ratio/(H_1+H_2)/H_i). We reproduce it verbatim."""
        a = self.S1_plus
        b = self.S2_minus
        s = 1.0 / (a + b)
        return ((s * b, s * a), (-s * b, s * b))

    def back_projection_matrix(self):
        """The P used in evolve_psi's back-projection. The reference passes H_1
        twice (src/model.jl:173), yielding [[1,-1],[1,1]] regardless of H_2 —
        inconsistent with P_inv whenever H_1 != H_2. ``compat_reference_P``
        selects which behavior to use."""
        if self.compat_reference_P:
            return self.P_matrix(self.H_1, self.H_1)
        return self.P_matrix()

    def validate(self) -> None:
        """The reference asserts sign(beta_1) == -sign(beta_2), i.e. the
        configuration is baroclinically unstable (reference: src/model.jl:38)."""
        if math.copysign(1.0, self.beta_1) != -math.copysign(1.0, self.beta_2):
            raise ValueError(
                "configuration is not baroclinically unstable: "
                f"beta_1={self.beta_1}, beta_2={self.beta_2}"
            )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --- Named presets (BASELINE.json configs 1-5) ---

def preset(name: str) -> ModelConfig:
    """Named configurations mirroring BASELINE.json's five configs plus the
    reference's production (src/run_model.jl:97-116), test (src/test.jl:8-23)
    and benchmark (src/benchmarking/benchmarking.jl:6-26) configs."""
    presets = {
        # Reference production config (reference: src/run_model.jl:98-116).
        "production": ModelConfig(),
        # BASELINE config 1: single-layer barotropic vortex, 128^2, leapfrog,
        # CPU-runnable.
        "barotropic-128": ModelConfig(
            n_layers=1, M=128, P=128, Lx=4000.0 * KM, Ly=4000.0 * KM,
            dt=30.0 * MINUTES, T=30.0 * DAY, U=0.0, r=0.0, visc=100.0,
            time_scheme="leapfrog_ra", ic_type="vortex",
        ),
        # BASELINE config 2: two-layer 256^2, wind-driven double-gyre,
        # Robert-Asselin filter.
        "two-layer-256": ModelConfig(
            M=256, P=256, Lx=4000.0 * KM, Ly=4000.0 * KM,
            dt=15.0 * MINUTES, T=1.0 * YEAR,
            time_scheme="leapfrog_ra", wind_tau0=0.1,
        ),
        # BASELINE config 3: two-layer baroclinic instability spinup, 512^2,
        # 10k-step allclose check config (float64).
        "spinup-512": ModelConfig(
            M=512, P=512, Lx=4000.0 * KM, Ly=4000.0 * KM,
            dt=5.0 * MINUTES, T=10000 * 5.0 * MINUTES, dtype="float64",
        ),
        # BASELINE config 4: two-layer 2048^2 single-chip speed-of-light.
        "turbulence-2048": ModelConfig(
            M=2048, P=2048, Lx=4000.0 * KM, Ly=4000.0 * KM,
            dt=1.0 * MINUTES, T=1.0 * DAY, dtype="float32",
        ),
        # BASELINE config 5: two-layer 8192^2 multi-host domain-decomposed.
        "pod-8192": ModelConfig(
            M=8192, P=8192, Lx=4000.0 * KM, Ly=4000.0 * KM,
            dt=30.0, T=1.0 * DAY, dtype="float32",
        ),
        # BASELINE config 5 on the communication-avoiding elliptic route:
        # distributed multigrid (O(halo) traffic/step) instead of the
        # transposed-FFT inversion.
        # mg_cycles=2 is the f32-noise-band fidelity point WITH the
        # extrapolated warm start (mg_extrapolate, default on): 5000-step
        # energy bias 2.1e-6 (results/mg_accuracy_256_5000_extrap.json)
        # vs 1.8e-4 without extrapolation; mg_cycles=1 trades a bounded
        # ~3e-5 bias for one V-cycle less per step.
        "pod-8192-mg": ModelConfig(
            M=8192, P=8192, Lx=4000.0 * KM, Ly=4000.0 * KM,
            dt=30.0, T=1.0 * DAY, dtype="float32",
            elliptic_impl="multigrid", mg_cycles=2,
        ),
        # Reference benchmark sweep base (reference: src/benchmarking/benchmarking.jl:6-26).
        "bench-ref": ModelConfig(
            Lx=4000.0 * KM, Ly=4000.0 * KM, dt=60.0 * MINUTES, T=1.0 * DAY,
            r=1e-7, initial_kick=1e-6, M=64, P=64, dtype="float64",
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(presets)}")
    return presets[name]
