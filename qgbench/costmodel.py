"""Operations and compulsory bytes of one two-layer QG step, from shapes.

Counts are algorithmic: each stencil operation is counted once per grid
point, as the reference's formulas write it, whatever a compiled program
recomputes; an N-point complex FFT counts 5 N log2 N operations. Byte
floors are compulsory traffic: every input of a stage read once and every
output written once, which no fusion of the same algorithm can go below.
The per-configuration files under ``costs/`` add these up for the route
their configuration runs.
"""

from __future__ import annotations

import math

F32 = 4                  # bytes of a float32
C64 = 8                  # bytes of a complex64

# Per grid point and layer: 49 operations for the tendency (laplacian 6,
# friction 6, Arakawa Jacobian 32, beta, shear and drag terms and their
# sum) and 7 for the AB3 update. That is XLA's own count (cost_analysis) of
# the plain reference's formulas (qgbench/reference.py) with constants
# folded, the fewest a compiler needs for them; a test keeps the two equal.
STENCIL_FLOPS_PER_LAYER_POINT = 56

# Tendency + update: read zeta, psi, f1, f2; write zeta_new and the new f1
# (the new f2 is the old f1, rebound without a copy). Per layer point.
STENCIL_BYTES_PER_LAYER_POINT = 6 * F32


def fft_flops(n_points: int) -> float:
    """One N-point complex transform."""
    return 5.0 * n_points * math.log2(n_points)


def stencil(M: int, P: int, layers: int = 2) -> dict:
    n = M * P * layers
    return {"stencil_flops": STENCIL_FLOPS_PER_LAYER_POINT * n,
            "stencil_bytes": STENCIL_BYTES_PER_LAYER_POINT * n}


def packed_inversion(M: int, P: int) -> dict:
    """Both layers packed into one complex field: one forward and one
    inverse M x P transform, and the per-wavenumber A W + B conj(W(-k))
    (two complex products and a sum, 14 operations). Floor: each
    transform reads and writes one complex64 field once."""
    n = M * P
    return {"fft_flops": 2 * fft_flops(n) + 14 * n,
            "fft_bytes": 2 * (C64 * n + C64 * n)}


def modal_inversion(M: int, P: int) -> dict:
    """Two modes solved apart (the distributed route): a 2x2 modal mix
    before and after (6 operations per point each), per mode a forward and
    an inverse complex M x P transform and a real symbol multiply (2
    operations per point). Floor per mode: the forward transform reads the
    real mode and writes its complex spectrum, the inverse reads the
    spectrum and writes the real result."""
    n = M * P
    return {"fft_flops": 4 * fft_flops(n) + 2 * 6 * n + 2 * 2 * n,
            "fft_bytes": 2 * ((F32 * n + C64 * n) + (C64 * n + F32 * n))}


def per_chip(parts: dict, chips: int) -> dict:
    """Totals per step, split evenly over the chips, with ``flops``."""
    out = {k: v / chips for k, v in parts.items()}
    out["flops"] = out["stencil_flops"] + out["fft_flops"]
    return out
