"""turbulence-2048 on one card: the packed single-transform inversion
(tpu_qg.ops.spectral.PackedModalInverter)."""

from qgbench import costmodel as cm


def per_step(model: dict, chips: int) -> dict:
    M, P = model["M"], model["P"]
    return cm.per_chip({**cm.stencil(M, P), **cm.packed_inversion(M, P)},
                       chips)
