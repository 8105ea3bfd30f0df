"""pod-8192 on a mesh: per-mode transposed distributed FFTs
(tpu_qg.parallel.distributed_fft.DistributedHelmholtzSolver). Halo rows
and the all_to_all are not compulsory traffic of one card and are left
out of the floors."""

from qgbench import costmodel as cm


def per_step(model: dict, chips: int) -> dict:
    M, P = model["M"], model["P"]
    return cm.per_chip({**cm.stencil(M, P), **cm.modal_inversion(M, P)},
                       chips)
