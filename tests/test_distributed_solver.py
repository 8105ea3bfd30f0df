"""The transposed distributed FFT solve (DistributedHelmholtzSolver, with
the modal projection the halo stepper wraps around it) against the
single-device PackedModalInverter, at the extents and mesh shapes the
multi-device inversion has to serve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as Pspec

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM
from tpu_qg.ops.multigrid import modal_mix
from tpu_qg.ops.spectral import PackedModalInverter
from tpu_qg.parallel import make_mesh
from tpu_qg.parallel.distributed_fft import (DistributedHelmholtzSolver,
                                             transposes_divide)


@pytest.mark.parametrize("mesh_shape,M,P", [
    ((1, 1), 256, 256), ((2, 1), 256, 256), ((4, 1), 256, 512),
    ((8, 1), 128, 1024), ((4, 1), 256, 1024), ((1, 4), 128, 1024),
    ((2, 2), 256, 512), ((4, 2), 256, 1024), ((2, 4), 128, 1024)])
def test_distributed_modal_inversion_matches_packed(mesh_shape, M, P):
    cfg = ModelConfig(M=M, P=P, Lx=4000.0 * KM, Ly=4000.0 * KM * P / M,
                      dtype="float64")
    nx, ny = mesh_shape
    assert transposes_divide(M, P, nx, ny)
    rng = np.random.default_rng(M + P + nx)
    zeta = rng.standard_normal((2, M, P)) * 1e-5
    ref = np.asarray(PackedModalInverter(
        M, P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
        cfg.back_projection_matrix())(jnp.asarray(zeta)))

    solver = DistributedHelmholtzSolver(M, P, cfg.dx, (0.0, cfg.S_eig))

    def invert(z):
        return modal_mix(cfg.back_projection_matrix(),
                         solver(modal_mix(cfg.P_inv_matrix(), z)))

    mesh = make_mesh(mesh_shape, devices=jax.devices()[:nx * ny])
    f = jax.jit(jax.shard_map(invert, mesh=mesh,
                              in_specs=(Pspec(None, "x", "y"),),
                              out_specs=Pspec(None, "x", "y"),
                              check_vma=False))
    got = np.asarray(f(jnp.asarray(zeta)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-11 * np.abs(ref).max())
