"""Multi-device sharding tests on the virtual 8-device CPU mesh
(the fake-backend analog for testing domain decomposition without several
cards, SURVEY.md section 4)."""

import jax
import numpy as np
import pytest

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.models import QGModel, init_state
from tpu_qg.parallel import make_mesh, make_sharded_step_fn, shard_state
from tpu_qg.parallel.gspmd import make_sharded_run_fn


def small_cfg(**kw):
    base = dict(
        H_1=1.0 * KM, H_2=2.0 * KM, beta=2e-11,
        Lx=4000.0 * KM, Ly=4000.0 * KM,
        dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1,
        M=32, P=32, visc=100.0, r=1e-7, R_d=40.0 * KM,
        initial_kick=1e-6, dtype="float64",
    )
    base.update(kw)
    return ModelConfig(**base)


def _psi_init(cfg, seed=0):
    rng = np.random.default_rng(seed)
    amp = cfg.initial_kick * cfg.U * cfg.Ly
    return amp * rng.random((2, cfg.M, cfg.P))


def _per_mode_run(cfg, state, n_steps):
    """Single-device reference trajectory with per-mode solvers (the same
    elliptic algorithm the sharded paths use)."""
    from tpu_qg.models.core import make_step_fn
    step = jax.jit(make_step_fn(cfg, batched_fft=False))
    for _ in range(n_steps):
        state = step(state)
    return state


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert mesh.axis_names == ("x", "y")
    mesh18 = make_mesh((1, 8))
    assert mesh18.devices.shape == (1, 8)
    with pytest.raises(ValueError):
        make_mesh((3, 4))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_sharded_step_matches_single_device(mesh_shape):
    """The mesh-sharded step produces bit-comparable results to the
    single-device step for every mesh layout."""
    cfg = small_cfg()
    psi0 = _psi_init(cfg)
    state = init_state(cfg, psi_init=psi0)

    # Reference uses the per-mode (batched_fft=False) solver — the same
    # algorithm the sharded paths run — so the 1e-12 comparison stays strict
    # (the default packed single-fft2 inverter differs by ~1e-12 roundoff).
    ref = _per_mode_run(cfg, state, 10)

    mesh = make_mesh(mesh_shape)
    sharded_run = make_sharded_run_fn(cfg, mesh)
    sstate = shard_state(init_state(cfg, psi_init=psi0), mesh)
    out = sharded_run(sstate, 10)

    np.testing.assert_allclose(np.asarray(out.zeta), np.asarray(ref.zeta),
                               rtol=1e-12, atol=1e-20)
    np.testing.assert_allclose(np.asarray(out.psi), np.asarray(ref.psi),
                               rtol=1e-12, atol=1e-16)


def test_sharded_step_fn_single_step():
    cfg = small_cfg()
    mesh = make_mesh((2, 4))
    step = make_sharded_step_fn(cfg, mesh, donate=False)
    state = shard_state(init_state(cfg, psi_init=_psi_init(cfg)), mesh)
    out = step(state)
    assert int(out.step) == 1
    # output is sharded over the mesh
    assert out.zeta.sharding.mesh.shape == {"x": 2, "y": 4}


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_halo_stepper_matches_single_device(mesh_shape):
    """The explicit shard_map path (ppermute halo exchange + transposed
    distributed FFT) matches the single-device step to roundoff."""
    from tpu_qg.parallel.stepper import make_halo_step_fn

    cfg = small_cfg()
    psi0 = _psi_init(cfg)
    ref = _per_mode_run(cfg, init_state(cfg, psi_init=psi0), 5)

    mesh = make_mesh(mesh_shape)
    step = make_halo_step_fn(cfg, mesh, donate=False)
    s = shard_state(init_state(cfg, psi_init=psi0), mesh)
    for _ in range(5):
        s = step(s)
    scale = np.abs(np.asarray(ref.zeta)).max()
    np.testing.assert_allclose(np.asarray(s.zeta), np.asarray(ref.zeta),
                               rtol=0, atol=1e-12 * scale)
    pscale = np.abs(np.asarray(ref.psi)).max()
    np.testing.assert_allclose(np.asarray(s.psi), np.asarray(ref.psi),
                               rtol=0, atol=1e-12 * pscale)


def test_halo_stepper_barotropic():
    """Single-layer model on the halo path."""
    from tpu_qg.parallel.stepper import make_halo_step_fn

    cfg = small_cfg(n_layers=1, U=0.0, r=0.0, M=32, P=32)
    psi0 = _psi_init(cfg)[:1]
    single = QGModel(cfg)
    ref = single.init_state(psi_init=psi0)
    for _ in range(3):
        ref = single.step(ref)
    mesh = make_mesh((2, 4))
    step = make_halo_step_fn(cfg, mesh, donate=False)
    s = shard_state(init_state(cfg, psi_init=psi0), mesh)
    for _ in range(3):
        s = step(s)
    scale = np.abs(np.asarray(ref.zeta)).max()
    np.testing.assert_allclose(np.asarray(s.zeta), np.asarray(ref.zeta),
                               rtol=0, atol=1e-12 * scale)


def test_exchange_halo_unit():
    """Halo exchange reproduces jnp.pad(mode='wrap') on the gathered grid."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from tpu_qg.parallel.halo import exchange_halo

    rng = np.random.default_rng(0)
    M, Pn, h = 16, 16, 2
    u = rng.standard_normal((M, Pn))
    mesh = make_mesh((2, 4))

    def f(x):
        return exchange_halo(x, h, "x", "y")

    padded_blocks = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("x", "y"),), out_specs=P("x", "y"),
        check_vma=False))(jnp.asarray(u))
    # Each local block (8+2h, 4+2h); gathered result has block-interleaved
    # layout — verify one block directly instead.
    local = np.asarray(padded_blocks)
    # block (0,0): rows 0:8, cols 0:4 with wraparound halos
    expect = np.pad(u, h, mode="wrap")  # global padded
    blk = local[: 8 + 2 * h, : 4 + 2 * h]
    np.testing.assert_allclose(blk, expect[0:8 + 2 * h, 0:4 + 2 * h])


def test_sharded_output_stays_sharded():
    """No silent full-gather of the state between steps."""
    cfg = small_cfg()
    mesh = make_mesh((2, 4))
    run = make_sharded_run_fn(cfg, mesh)
    state = shard_state(init_state(cfg, psi_init=_psi_init(cfg)), mesh)
    out = run(state, 4)
    spec = out.zeta.sharding.spec
    assert tuple(spec) == (None, "x", "y")


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_halo_overlap_matches_blocking(mesh_shape):
    """The halo/compute-overlapped step (interior stencil concurrent with the
    ppermutes, rim patched after — SURVEY section 7.7) is exactly equal to the
    blocking step, and both match the single-device step to roundoff. M=P=64
    so every mesh layout has tiles with a genuine interior (>= 8 wide)."""
    from tpu_qg.parallel.stepper import make_halo_step_fn

    cfg = small_cfg(M=64, P=64, wind_tau0=0.1)
    psi0 = _psi_init(cfg)
    ref = _per_mode_run(cfg, init_state(cfg, psi_init=psi0), 5)

    mesh = make_mesh(mesh_shape)
    step_block = make_halo_step_fn(cfg, mesh, donate=False, overlap=False)
    step_over = make_halo_step_fn(cfg, mesh, donate=False, overlap=True)
    sb = shard_state(init_state(cfg, psi_init=psi0), mesh)
    so = shard_state(init_state(cfg, psi_init=psi0), mesh)
    for _ in range(5):
        sb, so = step_block(sb), step_over(so)
    # Same expression per point, but XLA fuses/vectorizes the two programs
    # differently -> agreement to a few f64 ulps, not bitwise.
    bscale = np.abs(np.asarray(sb.zeta)).max()
    np.testing.assert_allclose(np.asarray(so.zeta), np.asarray(sb.zeta),
                               rtol=0, atol=1e-13 * bscale)
    bpscale = np.abs(np.asarray(sb.psi)).max()
    np.testing.assert_allclose(np.asarray(so.psi), np.asarray(sb.psi),
                               rtol=0, atol=1e-13 * bpscale)
    scale = np.abs(np.asarray(ref.zeta)).max()
    np.testing.assert_allclose(np.asarray(so.zeta), np.asarray(ref.zeta),
                               rtol=0, atol=1e-12 * scale)


def test_halo_overlap_small_tile_fallback():
    """Tiles too small for an interior (m or p < 8) silently use the blocking
    exchange; results still match the single-device trajectory."""
    from tpu_qg.parallel.stepper import make_halo_step_fn

    cfg = small_cfg()          # M=P=32; (8,1) mesh -> 4-row tiles
    psi0 = _psi_init(cfg)
    ref = _per_mode_run(cfg, init_state(cfg, psi_init=psi0), 3)
    mesh = make_mesh((8, 1))
    step = make_halo_step_fn(cfg, mesh, donate=False, overlap=True)
    s = shard_state(init_state(cfg, psi_init=psi0), mesh)
    for _ in range(3):
        s = step(s)
    scale = np.abs(np.asarray(ref.zeta)).max()
    np.testing.assert_allclose(np.asarray(s.zeta), np.asarray(ref.zeta),
                               rtol=0, atol=1e-12 * scale)
