"""I/O layer tests: snapshot parity keys, metadata, exact AB3 resume."""

import numpy as np

from tpu_qg.config import ModelConfig
from tpu_qg.constants import KM, MINUTES, YEAR
from tpu_qg.io import RunReader, RunWriter, create_metadata
from tpu_qg.models import QGModel


def small_cfg(**kw):
    base = dict(
        M=16, P=16, Lx=4000.0 * KM, Ly=4000.0 * KM,
        dt=60.0 * MINUTES, T=1.0 * YEAR, U=0.1, visc=100.0, r=1e-7,
        R_d=40.0 * KM, initial_kick=1e-6, dtype="float64",
    )
    base.update(kw)
    return ModelConfig(**base)


def test_metadata_parity():
    """Metadata fields match the reference's create_metadata
    (reference: src/run_model.jl:6-20) — including the FIXED sampling cadence
    (the reference's run loop saves every 2*sample_timestep, quirk)."""
    cfg = small_cfg()
    meta = create_metadata(cfg)
    assert meta["dt"] == cfg.dt
    assert meta["T"] == cfg.T
    assert meta["sample_timestep"] == int((24 * 3600) // cfg.dt)
    assert meta["total_steps"] == cfg.total_steps


def test_snapshot_roundtrip(tmp_path):
    cfg = small_cfg()
    writer = RunWriter(tmp_path / "run", cfg)
    z = np.random.default_rng(0).random((2, 16, 16))
    p = np.random.default_rng(1).random((2, 16, 16))
    writer.write_snapshot(42, z, p)
    reader = RunReader(tmp_path / "run")
    assert reader.snapshot_steps() == [42]
    z2, p2 = reader.load_snapshot(42)
    np.testing.assert_array_equal(z, z2)
    np.testing.assert_array_equal(p, p2)
    cfg2 = reader.config()
    assert cfg2 == cfg


def test_exact_ab3_resume(tmp_path):
    """Checkpoints carry the tendency history, so a resumed run is bit-exact
    vs an uninterrupted one (the reference cannot do this: it saves only
    time-level 1, SURVEY.md section 5)."""
    cfg = small_cfg()
    model = QGModel(cfg)
    rng = np.random.default_rng(2)
    psi0 = cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, 16, 16))

    # Uninterrupted 20 steps.
    s = model.init_state(psi_init=psi0)
    ref = model.run(s, 20)

    # 10 steps -> checkpoint -> reload -> 10 more.
    s = model.init_state(psi_init=psi0)
    mid = model.run(s, 10)
    writer = RunWriter(tmp_path / "ck", cfg)
    writer.write_checkpoint(mid)
    reloaded = RunReader(tmp_path / "ck").load_checkpoint()
    assert int(reloaded.step) == 10
    resumed = model.run(reloaded, 10)

    np.testing.assert_array_equal(np.asarray(resumed.zeta), np.asarray(ref.zeta))
    np.testing.assert_array_equal(np.asarray(resumed.psi), np.asarray(ref.psi))


def test_sharded_checkpoint_exact_resume(tmp_path):
    """Sharded checkpoints (per-process shard files, no full-grid gather)
    resume bit-exactly onto the same mesh, and the
    reader assembles the same global state (mesh-changed / tooling path).
    Counterpart of the reference's single-writer JLD checkpoints
    (reference: src/run_model.jl:86-91) at pod-scale I/O shape."""
    import jax

    from tpu_qg.parallel import make_mesh, shard_state
    from tpu_qg.parallel.gspmd import state_sharding

    cfg = small_cfg(M=32, P=32)
    model = QGModel(cfg)
    rng = np.random.default_rng(7)
    psi0 = cfg.initial_kick * cfg.U * cfg.Ly * rng.random((2, 32, 32))

    s = model.init_state(psi_init=psi0)
    ref = model.run(s, 20)

    mesh = make_mesh((2, 4))
    mid = shard_state(model.run(model.init_state(psi_init=psi0), 10), mesh)
    writer = RunWriter(tmp_path / "ck", cfg)
    writer.write_checkpoint_sharded(mid)

    reader = RunReader(tmp_path / "ck")
    assert reader.checkpoint_steps() == [10]

    # Same-mesh resume: per-device exact-match load, then 10 more steps.
    reloaded = reader.load_checkpoint_sharded(state_sharding(mesh))
    assert int(reloaded.step) == 10
    for name in ("zeta", "psi", "f1", "f2"):
        np.testing.assert_array_equal(
            np.asarray(getattr(reloaded, name)),
            np.asarray(getattr(mid, name)))
    resumed = model.run(jax.device_put(reloaded, jax.devices("cpu")[0]), 10)
    np.testing.assert_array_equal(np.asarray(resumed.zeta),
                                  np.asarray(ref.zeta))

    # Mesh-changed resume (different shape -> assembly fallback).
    mesh2 = make_mesh((4, 2))
    reloaded2 = reader.load_checkpoint_sharded(state_sharding(mesh2))
    np.testing.assert_array_equal(np.asarray(reloaded2.zeta),
                                  np.asarray(mid.zeta))

    # Plain reader assembly (load_checkpoint on a sharded checkpoint).
    assembled = reader.load_checkpoint()
    np.testing.assert_array_equal(np.asarray(assembled.f1),
                                  np.asarray(mid.f1))


def test_sharded_snapshot_roundtrip(tmp_path):
    """Sharded snapshots keep the reference's {field}_{step} keying per
    shard and reassemble exactly."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_qg.parallel import make_mesh

    cfg = small_cfg(M=32, P=32)
    mesh = make_mesh((2, 4))
    sh = NamedSharding(mesh, P(None, "x", "y"))
    rng = np.random.default_rng(3)
    z = jax.device_put(rng.random((2, 32, 32)), sh)
    p = jax.device_put(rng.random((2, 32, 32)), sh)
    writer = RunWriter(tmp_path / "run", cfg)
    writer.write_snapshot_sharded(5, z, p)

    shard_files = sorted((tmp_path / "run").glob("snap_*-shard*.npz"))
    assert len(shard_files) == 1     # single process
    with np.load(shard_files[0]) as zf:
        assert any(k.startswith("zeta_5_shard") for k in zf.files)

    reader = RunReader(tmp_path / "run")
    assert reader.snapshot_steps() == [5]
    z2, p2 = reader.load_snapshot(5)
    np.testing.assert_array_equal(np.asarray(z), z2)
    np.testing.assert_array_equal(np.asarray(p), p2)


def test_run_model_driver_sharded_io(tmp_path):
    """run_model with checkpoint_mode='sharded' on a mesh writes shard
    files (no monolithic npz past step 0) and --resume continues from
    them."""
    from tpu_qg.parallel import make_mesh
    from tpu_qg.run import run_model

    cfg = small_cfg(M=32, P=32, dtype="float32",
                    T=20 * 60.0 * MINUTES)
    mesh = make_mesh((2, 4))
    run_model(cfg, run_dir=str(tmp_path / "drv"), verbose=False,
              sample_interval=10 * cfg.dt, checkpoint_every=10,
              mesh=mesh, checkpoint_mode="sharded")
    d = tmp_path / "drv"
    assert sorted(d.glob("checkpoint_*-shard*.npz"))
    assert not list(d.glob("checkpoint_000000020.npz"))
    reader = RunReader(d)
    assert reader.checkpoint_steps() == [10, 20]
    assert reader.snapshot_steps() == [0, 10, 20]

    out = run_model(cfg, run_dir=str(d), verbose=False,
                    sample_interval=10 * cfg.dt, n_steps=30,
                    resume=True, mesh=mesh, checkpoint_mode="sharded")
    assert int(out.step) == 30
    assert 30 in RunReader(d).checkpoint_steps()


def test_run_model_driver(tmp_path):
    """End-to-end driver parity with run_model (reference: src/run_model.jl:55-95):
    writes IC snapshot, periodic snapshots, and a final checkpoint."""
    from tpu_qg.run import run_model

    cfg = small_cfg(T=30 * 60.0 * MINUTES)  # 30 steps
    out = run_model(cfg, run_dir=str(tmp_path / "drv"), verbose=False,
                    sample_interval=10 * cfg.dt)
    reader = RunReader(tmp_path / "drv")
    assert reader.snapshot_steps() == [0, 10, 20, 30]
    assert reader.checkpoint_steps() == [30]
    assert int(out.step) == 30
