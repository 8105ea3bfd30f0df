"""chip_smoke.py on the CPU: its comparisons pass on true results and fail
on perturbed ones, each phase runs at a toy size, and the script refuses
to run (non-zero exit, "ok": false) without a GPU."""

import json
import pathlib
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from tpu_qg.config import preset  # noqa: E402
from tpu_qg.models.core import QGModel, State, init_state  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    lines = capsys.readouterr().out.strip().splitlines()
    first, last = json.loads(lines[0]), json.loads(lines[-1])
    assert first["phase"] == "device" and first["ok"] is False
    assert last == {"ok": False, "device": {"platform": "cpu", "kind": "cpu",
                                            "count": len(jax.devices())}}
    # No phase past the device check ran on the CPU.
    assert len(lines) == 2


def _state(seed=0):
    rng = np.random.default_rng(seed)
    f = [rng.standard_normal((2, 8, 8)) for _ in range(4)]
    return State(*f, np.int32(5))


@pytest.mark.parametrize("scale,ok,bitwise", [(0.0, True, True),
                                              (1e-9, True, False),
                                              (1e-3, False, False)])
def test_compare_resume(scale, ok, bitwise):
    a = _state()
    b = a._replace(zeta=a.zeta * (1.0 + scale))
    rec = chip_smoke.compare_resume(a, b)
    assert rec["ok"] is ok and rec["bitwise"] is bitwise
    assert bitwise or "why" in rec


@pytest.mark.parametrize("scale,ok", [(1e-7, True), (1e-3, False)])
def test_close(scale, ok):
    want = np.linspace(-1.0, 2.0, 50)
    rec = chip_smoke.close(want + scale * 2.0, want, 1e-5)
    assert rec["ok"] is ok and rec["tol"] == 1e-5
    assert rec["rel_err"] == pytest.approx(scale, rel=1e-6)


@pytest.mark.parametrize("bytes_in_use,ok", [
    ([540e6, 530e6, 530e6, 530e6], True),
    ([540e6 + 2.1e9, 530e6, 530e6, 530e6], False),     # unsharded copy
    ([300e6, 530e6, 530e6, 530e6], False),               # missing share
])
def test_check_quarters(bytes_in_use, ok):
    assert chip_smoke.check_quarters(bytes_in_use, 2.147e9)["ok"] is ok


@pytest.mark.parametrize("poison", [False, True])
def test_check_state(poison):
    cfg = preset("turbulence-2048").replace(M=16, P=16)
    state = init_state(cfg, key=jax.random.PRNGKey(0))
    if poison:
        state = state._replace(zeta=state.zeta.at[0, 3, 3].set(np.nan))
    rec = chip_smoke.check_state(cfg, state)
    assert rec["ok"] is (not poison) and rec["cfl_max"] == 1.0


@pytest.mark.parametrize("missing", [None, "checkpoint_000000024.npz",
                                     "metadata.json"])
def test_check_run_dir(tmp_path, missing):
    for name in ("snap_000000024.npz", "checkpoint_000000024.npz",
                 "metadata.json"):
        if name != missing:
            (tmp_path / name).write_text("x")
    assert chip_smoke.check_run_dir(tmp_path)["ok"] is (missing is None)


def test_phase_main_path_toy(tmp_path):
    """One model day at dt = 1 h (24 steps) at 32^2, resumed to two days:
    the resumed state is bitwise the uninterrupted one."""
    rec = chip_smoke.phase_main_path(
        tmp_path, steps=24, overrides=("M=32", "P=32", "dt=3600.0"),
        production_steps=12, production_overrides=("M=32", "P=16"))
    assert rec["ok"], rec
    assert rec["resume"]["bitwise"]
    assert rec["files"]["checkpoints"] == ["checkpoint_000000024.npz",
                                           "checkpoint_000000048.npz"]


def test_phase_accuracy_f32_toy():
    rec = chip_smoke.phase_accuracy_f32(M=32, steps=10)
    assert rec["ok"], rec
    assert rec["dtypes"] == ["float32", "float64"]


def test_phase_f64_acceptance_toy():
    rec = chip_smoke.phase_f64_acceptance(M=32, steps=20)
    assert rec["ok"], rec
    assert rec["rel_err_zeta"] < 1e-9


def test_phase_multigrid_toy():
    rec = chip_smoke.phase_multigrid(M=128)
    assert rec["ok"], rec


def test_phase_timing_toy():
    rec = chip_smoke.phase_timing(M=32, steps=5, reps=2)
    assert rec["ok"], rec
    for part in ("step", "tendency_update", "inversion"):
        assert rec[part]["ms_per_step"] > 0


@pytest.mark.parametrize("phase,overrides,mesh", [
    ("phase_pod_spectral", {"M": 64, "P": 64}, [4, 1]),
    ("phase_pod_multigrid", {"M": 256, "P": 256, "mg_cycles": 4}, [2, 2]),
    ("phase_pod_gspmd", {"M": 64, "P": 64}, [4, 1]),
])
def test_four_card_phases_toy(phase, overrides, mesh):
    """The four-card path on four virtual CPU devices: the mesh is the
    algorithm's preferred one and the sharded run matches card 0."""
    rec = getattr(chip_smoke, phase)(jax.devices()[:4], steps=4,
                                     overrides=overrides)
    assert rec["ok"], rec
    assert rec["mesh"] == mesh and "memory" not in rec
