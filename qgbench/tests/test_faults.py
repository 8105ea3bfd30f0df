"""The check that decides ``correct`` refuses a broken timed path. Each
test drives a whole run at a toy grid, past the look for a GPU, with one
fault planted underneath, and sees ``correct`` come out false. The cell's
own limits apply.

Faults a QG cell can have: a step that returns its state unchanged; the
exchange between chips left out (four-card cell); an answer altered where
it is produced (the state after a scan, or the snapshot file). A cell has
no batch whose mean could be taken over half. The control (the reference
in bfloat16 in the program's place) must be refused too."""

import time

import jax
import jax.numpy as jnp
import pytest

from qgbench import harness
from qgbench.control import bfloat16_reference

TOY = {"model": {"M": 32, "P": 32}}


def run(cell_name, **kw):
    cell = harness.load_cell(cell_name)
    return harness.run_cell(cell, 12345, 0.2, False, time.perf_counter(),
                            rehearsal=True, overrides=TOY,
                            log=lambda *a, **k: None, **kw)


def failing(result):
    return sorted(k for k, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


CELLS = ["turbulence-2048.daily", "pod-8192.spinup"]


def unchanged_state(monkeypatch):
    from tpu_qg.models.core import QGModel
    from tpu_qg.parallel import stepper
    monkeypatch.setattr(QGModel, "run", lambda self, state, n: state)
    monkeypatch.setattr(stepper, "make_halo_run_fn",
                        lambda cfg, mesh, **kw: lambda state, n: state)


def altered_state(monkeypatch):
    from tpu_qg.models.core import QGModel
    from tpu_qg.parallel import stepper
    run1, make = QGModel.run, stepper.make_halo_run_fn

    def alter(state):
        return state._replace(zeta=state.zeta * 1.01)

    monkeypatch.setattr(QGModel, "run",
                        lambda self, state, n: alter(run1(self, state, n)))

    def make_altered(cfg, mesh, **kw):
        run_fn = make(cfg, mesh, **kw)
        return lambda state, n: alter(run_fn(state, n))
    monkeypatch.setattr(stepper, "make_halo_run_fn", make_altered)


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault, caught_by", [
    (unchanged_state, {"steps_err", "final_step_err", "tend_err"}),
    (altered_state, {"zeta_err"}),
])
def test_fault_is_refused(cell_name, fault, caught_by, monkeypatch):
    fault(monkeypatch)
    result = run(cell_name)
    assert result["correct"] is False
    assert caught_by <= set(failing(result))


def test_exchange_left_out_is_refused(monkeypatch):
    from tpu_qg.parallel import stepper

    def local_wrap(u, h, axis_x="x", axis_y="y"):
        # Each tile wraps onto itself: no data from the neighbours.
        return jnp.pad(u, [(0, 0)] * (u.ndim - 2) + [(h, h), (h, h)],
                       mode="wrap")
    monkeypatch.setattr(stepper, "exchange_halo", local_wrap)
    result = run("pod-8192.spinup")
    assert result["correct"] is False
    assert "tend_err" in failing(result)


def test_altered_snapshot_is_refused(monkeypatch):
    import tpu_qg.io as tio
    write = tio.RunWriter.write_snapshot
    monkeypatch.setattr(tio.RunWriter, "write_snapshot",
                        lambda self, step, zeta, psi: write(
                            self, step, zeta * (1 + 1e-6), psi))
    result = run("turbulence-2048.daily")
    assert result["correct"] is False
    assert {"snapshot_diff", "snapshot_max_mismatch"} <= set(
        failing(result))


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_refused(cell_name):
    result = run(cell_name, substitute=bfloat16_reference)
    assert result["correct"] is False
    assert {"zeta_err", "psi_err", "tend_err"} & set(failing(result))


def test_sound_run_is_correct():
    assert jax.devices()[0].platform == "cpu"
    result = run("turbulence-2048.daily")
    assert result["correct"] is True, result["checks"]
