"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Tests run on the CPU backend: reference equivalence needs float64, and the
multi-device sharding tests use a virtual 8-device host mesh, the standard
JAX fake-backend analog (SURVEY.md section 4). What needs a GPU is checked
by chip_smoke.py on the card.
"""

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache(monkeypatch):
    """Entry points called by tests (tpu_qg.run.main) would point JAX's
    persistent compile cache at the checkout; tests compile without it."""
    from tpu_qg.utils import runtime
    monkeypatch.setattr(runtime, "setup_compile_cache", lambda: None)
