"""Process set-up shared by the entry points: compile cache, device
report, the float64 guard, and the default mesh shape."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_qg.config import ModelConfig, preset
from tpu_qg.models.core import QGModel, init_state
from tpu_qg.parallel.distributed_fft import transposes_divide
from tpu_qg.parallel.mesh import preferred_mesh_shape
from tpu_qg.utils import runtime

# The real helper (conftest replaces the module attribute with a no-op so
# that tests compile without a persistent cache).
from tpu_qg.utils.runtime import setup_compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_compile_cache_env_is_left_alone(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/dir")
    assert setup_compile_cache() == "/some/dir"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert setup_compile_cache() == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_compile_cache_written_only_where_the_env_says(tmp_path):
    """A run with JAX_COMPILATION_CACHE_DIR set writes its cache there and
    leaves the checkout's default directory untouched."""
    code = ("import jax, jax.numpy as jnp;"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
            "from tpu_qg.utils.runtime import setup_compile_cache;"
            "setup_compile_cache();"
            "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()")
    default = REPO / ".jax_cache"
    had = set(os.listdir(default)) if default.exists() else None
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                   check=True, timeout=120)
    assert any(tmp_path.iterdir())
    now = set(os.listdir(default)) if default.exists() else None
    assert now == had


def test_device_report():
    rep = runtime.device_report()
    assert rep == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_gpu_query_fails_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises((OSError, subprocess.CalledProcessError)):
        runtime.gpu_name_and_power_limit()


@pytest.mark.parametrize("build", ["model", "init_state"])
def test_float64_needs_x64(build):
    cfg = preset("spinup-512").replace(M=16, P=16)
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="64-bit"):
            if build == "model":
                QGModel(cfg)
            else:
                init_state(cfg)
        # float32 configurations are unaffected.
        assert QGModel(cfg.replace(dtype="float32")).init_state().zeta.dtype \
            == jnp.float32
    finally:
        jax.config.update("jax_enable_x64", True)


def test_run_main_turns_on_x64_for_float64_presets():
    """A float64 preset through the CLI really runs in float64, from a
    process that starts in 32-bit mode."""
    from tpu_qg.run import main
    jax.config.update("jax_enable_x64", False)
    try:
        out = main(["--preset", "spinup-512", "--steps", "2", "--no-save",
                    "--set", "M=32", "P=32"])
        assert jax.config.jax_enable_x64
    finally:
        jax.config.update("jax_enable_x64", True)
    assert out.zeta.dtype == jnp.float64 and out.psi.dtype == jnp.float64
    assert int(out.step) == 2


def test_spinup_512_run_model_is_float64():
    from tpu_qg.run import run_model
    cfg = preset("spinup-512").replace(M=32, P=32)
    out = run_model(cfg, save_results=False, n_steps=3, verbose=False)
    for leaf in (out.zeta, out.psi, out.f1, out.f2):
        assert leaf.dtype == jnp.float64
    assert np.isfinite(np.asarray(out.zeta)).all()


def test_distributed_needs_coordinator():
    from tpu_qg.run import main
    with pytest.raises(SystemExit):
        main(["--preset", "barotropic-128", "--distributed", "--no-save"])


@pytest.mark.parametrize("name,n,shape", [
    ("pod-8192", 4, (4, 1)),          # spectral: one transpose pair
    ("pod-8192", 8, (8, 1)),
    ("pod-8192-mg", 4, (2, 2)),       # multigrid: least halo perimeter
    ("pod-8192-mg", 8, (2, 4)),
    ("two-layer-256", 1, (1, 1)),
])
def test_preferred_mesh_shape(name, n, shape):
    assert preferred_mesh_shape(preset(name), n) == shape


def test_preferred_mesh_shape_falls_back_to_most_square():
    # P = 6 does not split over 4 devices: no (4, 1) transposes.
    cfg = ModelConfig(M=8, P=6)
    assert not transposes_divide(8, 6, 4, 1)
    assert preferred_mesh_shape(cfg, 4) == (2, 2)
    assert preferred_mesh_shape(None, 8) == (2, 4)


@pytest.mark.parametrize("M,P,nx,ny,ok", [
    (8192, 8192, 4, 1, True), (8192, 8192, 2, 2, True),
    (256, 512, 8, 1, True), (6, 8, 4, 1, False), (8, 6, 2, 2, False),
    (12, 8, 2, 4, False)])
def test_transposes_divide(M, P, nx, ny, ok):
    assert transposes_divide(M, P, nx, ny) is ok
