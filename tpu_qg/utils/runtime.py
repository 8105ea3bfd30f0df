"""Process set-up shared by the entry points (``tpu_qg.run``, ``bench.py``,
``chip_smoke.py``): the persistent compile cache, 64-bit mode for float64
configurations, and a report of the devices a run is on."""

from __future__ import annotations

import os
import pathlib
import subprocess
from typing import Dict

import jax

# <checkout>/.jax_cache: a fixed path, because the directory is part of the
# cache key — a cache that moves never hits.
REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one directory and return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
    alone; otherwise the cache lives in the checkout (``REPO_CACHE_DIR``,
    listed in .gitignore)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)


def enable_x64_if_needed(dtype: str) -> None:
    """Turn on 64-bit mode for a float64 configuration. Call before any
    array exists: arrays made earlier keep their 32-bit dtype."""
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)


def device_report() -> Dict:
    """Platform, device kind and count of the devices JAX runs on, as
    ``jax.devices()`` reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, one
    line per card. Raises when ``nvidia-smi`` is missing or fails: a device
    number is never reported without the card it was taken on."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    text = out.stdout.strip()
    if not text:
        raise RuntimeError("nvidia-smi reported no GPU")
    return text
