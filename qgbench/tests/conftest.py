"""The harness's tests run on the CPU, with four virtual devices for the
four-card cell, and without the persistent compile cache."""

import pathlib
import sys

import jax

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
