"""Device mesh construction for 2-D spatial domain decomposition."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a * b == n, a <= b."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return a, n // a


def preferred_mesh_shape(cfg, n_devices: int) -> Tuple[int, int]:
    """Mesh shape for ``n_devices`` given the model config, from the
    algorithm alone.

    The spectral route's transposed FFT needs ``transposes_divide``; on an
    (N, 1) mesh it makes one all_to_all pair per solve instead of two, so
    (N, 1) is taken whenever the grid admits it. Otherwise, and for the
    multigrid route (halo traffic only, least for the shortest tile
    perimeter), the most-square split.
    """
    from .distributed_fft import transposes_divide

    if (cfg is not None and cfg.elliptic_impl == "spectral"
            and transposes_divide(cfg.M, cfg.P, n_devices, 1)):
        return (n_devices, 1)
    return _factor2(n_devices)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("x", "y"),
              devices=None, cfg=None) -> Mesh:
    """Build a 2-D ('x', 'y') device mesh over the available devices.

    ``shape=None`` uses all devices, shaped by ``preferred_mesh_shape``
    when a ``cfg`` is given, else most-square. An explicit shape smaller
    than the device count takes the FIRST nx*ny devices (e.g. ``--mesh 4,1``
    on an 8-device host). Axis 'x' shards the M (first spatial) dimension,
    'y' the P dimension.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if shape is None:
        shape = preferred_mesh_shape(cfg, n) if cfg is not None \
            else _factor2(n)
    if shape[0] * shape[1] > n:
        raise ValueError(f"mesh shape {shape} needs more than the {n} "
                         "available devices")
    devices = devices[:shape[0] * shape[1]]
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=tuple(axis_names))
