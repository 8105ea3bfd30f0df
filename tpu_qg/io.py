"""Snapshot / checkpoint / metadata I/O.

Counterpart of the reference's JLD output path (reference: src/run_model.jl:70-91
writes ``zeta_$t`` / ``psi_$t`` keyed snapshots plus a metadata dict; readers in
src/plotting/animation.jl:6-17). Differences by design:

  * A run is a *directory* of npz files plus ``metadata.json`` instead of one
    append-only JLD/HDF5 file (append-friendly, trivially parallel-readable).
  * Keys keep the reference's ``{field}_{step}`` naming for tooling parity.
  * Full-state checkpoints additionally store the AB3 tendency history and step
    counter, enabling *exact* restart — the reference saves only time-level 1,
    so an exact AB3 resume is impossible there (SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .config import ModelConfig
from .constants import DAY
from .models.core import State

PathLike = Union[str, pathlib.Path]

# Sharded files: {kind}_{step:09d}-shard{process:05d}.npz (+ .index.json).
_SHARD_RE = re.compile(r"^(snap|checkpoint)_(\d+)-shard(\d+)$")


def _normalize_index(index, shape) -> Tuple[Tuple[int, int], ...]:
    """Concrete ((start, stop), ...) per dim from a tuple of slices (the
    form jax shard indices come in; None endpoints resolved against shape)."""
    out = []
    for sl, dim in zip(index, shape):
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise ValueError(f"non-unit-stride shard index {sl}")
        out.append((int(start), int(stop)))
    return tuple(out)


def create_metadata(cfg: ModelConfig, sample_interval: float = 1.0 * DAY) -> Dict:
    """Run metadata (reference: src/run_model.jl:6-20, ``create_metadata``)."""
    sample_timestep = int(sample_interval // cfg.dt)
    return {
        "dt": cfg.dt,
        "T": cfg.T,
        "sample_interval": sample_interval,
        "sample_timestep": sample_timestep,
        "total_steps": cfg.total_steps,
        "config": dataclasses.asdict(cfg),
    }


class RunWriter:
    """Streams snapshots and checkpoints of a run to a directory.

    ``write_metadata=False`` lets non-primary processes construct a writer
    for the sharded I/O paths (each process writes only its own shard
    files) without racing on ``metadata.json``.
    """

    def __init__(self, run_dir: PathLike, cfg: ModelConfig,
                 sample_interval: float = 1.0 * DAY,
                 write_metadata: bool = True):
        self.dir = pathlib.Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        if write_metadata:
            meta = create_metadata(cfg, sample_interval)
            (self.dir / "metadata.json").write_text(json.dumps(meta, indent=2))

    def write_snapshot(self, step: int, zeta: np.ndarray, psi: np.ndarray) -> None:
        """Save the prognostic fields at a step under reference-parity keys
        (reference: src/run_model.jl:87-90)."""
        np.savez(
            self.dir / f"snap_{step:09d}.npz",
            **{f"zeta_{step}": np.asarray(zeta), f"psi_{step}": np.asarray(psi)},
        )

    def write_checkpoint(self, state: State) -> None:
        """Full-state checkpoint (zeta, psi, AB3 history, step) for exact resume."""
        step = int(state.step)
        np.savez(
            self.dir / f"checkpoint_{step:09d}.npz",
            zeta=np.asarray(state.zeta),
            psi=np.asarray(state.psi),
            f1=np.asarray(state.f1),
            f2=np.asarray(state.f2),
            step=np.asarray(step),
        )

    def _write_sharded(self, kind: str, step: int, fields: Dict) -> None:
        """Write THIS process's addressable shards of sharded jax.Arrays to
        one npz + index sidecar. Call on EVERY process (each writes only its
        own file — no full-grid gather, no cross-process races; shared-FS
        multihost layout, the orbax-style scheme at npz simplicity).

        Keys keep the reference's ``{field}_{step}`` naming per shard
        (reference: src/run_model.jl:87-90), suffixed ``_shard{k}``.
        """
        import jax

        proc = jax.process_index()
        path = self.dir / f"{kind}_{step:09d}-shard{proc:05d}.npz"
        arrays: Dict[str, np.ndarray] = {}
        index: Dict = {"step": step, "process": proc, "fields": {},
                       "shards": {}}
        for name, leaf in fields.items():
            index["fields"][name] = {
                "shape": list(leaf.shape), "dtype": str(leaf.dtype)}
            shards = getattr(leaf, "addressable_shards", None)
            if shards is None:      # host numpy array: single full shard
                key = f"{name}_{step}_shard0"
                arrays[key] = np.asarray(leaf)
                index["shards"][key] = {
                    "field": name,
                    "index": [[0, d] for d in leaf.shape]}
                continue
            for k, s in enumerate(shards):
                if s.replica_id != 0:   # replicated copy — write once
                    continue
                key = f"{name}_{step}_shard{k}"
                arrays[key] = np.asarray(s.data)
                index["shards"][key] = {
                    "field": name,
                    "index": [list(se) for se in
                              _normalize_index(s.index, leaf.shape)]}
        np.savez(path, **arrays)
        path.with_suffix(".index.json").write_text(json.dumps(index))

    def write_checkpoint_sharded(self, state: State) -> None:
        """Sharded full-state checkpoint: per-process shard files, no
        gather. Collective in the weak sense only (every process must call
        it so every shard lands on disk). Pod-scale counterpart of
        ``write_checkpoint`` (the gathered path moves the whole grid
        through host 0 — 256 MB/field at 8192² f32)."""
        step = int(state.step)
        self._write_sharded("checkpoint", step, {
            "zeta": state.zeta, "psi": state.psi,
            "f1": state.f1, "f2": state.f2})

    def write_snapshot_sharded(self, step: int, zeta, psi) -> None:
        """Sharded snapshot of the prognostic fields (same scheme)."""
        self._write_sharded("snap", int(step), {"zeta": zeta, "psi": psi})


class RunReader:
    """Reads a run directory (counterpart of the reference's ``load_matrix`` /
    ``get_metadata``, src/plotting/animation.jl:6-17)."""

    def __init__(self, run_dir: PathLike):
        self.dir = pathlib.Path(run_dir)
        self.metadata = json.loads((self.dir / "metadata.json").read_text())

    def _steps(self, kind: str) -> List[int]:
        """All steps with a monolithic file or a complete-enough shard set."""
        steps = set()
        for p in self.dir.glob(f"{kind}_*.npz"):
            m = _SHARD_RE.match(p.stem)
            if m:
                steps.add(int(m.group(2)))
            elif p.stem.startswith(f"{kind}_"):
                try:
                    steps.add(int(p.stem.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def snapshot_steps(self) -> List[int]:
        return self._steps("snap")

    def _shard_files(self, kind: str, step: int) -> List[pathlib.Path]:
        return sorted(self.dir.glob(f"{kind}_{step:09d}-shard*.npz"))

    def _assemble_sharded(self, kind: str, step: int) -> Dict[str, np.ndarray]:
        """Assemble full global fields from this step's shard files (reader
        tooling / mesh-changed resume; the sharded-resume fast path is
        ``load_checkpoint_sharded``)."""
        files = self._shard_files(kind, step)
        if not files:
            raise FileNotFoundError(f"no {kind} shards for step {step} "
                                    f"in {self.dir}")
        out: Dict[str, np.ndarray] = {}
        for path in files:
            index = json.loads(path.with_suffix(".index.json").read_text())
            with np.load(path) as z:
                for key, meta in index["shards"].items():
                    name = meta["field"]
                    if name not in out:
                        f = index["fields"][name]
                        out[name] = np.empty(tuple(f["shape"]),
                                             np.dtype(f["dtype"]))
                    sl = tuple(slice(a, b) for a, b in meta["index"])
                    out[name][sl] = z[key]
        out["step"] = np.asarray(step)
        return out

    def load_snapshot(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        mono = self.dir / f"snap_{step:09d}.npz"
        if mono.exists():
            with np.load(mono) as z:
                return z[f"zeta_{step}"], z[f"psi_{step}"]
        fields = self._assemble_sharded("snap", step)
        return fields["zeta"], fields["psi"]

    def checkpoint_steps(self) -> List[int]:
        return self._steps("checkpoint")

    def load_checkpoint(self, step: Optional[int] = None) -> State:
        """Load a full-state checkpoint (latest by default) for exact resume.
        Sharded checkpoints are assembled to full-grid host arrays; use
        ``load_checkpoint_sharded`` to load straight onto a mesh without
        materializing the global grid."""
        import jax.numpy as jnp

        steps = self.checkpoint_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        mono = self.dir / f"checkpoint_{step:09d}.npz"
        if mono.exists():
            with np.load(mono) as z:
                fields = {k: z[k] for k in ("zeta", "psi", "f1", "f2", "step")}
        else:
            fields = self._assemble_sharded("checkpoint", step)
        return State(
            zeta=jnp.asarray(fields["zeta"]),
            psi=jnp.asarray(fields["psi"]),
            f1=jnp.asarray(fields["f1"]),
            f2=jnp.asarray(fields["f2"]),
            step=jnp.asarray(int(fields["step"]), jnp.int32),
        )

    def load_checkpoint_sharded(self, shardings: State,
                                step: Optional[int] = None) -> State:
        """Exact resume of a sharded checkpoint straight onto a mesh: each
        process reads only the shard data its devices need. When the target
        sharding's per-device indices exactly match the stored shards (same
        mesh shape — the production resume), each block is loaded once and
        never concatenated; otherwise falls back to assembling the global
        field on host first (mesh-changed resume, small grids)."""
        import jax
        import jax.numpy as jnp

        steps = self.checkpoint_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        files = self._shard_files("checkpoint", step)
        if not files:
            # Monolithic checkpoint: load + place.
            st = self.load_checkpoint(step)
            return jax.tree.map(jax.device_put, st, shardings)

        # Lookup: field -> {normalized index: (file, key)}.
        lookup: Dict[str, Dict] = {}
        meta_fields: Dict[str, Dict] = {}
        for path in files:
            index = json.loads(path.with_suffix(".index.json").read_text())
            meta_fields.update(index["fields"])
            for key, meta in index["shards"].items():
                norm = tuple(tuple(se) for se in meta["index"])
                lookup.setdefault(meta["field"], {})[norm] = (path, key)

        opened: Dict[pathlib.Path, Dict[str, np.ndarray]] = {}

        def read(path: pathlib.Path, key: str) -> np.ndarray:
            if path not in opened:
                with np.load(path) as z:
                    opened[path] = {k: z[k] for k in z.files}
            return opened[path][key]

        assembled: Dict[str, np.ndarray] = {}

        def field_on(name: str, sharding) -> jax.Array:
            shape = tuple(meta_fields[name]["shape"])
            dtype = np.dtype(meta_fields[name]["dtype"])
            dev_map = sharding.addressable_devices_indices_map(shape)
            per_dev = []
            for dev, idx in dev_map.items():
                norm = _normalize_index(idx, shape)
                hit = lookup.get(name, {}).get(norm)
                if hit is not None:
                    block = read(*hit)
                else:       # mesh shape changed: assemble once, then slice
                    if name not in assembled:
                        assembled.update({name: self._assemble_sharded(
                            "checkpoint", step)[name]})
                    block = assembled[name][tuple(
                        slice(a, b) for a, b in norm)]
                per_dev.append(jax.device_put(
                    np.ascontiguousarray(block, dtype), dev))
            return jax.make_array_from_single_device_arrays(
                shape, sharding, per_dev)

        return State(
            zeta=field_on("zeta", shardings.zeta),
            psi=field_on("psi", shardings.psi),
            f1=field_on("f1", shardings.f1),
            f2=field_on("f2", shardings.f2),
            step=jax.device_put(jnp.asarray(step, jnp.int32), shardings.step),
        )

    def config(self) -> ModelConfig:
        # Fields of older versions that no longer exist are dropped.
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        return ModelConfig(**{k: v for k, v in self.metadata["config"].items()
                              if k in names})
