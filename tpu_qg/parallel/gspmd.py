"""GSPMD sharded stepping: global arrays + sharding constraints.

The "let XLA insert collectives" path (the scaling-book recipe): the step
function is written on global (L, M, P) arrays exactly as in
tpu_qg.models.core; we annotate the spatial axes with a 2-D mesh sharding and
jit. Under SPMD partitioning XLA lowers the stencil rolls to collective
permutes of 1-cell boundary slabs and partitions/gathers the FFTs for
the elliptic solve. Always correct; the hand-tuned shard_map halo path
(tpu_qg.parallel.halo) exists for when the partitioner's choices are not
optimal.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModelConfig
from ..models.core import State, make_step_fn


def state_sharding(mesh: Mesh) -> State:
    """Shardings for each State leaf: spatial (M, P) axes over mesh ('x', 'y'),
    layer/history axes replicated, step counter replicated."""
    return State(
        zeta=NamedSharding(mesh, P(None, "x", "y")),
        psi=NamedSharding(mesh, P(None, "x", "y")),
        f1=NamedSharding(mesh, P(None, "x", "y")),
        f2=NamedSharding(mesh, P(None, "x", "y")),
        step=NamedSharding(mesh, P()),
    )


def shard_state(state: State, mesh: Mesh) -> State:
    """Place a state on the mesh with the canonical shardings."""
    sh = state_sharding(mesh)
    return jax.tree.map(jax.device_put, state, sh)


def make_sharded_step_fn(cfg: ModelConfig, mesh: Mesh, donate: bool = True):
    """Jitted single-step function with mesh-sharded inputs/outputs.

    Input buffers are donated (the state is dead after the step) so XLA can
    update in place — the multi-device analog of the reference's in-place
    ``store_new_state!`` ring buffer (reference: src/model.jl:101-106) without
    any aliasing hazards.
    """
    step = make_step_fn(cfg, batched_fft=False)
    sh = state_sharding(mesh)
    return jax.jit(
        step,
        in_shardings=(sh,),
        out_shardings=sh,
        donate_argnums=(0,) if donate else (),
    )


def make_sharded_run_fn(cfg: ModelConfig, mesh: Mesh):
    """Returns ``run(state, n) -> state``: an n-step ``lax.scan`` with
    mesh-sharded carry, compiled once per distinct n."""
    import functools

    step = make_step_fn(cfg, batched_fft=False)
    sh = state_sharding(mesh)

    @functools.lru_cache(maxsize=None)
    def compiled(n: int):
        def run(state: State) -> State:
            def body(s, _):
                return step(s), None
            out, _ = jax.lax.scan(body, state, None, length=n)
            return out
        return jax.jit(run, in_shardings=(sh,), out_shardings=sh,
                       donate_argnums=(0,))

    return lambda state, n: compiled(n)(state)
