#!/bin/sh
# Multi-card launcher — the counterpart of the reference's SGE batch job
# (reference: scripts/benchmarking_job.sh, which requested ONE CPU core on
# the Eddie cluster). One process per host drives all of that host's cards;
# tpu_qg shards the grid over the global ('x', 'y') mesh and the driver
# streams snapshots from process 0.
#
# One host: run it once; the mesh spans the host's cards.
# Several hosts: run THIS SAME SCRIPT once on every host, each with the same
# COORDINATOR and NUM_PROCESSES and its own PROCESS_ID.
#
# Environment:
#   PRESET      config preset name            (default: pod-8192)
#   RUN_DIR     snapshot/checkpoint directory (default: runs/pod)
#   STEPS       step-count override           (optional)
#   COORDINATOR host:port of process 0's jax.distributed coordinator
#               (several hosts only; then NUM_PROCESSES and PROCESS_ID are
#               required). scripts/multihost_smoke.py exercises this
#               plumbing with 2 CPU processes.
#   EXTRA_ARGS  extra tpu_qg.run arguments    (optional)
set -eu

PRESET="${PRESET:-pod-8192}"
RUN_DIR="${RUN_DIR:-runs/pod}"
STEPS="${STEPS:-}"
COORDINATOR="${COORDINATOR:-}"
# IMPORTANT: snapshot/checkpoint cadence drives COLLECTIVE gathers — every
# process must run with identical values or the gather deadlocks.
CHECKPOINT_EVERY="${CHECKPOINT_EVERY:-1000}"

cd "$(dirname "$0")/.."

if [ -n "$COORDINATOR" ]; then
    MESH_ARGS="--distributed --coordinator $COORDINATOR \
        --num-processes $NUM_PROCESSES --process-id $PROCESS_ID"
else
    MESH_ARGS="--mesh"
fi

exec python -m tpu_qg.run \
    --preset "$PRESET" \
    --run-dir "$RUN_DIR" \
    $MESH_ARGS \
    ${STEPS:+--steps "$STEPS"} \
    ${EXTRA_ARGS:-} \
    --checkpoint-every "$CHECKPOINT_EVERY"
