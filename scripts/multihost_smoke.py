#!/usr/bin/env python
"""2-process jax.distributed CPU smoke of the multi-host entry path.

Validates, without several hosts, everything the multi-host story depends on
(the reference's counterpart is the SGE batch job, reference:
scripts/benchmarking_job.sh):

  * ``run.py --distributed --coordinator`` process bootstrap
    (jax.distributed.initialize with an explicit local coordinator),
  * the global (2, 1) mesh over two single-CPU-device processes,
  * the shard_map halo step + distributed FFT across PROCESS boundaries
    (collectives ride the CPU backend's transport between processes),
  * multihost IO: snapshots/checkpoints gathered with process_allgather and
    written by process 0 only,
  * ``scripts/run_pod.sh`` argument plumbing (process 0 goes through the pod
    launcher itself; process 1 calls tpu_qg.run directly).

Writes a JSON evidence line and exits nonzero on any failure. Usage:

    python scripts/multihost_smoke.py [--steps 6] [--out results/...json]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None, help="evidence JSON path")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()

    port = _free_port()
    run_dir = tempfile.mkdtemp(prefix="multihost_smoke_")
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    # One CPU device per process.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=1").strip()
    common = [
        "--preset", "two-layer-256", "--steps", str(args.steps),
        "--set", "M=64", "P=64",
        "--run-dir", run_dir, "--checkpoint-every", str(args.steps),
    ]

    # Process 0 exercises the pod launcher's plumbing end to end; process 1
    # is the plain CLI form. Both must produce the same global trajectory.
    p0 = subprocess.Popen(
        ["sh", os.path.join(REPO, "scripts", "run_pod.sh")],
        env={**env, "PRESET": "two-layer-256", "RUN_DIR": run_dir,
             "STEPS": str(args.steps), "COORDINATOR": coord,
             "NUM_PROCESSES": "2", "PROCESS_ID": "0",
             "CHECKPOINT_EVERY": str(args.steps),
             "EXTRA_ARGS": "--set M=64 P=64"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    p1 = subprocess.Popen(
        [sys.executable, "-m", "tpu_qg.run", "--distributed",
         "--coordinator", coord, "--num-processes", "2", "--process-id", "1",
         *common],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)

    t0 = time.time()
    out0, _ = p0.communicate(timeout=args.timeout)
    out1, _ = p1.communicate(timeout=args.timeout)
    elapsed = time.time() - t0

    steps_line = f"step {args.steps}/{args.steps}"
    files = sorted(os.listdir(run_dir))
    record = {
        "processes": 2,
        "steps": args.steps,
        "rc0": p0.returncode,
        "rc1": p1.returncode,
        "proc0_ran_all_steps": steps_line in out0,
        "proc0_wrote_snapshots": any(f.startswith("snap_") for f in files),
        "proc0_wrote_checkpoint": any(f.startswith("checkpoint_")
                                      for f in files),
        # Process 1 must stay silent (primary-only logging) and write nothing.
        "proc1_silent": steps_line not in out1,
        "elapsed_s": round(elapsed, 2),
    }
    record["ok"] = (record["rc0"] == 0 and record["rc1"] == 0
                    and record["proc0_ran_all_steps"]
                    and record["proc0_wrote_snapshots"]
                    and record["proc0_wrote_checkpoint"])
    print(json.dumps(record))
    if not record["ok"]:
        print("--- process 0 tail ---", *out0.splitlines()[-25:], sep="\n")
        print("--- process 1 tail ---", *out1.splitlines()[-25:], sep="\n")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
