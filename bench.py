"""Headline benchmark: gridpoint-steps/s of the two-layer QG step on one GPU.

The full model step (XLA stencils + AB3 update + packed spectral inversion
through cuFFT, float32) at the BASELINE config-4 resolution (2048^2), in
chunks of 500 steps under one jitted ``lax.scan``. After a warm-up chunk
(which compiles), the median of 5 chunks is reported; each timed chunk ends
in ``jax.block_until_ready``.

Prints the device (platform, device_kind, count), the card's name and power
limit, and as its last line one JSON object:
{"metric", "value", "unit", "vs_baseline", "ms_per_step", "device", "card"}.
Exits non-zero, printing no result, when JAX finds no GPU.

vs_baseline: the reference's best measured throughput is the M=256 sweep
point — 24 steps in 5.141 s on one CPU core (BASELINE.md,
julia_parts_graph.ipynb cell 3) = 3.06e5 gridpoint-steps/s.

    python bench.py [--M 2048] [--P 2048] [--steps 500] [--reps 5]
"""

import argparse
import json
import sys

# Reference: M=256, 1 model-day, dt=60 min => 24 steps in 5.141 s (1 CPU core).
_REF_GRIDPOINT_STEPS_PER_S = 256 * 256 * 24 / 5.141


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--M", type=int, default=2048)
    parser.add_argument("--P", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)

    import jax

    from tpu_qg.config import ModelConfig
    from tpu_qg.constants import KM
    from tpu_qg.models.core import QGModel, init_state
    from tpu_qg.utils.profiling import median_call_seconds
    from tpu_qg.utils.runtime import (device_report, gpu_name_and_power_limit,
                                      setup_compile_cache)

    setup_compile_cache()
    dev = device_report()
    print(f"device: {json.dumps(dev)}")
    if dev["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX runs on {dev['platform']}",
              file=sys.stderr)
        return 1
    card = gpu_name_and_power_limit()
    print(f"card: {card}")

    cfg = ModelConfig(M=args.M, P=args.P, Lx=4000.0 * KM, Ly=4000.0 * KM,
                      dt=60.0, T=3600.0, dtype="float32")
    model = QGModel(cfg)
    state = init_state(cfg, key=jax.random.PRNGKey(0))
    seconds, state = median_call_seconds(
        lambda s: model.run(s, args.steps), state, args.reps)
    if not bool(jax.numpy.isfinite(state.zeta).all()):
        print("non-finite state after the timed chunks", file=sys.stderr)
        return 1

    gps = cfg.M * cfg.P * args.steps / seconds
    print(json.dumps({
        "metric": f"gridpoint-steps/s, two-layer QG {cfg.M}x{cfg.P} float32",
        "value": gps,
        "unit": "gridpoint-steps/s",
        "vs_baseline": gps / _REF_GRIDPOINT_STEPS_PER_S,
        "ms_per_step": 1e3 * seconds / args.steps,
        "device": dev,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
