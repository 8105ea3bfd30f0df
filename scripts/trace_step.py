"""Profile of the single-card step: where the device time goes.

Traces one jitted chunk of ``--steps`` steps of the whole model step at
``--M``^2 float32 (after a warm-up chunk that compiles), reduces the device
timeline of the trace to per-op totals, and times the packed inversion
alone with ``jnp.fft`` (cuFFT on the GPU) and with the matmul-factorized
DFT (``fft_impl="matmul"``): median of 5 chunks each.

Writes ``<out>/trace_<M>.json``: the device's timeline lines, busy time per
step, the idle share of the traced window, the top ops by device time, and
the inversion timings; prints a summary. The raw trace stays in
``<out>/trace_<M>/``.

    python scripts/trace_step.py --M 2048 --steps 100 --out chiprun_out/profile
"""

import argparse
import collections
import glob
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def device_summary(xplane_path: str, steps: int, top: int = 20) -> dict:
    """Per-op device time from an .xplane.pb. Busy time is the union of the
    kernel intervals on the device's stream lines; the window runs from the
    first kernel's start to the last one's end. Ops are read from the
    "XLA Ops" line when the trace has one, else from the stream lines."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {line.name: list(line.events) for line in plane.lines}
        streams = [n for n in lines if n.startswith("Stream")]
        intervals = sorted((e.start_ns, e.end_ns)
                           for n in streams for e in lines[n])
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in intervals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
        op_line = "XLA Ops" if "XLA Ops" in lines else None
        per_op = collections.defaultdict(lambda: [0, 0.0])
        for n in ([op_line] if op_line else streams):
            for e in lines[n]:
                rec = per_op[e.name]
                rec[0] += 1
                rec[1] += e.duration_ns
        total = sum(v[1] for v in per_op.values()) or 1.0
        ops = [{"op": k[:120], "count": v[0], "total_us": v[1] / 1e3,
                "us_per_step": v[1] / 1e3 / steps,
                "share": v[1] / total}
               for k, v in sorted(per_op.items(), key=lambda kv: -kv[1][1])]
        out[plane.name] = {
            "lines": sorted(lines), "ops_from": op_line or "streams",
            "busy_us_per_step": busy / 1e3 / steps,
            "window_us": window / 1e3,
            "idle_share": (1.0 - busy / window) if window else None,
            "top_ops": ops[:top]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                   "profile"))
    args = ap.parse_args(argv)

    import jax

    from tpu_qg.config import preset
    from tpu_qg.models.core import QGModel, _build_packed_inverter, init_state
    from tpu_qg.utils.profiling import inversion_chunk, median_call_seconds
    from tpu_qg.utils.runtime import (device_report, gpu_name_and_power_limit,
                                      setup_compile_cache)

    setup_compile_cache()
    dev = device_report()
    card = (gpu_name_and_power_limit() if dev["platform"] == "gpu"
            else "not a GPU")
    cfg = preset("turbulence-2048").replace(M=args.M, P=args.M)
    model = QGModel(cfg)
    state = init_state(cfg, key=jax.random.PRNGKey(0))
    state = jax.block_until_ready(model.run(state, args.steps))  # compile

    trace_dir = os.path.join(args.out, f"trace_{args.M}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        state = jax.block_until_ready(model.run(state, args.steps))
    xplane = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    rec = {"M": args.M, "steps": args.steps, "device": dev, "card": card,
           "trace": device_summary(xplane, args.steps)}

    inv = {}
    for impl in ("xla", "matmul"):
        inverter = _build_packed_inverter(cfg.replace(fft_impl=impl))
        sec, _ = median_call_seconds(inversion_chunk(inverter, args.steps),
                                     (state.zeta, state.psi), 5)
        inv[impl] = {"ms_per_inversion": 1e3 * sec / args.steps}
    rec["inversion"] = inv

    path = os.path.join(args.out, f"trace_{args.M}.json")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"card: {card}")
    print(json.dumps({"device": dev, "inversion": inv}))
    for name, d in rec["trace"].items():
        print(f"{name}: busy {d['busy_us_per_step']:.2f} us/step, idle "
              f"share {d['idle_share']}, lines {d['lines']}")
        for op in d["top_ops"][:15]:
            print(f"  {100 * op['share']:5.1f}%  {op['us_per_step']:9.2f} "
                  f"us/step  n={op['count']:6d}  {op['op']}")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
