"""One benchmark cell, run once: set-up, a timed window through
``tpu_qg.run.run_model``, the check against the plain reference, and, with
tracing on, the per-layer metrics from the device trace.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name:

    BENCHMARK.json                 the cells and metrics
    qgbench/configs/<config>.json  the model as it is run
    qgbench/costs/<config>.py      operations and byte floors per step
    qgbench/traffic/<traffic>.json the run loop's parameters
    qgbench/limits/<cell>.json     the limit of each number compared
    qgbench/metrics/<metric>.py    one per-layer metric's reader
    qgbench/peaks/<device kind>.json  the card's published peaks

How a run goes. The state is made on the device from ``--seed`` in one
jitted call. A pre-warm ``run_model`` call of two intervals compiles (or
loads from the compile cache) every program the window uses, and its
second interval gives the interval time. The main ``run_model`` call then
runs one set-up interval, in which ``run_model`` re-traces its scan, and as
many further intervals as fill ``--seconds``. The window runs from the end
of the set-up interval to the end of the last one; an interval ends when
the program's per-interval ``diagnostics`` call returns, which reads
scalars of the new state back to the host. The final checkpoint
``run_model`` writes on return lies outside the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# A fixed path inside the checkout: the directory is part of the cache key.
CACHE_DIR = BENCH_DIR / ".jax_cache"


class NoDevice(RuntimeError):
    """JAX finds no GPU, or fewer than the cell asks for."""


# --------------------------------------------------------------------------
# Files found by name


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "qgbench_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peak_file(kind: str) -> pathlib.Path:
    """The peak table of a device kind; a kind with no file is an error."""
    name = "".join(c if c.isalnum() else "_" for c in kind)
    return BENCH_DIR / "peaks" / f"{name}.json"


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    costs: object                  # module with per_step(model, chips)
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]     # metric name -> its reader module


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / "qgbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[name]
    config = load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    costs = load_module(bench_dir / "costs" / f"{w['config']}.py")

    def here(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if here(m) and m["moves"] in e2e_names]
    readers = {m["name"]: load_module(bench_dir / "metrics" /
                                      f"{m['name']}.py")
               for m in e2e + per_layer}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, costs=costs, end_to_end=e2e,
                per_layer=per_layer, readers=readers)


# --------------------------------------------------------------------------
# Host spans, compile events


class Spans:
    """Host spans by name, on ``time.perf_counter_ns``, each also written
    into the profiler's trace as a ``TraceAnnotation`` named
    ``qgbench.<name>``."""

    def __init__(self):
        self.records: List[tuple] = []       # (name, start_ns, end_ns)

    @contextlib.contextmanager
    def span(self, name: str):
        import jax
        start = time.perf_counter_ns()
        with jax.profiler.TraceAnnotation(f"qgbench.{name}"):
            yield
        self.records.append((name, start, time.perf_counter_ns()))

    def within(self, name: str, lo: int, hi: int) -> List[float]:
        """Durations in seconds of the ``name`` spans inside [lo, hi]."""
        return [(e - s) / 1e9 for n, s, e in self.records
                if n == name and s >= lo and e <= hi]


class CompileEvents:
    """Times of JAX's trace, compile and compile-cache events, so that the
    window can count what happened inside it (there should be nothing)."""

    DURATIONS = ("/jax/core/compile/jaxpr_trace_duration",
                 "/jax/core/compile/backend_compile_duration")
    EVENTS = ("/jax/compilation_cache/cache_hits",
              "/jax/compilation_cache/cache_misses")

    def __init__(self):
        self.times: List[tuple] = []         # (event, perf_counter_ns)

    def _duration(self, event, duration, **kw):
        if event in self.DURATIONS:
            self.times.append((event, time.perf_counter_ns()))

    def _event(self, event, **kw):
        if event in self.EVENTS:
            self.times.append((event, time.perf_counter_ns()))

    def __enter__(self):
        import jax.monitoring as mon
        mon.register_event_duration_secs_listener(self._duration)
        mon.register_event_listener(self._event)
        return self

    def __exit__(self, *exc):
        import jax.monitoring as mon
        mon.unregister_event_duration_listener(self._duration)
        mon.unregister_event_listener(self._event)

    def count(self, lo: int, hi: int) -> int:
        return sum(lo <= t <= hi for _, t in self.times)


# --------------------------------------------------------------------------
# Hooks around the program's per-interval calls


class Intervals:
    """What one ``run_model`` call did at its interval boundaries: the end
    time of each interval, the diagnostics it read, and device copies of
    the states the check needs."""

    def __init__(self, capture=(), on_end: Optional[Callable] = None):
        self.ends: List[int] = []
        self.diags: List[dict] = []
        self.capture = set(capture)              # interval indices to copy
        self.states: Dict[int, object] = {}
        self.on_end = on_end

    def end(self, state, diag):
        import jax
        import jax.numpy as jnp
        i = len(self.ends)
        self.ends.append(time.perf_counter_ns())
        self.diags.append(diag)
        if i in self.capture:
            # A copy: the next interval's scan may donate these buffers.
            self.states[i] = jax.tree.map(jnp.copy, state)
        if self.on_end is not None:
            self.on_end(i)


@contextlib.contextmanager
def instrument(spans: Spans):
    """Wrap the program's per-interval calls in spans, and route the end of
    every interval to ``current[0]``, the Intervals of the running call."""
    import tpu_qg.io as tio
    import tpu_qg.run as trun
    from tpu_qg.models.core import QGModel
    from tpu_qg.parallel import stepper

    current: List[Optional[Intervals]] = [None]
    orig = (trun.diagnostics, tio.RunWriter.write_snapshot, QGModel.run,
            stepper.make_halo_run_fn)

    def diagnostics(cfg, state):
        with spans.span("diagnostics"):
            d = orig[0](cfg, state)
        current[0].end(state, d)
        return d

    def write_snapshot(self, step, zeta, psi):
        with spans.span("snapshot"):
            orig[1](self, step, zeta, psi)

    def model_run(self, state, n_steps):
        with spans.span("step"):
            return orig[2](self, state, n_steps)

    def make_halo_run_fn(cfg, mesh, *a, **kw):
        run_fn = orig[3](cfg, mesh, *a, **kw)

        def run(state, n):
            with spans.span("step"):
                return run_fn(state, n)
        return run

    trun.diagnostics = diagnostics
    tio.RunWriter.write_snapshot = write_snapshot
    QGModel.run = model_run
    stepper.make_halo_run_fn = make_halo_run_fn
    try:
        yield current
    finally:
        (trun.diagnostics, tio.RunWriter.write_snapshot, QGModel.run,
         stepper.make_halo_run_fn) = orig


# --------------------------------------------------------------------------
# Set-up


def check_devices(chips: int) -> list:
    """The cell's GPUs, or NoDevice. Nothing falls back to the CPU."""
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError as e:
        raise NoDevice(f"JAX finds no GPU: {e}") from None
    if len(gpus) < chips:
        raise NoDevice(f"the cell needs {chips} GPUs; JAX finds {len(gpus)}")
    return gpus[:chips]


def power_limits() -> str:
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def setup_compile_cache() -> None:
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # The four-card step's executable is about 420 MB: a cap below that
    # (some machines set 200 MB) would recompile it in every run.
    jax.config.update("jax_compilation_cache_max_size", 4 * 2 ** 30)


def prng_key(seed: int):
    """A key for any seed a 64-bit integer holds (``PRNGKey`` alone keeps
    only the low 32 bits in 32-bit mode)."""
    import jax
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not in [0, 2**64)")
    key = jax.random.PRNGKey(seed & 0xFFFFFFFF)
    return jax.random.fold_in(key, seed >> 32)


def make_state(cfg, mesh, seed: int):
    """The initial state, made on the device(s) in one jitted call."""
    import functools

    import jax
    from tpu_qg.models.core import init_state
    shardings = None
    if mesh is not None:
        from tpu_qg.parallel.gspmd import state_sharding
        shardings = state_sharding(mesh)
    make = jax.jit(functools.partial(init_state, cfg), out_shardings=shardings)
    return jax.block_until_ready(make(prng_key(seed)))


def host_state(state) -> dict:
    return {k: np.asarray(getattr(state, k))
            for k in ("zeta", "psi", "f1", "f2", "step")}


# --------------------------------------------------------------------------
# The check against the reference


def compare(cell: Cell, start: dict, end: dict, steps: int, save: bool,
            snapshot, snapshots: Dict[int, float], diag_max: Dict[int, float],
            substitute: Optional[Callable] = None) -> Dict[str, dict]:
    """Each number compared, with its limit.

    ``start``/``end``: the program's state (host arrays) at the start and
    end of the sampled interval; ``snapshot``: the (zeta, psi) file the
    program wrote at that end, or None; ``snapshots``/``diag_max``: max|zeta|
    of every window snapshot as read back from its file, and as the
    program's diagnostics reported it. ``substitute(physics, start,
    steps)``, for the control, replaces the program's end state."""
    import jax
    import jax.numpy as jnp

    from qgbench import reference as ref

    ph = ref.physics(cell.config["model"])
    fields = ("zeta", "psi", "f1", "f2")
    out = {}
    with jax.enable_x64(True):
        s0 = ref.from_host([start[k] for k in fields], int(start["step"]),
                           jnp.float64, jax.devices()[0])
        want = ref.run(ph, s0, steps)
        del s0
        got = end if substitute is None else substitute(ph, start, steps)
        for name, k, i in (("zeta_err", "zeta", 0), ("psi_err", "psi", 1),
                           ("tend_err", "f1", 2)):
            out[name] = ref.rel_l2(got[k], want[i])
        out["steps_err"] = abs(int(got["step"]) - int(want[4]))
        if save:
            for name, i in (("snapshot_zeta_err", 0), ("snapshot_psi_err", 1)):
                out[name] = (math.inf if snapshot is None
                             else ref.rel_l2(snapshot[i], want[i]))
        del want, got
    if save:
        out["snapshot_diff"] = math.inf if snapshot is None else max(
            float(np.abs(snapshot[0] - end["zeta"]).max()),
            float(np.abs(snapshot[1] - end["psi"]).max()))
        out["snapshot_max_mismatch"] = sum(
            snapshots.get(step) != m for step, m in diag_max.items())
    return {k: {"value": v, "limit": cell.limits[k]} for k, v in out.items()}


def within_limits(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def read_snapshot(run_dir: pathlib.Path, step: int):
    """(zeta, psi) of the snapshot file of ``step``, or None if the file
    or its keys are missing."""
    try:
        with np.load(run_dir / f"snap_{step:09d}.npz") as z:
            return z[f"zeta_{step}"], z[f"psi_{step}"]
    except (OSError, KeyError):
        return None


# --------------------------------------------------------------------------
# The run


@dataclasses.dataclass
class Readings:
    """What a metric's reader (qgbench/metrics/<name>.py) may read."""

    chips: int
    grid_points: int       # M * P
    steps: int             # steps completed in the window
    window_s: float        # the window's length
    setup_s: float         # process start to window start
    interval_s: List[float]  # each window interval's length
    spans: Spans
    window: tuple          # (start_ns, end_ns) of the window
    costs: dict            # per chip per step: flops, *_bytes, *_flops
    peaks: dict
    trace: Optional[dict]  # qgbench.xplane.summarize() of the traced part
    traced_steps: int


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, rehearsal: bool = False,
             overrides: Optional[dict] = None,
             substitute: Optional[Callable] = None,
             keep_trace: Optional[pathlib.Path] = None,
             log=print) -> dict:
    """Run ``cell`` once and return the result line's object.

    For tests and tools only: ``rehearsal`` skips the look for GPUs and
    puts no metric values in the result; ``overrides`` ({"model": {...},
    "traffic": {...}}) changes fields of the cell's files, for toy grids;
    ``substitute`` (the control) replaces the program's output in the
    check; ``keep_trace`` copies the traced run's ``.xplane.pb`` there."""
    import jax

    from tpu_qg.config import ModelConfig
    from tpu_qg.parallel import make_mesh
    from tpu_qg.run import run_model

    if overrides:
        cell = dataclasses.replace(
            cell,
            config={**cell.config, "model": {**cell.config["model"],
                                            **overrides.get("model", {})}},
            traffic={**cell.traffic, **overrides.get("traffic", {})})
    if rehearsal:
        devices = jax.devices()[:cell.chips]
        peaks = load_json(peak_file("NVIDIA H100 80GB HBM3"))
    else:
        devices = check_devices(cell.chips)
        peaks = load_json(peak_file(devices[0].device_kind))
        log(f"cards: {power_limits()}", file=sys.stderr)
        setup_compile_cache()

    cfg = ModelConfig(**cell.config["model"])
    traffic = cell.traffic
    mesh = None
    if cell.chips > 1:
        mesh = make_mesh(tuple(cell.config["mesh"]), devices=devices,
                         cfg=cfg)
    sample_steps = max(int(traffic["sample_interval_s"] // cfg.dt), 1)
    save = bool(traffic["save_results"])
    scratch = pathlib.Path(tempfile.mkdtemp(prefix="qgbench-"))
    log(f"scratch: {scratch} on {filesystem(scratch)}", file=sys.stderr)
    spans = Spans()
    prof_dir = scratch / "trace"
    rng = np.random.default_rng(seed)

    host_step = [0]     # steps run_model was asked for so far

    def call(state, run_dir, n_intervals, iv: Intervals):
        current[0] = iv
        host_step[0] += n_intervals * sample_steps
        return run_model(cfg, run_dir=str(run_dir), save_results=save,
                         n_steps=host_step[0],
                         sample_interval=traffic["sample_interval_s"],
                         verbose=False, state=state, mesh=mesh,
                         parallel_impl="halo")

    try:
        with CompileEvents() as compiles, instrument(spans) as current:
            state = make_state(cfg, mesh, seed)
            warm = Intervals(capture=(0,))
            state = call(state, scratch / "prewarm", 2, warm)
            interval_s = (warm.ends[1] - warm.ends[0]) / 1e9
            del warm
            n_window = max(2, math.ceil(seconds / interval_s))
            # The checked interval, drawn from the seed among the first
            # ``check_intervals`` of the window: the state's age, and with
            # it the float32 error of the tendency, then does not grow as
            # the program gets faster and the window holds more intervals.
            k = int(rng.integers(1, min(n_window, int(
                traffic["check_intervals"])) + 1))
            n_traced = min(int(traffic["trace_intervals"]), n_window)

            def on_end(i):
                if trace and i == 0:
                    jax.profiler.start_trace(str(prof_dir), profiler_options=(
                        _profile_options()))
                    with spans.span("trace_start"):
                        pass
                if trace and i == n_traced:
                    jax.profiler.stop_trace()

            main = Intervals(capture=(k - 1, k), on_end=on_end)
            main_start = host_step[0]
            final = call(state, scratch / "main", 1 + n_window, main)
            del state
            jax.block_until_ready(final)
        t0, t1 = main.ends[0], main.ends[n_window]
        memory_peak = peak_bytes(devices)
        log(f"window: {n_window} intervals of {sample_steps} steps, "
            f"{(t1 - t0) / 1e9:.6f} s; pre-warm interval {interval_s:.6f} s; "
            f"compilations in window: {compiles.count(t0, t1)}; "
            f"sampled interval {k}", file=sys.stderr)
        intervals = [float(d) / 1e9 for d in np.diff(main.ends)]
        log("interval_s: " + " ".join(f"{d:.6f}" for d in intervals),
            file=sys.stderr)

        start, end = host_state(main.states[k - 1]), host_state(
            main.states[k])
        final_step = int(final.step)
        del final, main.states
        gc.collect()

        snapshot, snapshots, diag_max = None, {}, {}
        if save:
            for i in range(1, n_window + 1):
                step = main_start + (i + 1) * sample_steps
                diag_max[step] = main.diags[i]["max_abs_zeta"]
                fields = read_snapshot(scratch / "main", step)
                snapshots[step] = (None if fields is None
                                   else float(np.abs(fields[0]).max()))
                if i == k:
                    snapshot = fields
        t_check = time.perf_counter()
        checks = compare(cell, start, end, sample_steps, save, snapshot,
                         snapshots, diag_max, substitute)
        log(f"reference check: {time.perf_counter() - t_check:.3f} s",
            file=sys.stderr)
        checks["final_step_err"] = {
            "value": abs(final_step - host_step[0]), "limit": 0}
        correct = within_limits(checks)
        # The checked interval, or every window snapshot that disagreed.
        failed = max(int(not correct), checks.get(
            "snapshot_max_mismatch", {"value": 0})["value"])

        summary = None
        if trace:
            from qgbench import xplane
            path = xplane.find(prof_dir)
            if keep_trace is not None:
                shutil.copy(path, keep_trace)
            summary = xplane.summarize(xplane.load(path, planes={
                f"/device:{d.platform.upper()}:{d.id}" for d in devices}))
        readings = Readings(
            chips=len(devices), grid_points=cfg.M * cfg.P,
            steps=n_window * sample_steps, window_s=(t1 - t0) / 1e9,
            setup_s=t0 / 1e9 - t_start,
            interval_s=intervals,
            spans=spans, window=(t0, t1),
            costs=cell.costs.per_step(cell.config["model"], len(devices)),
            peaks=peaks, trace=summary,
            traced_steps=n_traced * sample_steps)
        wanted = cell.per_layer if trace else cell.end_to_end
        metrics: Dict[str, dict] = {}
        for m in wanted:
            value = cell.readers[m["name"]].read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        device = {"platform": devices[0].platform,
                  "kind": devices[0].device_kind, "count": len(devices),
                  "memory_peak_bytes": memory_peak}
        if summary is not None:
            device["busy_s"] = summary["busy_s"]
            device["window_s"] = summary["window_s"]
        result = {"correct": bool(correct), "attempted": n_window,
                  "failed": failed, "metrics": metrics, "device": device}
        if summary is not None:
            result["breakdown"] = xplane.breakdown(summary)
        if rehearsal:
            # No number of a CPU run goes out under a device metric's name.
            result["metrics"] = {}
            result["rehearsal"] = True
            result["metrics_found"] = sorted(m["name"] for m in wanted)
            device.pop("busy_s", None)
            device.pop("window_s", None)
            result.pop("breakdown", None)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _profile_options():
    import jax
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0       # the host spans are TraceAnnotations
    return opts


def peak_bytes(devices) -> Optional[int]:
    peaks = []
    for d in devices:
        stats = d.memory_stats()
        if stats and "peak_bytes_in_use" in stats:
            peaks.append(int(stats["peak_bytes_in_use"]))
    return max(peaks) if peaks else None


def filesystem(path: pathlib.Path) -> str:
    """The mount holding ``path`` and its type, from /proc/mounts."""
    best = ("?", "?")
    try:
        with open("/proc/mounts") as fh:
            for line in fh:
                parts = line.split()
                mnt, fstype = parts[1], parts[2]
                if (str(path).startswith(mnt.rstrip("/") + "/")
                        and len(mnt) >= len(best[0])):
                    best = (mnt, fstype)
    except OSError:
        pass
    return f"{best[0]} ({best[1]})"


def report(result: dict, log=print) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; then the result line as the last line on standard
    output."""
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        log(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
            file=sys.stderr)
    log(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    log(json.dumps(result), flush=True)
