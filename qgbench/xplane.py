"""Reduction of a JAX profiler trace (``.xplane.pb``) to what the per-layer
metrics read.

Busy time is the union of the event intervals on a device's stream lines
(the reduction of ``scripts/trace_step.py``'s ``device_summary``, kept here
so that the yardstick stays with the benchmark). Every device event falls
in one class:

    fft         cuFFT kernels, and any kernel of an XLA ``fft`` op (the
                cuBLAS scaling pass after an inverse transform)
    collective  NCCL kernels and peer-to-peer copies
    transfer    copies between host and device
    other       everything else: XLA fusions (stencils, update, packing,
                symbol multiply, reductions) and device-to-device copies

The window is taken from the benchmark's host spans in the same trace
(``TraceAnnotation`` events named ``qgbench.<span>``, on the profiler's
clock): from the ``trace_start`` marker to the end of the last
``diagnostics`` span. Each idle gap of a device inside the window is put
down to the host span its midpoint falls in, or to ``other``.
"""

from __future__ import annotations

import collections
import glob
import os
from typing import Dict, List, Optional

SPAN_PREFIX = "qgbench."


def find(log_dir) -> str:
    """The newest ``.xplane.pb`` under a ``jax.profiler`` log directory."""
    paths = sorted(glob.glob(os.path.join(
        str(log_dir), "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return paths[-1]


def classify(name: str, hlo_op: str) -> str:
    low = name.lower()
    if low.startswith("nccl") or "memcpyp2p" in low:
        return "collective"
    if "fft" in low or hlo_op.startswith("fft"):
        return "fft"
    if low.startswith(("memcpyh2d", "memcpyd2h", "memcpyhtod",
                       "memcpydtoh")):
        return "transfer"
    return "other"


def load(xplane_path: str, planes: Optional[set] = None) -> dict:
    """Device events and benchmark host spans from a trace, as plain data:
    ``{"devices": {plane: [(start_ns, end_ns, name, class), ...]},
    "spans": [(name, start_ns, end_ns), ...]}``. ``planes`` keeps only those
    device planes (the cell's cards, when the machine has more)."""
    from jax.profiler import ProfileData

    devices: Dict[str, list] = {}
    spans: List[tuple] = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if plane.name.startswith("/device:"):
            if planes is not None and plane.name not in planes:
                continue
            events = []
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for e in line.events:
                    hlo_op = ""
                    for key, value in e.stats:
                        if key == "hlo_op":
                            hlo_op = str(value)
                            break
                    events.append((e.start_ns, e.end_ns, e.name,
                                   classify(e.name, hlo_op)))
            devices[plane.name] = sorted(events)
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                for e in line.events:
                    if e.name.startswith(SPAN_PREFIX):
                        spans.append((e.name[len(SPAN_PREFIX):],
                                      e.start_ns, e.end_ns))
    return {"devices": devices, "spans": sorted(spans, key=lambda s: s[1])}


def window_of(spans) -> tuple:
    starts = [s for n, s, _ in spans if n == "trace_start"]
    ends = [e for n, _, e in spans if n == "diagnostics"]
    if not starts or not ends:
        raise ValueError("the trace holds no qgbench.trace_start marker "
                         "and diagnostics span")
    return starts[0], max(ends)


def _union(intervals) -> List[tuple]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def _span_at(spans, t: float) -> str:
    """The innermost benchmark span that holds time ``t``."""
    best, width = "other", None
    for name, s, e in spans:
        if s <= t <= e and (width is None or e - s < width):
            best, width = name, e - s
    return best


def summarize(trace: dict, window: Optional[tuple] = None) -> dict:
    """Per device, inside the window: busy seconds, seconds per class, per
    op, and idle seconds per host span; and their means over devices."""
    lo, hi = window or window_of(trace["spans"])
    window_s = (hi - lo) / 1e9
    per_device = {}
    for plane, events in trace["devices"].items():
        clipped = [(max(s, lo), min(e, hi), n, c) for s, e, n, c in events
                   if e > lo and s < hi]
        busy = _union((s, e) for s, e, _, _ in clipped)
        classes: Dict[str, float] = collections.defaultdict(float)
        ops: Dict[str, float] = collections.defaultdict(float)
        for s, e, n, c in clipped:
            classes[c] += (e - s) / 1e9
            ops[n] += (e - s) / 1e9
        idle: Dict[str, float] = collections.defaultdict(float)
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                idle[_span_at(trace["spans"], (a + b) / 2)] += (b - a) / 1e9
        per_device[plane] = {
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "classes": dict(classes), "ops": dict(ops), "idle": dict(idle)}
    n = max(len(per_device), 1)

    def mean(key):
        out: Dict[str, float] = collections.defaultdict(float)
        for d in per_device.values():
            for k, v in d[key].items():
                out[k] += v / n
        return dict(out)

    return {"window_s": window_s,
            "busy_s": sum(d["busy_s"] for d in per_device.values()) / n,
            "classes": mean("classes"), "ops": mean("ops"),
            "idle": mean("idle"), "devices": per_device}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each as [[name, seconds], ...] (means over
    devices)."""
    def largest(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": largest(summary["ops"]),
            "idle_gaps": largest(summary["idle"])}
