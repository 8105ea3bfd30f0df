"""Whole step's share of the float32 peak: the algorithmic operations of
the steps in the traced window (qgbench/costs/<config>.py) over the
window's length times the chips times the peak, in percent."""


def read(r):
    if r.trace is None or r.trace["window_s"] <= 0:
        return None
    flops = r.costs["flops"] * r.chips * r.traced_steps
    peak = r.chips * r.peaks["float32_flops_per_s"]
    return 100.0 * flops / (r.trace["window_s"] * peak)
