"""Stencil, update and other XLA fusions against their roofline: the
least time of the tendency + update (the larger of its byte floor at peak
bandwidth and its operations at the float32 peak) over the device time of
all events that are not cuFFT, collective or host transfer, per chip, in
percent. The byte floor bounds it at these sizes."""


def read(r):
    if r.trace is None:
        return None
    busy = r.trace["classes"].get("other", 0.0)
    if busy <= 0:
        return None
    least = max(r.costs["stencil_bytes"] / r.peaks["hbm_bytes_per_s"],
                r.costs["stencil_flops"] / r.peaks["float32_flops_per_s"])
    return 100.0 * least * r.traced_steps / busy
