"""cuFFT against its roofline: the least time of the inversion's
transforms (the larger of one read and one write per transform at peak
bandwidth and the transform operations at the float32 peak) over the
device time of cuFFT's events, per chip, in percent. The byte floor bounds
it at these sizes."""


def read(r):
    if r.trace is None:
        return None
    busy = r.trace["classes"].get("fft", 0.0)
    if busy <= 0:
        return None
    least = max(r.costs["fft_bytes"] / r.peaks["hbm_bytes_per_s"],
                r.costs["fft_flops"] / r.peaks["float32_flops_per_s"])
    return 100.0 * least * r.traced_steps / busy
