"""Collective (NCCL) kernel time over the traced window, on the chip where
it is largest, in percent. Nothing to read on one chip."""


def read(r):
    if r.trace is None or r.trace["window_s"] <= 0:
        return None
    times = [d["classes"].get("collective", 0.0)
             for d in r.trace["devices"].values()]
    if not times or max(times) <= 0:
        return None
    return 100.0 * max(times) / r.trace["window_s"]
