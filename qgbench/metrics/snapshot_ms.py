"""Mean host time of one snapshot write (the benchmark's span around
RunWriter.write_snapshot) over the window, in milliseconds."""


def read(r):
    times = r.spans.within("snapshot", *r.window)
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
