"""Gridpoint-steps per second of the whole job: every step completed in
the window times M * P, over the window's length. Snapshot writes and
diagnostics read-backs inside the window count."""


def read(r):
    return r.steps * r.grid_points / r.window_s
