"""Seconds from process start to the window's start: importing JAX,
reaching the cards, making the state, the pre-warm call (which compiles
or loads every program from the cache) and the main call's first
interval, in which run_model re-traces its scan."""


def read(r):
    return r.setup_s
