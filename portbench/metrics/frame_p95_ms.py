"""The 95th percentile of every frame's latency in the window, from the
call to its return."""

from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx)
