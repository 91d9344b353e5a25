"""The profiled window's share of wall time in which the device ran
nothing (1 - the union of its kernel, copy and set intervals over the
window), in %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
