"""The operations a unit needs (work.py, counted from the scene) over
its measured time and the float32 peak, in %."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
