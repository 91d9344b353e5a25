"""The window's wall time over the training steps completed in it."""

from portbench import readers


def read(ctx):
    return readers.per_unit_ms(ctx)
