"""The window's wall time over the frames completed in it (a frame: one
call of the cell's render entry, its pixels on the host)."""

from portbench import readers


def read(ctx):
    return readers.per_unit_ms(ctx)
