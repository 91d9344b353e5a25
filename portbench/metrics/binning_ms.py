"""Device ms a unit of binning (render/binning.py, with the row
gather's backward)."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, readers.BINNING)
