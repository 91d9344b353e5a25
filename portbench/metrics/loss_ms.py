"""Device ms a step of the loss (train/losses.py), backward included."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, readers.LOSS)
