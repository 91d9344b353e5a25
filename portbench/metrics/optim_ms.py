"""Device ms a step of Adam (train/optim.py)."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, readers.OPTIM)
