"""The compositing backward kernel's share of its roofline, in %: the
device kernels whose name holds `composite_bwd`."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "bwd", "composite_bwd")
