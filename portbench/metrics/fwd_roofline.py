"""The compositing forward kernel's share of its roofline, in %: the
device kernels whose name holds `composite_fwd_kernel`."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "fwd", "composite_fwd_kernel")
