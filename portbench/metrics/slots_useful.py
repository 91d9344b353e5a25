"""The share of binning's enumerated bbox slots that the exact cull kept,
in % (counters `bin.slots_kept` over `bin.slots`): how much of the row
sort's input is a tile a splat reaches."""

from portbench import spans


def read(ctx):
    return spans.share(ctx, "bin.slots_kept", "bin.slots")
