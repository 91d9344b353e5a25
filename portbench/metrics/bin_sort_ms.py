"""Device ms a unit in binning's tile-key sort (the `bin.key_sort` span:
the keys built, sorted, and each tile's bounds searched)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, ("bin.key_sort",))
