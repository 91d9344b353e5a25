"""The share of binning's sorted tile keys that name a tile, in %
(counters `bin.keys_real` over `bin.keys_sorted`): the rest are the
sentinels of empty slots."""

from portbench import spans


def read(ctx):
    return spans.share(ctx, "bin.keys_real", "bin.keys_sorted")
