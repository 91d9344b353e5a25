"""Device ms a unit in binning's per-row compaction of the bbox slots
after the cull (the `bin.compact` span: the row sort of
render/binning.py::bin_and_gather_packed)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, ("bin.compact",))
