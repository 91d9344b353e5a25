"""Host ms a frame spent waiting for the device: the mesh raster's read
of its tile counts (`mesh.read_counts`, where the cell has an object)
and the frames' copy to the host (`rollout.to_host`)."""

from portbench import spans


def read(ctx):
    names = ("rollout.to_host",)
    if ctx["cell"].traffic.get("object"):
        names = ("mesh.read_counts",) + names
    return spans.ms_per_unit(ctx, names, "host_ms")
