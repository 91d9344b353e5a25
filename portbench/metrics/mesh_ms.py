"""Device ms a frame of the mesh raster and the depth merge
(render/mesh_raster.py, render/compose.py)."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, readers.MESH)
