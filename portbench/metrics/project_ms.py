"""Device ms a unit of projection and SH (render/project.py, core/),
backward included."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, readers.PROJECT)
