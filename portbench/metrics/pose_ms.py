"""Host ms a frame posing the object's links and copying them to the
device (the `rollout.pose` span of scenegen/rollout.py)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, ("rollout.pose",), "host_ms")
